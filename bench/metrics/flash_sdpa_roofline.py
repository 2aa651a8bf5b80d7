"""Share of its roofline that ``flash_sdpa`` reached in the traced window:
the sum over its launches of the least time each could take (bytes over
the HBM rate or operations over the bf16 tensor-core peak, the larger;
``harness.flops.flash_sdpa_cost``) over the device time of its kernels in
the trace.  Each batch launches it once a layer of the weak and of the
strong pass, at the batch's padded shape; when the trace's launch count
differs from that, or the model has no attention, nothing is read."""
from harness import flops
from harness.trace import kernel_time


def read(ctx):
    if ctx.trace is None or ctx.exit_layer is None or ctx.model["arch_type"] != "dense":
        return None
    n, seconds = kernel_time(ctx.trace["kernels"], "flash_sdpa")
    m = ctx.model
    per_batch = ctx.exit_layer + m["num_layers"]
    if n != per_batch * len(ctx.records) or seconds <= 0:
        return None
    bound = 0.0
    for r in ctx.records:
        cost = flops.flash_sdpa_cost(r["rows"], r["pad"], r["pad"], m["num_heads"],
                                     m["num_kv_heads"], m["head_dim"])
        bound += per_batch * flops.bound_s(*cost)[0]
    return 100.0 * bound / seconds
