"""Share of its roofline that ``wkv6`` reached in the traced window: the
sum over its launches of the least time each could take (bytes over the
HBM rate or float32 operations over the CUDA-core peak, the larger;
``harness.flops.wkv6_cost``) over the device time of its kernels in the
trace.  Each batch launches it once a layer of the weak and of the strong
pass, over the batch's padded shape; when the trace's launch count differs
from that, or the model is not RWKV, nothing is read."""
from harness import flops
from harness.trace import kernel_time


def read(ctx):
    if ctx.trace is None or ctx.exit_layer is None or ctx.model["arch_type"] != "rwkv":
        return None
    n, seconds = kernel_time(ctx.trace["kernels"], "wkv6")
    m = ctx.model
    per_batch = ctx.exit_layer + m["num_layers"]
    if n != per_batch * len(ctx.records) or seconds <= 0:
        return None
    hd = m["rwkv_head_size"]
    bound = 0.0
    for r in ctx.records:
        cost = flops.wkv6_cost(r["rows"], r["pad"], m["d_model"] // hd, hd, hd)
        bound += per_batch * flops.bound_s(*cost)[0]
    return 100.0 * bound / seconds
