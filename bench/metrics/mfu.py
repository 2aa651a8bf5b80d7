"""The whole step's share of the card's bf16 peak: the model FLOPs of the
traced window's batches, as the cell's driver counts them
(``model_flops``; for the LM cascade ``harness.flops.cascade_flops``: the
weak and the strong pass over the scored positions, weights multiplied,
the unembedding but not the embedding gather, causal attention, the RWKV6
recurrence; padding not counted) over the window's seconds times the data
sheet's 989 TFLOP/s.  Read on the card only, and only where the driver has
a count."""
from harness import flops


def read(ctx):
    if ctx.trace is None or not ctx.on_card:
        return None
    work = ctx.driver.model_flops(ctx.records)
    if work is None:
        return None
    return 100.0 * work / (ctx.window_s * flops.PEAK_BF16_OPS_PER_S)
