"""Scored positions (a label >= 0; padding and each prompt's last token
excluded) of the batches the window completed, over the window's seconds."""


def read(ctx):
    return sum(r["scored"] for r in ctx.records) / ctx.window_s
