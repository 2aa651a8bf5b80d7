"""Seconds from the process's start (before its imports) to the first
timed batch: weights, traffic, calibration, engine load, warm-up, and on a
checkout's first run the kernels' build."""


def read(ctx):
    return ctx.setup_s
