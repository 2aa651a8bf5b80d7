"""LR schedules as step -> lr callables (``repro.train.schedule``).

Each is computed in float32, operation for operation as ``jnp`` computes it,
and returned as the Python float of that float32 value: the lr of every
AdamW step.  The cosine is the float32 rounding of the double-precision
cosine; XLA's float32 cosine differs from it in the last place on about one
argument in a hundred."""
from __future__ import annotations

import math
from typing import Callable

import numpy as np

f32 = np.float32


def constant_schedule(lr: float) -> Callable[[int], float]:
    return lambda step: float(f32(lr))


def warmup_cosine(
    peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
) -> Callable[[int], float]:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak_lr`` at ``total_steps``."""

    def fn(step) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(peak_lr) * step / f32(max(warmup_steps, 1)))
        t = (step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1))
        t = min(max(t, f32(0.0)), f32(1.0))
        cos = f32(math.cos(f32(math.pi) * t))
        return float(f32(peak_lr) * (f32(final_frac) + f32((1 - final_frac) * 0.5) * (f32(1.0) + cos)))

    return fn
