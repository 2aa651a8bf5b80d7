"""Optional stage timing for the serve path: a caller passes a dict, and
each stage adds its host milliseconds to it, measured after waiting for the
device so that queued kernels count in the stage that launched them.  With
no dict nothing waits."""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

StageMs = Optional[Dict[str, float]]


def now(stage_ms: StageMs, device: torch.device) -> float:
    """Host clock, after the device is idle when stages are timed."""
    if stage_ms is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def add(stage_ms: StageMs, name: str, t0: float, device: torch.device) -> float:
    """Add the milliseconds since ``t0`` to ``stage_ms[name]``; returns the
    end time, the next stage's start."""
    t1 = now(stage_ms, device)
    if stage_ms is not None:
        stage_ms[name] = stage_ms.get(name, 0.0) + (t1 - t0) * 1e3
    return t1
