"""Seeded 2-D client mobility traces.

Two standard models, both drawing every random number up front from one
``numpy`` generator so a trace is a pure function of ``(config, n_clients,
n_steps, seed)``:

- ``random_walk`` — heading follows a seeded Gaussian turn process; the
  client advances ``speed * dt`` per step and is clamped to the area.
- ``waypoint`` — the classic random-waypoint model: the client heads for a
  seeded target at constant speed, switching to the next target the step
  it would arrive.

The rollout runs the T-1 motion steps as a loop of float32 tensor ops on a
device (:func:`rollout`; ``repro`` runs them as one jitted ``lax.scan``),
with a pure-Python/numpy reference oracle (:func:`rollout_ref`) that
consumes the *same* pre-drawn arrays, mirroring the ``track_clip`` /
``track_clip_ref`` pairing in :mod:`repro_torch.video.track`.  Because all
randomness is materialized before either path runs, the two agree to
float32 rounding (tested), and two calls with equal seeds are bit-identical
— the property the handover acceptance test pins.

Positions are float32 ``(T, n_clients, 2)``; entry ``[t]`` is where each
client is while frame ``t`` is captured (the initial placement is row 0;
motion happens between frames).

The port of ``repro.mobility.motion``: ``MotionConfig``, ``_draws`` and
``rollout_ref`` copied (numpy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import DeviceLike, resolve_device

MODELS = ("waypoint", "random_walk")


@dataclass(frozen=True)
class MotionConfig:
    """Geometry + kinematics of a client population.

    Parameters
    ----------
    model : str
        ``"waypoint"`` or ``"random_walk"``.
    area : (float, float)
        Width/height of the rectangular world (same distance units as
        base-station placements in :mod:`repro.mobility.coverage`).
    speed : float
        Distance covered per time unit (every client moves every step).
    dt : float
        Simulation step length in time units (one frame period).
    turn_sigma : float
        Random-walk only: stddev of the per-step heading change (radians).
    """

    model: str = "waypoint"
    area: Tuple[float, float] = (1000.0, 1000.0)
    speed: float = 12.0
    dt: float = 1.0
    turn_sigma: float = 0.35

    def __post_init__(self) -> None:
        if self.model not in MODELS:
            raise KeyError(f"unknown motion model {self.model!r}; have {MODELS}")
        if self.speed < 0 or self.dt <= 0:
            raise ValueError(f"need speed >= 0 and dt > 0, got {self.speed}, {self.dt}")
        if self.area[0] <= 0 or self.area[1] <= 0:
            raise ValueError(f"area must be positive, got {self.area}")

    def spec(self) -> Dict[str, float]:
        return {
            "model": self.model,
            "area": list(self.area),
            "speed": self.speed,
            "dt": self.dt,
            "turn_sigma": self.turn_sigma,
        }


def _draws(
    config: MotionConfig, n_clients: int, n_steps: int, seed: int
) -> Dict[str, np.ndarray]:
    """Materialize every random number the rollout will consume — shared
    verbatim by the device loop and the reference, so the only difference between
    the two paths is the arithmetic backend."""
    if n_clients < 1 or n_steps < 1:
        raise ValueError(f"need n_clients, n_steps >= 1, got {n_clients}, {n_steps}")
    rng = np.random.default_rng(seed)
    w, h = config.area
    scale = np.array([w, h], np.float32)
    out = {"pos0": (rng.random((n_clients, 2)).astype(np.float32)) * scale}
    if config.model == "random_walk":
        out["heading0"] = (rng.random(n_clients) * (2 * np.pi)).astype(np.float32)
        out["turns"] = rng.normal(
            0.0, config.turn_sigma, (n_steps - 1, n_clients)
        ).astype(np.float32)
    else:
        # one fresh target per (step, client) is a strict upper bound on
        # consumption: a client reaches at most one waypoint per step
        out["targets"] = (
            rng.random((n_steps, n_clients, 2)).astype(np.float32) * scale
        )
    return out


def rollout(
    config: MotionConfig,
    n_clients: int,
    n_steps: int,
    seed: int = 0,
    *,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Seeded positions ``(n_steps, n_clients, 2)`` (host float32): the T-1
    motion steps of ``_draws``' arrays as float32 tensor ops on ``device``,
    one host copy at the end.  The arithmetic is ``rollout_ref``'s, op for
    op (the waypoint model's ``reach = dist <= step_len`` included: one
    rounding there sends a client on to its next target, so traces are
    compared whole)."""
    dev = resolve_device(device)
    draws = {k: torch.from_numpy(v).to(dev) for k, v in
             _draws(config, n_clients, n_steps, seed).items()}
    step_len = torch.tensor(np.float32(config.speed * config.dt), device=dev)
    lim = torch.tensor(np.asarray(config.area, np.float32), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pos = draws["pos0"]
    path = torch.empty((n_steps, n_clients, 2), dtype=torch.float32, device=dev)
    path[0] = pos
    if config.model == "random_walk":
        heading, turns = draws["heading0"], draws["turns"]
        for t in range(n_steps - 1):
            heading = heading + turns[t]
            delta = step_len * torch.stack([torch.cos(heading), torch.sin(heading)], dim=-1)
            pos = torch.minimum(torch.maximum(pos + delta, zero), lim)
            path[t + 1] = pos
    else:
        targets = draws["targets"]
        t_max = targets.shape[0] - 1
        idx = torch.zeros(n_clients, dtype=torch.int64, device=dev)
        clients = torch.arange(n_clients, device=dev)
        tiny = torch.tensor(np.float32(1e-12), device=dev)
        for t in range(n_steps - 1):
            tgt = targets[idx, clients]
            d = tgt - pos
            # the correctly rounded float32 square root (numpy's, and the
            # card's sqrtf): the CPU's vectorized float32 sqrt is not always
            dist = torch.sqrt(torch.sum(d * d, dim=-1).to(torch.float64)).to(torch.float32)
            reach = dist <= step_len
            safe = torch.maximum(dist, tiny)
            stepped = pos + d * (step_len / safe)[:, None]
            pos = torch.where(reach[:, None], tgt, stepped)
            idx = torch.clamp(idx + reach.to(torch.int64), max=t_max)
            path[t + 1] = pos
    return path.cpu().numpy()


def rollout_ref(
    config: MotionConfig, n_clients: int, n_steps: int, seed: int = 0
) -> np.ndarray:
    """Pure-Python/numpy oracle over the same pre-drawn arrays — the
    reviewable spec the scan is tested against."""
    draws = _draws(config, n_clients, n_steps, seed)
    step_len = np.float32(config.speed * config.dt)
    lim = np.asarray(config.area, np.float32)
    pos = draws["pos0"].copy()
    path = [pos.copy()]
    if config.model == "random_walk":
        heading = draws["heading0"].copy()
        for t in range(n_steps - 1):
            heading = heading + draws["turns"][t]
            delta = step_len * np.stack(
                [np.cos(heading), np.sin(heading)], axis=-1
            ).astype(np.float32)
            pos = np.clip(pos + delta, 0.0, lim).astype(np.float32)
            path.append(pos.copy())
    else:
        targets = draws["targets"]
        t_max = targets.shape[0] - 1
        idx = np.zeros(n_clients, np.int32)
        for t in range(n_steps - 1):
            tgt = targets[idx, np.arange(n_clients)]
            d = tgt - pos
            dist = np.sqrt(np.sum(d * d, axis=-1), dtype=np.float32)
            reach = dist <= step_len
            safe = np.maximum(dist, np.float32(1e-12))
            stepped = (pos + d * (step_len / safe)[:, None]).astype(np.float32)
            pos = np.where(reach[:, None], tgt, stepped)
            idx = np.minimum(idx + reach.astype(np.int32), t_max)
            path.append(pos.copy())
    return np.stack(path, axis=0)
