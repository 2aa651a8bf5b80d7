"""Queue-aware offloading policies over the netsim layer.

Two controllers, both registered in the ``repro_torch.api`` policy registry
(so ``OffloadEngine(policy="queue_aware")`` / ``"value_iteration"`` and every
runtime built on the engine get them for free):

- ``queue_aware`` — the engine's quantile-threshold rule with the reward
  estimate *discounted by predicted queueing delay* (a bounded penalty
  ``delay_weight * d / (d + delay_scale)``), plus an integral controller on
  the realized ratio so deferring offloads during congestion is paid back
  in uncongested windows — the realized ratio tracks the target while the
  offloads themselves land where the queue is short.
- ``value_iteration`` — the Qiu et al.-style MDP over
  ``(queue depth × channel state)``: value iteration with the calibration
  score distribution as the per-frame reward prior, yielding a per-state
  threshold table ``theta[q, c]`` — offload iff estimate > theta at the
  observed state.  Each Bellman sweep updates every state at once as
  float32 tensor ops on ``device`` (no per-state Python loop);
  ``value_iteration_sweep`` solves a whole ratio grid at once, the ratio
  being a leading tensor dimension.

Both consume *runtime-injected context* (``congestion`` / ``state_probe``
zero-arg callables, wired by ``OffloadRuntime.open_session`` exactly like
the ``token_bucket`` clock) and degrade gracefully without it: no probe
means no congestion signal, and both collapse to plain threshold behavior.

Ported from the JAX package (``repro.netsim.policy``), where the solve is
one jitted ``lax.scan`` (``vmap`` for the sweep); here it is a Python loop
of the same closed-form sweep over tensors, and ``value_iteration_ref`` is
that package's per-state Python oracle, copied.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.policies import (
    BudgetTracker,
    decide_sequential,
    quantile_threshold,
    register_policy,
)
from repro_torch.kernels.dispatch import DeviceLike, resolve_device


# --------------------------------------------------------------- queue_aware


@register_policy("queue_aware")
class QueueAwarePolicy:
    """Quantile threshold on a congestion-discounted estimate, with an
    integral ratio controller.

    Parameters (beyond the registry's ``calibration_scores, ratio``):

    delay_weight : float
        Max penalty subtracted from the estimate as predicted delay grows
        (estimates are rank-transformed into [0, 1] by the engine's CDF, so
        1.0 means "infinite queue kills any offload").
    delay_scale : float
        Delay (in sim time units) at which half the max penalty applies.
    gain : float
        Integral gain of the shared realized-ratio controller
        (:class:`repro_torch.api.policies.BudgetTracker`): any persistent
        suppression — however long the congestion lasts — is eventually
        paid back and the realized ratio converges to the target exactly.
    congestion : callable or None
        Zero-arg probe returning the predicted uplink sojourn (queue wait +
        transmission) at the best edge, in sim time units.  Runtime wiring,
        never serialized (stripped like the token-bucket clock).
    """

    context_params = ("congestion",)

    def __init__(
        self,
        calibration_scores: np.ndarray,
        ratio: float,
        delay_weight: float = 0.5,
        delay_scale: float = 2.0,
        gain: float = 0.05,
        congestion: Optional[Callable[[], float]] = None,
    ):
        if delay_scale <= 0.0:
            raise ValueError(f"delay_scale must be > 0, got {delay_scale}")
        self._cal = np.sort(np.asarray(calibration_scores, np.float64))
        self.delay_weight = float(delay_weight)
        self.delay_scale = float(delay_scale)
        self.congestion = congestion
        self._budget = BudgetTracker(gain)
        self.set_ratio(ratio)

    @property
    def gain(self) -> float:
        return self._budget.gain

    def set_ratio(self, ratio: float) -> None:
        self.ratio = float(np.clip(ratio, 0.0, 1.0))

    def _penalty(self) -> float:
        d = max(float(self.congestion()), 0.0) if self.congestion is not None else 0.0
        return self.delay_weight * d / (d + self.delay_scale)

    def decide(self, estimate: float) -> bool:
        thr = self._budget.threshold(self._cal, self.ratio)
        off = bool(float(estimate) - self._penalty() > thr)
        self._budget.account(off)
        return off

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        # sequential by construction: the controller state and the live
        # congestion probe evolve decision to decision
        return decide_sequential(self, estimates)

    def spec(self) -> Dict[str, Any]:
        return {
            "delay_weight": self.delay_weight,
            "delay_scale": self.delay_scale,
            "gain": self.gain,
        }


# ----------------------------------------------------------- value iteration


def _estimate_bins(calibration_scores: np.ndarray, n_bins: int) -> np.ndarray:
    """Equiprobable discretization of the calibration score distribution
    (bin centers at the mid-bin quantiles, each with mass 1/n_bins)."""
    cal = np.asarray(calibration_scores, np.float64)
    if cal.size == 0:
        return np.zeros(n_bins)
    qs = (np.arange(n_bins) + 0.5) / n_bins
    return np.quantile(cal, qs)


def _vi_sweep_body(V, e_bins, lam, delay_cost, slow, P, gamma, q_off, q_loc):
    """One Bellman sweep over the whole (Q+1, 2) state space, vectorized;
    ``V`` is ``(..., Q+1, 2)`` and ``lam`` ``(...)``, one price a leading
    index (a scalar for one solve).

    With ``relu(x) = max(x, 0)`` the backup has the closed form
    ``V(q,c) = E_e[relu(e - theta(q,c))] + gamma * EV_local(q,c)`` where
    ``theta`` is the indifference threshold — exactly the per-state decision
    rule the policy serves with.
    """
    EV = V @ P.T                                   # (..., Q+1, 2): E_{c'}[V | c]
    EV_off = EV[..., q_off, :]                     # next-state values, offload
    EV_loc = EV[..., q_loc, :]                     # next-state values, local
    q_idx = torch.arange(V.shape[-2], dtype=V.dtype, device=V.device)
    theta = (
        lam[..., None, None]
        + delay_cost * (q_idx + 1.0)[:, None] * slow[None, :]
        + gamma * (EV_loc - EV_off)
    )
    gain = torch.mean(
        torch.clamp_min(e_bins.reshape((-1,) + (1,) * theta.dim()) - theta, 0.0), dim=0
    )
    return gain + gamma * EV_loc, theta


def _solve(e_bins, lams, *, max_queue, delay_cost, bad_slowdown, p_gb, p_bg, gamma,
           n_sweeps, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_sweeps`` sweeps from ``V = 0`` for every price in ``lams`` (any
    leading shape), then the thresholds of the final table; float32 on
    ``device``, every operand built there once."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    Q = int(max_queue)
    q_idx = np.arange(Q + 1)
    args = (
        torch.tensor(np.asarray(e_bins), **f32),
        torch.tensor(np.asarray(lams), **f32),
        torch.tensor(float(delay_cost), **f32),
        torch.tensor([1.0, float(bad_slowdown)], **f32),
        torch.tensor([[1.0 - p_gb, p_gb], [p_bg, 1.0 - p_bg]], **f32),
        torch.tensor(float(gamma), **f32),
        torch.tensor(np.minimum(q_idx + 1, Q), dtype=torch.long, device=dev),
        torch.tensor(np.maximum(q_idx - 1, 0), dtype=torch.long, device=dev),
    )
    V = torch.zeros(tuple(args[1].shape) + (Q + 1, 2), **f32)
    for _ in range(int(n_sweeps)):
        V, _ = _vi_sweep_body(V, *args)
    _, theta = _vi_sweep_body(V, *args)
    return V, theta


def solve_value_iteration(
    e_bins: np.ndarray,
    lam: float,
    *,
    max_queue: int = 16,
    delay_cost: float = 0.05,
    bad_slowdown: float = 4.0,
    p_gb: float = 0.1,
    p_bg: float = 0.3,
    gamma: float = 0.9,
    n_sweeps: int = 64,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Value-iterate the (queue depth × channel) offloading MDP on ``device``.

    Returns ``(V, theta)`` with shapes ``(max_queue+1, 2)``: the value table
    and the per-state offload thresholds.  Every sweep updates all states as
    float32 tensor ops — there is no per-state Python loop — and the host
    waits for the device once, for the result.
    """
    V, theta = _solve(
        e_bins, np.float32(lam), max_queue=max_queue, delay_cost=delay_cost,
        bad_slowdown=bad_slowdown, p_gb=p_gb, p_bg=p_bg, gamma=gamma,
        n_sweeps=n_sweeps, device=device,
    )
    return V.cpu().numpy().astype(np.float64), theta.cpu().numpy().astype(np.float64)


def value_iteration_sweep(
    calibration_scores: np.ndarray,
    ratios: Sequence[float],
    *,
    n_bins: int = 32,
    max_queue: int = 16,
    delay_cost: float = 0.05,
    bad_slowdown: float = 4.0,
    p_gb: float = 0.1,
    p_bg: float = 0.3,
    gamma: float = 0.9,
    n_sweeps: int = 64,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Per-state thresholds for a whole ratio grid in one solve: the
    ratio-derived offload prices are the leading dimension of every sweep.
    Returns ``theta`` of shape ``(len(ratios), max_queue+1, 2)``."""
    e_bins = _estimate_bins(calibration_scores, n_bins)
    lams = np.asarray(
        [quantile_threshold(calibration_scores, r) for r in ratios], np.float32
    )
    _, theta = _solve(
        e_bins, lams, max_queue=max_queue, delay_cost=delay_cost,
        bad_slowdown=bad_slowdown, p_gb=p_gb, p_bg=p_bg, gamma=gamma,
        n_sweeps=n_sweeps, device=device,
    )
    return theta.cpu().numpy().astype(np.float64)


def value_iteration_ref(
    e_bins: np.ndarray,
    lam: float,
    *,
    max_queue: int = 16,
    delay_cost: float = 0.05,
    bad_slowdown: float = 4.0,
    p_gb: float = 0.1,
    p_bg: float = 0.3,
    gamma: float = 0.9,
    n_sweeps: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-Python per-state reference solver (the benchmark baseline and
    the correctness oracle for the tensor solve)."""
    e = np.asarray(e_bins, np.float64)
    Q = int(max_queue)
    slow = [1.0, float(bad_slowdown)]
    P = [[1.0 - p_gb, p_gb], [p_bg, 1.0 - p_bg]]
    V = np.zeros((Q + 1, 2))

    def backup(V):
        theta = np.zeros_like(V)
        V_new = np.zeros_like(V)
        for q in range(Q + 1):
            for c in range(2):
                ev_off = sum(P[c][c2] * V[min(q + 1, Q), c2] for c2 in range(2))
                ev_loc = sum(P[c][c2] * V[max(q - 1, 0), c2] for c2 in range(2))
                th = lam + delay_cost * (q + 1) * slow[c] + gamma * (ev_loc - ev_off)
                theta[q, c] = th
                V_new[q, c] = float(np.mean(np.maximum(e - th, 0.0))) + gamma * ev_loc
        return V_new, theta

    theta = np.zeros_like(V)
    for _ in range(n_sweeps):
        V, _ = backup(V)
    _, theta = backup(V)
    return V, theta


@register_policy("value_iteration")
class ValueIterationPolicy:
    """Serve-time MDP controller: offload iff estimate > ``theta[q, c]``.

    The threshold table comes from :func:`solve_value_iteration` (solved on
    ``device`` at construction / ``set_ratio``); ``state_probe`` is the
    runtime-injected zero-arg callable returning the observed
    ``(queue_depth, channel_state)`` at decision time.  Without a probe the
    policy serves from the ``(0, good)`` state — plain threshold behavior.
    ``device`` is runtime wiring too: engines and sessions pass their own,
    and it is never serialized.
    """

    context_params = ("state_probe", "device")

    def __init__(
        self,
        calibration_scores: np.ndarray,
        ratio: float,
        max_queue: int = 16,
        delay_cost: float = 0.05,
        bad_slowdown: float = 4.0,
        p_gb: float = 0.1,
        p_bg: float = 0.3,
        gamma: float = 0.9,
        n_sweeps: int = 64,
        n_bins: int = 32,
        state_probe: Optional[Callable[[], Tuple[int, int]]] = None,
        device: DeviceLike = "cuda",
    ):
        self._cal = np.asarray(calibration_scores, np.float64)
        self.max_queue = int(max_queue)
        self.delay_cost = float(delay_cost)
        self.bad_slowdown = float(bad_slowdown)
        self.p_gb = float(p_gb)
        self.p_bg = float(p_bg)
        self.gamma = float(gamma)
        self.n_sweeps = int(n_sweeps)
        self.n_bins = int(n_bins)
        self.state_probe = state_probe
        self.device = resolve_device(device)
        self._e_bins = _estimate_bins(self._cal, self.n_bins)
        self.set_ratio(ratio)

    def set_ratio(self, ratio: float) -> None:
        self.ratio = float(np.clip(ratio, 0.0, 1.0))
        lam = quantile_threshold(self._cal, self.ratio)
        _, self.theta = solve_value_iteration(
            self._e_bins,
            lam,
            max_queue=self.max_queue,
            delay_cost=self.delay_cost,
            bad_slowdown=self.bad_slowdown,
            p_gb=self.p_gb,
            p_bg=self.p_bg,
            gamma=self.gamma,
            n_sweeps=self.n_sweeps,
            device=self.device,
        )

    def _state(self) -> Tuple[int, int]:
        if self.state_probe is None:
            return 0, 0
        q, c = self.state_probe()
        return min(max(int(q), 0), self.max_queue), int(np.clip(int(c), 0, 1))

    def decide(self, estimate: float) -> bool:
        q, c = self._state()
        return bool(float(estimate) > self.theta[q, c])

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        # the probed state evolves as upstream dispatch fills queues, so
        # batches decide sequentially like the other stateful policies
        return decide_sequential(self, estimates)

    def spec(self) -> Dict[str, Any]:
        return {
            "max_queue": self.max_queue,
            "delay_cost": self.delay_cost,
            "bad_slowdown": self.bad_slowdown,
            "p_gb": self.p_gb,
            "p_bg": self.p_bg,
            "gamma": self.gamma,
            "n_sweeps": self.n_sweeps,
            "n_bins": self.n_bins,
        }
