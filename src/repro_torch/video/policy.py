"""Temporal offloading policies over video streams.

Two controllers, registered in the ``repro_torch.api`` policy registry (so
``OffloadEngine(policy="temporal_hysteresis")`` / ``"keyframe"`` and every
runtime built on the engine get them for free):

- ``temporal_hysteresis`` — the quantile-threshold rule with three
  stream-level amendments: (1) an EWMA prior over the estimates (consecutive
  frames are correlated, so the smoothed estimate is the better per-frame
  signal), (2) a Schmitt-trigger hysteresis band around the threshold so the
  decision doesn't chatter on estimate noise, and (3) **stale-result
  credit** — when a fresh edge result already covers the stream (probed via
  the runtime-injected ``staleness`` callable), the estimate is discounted
  by ``stale_credit * freshness``, so the budget the redundant frames would
  have burned is re-spent (via the same integral controller as
  ``queue_aware``) on frames no edge result covers.
- ``keyframe`` — offload on scene changes: the runtime-injected
  ``scene_change`` probe (tracker churn + frame-difference overlap, see
  :mod:`repro_torch.video.features`) boosts the estimate at cuts, and a hard
  refractory period keeps consecutive offloads at least ``refractory``
  frames apart, spreading the budget over the stream.

Both consume *runtime-injected context* (zero-arg callables wired by the
video runtime exactly like the netsim congestion probes) and degrade
gracefully without it: no staleness probe means no credit, no scene probe
means no boost — both collapse to (smoothed) threshold behaviour, and both
track the target ratio through the integral deficit controller.  Copied
from the JAX package (``repro.video.policy``): host numpy, registered through
``_ensure_plugins``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.api.policies import (
    ALWAYS_THRESHOLD as _ALWAYS,
    NEVER_THRESHOLD as _NEVER,
    BudgetTracker,
    decide_sequential,
    register_policy,
)
from repro_torch.video.features import EwmaSmoother


@register_policy("temporal_hysteresis")
class TemporalHysteresisPolicy:
    """Smoothed threshold with a hysteresis band and stale-result credit.

    Parameters (beyond the registry's ``calibration_scores, ratio``):

    hysteresis : float
        Half-width of the Schmitt band (in estimate units — the engine's
        CDF puts estimates in [0, 1]): after an offload the bar drops by
        ``hysteresis``, after a local decision it rises by ``hysteresis``,
        so a borderline stream doesn't flip decision every frame.
    stale_credit : float
        Max discount subtracted from the estimate while a fresh edge result
        covers the stream; decays linearly to 0 over ``stale_horizon``.
    stale_horizon : float
        Staleness (frames) at which an edge result stops counting as cover.
    gain : float
        Integral gain of the realized-ratio tracker.
    ewma : float
        EWMA weight on the newest estimate (1.0 disables smoothing).
    staleness : callable or None
        Zero-arg probe of the stream's current staleness — frames since the
        newest covering edge result was *captured* (``inf`` when none).
        Runtime wiring, never serialized (stripped like the token-bucket
        clock).
    """

    context_params = ("staleness",)

    def __init__(
        self,
        calibration_scores: np.ndarray,
        ratio: float,
        hysteresis: float = 0.04,
        stale_credit: float = 0.5,
        stale_horizon: float = 6.0,
        gain: float = 0.05,
        ewma: float = 0.7,
        staleness: Optional[Callable[[], float]] = None,
    ):
        if stale_horizon <= 0.0:
            raise ValueError(f"stale_horizon must be > 0, got {stale_horizon}")
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        self._cal = np.sort(np.asarray(calibration_scores, np.float64))
        self.hysteresis = float(hysteresis)
        self.stale_credit = float(stale_credit)
        self.stale_horizon = float(stale_horizon)
        self.ewma = float(ewma)
        self.staleness = staleness
        self._budget = BudgetTracker(gain)
        self._smoother = EwmaSmoother(alpha=self.ewma)
        self._last_offload = False
        self.set_ratio(ratio)

    def set_ratio(self, ratio: float) -> None:
        self.ratio = float(np.clip(ratio, 0.0, 1.0))

    def _credit(self) -> float:
        if self.staleness is None:
            return 0.0
        s = float(self.staleness())
        if not np.isfinite(s):
            return 0.0
        fresh = max(0.0, 1.0 - max(s, 0.0) / self.stale_horizon)
        return self.stale_credit * fresh

    def decide(self, estimate: float) -> bool:
        e = self._smoother.update(float(estimate)) - self._credit()
        thr = self._budget.threshold(self._cal, self.ratio)
        if thr not in (_NEVER, _ALWAYS):  # degenerate budgets stay hard
            thr += -self.hysteresis if self._last_offload else self.hysteresis
        off = bool(e > thr)
        self._budget.account(off)
        self._last_offload = off
        return off

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        # sequential by construction: the EWMA, the hysteresis state, and
        # the live staleness probe all evolve decision to decision
        return decide_sequential(self, estimates)

    def spec(self) -> Dict[str, Any]:
        return {
            "hysteresis": self.hysteresis,
            "stale_credit": self.stale_credit,
            "stale_horizon": self.stale_horizon,
            "gain": self._budget.gain,
            "ewma": self.ewma,
        }


@register_policy("keyframe")
class KeyframePolicy:
    """Offload on scene changes with a refractory period.

    The scene-change probe boosts the estimate by ``change_boost * score``
    (so cuts clear the threshold even when the per-frame estimate alone
    would not), while decisions within ``refractory`` frames of the last
    offload are forced local — offloads spread along the stream instead of
    clustering on one busy scene.  The integral budget tracker keeps the
    realized ratio on target whenever the refractory ceiling
    ``1 / refractory`` allows it.

    ``scene_change`` is runtime wiring (never serialized): a zero-arg probe
    returning the stream's current scene-change score in [0, 1].
    """

    context_params = ("scene_change",)

    def __init__(
        self,
        calibration_scores: np.ndarray,
        ratio: float,
        refractory: int = 2,
        change_boost: float = 0.6,
        gain: float = 0.05,
        scene_change: Optional[Callable[[], float]] = None,
    ):
        if refractory < 1:
            raise ValueError(f"refractory must be >= 1, got {refractory}")
        self._cal = np.sort(np.asarray(calibration_scores, np.float64))
        self.refractory = int(refractory)
        self.change_boost = float(change_boost)
        self.scene_change = scene_change
        self._budget = BudgetTracker(gain)
        self._since_offload = np.inf
        self.set_ratio(ratio)

    def set_ratio(self, ratio: float) -> None:
        self.ratio = float(np.clip(ratio, 0.0, 1.0))

    def decide(self, estimate: float) -> bool:
        boost = 0.0
        if self.scene_change is not None:
            boost = self.change_boost * float(np.clip(self.scene_change(), 0.0, 1.0))
        thr = self._budget.threshold(self._cal, self.ratio)
        off = bool(float(estimate) + boost > thr)
        # the refractory period is a hard rate cap — except for the
        # degenerate always-offload TARGET, which stays absolute.  Guard on
        # the target ratio, not the threshold sentinel: a saturated deficit
        # controller also yields ALWAYS_THRESHOLD and must NOT break the cap
        if off and self.ratio < 1.0 and self._since_offload < self.refractory:
            off = False
        self._budget.account(off)
        # counting the offload frame itself as 1 elapsed makes consecutive
        # offloads exactly `refractory` frames apart at the cap, so the
        # documented ceiling 1/refractory is exact
        self._since_offload = 1 if off else self._since_offload + 1
        return off

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        # sequential by construction: refractory + deficit state evolve
        return decide_sequential(self, estimates)

    def spec(self) -> Dict[str, Any]:
        return {
            "refractory": self.refractory,
            "change_boost": self.change_boost,
            "gain": self._budget.gain,
        }
