"""Online decision policy: self-calibrating quantile threshold.

``adaptive_threshold`` is the streaming counterpart of the paper's
deployable quantile threshold: instead of freezing the calibration score
distribution at fit time, it tracks the estimates it actually decides on
with a :class:`~repro_torch.online.cdf.StreamingQuantiles` grid (warm-started
from the fitted calibration scores) and rederives the ``(1-ratio)``
threshold from the *live* distribution every decision.  The shared
:class:`~repro_torch.api.policies.BudgetTracker` integral controller closes the
realized-ratio loop on top, so the target budget holds both through the
tracker's warmup and through genuine distribution shifts.

Registered through the same lazy ``_ensure_plugins`` pattern as the netsim
and video policies, so ``OffloadEngine(policy="adaptive_threshold")`` works
without importing ``repro_torch.online`` anywhere.

Copied from the JAX package (``repro.online.policy``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.api.policies import (
    BudgetTracker,
    decide_sequential,
    register_policy,
)
from repro_torch.online.cdf import StreamingQuantiles


@register_policy("adaptive_threshold")
class AdaptiveThresholdPolicy:
    """Quantile threshold against the live estimate distribution.

    Parameters (beyond the registry's ``calibration_scores, ratio``):

    n_markers : int
        Resolution of the streaming quantile grid.
    gain : float
        Integral gain of the realized-ratio tracker.
    """

    def __init__(
        self,
        calibration_scores: np.ndarray,
        ratio: float,
        n_markers: int = 33,
        gain: float = 0.05,
    ):
        cal = np.sort(np.asarray(calibration_scores, np.float64))
        self._tracker = StreamingQuantiles(int(n_markers)).warm_start(cal)
        self._fallback_cal = cal  # until the tracker markers initialize
        self._budget = BudgetTracker(gain)
        self.n_markers = int(n_markers)
        self.set_ratio(ratio)

    def set_ratio(self, ratio: float) -> None:
        self.ratio = float(np.clip(ratio, 0.0, 1.0))

    def _calibration(self) -> np.ndarray:
        if self._tracker.initialized:
            return self._tracker.calibration_scores()
        return self._fallback_cal

    def decide(self, estimate: float) -> bool:
        e = float(estimate)
        self._tracker.update(e)
        off = bool(e > self._budget.threshold(self._calibration(), self.ratio))
        self._budget.account(off)
        return off

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        # sequential by construction: the tracker and the deficit controller
        # both evolve decision to decision
        return decide_sequential(self, estimates)

    def spec(self) -> Dict[str, Any]:
        return {"n_markers": self.n_markers, "gain": self._budget.gain}
