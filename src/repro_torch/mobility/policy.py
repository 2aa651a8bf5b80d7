"""``mobility_aware`` — the offload policy for clients in motion.

The quantile-budget rule with one mobility amendment: the reward estimate
is discounted by the client's predicted **time to coverage loss** (probed
via the runtime-injected ``coverage_ttl`` callable, wired by
:class:`repro_torch.mobility.runtime.MobileRuntime` from the motion trace and
coverage map).  An offloaded frame only pays off if its result makes it
back before the client falls out of coverage; with the round trip taking
about ``rtt_horizon`` time units, a frame with ``ttl < rtt_horizon`` keeps
only ``ttl / rtt_horizon`` of its estimated reward.  Frames the discount
suppresses refund their budget through the same integral
:class:`~repro_torch.api.policies.BudgetTracker` as the other stream policies,
so the realized ratio converges to the target — spent where the result
will actually be received.

Registered on import (see ``repro_torch.api.policies._ensure_plugins``); without
a probe it collapses to plain quantile-threshold behaviour.

Copied from the JAX package (``repro.mobility.policy``): host numpy.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.api.policies import (
    BudgetTracker,
    decide_sequential,
    register_policy,
)


@register_policy("mobility_aware")
class MobilityAwarePolicy:
    """Quantile budget with coverage-lookahead reward discounting.

    Parameters (beyond the registry's ``calibration_scores, ratio``):

    rtt_horizon : float
        Time units an offload's result roughly takes to come back
        (uplink + service + downlink); the discount ramp's width.
    gain : float
        Integral gain of the budget tracker.
    coverage_ttl : callable or None
        Runtime-injected zero-arg probe of the predicted time to coverage
        loss (``inf`` when not leaving coverage).  Never serialized.
    """

    context_params = ("coverage_ttl",)

    def __init__(
        self,
        calibration_scores: np.ndarray,
        ratio: float,
        rtt_horizon: float = 6.0,
        gain: float = 0.05,
        coverage_ttl: Optional[Callable[[], float]] = None,
    ):
        if rtt_horizon <= 0:
            raise ValueError(f"rtt_horizon must be > 0, got {rtt_horizon}")
        self._cal = np.sort(np.asarray(calibration_scores, dtype=np.float64))
        self.rtt_horizon = float(rtt_horizon)
        self.coverage_ttl = coverage_ttl
        self._budget = BudgetTracker(gain)
        self.set_ratio(ratio)

    def set_ratio(self, ratio: float) -> None:
        self.ratio = float(np.clip(ratio, 0.0, 1.0))

    def _discount(self) -> float:
        if self.coverage_ttl is None:
            return 1.0
        ttl = float(self.coverage_ttl())
        if not np.isfinite(ttl):
            return 1.0
        return float(np.clip(max(ttl, 0.0) / self.rtt_horizon, 0.0, 1.0))

    def decide(self, estimate: float) -> bool:
        e = float(estimate) * self._discount()
        off = bool(e > self._budget.threshold(self._cal, self.ratio))
        self._budget.account(off)
        return off

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        # sequential: the live coverage probe and the integral budget both
        # evolve decision to decision
        return decide_sequential(self, estimates)

    def spec(self) -> Dict[str, Any]:
        return {"rtt_horizon": self.rtt_horizon, "gain": self._budget.gain}
