"""Offloading decision policies (paper §III, §V).

The paper's deployable policy is a fixed threshold T on the reward estimate,
with T = the (1-r)-quantile of calibration-set estimates for a target
offloading ratio r — adjustable at runtime (the key advantage over the
train-time-fixed baselines).  A token-bucket variant ([23]-style) enforces a
hard rate constraint with burst tolerance for the dynamic-budget setting.

Copied from the JAX package (``repro.core.policy``); plain numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


class ThresholdPolicy:
    """Offload iff estimate > T; T derived from a calibration distribution."""

    def __init__(self, calibration_scores: np.ndarray, ratio: float) -> None:
        self._cal = np.sort(np.asarray(calibration_scores, dtype=np.float64))
        self.set_ratio(ratio)

    def set_ratio(self, ratio: float) -> None:
        """Runtime-adjustable offloading ratio (paper Table I row 3)."""
        self.ratio = float(np.clip(ratio, 0.0, 1.0))
        if self.ratio >= 1.0:
            self.threshold = -np.inf
        elif self.ratio <= 0.0:
            self.threshold = np.inf
        else:
            self.threshold = float(np.quantile(self._cal, 1.0 - self.ratio))

    def decide(self, estimate: float) -> bool:
        return bool(estimate > self.threshold)

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        return np.asarray(estimates) > self.threshold


@dataclass
class TokenBucket:
    """Token-bucket rate limiter for offloading under hard budget (cf. [23]).

    ``rate`` tokens arrive per image; bucket depth ``depth``; an offload
    consumes one token.  The effective threshold rises as the bucket drains,
    making the policy spend scarce tokens only on the highest estimates.

    With ``clock`` (any zero-arg callable returning a monotone float, e.g. a
    simulation's manual clock), refill becomes ``rate`` tokens per *time
    unit* instead of per arrival.  ``decide`` never reads the wall clock
    itself, so streaming simulations and tests stay reproducible.
    """

    rate: float
    depth: float
    base_threshold: float
    level: Optional[float] = None  # None -> starts full (= depth)
    clock: Optional[Callable[[], float]] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        if self.level is None:
            self.level = self.depth
        self._last_t = self.clock() if self.clock is not None else 0.0

    def _refill(self) -> None:
        if self.clock is None:
            self.level = min(self.level + self.rate, self.depth)
            return
        now = self.clock()
        dt = max(now - self._last_t, 0.0)
        self._last_t = now
        self.level = min(self.level + self.rate * dt, self.depth)

    def try_take(self) -> bool:
        """Plain rate-limiter admission: consume a token if one is available.
        Unlike ``decide`` there is no scarcity threshold — this is the
        estimate-independent form edge servers use to cap admissions."""
        self._refill()
        if self.level >= 1.0:
            self.level -= 1.0
            return True
        return False

    def decide(self, estimate: float) -> bool:
        self._refill()
        if self.level < 1.0:
            return False
        # scarcity-adjusted threshold: full bucket -> base threshold,
        # nearly-empty bucket -> demand estimates near the top of [0, 1]
        scarcity = 1.0 - (self.level - 1.0) / max(self.depth - 1.0, 1e-9)
        thr = self.base_threshold + (1.0 - self.base_threshold) * scarcity
        if estimate > thr:
            self.level -= 1.0
            return True
        return False
