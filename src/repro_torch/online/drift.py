"""Estimator-confidence drift detection on realized-vs-predicted residuals.

Each observed offload yields a residual ``r = realized − predicted`` in the
engine's rank space ([0, 1] after the CDF transform).  The residual stream
over the *offloaded subset* is NOT zero-mean even for a perfectly
calibrated estimator — offloaded frames are the predicted-high tail, so
selection bias (regression to the mean) gives a steady negative offset.
What a distribution shift changes is the residual *level*.
:class:`DriftDetector` is therefore self-starting:

- an **EWMA** baseline of the residual and its deviation variance (the
  running level and scale — steady selection bias lives here), and
- a standardized **two-sided CUSUM** over deviations *from that baseline*:
  ``z = (r − mean) / sigma``, ``S⁺ = max(0, S⁺ + z − k)``,
  ``S⁻ = max(0, S⁻ − z − k)`` — the classic change-point statistic that
  accumulates evidence of a level *change* while shrugging off isolated
  outliers and absorbing any constant offset into the baseline.

``drifted`` fires when either side exceeds the threshold ``h`` (after a
minimum observation count), which the :class:`AdaptiveEngine` answers with a
forced refit; ``ratio_multiplier()`` maps accumulated drift evidence to a
widened offload ratio in [1, ``widen``] — when confidence decays, buy more
strong supervision, which is exactly what re-fits the model fastest.

Pure scalar state, no RNG; serializes via ``state()/from_state`` for
bit-identical replay from checkpoints.

Copied from the JAX package (``repro.online.drift``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class DriftConfig:
    alpha: float = 0.05  # EWMA weight on the newest residual (baseline speed)
    k: float = 0.5  # CUSUM allowance (in residual-sigma units)
    h: float = 8.0  # CUSUM decision threshold (sigma units)
    min_obs: int = 16  # observations before drift can fire
    widen: float = 1.25  # max offload-ratio multiplier at full drift evidence
    sigma_floor: float = 0.02  # residual-scale floor (rank space)


class DriftDetector:
    """Self-starting residual CUSUM: EWMA baseline + two-sided standardized
    CUSUM over deviations from it."""

    def __init__(self, config: DriftConfig = DriftConfig()):
        if not 0.0 < config.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {config.alpha}")
        if config.widen < 1.0:
            raise ValueError(f"widen must be >= 1, got {config.widen}")
        self.config = config
        self.mean = 0.0  # EWMA baseline of residuals
        self.var = 0.0  # EWMA of squared deviations from the baseline
        self.cusum_pos = 0.0
        self.cusum_neg = 0.0
        self.n = 0
        self.events = 0  # drift detections over the detector's lifetime
        # CUSUM accumulation pauses until the baseline has settled — after
        # construction AND after every reset() (a refit changes the model,
        # so the residual level legitimately moves and must re-baseline
        # without counting as fresh drift)
        self.settle_until = self.config.min_obs
        self._reseed = False  # next sample re-anchors the baseline

    def update(self, predicted: float, realized: float) -> float:
        """Fold one (predicted, realized) pair; returns the residual."""
        r = float(realized) - float(predicted)
        a = self.config.alpha
        if self.n == 0 or self._reseed:
            # anchor the baseline at the current residual level — at start,
            # and after a handled drift (the refit legitimately moved the
            # level; chasing it with the slow EWMA would re-trigger).  The
            # scale estimate is kept: refits move the level, not the noise.
            self.mean = r
            self._reseed = False
        else:
            # score against the baseline BEFORE it absorbs this sample —
            # a level change accumulates in the CUSUM while the baseline
            # slowly catches up
            if self.n >= self.settle_until:
                z = (r - self.mean) / self.sigma
                k = self.config.k
                self.cusum_pos = max(0.0, self.cusum_pos + z - k)
                self.cusum_neg = max(0.0, self.cusum_neg - z - k)
            dev = r - self.mean
            self.mean += a * dev
            self.var = (1.0 - a) * self.var + a * dev * dev
        self.n += 1
        return r

    @property
    def sigma(self) -> float:
        """Residual scale estimate (EWMA deviation std, floored)."""
        return max(float(np.sqrt(max(self.var, 0.0))), self.config.sigma_floor)

    @property
    def statistic(self) -> float:
        """The larger of the two CUSUM sides — accumulated drift evidence."""
        return max(self.cusum_pos, self.cusum_neg)

    @property
    def drifted(self) -> bool:
        return self.n >= self.config.min_obs and self.statistic > self.config.h

    def confidence(self) -> float:
        """Estimator confidence in (0, 1]: 1 with no drift evidence,
        → 0 as the CUSUM statistic blows past the threshold."""
        return 1.0 / (1.0 + self.statistic / self.config.h)

    def ratio_multiplier(self) -> float:
        """Offload-ratio widening in [1, widen].  Gated: widening starts
        only once the CUSUM statistic passes half the decision threshold —
        the sub-h/2 band is where the statistic wanders under steady-state
        noise (residuals are autocorrelated across concurrent streams), and
        widening there would chronically inflate the realized offload
        ratio.  Above the gate it ramps linearly to ``widen`` at ``h``."""
        half = 0.5 * self.config.h
        frac = min(max(self.statistic - half, 0.0) / half, 1.0)
        return 1.0 + (self.config.widen - 1.0) * frac

    def rebaseline(self) -> None:
        """Re-anchor after a *planned* incremental model update: the
        prediction level legitimately moved, so the baseline mean re-seeds
        at the next sample instead of slowly chasing it (which would read
        the loop's own updates as drift).  The CUSUM sides are kept: they
        decay on their own (−k per in-control sample), so surviving
        evidence means mispredictions persist *despite* the incremental
        path keeping up — exactly the condition for a drift-forced full
        refit."""
        self._reseed = True

    def reset(self, count_event: bool = True) -> None:
        """Re-arm after a full refit landed: clear the CUSUM evidence and
        pause accumulation while the baseline re-settles on the refreshed
        model's residual level.  ``count_event=False`` for periodic
        (schedule-driven) refits that were not drift-forced."""
        self.cusum_pos = 0.0
        self.cusum_neg = 0.0
        self.settle_until = self.n + self.config.min_obs
        self._reseed = True
        if count_event:
            self.events += 1

    def state(self) -> Dict[str, np.ndarray]:
        return {
            "mean": np.asarray(self.mean, np.float64),
            "var": np.asarray(self.var, np.float64),
            "cusum_pos": np.asarray(self.cusum_pos, np.float64),
            "cusum_neg": np.asarray(self.cusum_neg, np.float64),
            "n": np.asarray(self.n, np.int64),
            "events": np.asarray(self.events, np.int64),
            "settle_until": np.asarray(self.settle_until, np.int64),
            "reseed": np.asarray(int(self._reseed), np.int64),
        }

    @classmethod
    def from_state(
        cls, state: Dict[str, np.ndarray], config: DriftConfig = DriftConfig()
    ) -> "DriftDetector":
        det = cls(config)
        det.mean = float(np.asarray(state["mean"]))
        det.var = float(np.asarray(state["var"]))
        det.cusum_pos = float(np.asarray(state["cusum_pos"]))
        det.cusum_neg = float(np.asarray(state["cusum_neg"]))
        det.n = int(np.asarray(state["n"]))
        det.events = int(np.asarray(state["events"]))
        if "settle_until" in state:
            det.settle_until = int(np.asarray(state["settle_until"]))
        if "reseed" in state:
            det._reseed = bool(int(np.asarray(state["reseed"])))
        return det
