"""Streaming CDF / rank-transform updates (P²-style quantile tracking).

The engine's decision thresholds are quantiles of two fitted distributions:
the calibration *score* distribution (``set_ratio`` / ``quantile_threshold``)
and the calibration *reward* distribution (the MORIC ``CdfTransform``).  Both
are frozen at fit time, so when deployment distributions move, the realized
offload ratio drifts off target and the rank targets decalibrate.

:class:`StreamingQuantiles` tracks a whole quantile grid of a scalar stream
in O(markers) memory and O(markers) time per observation — the multi-marker
extension of the Jain & Chlamtac P² algorithm (piecewise-parabolic marker
updates, no sample storage).  It warm-starts from the engine's fitted
calibration sample and round-trips through the existing
``CdfTransform.state()/from_state`` surface:

    tracker = StreamingQuantiles.from_transform(engine.transform)
    tracker.update(realized_reward)            # per observed frame
    engine.transform = tracker.to_transform()  # periodic refresh

``calibration_scores()`` exposes the live marker heights as a sorted array —
a drop-in replacement for ``engine.calibration_scores`` wherever quantile
thresholds are derived (``make_policy``, ``quantile_threshold``,
``BudgetTracker``), which is how ``set_ratio`` stays calibrated as the score
distribution moves.

Everything is deterministic (no RNG) and the full tracker state serializes
as plain arrays (``state()``/``from_state``) so adaptive engines replay
bit-identically from a checkpoint.

Copied from the JAX package (``repro.online.cdf``): host numpy over the
port's ``CdfTransform``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.reward import CdfTransform


class StreamingQuantiles:
    """P²-style tracker of ``n_markers`` evenly spaced quantiles.

    Markers sit at probs ``linspace(0, 1, n_markers)`` (endpoints track the
    running min/max).  Until ``n_markers`` observations (or a warm start)
    arrive, samples are buffered exactly; the first sufficient batch
    initializes the markers and the tracker goes streaming.
    """

    def __init__(self, n_markers: int = 65):
        if n_markers < 5:
            raise ValueError(f"need >= 5 markers, got {n_markers}")
        self.n_markers = int(n_markers)
        self.probs = np.linspace(0.0, 1.0, self.n_markers)
        self.heights: Optional[np.ndarray] = None  # marker values, sorted
        self.positions: Optional[np.ndarray] = None  # 1-based marker ranks
        self.count = 0
        self._seed_buffer: list = []

    # ---------------------------------------------------------- construction

    def warm_start(self, samples: np.ndarray) -> "StreamingQuantiles":
        """Initialize the markers from a sample (the fitted calibration set).
        Requires at least ``n_markers`` values; fewer land in the seed buffer
        and streaming starts once enough have arrived."""
        s = np.sort(np.asarray(samples, np.float64).ravel())
        s = s[np.isfinite(s)]
        if s.size < self.n_markers:
            self._seed_buffer.extend(float(v) for v in s)
            self._maybe_seed()
            return self
        self.heights = np.quantile(s, self.probs)
        self.count = int(s.size)
        # desired 1-based ranks, forced strictly increasing from 1 to count
        pos = np.rint(1.0 + self.probs * (self.count - 1)).astype(np.int64)
        pos = np.maximum.accumulate(np.maximum(pos, np.arange(self.n_markers) + 1))
        pos = np.minimum(pos, self.count - self.n_markers + 1 + np.arange(self.n_markers))
        self.positions = pos.astype(np.float64)
        self._seed_buffer = []
        return self

    @classmethod
    def from_transform(
        cls, transform: CdfTransform, n_markers: int = 65
    ) -> "StreamingQuantiles":
        """Warm-start from a fitted ``CdfTransform`` via its public
        ``state()`` surface."""
        t = cls(n_markers)
        t.warm_start(np.asarray(transform.state()["sorted_rewards"]))
        return t

    def _maybe_seed(self) -> None:
        if self.heights is None and len(self._seed_buffer) >= self.n_markers:
            buf = self._seed_buffer
            self._seed_buffer = []
            self.warm_start(np.asarray(buf))

    # -------------------------------------------------------------- updates

    def update(self, x: float) -> None:
        """Fold one observation into the marker grid (P² marker moves)."""
        x = float(x)
        if not np.isfinite(x):
            return
        if self.heights is None:
            self._seed_buffer.append(x)
            self._maybe_seed()
            return
        h, n = self.heights, self.positions
        m = self.n_markers
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[m - 1]:
            h[m - 1] = x
            k = m - 2
        else:
            k = int(np.searchsorted(h, x, side="right")) - 1
            k = min(max(k, 0), m - 2)
        n[k + 1 :] += 1.0
        self.count += 1
        desired = 1.0 + self.probs * (self.count - 1)
        for i in range(1, m - 1):
            d = desired[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                s = 1.0 if d >= 1.0 else -1.0
                # piecewise-parabolic (P²) candidate
                hp = h[i] + (s / (n[i + 1] - n[i - 1])) * (
                    (n[i] - n[i - 1] + s) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
                )
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # linear fallback keeps monotonicity
                    j = i + int(s)
                    h[i] = h[i] + s * (h[j] - h[i]) / (n[j] - n[i])
                n[i] += s

    def update_batch(self, xs: np.ndarray) -> None:
        for x in np.asarray(xs, np.float64).ravel():
            self.update(float(x))

    # -------------------------------------------------------------- queries

    @property
    def initialized(self) -> bool:
        return self.heights is not None

    def quantile(self, q: float) -> float:
        """Interpolated quantile estimate at ``q`` in [0, 1]."""
        if self.heights is None:
            if not self._seed_buffer:
                raise RuntimeError("quantile() on an empty tracker")
            return float(np.quantile(np.asarray(self._seed_buffer), q))
        return float(np.interp(float(q), self.probs, self.heights))

    def calibration_scores(self) -> np.ndarray:
        """The live marker heights as a sorted sample of the tracked
        distribution — a drop-in ``calibration_scores`` array for
        ``make_policy`` / ``quantile_threshold``."""
        if self.heights is None:
            if not self._seed_buffer:
                raise RuntimeError("calibration_scores() on an empty tracker")
            return np.sort(np.asarray(self._seed_buffer, np.float64))
        return self.heights.copy()

    def to_transform(self) -> CdfTransform:
        """The tracked distribution as a ``CdfTransform`` (via its public
        ``from_state``) — the streaming refresh of the engine's MORIC
        transform."""
        return CdfTransform.from_state({"sorted_rewards": self.calibration_scores()})

    # ------------------------------------------------------------ persistence

    def state(self) -> Dict[str, np.ndarray]:
        return {
            "probs": self.probs.copy(),
            "heights": (
                self.heights.copy() if self.heights is not None else np.zeros(0)
            ),
            "positions": (
                self.positions.copy() if self.positions is not None else np.zeros(0)
            ),
            "count": np.asarray(self.count, np.int64),
            "seed_buffer": np.asarray(self._seed_buffer, np.float64),
        }

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray]) -> "StreamingQuantiles":
        probs = np.asarray(state["probs"], np.float64)
        t = cls(n_markers=probs.size)
        t.probs = probs
        heights = np.asarray(state["heights"], np.float64)
        if heights.size:
            t.heights = heights.copy()
            t.positions = np.asarray(state["positions"], np.float64).copy()
        t.count = int(np.asarray(state["count"]))
        t._seed_buffer = [float(v) for v in np.asarray(state["seed_buffer"])]
        return t
