"""Network link models — size-dependent transmission delay over the
device→edge uplink.

The paper's deployment setting puts the strong detector behind a
rate-constrained wireless link; without one, ``repro_torch.runtime``
collapses that whole path into one scalar latency draw.  A :class:`NetworkLink` makes the
transmission leg explicit: a frame of ``size_bits`` entering the link at
time ``t`` occupies it for ``size_bits / bandwidth_at(t) + propagation``
time units.  Three models:

- :class:`ConstantRateLink` — fixed bandwidth (the textbook M/D/1 front),
- :class:`TraceBandwidthLink` — piecewise-constant bandwidth from a
  ``(times, bandwidths)`` trace, for replaying measured network conditions,
- :class:`GilbertElliottLink` — the classic seeded two-state (good/bad)
  Markov channel; the bad state throttles bandwidth, so congestion arrives
  in bursts the way wireless fading does.

Everything is manually clocked: links never read the wall clock, and the
Gilbert–Elliott state is a pure function of the time slot (materialized
lazily, cached forever), so any sequence of queries — including *future*
probes from queue-delay predictors — is deterministic under a seed.

Copied from the JAX package (``repro.netsim.link``): seeded numpy, so a
channel's states equal that package's slot for slot.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

#: channel-state labels (``state_at`` return values)
CHANNEL_GOOD = 0
CHANNEL_BAD = 1


class NetworkLink:
    """Base link: fixed ``bandwidth`` (bits per time unit) + ``propagation``
    delay.  Subclasses override :meth:`bandwidth_at` (and optionally
    :meth:`state_at`) to make the rate time- or state-dependent."""

    def __init__(self, bandwidth: float, *, propagation: float = 0.0):
        if bandwidth <= 0.0:
            raise ValueError(f"bandwidth must be > 0, got {bandwidth}")
        if propagation < 0.0:
            raise ValueError(f"propagation must be >= 0, got {propagation}")
        self.bandwidth = float(bandwidth)
        self.propagation = float(propagation)

    def bandwidth_at(self, now: float) -> float:
        """Instantaneous link rate in bits per time unit."""
        return self.bandwidth

    def state_at(self, now: float) -> int:
        """Channel state at ``now`` (``CHANNEL_GOOD`` unless the model has
        one); queue-aware controllers condition on this."""
        return CHANNEL_GOOD

    def transmit_delay(self, size_bits: float, now: float) -> float:
        """Time to push ``size_bits`` through the link starting at ``now``."""
        if size_bits < 0.0:
            raise ValueError(f"size_bits must be >= 0, got {size_bits}")
        return float(size_bits) / self.bandwidth_at(now) + self.propagation

    def spec(self) -> dict:
        return {"bandwidth": self.bandwidth, "propagation": self.propagation}


class ConstantRateLink(NetworkLink):
    """Fixed-rate link — ``NetworkLink`` under its canonical name."""


class TraceBandwidthLink(NetworkLink):
    """Piecewise-constant bandwidth replayed from a trace.

    ``times`` are the sorted segment start times; ``bandwidths[i]`` holds
    from ``times[i]`` until the next start (the last segment holds forever,
    and queries before ``times[0]`` see ``bandwidths[0]``).
    """

    def __init__(
        self,
        times: Sequence[float],
        bandwidths: Sequence[float],
        *,
        propagation: float = 0.0,
    ):
        t = np.asarray(times, np.float64)
        bw = np.asarray(bandwidths, np.float64)
        if t.ndim != 1 or t.size == 0 or t.shape != bw.shape:
            raise ValueError(
                f"times/bandwidths must be equal-length 1-D, got {t.shape}/{bw.shape}"
            )
        if np.any(np.diff(t) < 0):
            raise ValueError("trace times must be sorted ascending")
        if np.any(bw <= 0.0):
            raise ValueError("trace bandwidths must all be > 0")
        super().__init__(float(bw[0]), propagation=propagation)
        self._times = t
        self._bw = bw

    def bandwidth_at(self, now: float) -> float:
        i = int(np.searchsorted(self._times, now, side="right")) - 1
        return float(self._bw[max(i, 0)])

    def spec(self) -> dict:
        return {
            "times": self._times.tolist(),
            "bandwidths": self._bw.tolist(),
            "propagation": self.propagation,
        }


class GilbertElliottLink(NetworkLink):
    """Seeded two-state Markov (Gilbert–Elliott) channel.

    Time is sliced into ``slot``-length intervals; within a slot the state
    is constant, and at each slot boundary the chain moves good→bad with
    probability ``p_gb`` and bad→good with probability ``p_bg``.  The state
    sequence is materialized lazily from a seeded generator and cached, so
    ``state_at``/``bandwidth_at`` are pure functions of time — probing the
    future (queue predictors do) never perturbs the trajectory.

    ``bad_bandwidth`` defaults to ``bandwidth / 10`` — a deep fade rather
    than a hard outage, so frames in flight still drain, just slowly.

    The cache grows one entry per slot up to the furthest time ever
    queried; ``max_slots`` (default 2e6) bounds it so a runaway query (e.g.
    probing the channel at a drain sentinel like ``t=1e12``) raises a clear
    ``ValueError`` instead of consuming unbounded time and memory.  Long-
    horizon simulations should raise ``slot`` (coarser fades) or
    ``max_slots`` explicitly.
    """

    def __init__(
        self,
        bandwidth: float,
        *,
        bad_bandwidth: float = None,
        p_gb: float = 0.1,
        p_bg: float = 0.3,
        slot: float = 1.0,
        propagation: float = 0.0,
        seed: int = 0,
        max_slots: int = 2_000_000,
    ):
        super().__init__(bandwidth, propagation=propagation)
        self.bad_bandwidth = (
            float(bad_bandwidth) if bad_bandwidth is not None else self.bandwidth / 10.0
        )
        if self.bad_bandwidth <= 0.0:
            raise ValueError(f"bad_bandwidth must be > 0, got {self.bad_bandwidth}")
        for name, p in (("p_gb", p_gb), ("p_bg", p_bg)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if slot <= 0.0:
            raise ValueError(f"slot must be > 0, got {slot}")
        self.p_gb = float(p_gb)
        self.p_bg = float(p_bg)
        self.slot = float(slot)
        self.seed = int(seed)
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self._rng = np.random.default_rng(seed)
        self._states: List[int] = [CHANNEL_GOOD]  # slot index -> state

    def _materialize(self, slot_idx: int) -> None:
        if slot_idx >= self.max_slots:
            raise ValueError(
                f"channel query at slot {slot_idx} exceeds max_slots="
                f"{self.max_slots} (t={slot_idx * self.slot:g}); raise `slot` "
                f"or `max_slots` for longer horizons"
            )
        if len(self._states) > slot_idx:
            return
        # bulk-draw the uniforms; the (state-dependent) transition walk
        # itself stays sequential but touches each slot exactly once ever
        us = self._rng.uniform(size=slot_idx + 1 - len(self._states))
        s = self._states[-1]
        for u in us:
            if s == CHANNEL_GOOD:
                s = CHANNEL_BAD if u < self.p_gb else CHANNEL_GOOD
            else:
                s = CHANNEL_GOOD if u < self.p_bg else CHANNEL_BAD
            self._states.append(s)

    def state_at(self, now: float) -> int:
        idx = max(int(np.floor(now / self.slot)), 0)
        self._materialize(idx)
        return self._states[idx]

    def bandwidth_at(self, now: float) -> float:
        return (
            self.bandwidth
            if self.state_at(now) == CHANNEL_GOOD
            else self.bad_bandwidth
        )

    def stationary_bad_fraction(self) -> float:
        """Long-run fraction of time in the bad state (the chain's
        stationary distribution) — MDP controllers use it as the channel
        prior when they cannot observe the state."""
        denom = self.p_gb + self.p_bg
        return self.p_gb / denom if denom > 0.0 else 0.0

    def spec(self) -> dict:
        return {
            "bandwidth": self.bandwidth,
            "bad_bandwidth": self.bad_bandwidth,
            "p_gb": self.p_gb,
            "p_bg": self.p_bg,
            "slot": self.slot,
            "propagation": self.propagation,
            "seed": self.seed,
            "max_slots": self.max_slots,
        }
