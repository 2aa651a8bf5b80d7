"""`MultiEdgeDispatcher` — routes accepted offloads across N heterogeneous
edges, with drop-or-degrade on saturation.

Strategies (``list_strategies()``):

- ``round_robin``   — rotate through the fleet, take the first that admits,
- ``least_loaded``  — prefer the lowest in-flight/capacity fraction,
- ``score_weighted``— seeded sampling of the probe order with weights
  ``free_slots / expected_latency`` sharpened by the frame's reward
  estimate (high-value frames concentrate on the fastest free edges,
  low-value frames spread for load balance), so fast idle edges absorb
  most traffic while loaded ones still get a share (power-of-choices
  flavor).

When no edge admits a frame, the saturation policy decides its fate:
``degrade`` serves the weak result locally (frame is answered, quality
degrades), ``drop`` discards it.  Both are counted; the per-step outcome is
recorded on the :class:`DispatchResult` so traces stay exact.

Copied from the JAX package (``repro.runtime.dispatch``); plain numpy,
whose seeded ``score_weighted`` draws it repeats exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.runtime.edge import EdgeWorker, LatencyBreakdown

_STRATEGIES = ("round_robin", "least_loaded", "score_weighted")
_ON_SATURATION = ("degrade", "drop")

#: trace outcome labels
OUTCOME_LOCAL = "local"          # policy kept the frame on the weak device
OUTCOME_OFFLOADED = "offloaded"  # admitted by an edge
OUTCOME_DEGRADED = "degraded"    # wanted to offload, fleet saturated -> weak
OUTCOME_DROPPED = "dropped"      # wanted to offload, fleet saturated -> lost


def list_strategies() -> List[str]:
    """Registered dispatch strategies (for configs and error messages)."""
    return list(_STRATEGIES)


@dataclass(frozen=True)
class DispatchResult:
    """Where one accepted offload went (or why it didn't).  ``breakdown``
    decomposes the latency of admitted frames into uplink queue wait,
    transmission, and edge service (pure service on link-free edges)."""

    step: int
    estimate: float
    edge: Optional[str]
    latency: Optional[float]
    outcome: str
    breakdown: Optional[LatencyBreakdown] = None


class MultiEdgeDispatcher:
    def __init__(
        self,
        edges: Sequence[EdgeWorker],
        strategy: str = "least_loaded",
        *,
        on_saturation: str = "degrade",
        seed: int = 0,
    ):
        if strategy not in _STRATEGIES:
            raise KeyError(f"unknown strategy {strategy!r}; have {list_strategies()}")
        if on_saturation not in _ON_SATURATION:
            raise KeyError(
                f"unknown saturation policy {on_saturation!r}; have {list(_ON_SATURATION)}"
            )
        self.edges = list(edges)
        if not self.edges:
            raise ValueError("dispatcher needs at least one edge")
        names = [e.name for e in self.edges]
        if len(set(names)) != len(names):
            raise ValueError(f"edge names must be unique, got {names}")
        self.strategy = strategy
        self.on_saturation = on_saturation
        self._rr = 0
        self._rng = np.random.default_rng(seed)
        self.dropped = 0
        self.degraded = 0
        self._profiler: Optional[Any] = None
        self._outcomes: Optional[Dict[str, Any]] = None

    # --------------------------------------------------------------- obs

    def attach_obs(self, obs: Optional[Any], tid_base: int = 100) -> None:
        """Wire the dispatcher and its fleet into an observability handle:
        per-outcome dispatch counters, the host-phase profiler, and one
        trace track per edge starting at ``tid_base``."""
        if obs is None:
            return
        self._profiler = obs.profiler
        reg = obs.metrics
        if reg is not None:
            self._outcomes = {
                outcome: reg.counter(
                    "repro_dispatch_total", {"outcome": outcome},
                    help="dispatch decisions by outcome",
                )
                for outcome in (
                    OUTCOME_OFFLOADED, OUTCOME_DEGRADED, OUTCOME_DROPPED
                )
            }
        for i, e in enumerate(self.edges):
            e.attach_obs(obs, tid=tid_base + i)

    # --------------------------------------------------------------- routing

    def poll(self, now: float) -> None:
        """Advance all edges to ``now``, completing finished offloads."""
        for e in self.edges:
            e.poll(now)

    def _probe_order(self, estimate: float) -> List[int]:
        n = len(self.edges)
        if self.strategy == "round_robin":
            start = self._rr
            self._rr = (self._rr + 1) % n
            return [(start + i) % n for i in range(n)]
        if self.strategy == "least_loaded":
            return sorted(range(n), key=lambda i: (self.edges[i].load, i))
        # score_weighted: seeded sampling without replacement, weight =
        # free slots per unit of expected latency, sharpened by the frame's
        # reward estimate — exponent 1 + clip(estimate, 0, 1), so a
        # high-value frame concentrates its probe order on the best edges
        # while a low-value frame spreads more evenly (weights are
        # normalized, so only a *shape* change can use the estimate)
        w = np.array(
            [
                max(e.capacity - e.inflight, 0) / max(e.expected_latency(), 1e-9)
                for e in self.edges
            ],
            dtype=np.float64,
        )
        pos = np.flatnonzero(w > 0.0)
        if pos.size == 0:
            return list(range(n))
        sharp = w[pos] ** (1.0 + float(np.clip(estimate, 0.0, 1.0)))
        order = [
            int(i)
            for i in self._rng.choice(
                pos, size=pos.size, replace=False, p=sharp / sharp.sum()
            )
        ]
        # saturated edges last, in index order (their buckets may still admit
        # once try_admit polls completions at dispatch time)
        return order + [i for i in range(n) if w[i] <= 0.0]

    def dispatch(
        self,
        now: float,
        step: int,
        estimate: float,
        *,
        prefer: Optional[int] = None,
        pin: bool = False,
        size_bits: Optional[float] = None,
    ) -> DispatchResult:
        """Route one accepted offload; on fleet saturation apply the
        drop-or-degrade policy.

        ``prefer`` (an edge index) probes that edge first and only then
        falls back to the strategy's order — the seam mobility-aware
        dispatchers use to favor a stream's serving base station while
        keeping the fleet as backup.  ``pin=True`` hardens that to *only*
        that edge (a mobile client's single radio talks to one station;
        refusal degrades/drops rather than teleporting the frame).
        ``size_bits`` overrides the frame's size on the uplink
        (coverage-dependent links price a far client's frame higher)."""
        prof = self._profiler
        if prof is None:
            self.poll(now)
        else:
            t0 = prof.begin()
            self.poll(now)
            prof.add("dispatch.poll", t0)
            t0 = prof.begin()
        if pin and prefer is None:
            raise ValueError("pin=True needs prefer=<edge index>")
        order = self._probe_order(estimate)
        if prefer is not None:
            if not 0 <= prefer < len(self.edges):
                raise IndexError(
                    f"prefer={prefer} outside fleet of {len(self.edges)}"
                )
            order = [prefer] if pin else (
                [prefer] + [i for i in order if i != prefer]
            )
        if prof is not None:
            prof.add("dispatch.probe_order", t0)
            t0 = prof.begin()
        for i in order:
            lat = self.edges[i].try_admit(now, step, estimate, size_bits)
            if lat is not None:
                if prof is not None:
                    prof.add("dispatch.admit", t0)
                if self._outcomes is not None:
                    self._outcomes[OUTCOME_OFFLOADED].inc()
                return DispatchResult(
                    step=step, estimate=estimate, edge=self.edges[i].name,
                    latency=lat, outcome=OUTCOME_OFFLOADED,
                    breakdown=self.edges[i].last_breakdown,
                )
        if prof is not None:
            prof.add("dispatch.admit", t0)
        if self.on_saturation == "degrade":
            self.degraded += 1
            outcome = OUTCOME_DEGRADED
        else:
            self.dropped += 1
            outcome = OUTCOME_DROPPED
        if self._outcomes is not None:
            self._outcomes[outcome].inc()
        return DispatchResult(
            step=step, estimate=estimate, edge=None, latency=None, outcome=outcome
        )

    # ----------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        return {
            "strategy": self.strategy,
            "on_saturation": self.on_saturation,
            "dropped": self.dropped,
            "degraded": self.degraded,
            "edges": {e.name: e.stats() for e in self.edges},
        }
