"""`OffloadRuntime` + the seeded `simulate()` driver.

The runtime is the top-level serve-time object: one frozen
:class:`repro_torch.api.OffloadEngine` artifact, a fleet of
:class:`~repro_torch.runtime.edge.EdgeWorker`, and a
:class:`~repro_torch.runtime.dispatch.MultiEdgeDispatcher` strategy.  Sessions
opened from it decide in arrival order; frames the policy offloads are
routed across the fleet; saturation degrades (or drops) them.

``simulate`` is the deterministic end-to-end driver of the paper's
deployment picture — one weak embedded device emitting a stream of frames
toward N constrained edges — producing an exact per-step
:class:`StreamTrace`.  Everything is seeded and clocked manually, so two
runs with the same inputs are identical record-for-record.  The seeded
draws (edge jitter, ``score_weighted`` probe orders) are the JAX package's
numpy draws (``repro.runtime.simulate``), so a trace differs from that
package's only where an estimate does.

On the card the stream's features stay there: ``serve`` walks the rows of
the device feature matrix and each enters the session's buffer by a
device-to-device copy; the host waits for the card once per micro-batch,
when the drain copies its estimates for the policy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.engine import OffloadEngine
from repro_torch.runtime.clock import ManualClock
from repro_torch.runtime.dispatch import (
    OUTCOME_LOCAL,
    OUTCOME_OFFLOADED,
    DispatchResult,
    MultiEdgeDispatcher,
)
from repro_torch.runtime.edge import EdgeLatencyModel, EdgeWorker
from repro_torch.runtime.session import OffloadSession, SessionTelemetry, StepDecision


@dataclass(frozen=True)
class StepRecord:
    """One frame's full serve-time story, in arrival order.

    For offloaded frames the latency decomposes exactly:
    ``latency == queue_delay + transmit_delay + service_delay +
    downlink_delay`` (the uplink queue wait, the transmission over the
    link, the edge service time, and the result's return transit — the
    first two are 0 on link-free edges, the last is 0 on edges without a
    downlink).  Non-offloaded frames carry ``None`` for all four.

    Video streams (:meth:`repro_torch.video.VideoRuntime.serve_clip`)
    additionally stamp temporal fields:
    ``source`` is what was actually served for the frame (``"weak"`` or
    ``"edge"`` for a propagated stale edge result), ``staleness`` the age of
    that result in frames (None when served weak), ``effective_accuracy``
    the frame's AP against ground truth.  Per-image simulations leave all
    three None."""

    step: int
    t_arrival: float
    t_decision: float
    estimate: float
    offload: bool
    edge: Optional[str]
    latency: Optional[float]
    outcome: str
    queue_delay: Optional[float] = None
    transmit_delay: Optional[float] = None
    service_delay: Optional[float] = None
    downlink_delay: Optional[float] = None
    source: Optional[str] = None
    staleness: Optional[float] = None
    effective_accuracy: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "t_arrival": self.t_arrival,
            "t_decision": self.t_decision,
            "estimate": self.estimate,
            "offload": self.offload,
            "edge": self.edge,
            "latency": self.latency,
            "outcome": self.outcome,
            "queue_delay": self.queue_delay,
            "transmit_delay": self.transmit_delay,
            "service_delay": self.service_delay,
            "downlink_delay": self.downlink_delay,
            "source": self.source,
            "staleness": self.staleness,
            "effective_accuracy": self.effective_accuracy,
        }


@dataclass
class StreamTrace:
    """Per-step records + end-of-stream telemetry and dispatcher stats."""

    records: List[StepRecord]
    telemetry: SessionTelemetry
    dispatcher: Dict[str, Any]

    def outcome_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for r in self.records:
            counts[r.outcome] = counts.get(r.outcome, 0) + 1
        return counts

    def offload_mask(self) -> np.ndarray:
        """Frames actually served by an edge, in arrival order (degraded and
        dropped frames are False — they never reached the strong model)."""
        return np.array([r.outcome == OUTCOME_OFFLOADED for r in self.records])

    def effective_accuracy(self) -> Optional[float]:
        """Mean per-frame effective accuracy over the records that carry it
        (video streams; ``None`` for per-image simulations)."""
        vals = [
            r.effective_accuracy
            for r in self.records
            if r.effective_accuracy is not None
        ]
        return float(np.mean(vals)) if vals else None

    def staleness_profile(self) -> Dict[str, float]:
        """How the stream was actually served: fraction of frames answered
        from a propagated edge result and their mean staleness."""
        stale = [r.staleness for r in self.records if r.staleness is not None]
        n = len(self.records)
        return {
            "covered_fraction": len(stale) / n if n else 0.0,
            "mean_staleness": float(np.mean(stale)) if stale else 0.0,
        }

    def latency_decomposition(self) -> Optional[Dict[str, float]]:
        """Mean queue/transmit/service/downlink components over the
        offloaded frames (``None`` when nothing was offloaded)."""
        rows = [
            (
                r.queue_delay,
                r.transmit_delay,
                r.service_delay,
                r.downlink_delay if r.downlink_delay is not None else 0.0,
            )
            for r in self.records
            if r.queue_delay is not None
        ]
        if not rows:
            return None
        q, t, s, d = (float(np.mean(col)) for col in zip(*rows))
        return {
            "queue": q, "transmit": t, "service": s, "downlink": d,
            "total": q + t + s + d,
        }

    def summary(self) -> Dict[str, Any]:
        lats = [r.latency for r in self.records if r.latency is not None]
        return {
            "steps": len(self.records),
            "outcomes": self.outcome_counts(),
            "telemetry": self.telemetry.as_dict(),
            "dispatcher": self.dispatcher,
            "mean_offload_latency": float(np.mean(lats)) if lats else None,
            "latency_decomposition": self.latency_decomposition(),
            "effective_accuracy": self.effective_accuracy(),
        }


def default_edge_fleet(
    n: int = 3, seed: int = 0, *, prefix: str = "edge"
) -> List[EdgeWorker]:
    """A seeded heterogeneous fleet: a fast/small edge, then progressively
    bigger, slower, more rate-limited ones (cycled past n=3).  ``prefix``
    keeps edge names unique when several fleets coexist (one per shard in
    a fleet)."""
    profiles = [
        dict(capacity=2, rate=0.5, burst=2.0,
             latency=EdgeLatencyModel(base=0.5, per_inflight=0.1, jitter=0.05)),
        dict(capacity=4, rate=0.35, burst=4.0,
             latency=EdgeLatencyModel(base=1.0, per_inflight=0.2, jitter=0.1)),
        dict(capacity=8, rate=0.25, burst=8.0,
             latency=EdgeLatencyModel(base=2.0, per_inflight=0.1, jitter=0.1)),
    ]
    return [
        EdgeWorker(f"{prefix}{i}", seed=seed + i, **profiles[i % len(profiles)])
        for i in range(n)
    ]


def default_congested_fleet(
    n: int = 3,
    seed: int = 0,
    *,
    transmit_time: float = 5.0,
    queue_depth: int = 12,
    p_gb: float = 0.08,
    p_bg: float = 0.25,
    bad_slowdown: float = 4.0,
    prefix: str = "edge",
) -> List[EdgeWorker]:
    """A seeded fleet behind congested Gilbert–Elliott uplinks — the netsim
    acceptance scenario.  Each edge's link pushes one frame in
    ``transmit_time`` time units in the good state and ``bad_slowdown``×
    that in fades, so with frames arriving every time unit the uplink
    queues genuinely build and queue-aware policies have something to see.
    Service itself is fast (the bottleneck is the link, as in the paper's
    rate-constrained setting)."""
    from repro_torch.netsim import GilbertElliottLink

    return [
        EdgeWorker(
            f"{prefix}{i}",
            capacity=queue_depth + 4,
            latency=EdgeLatencyModel(base=0.2, per_inflight=0.02, jitter=0.02),
            link=GilbertElliottLink(
                bandwidth=1.0 / transmit_time,
                bad_bandwidth=1.0 / (transmit_time * bad_slowdown),
                p_gb=p_gb,
                p_bg=p_bg,
                slot=1.0,
                seed=seed * 101 + i,
            ),
            queue_depth=queue_depth,
            frame_bits=1.0,
            seed=seed + i,
        )
        for i in range(n)
    ]


def default_linked_fleet(
    n: int = 3,
    seed: int = 0,
    *,
    transmit_time: float = 0.08,
    queue_depth: int = 64,
    fading: bool = False,
    p_gb: float = 0.05,
    p_bg: float = 0.4,
    bad_slowdown: float = 3.0,
    prefix: str = "edge",
) -> List[EdgeWorker]:
    """The heterogeneous ``default_edge_fleet`` profiles with *real* netsim
    uplinks in front of them: a fast ``ConstantRateLink`` per edge (one
    frame in ``transmit_time`` time units) or, with ``fading=True``, a
    seeded Gilbert–Elliott channel that slows to ``bad_slowdown``× in
    fades.  Unlike ``default_congested_fleet`` the link is provisioned as
    the *minor* cost — service still dominates — so scenarios built on the
    latency-only fleet keep their character while every frame genuinely
    pays transit (the fleet city scenario runs on this)."""
    from repro_torch.netsim import ConstantRateLink, GilbertElliottLink

    fleet = default_edge_fleet(n, seed, prefix=prefix)
    out: List[EdgeWorker] = []
    for i, e in enumerate(fleet):
        if fading:
            link = GilbertElliottLink(
                bandwidth=1.0 / transmit_time,
                bad_bandwidth=1.0 / (transmit_time * bad_slowdown),
                p_gb=p_gb,
                p_bg=p_bg,
                slot=1.0,
                seed=seed * 211 + i,
            )
        else:
            link = ConstantRateLink(1.0 / transmit_time)
        out.append(
            EdgeWorker(
                e.name,
                capacity=e.capacity,
                rate=e._bucket.rate if e._bucket is not None else None,
                burst=e._bucket.depth if e._bucket is not None else 1.0,
                latency=e.latency,
                link=link,
                queue_depth=queue_depth,
                frame_bits=1.0,
                seed=seed + i,
            )
        )
    return out


class OffloadRuntime:
    """The served system: engine artifact + edge fleet + dispatch strategy.

    ``net_state`` (a network estimator,
    :class:`repro_torch.online.NetworkEstimator`) switches the congestion / state
    probes handed to queue-aware policies from the simulator's oracle
    signals to *measured* estimates fed purely by completed round trips —
    what a real device can actually observe.
    The runtime binds it to its manual clock and fleet size and records
    every admitted offload into it."""

    def __init__(
        self,
        engine: OffloadEngine,
        edges: Sequence[EdgeWorker],
        *,
        strategy: str = "least_loaded",
        on_saturation: str = "degrade",
        seed: int = 0,
        net_state: Optional[Any] = None,
        obs: Optional[Any] = None,
    ):
        self.engine = engine
        self.dispatcher = MultiEdgeDispatcher(
            edges, strategy, on_saturation=on_saturation, seed=seed
        )
        self.clock = ManualClock()
        self.net_state = net_state
        if net_state is not None:
            net_state.bind_clock(self.clock)
            net_state.bind_fleet(len(self.dispatcher.edges))
        # observability: spans are stamped in *simulated* time (the manual
        # clock), edges get trace tracks 100+, streams 1+ (0 is the driver)
        self.obs = obs
        if obs is not None:
            obs.bind_clock(self.clock)
            if obs.tracer is not None:
                obs.tracer.thread_name(0, "runtime")
            self.dispatcher.attach_obs(obs, tid_base=100)

    def _best_edge(self) -> EdgeWorker:
        """The edge a new offload would most plausibly land on: the one
        with the smallest predicted uplink sojourn (ties by fleet order)."""
        edges = self.dispatcher.edges
        now = self.clock()
        return min(edges, key=lambda e: e.predicted_uplink_delay(now))

    def _congestion(self) -> float:
        """Congestion signal for queue-aware policies: the *measured*
        estimate when a ``net_state`` tracker is wired, else the oracle —
        the predicted uplink queueing wait at the best edge right now (how
        long a frame offloaded at this instant would sit behind others
        before its own transmission starts; 0 for link-free fleets)."""
        if self.net_state is not None:
            return float(self.net_state.congestion())
        return self._best_edge().predicted_uplink_delay(self.clock())

    def _state_probe(self):
        """(queue depth, channel state) for ``value_iteration`` policies:
        measured when a ``net_state`` tracker is wired, else observed at
        the best edge."""
        if self.net_state is not None:
            return self.net_state.state_probe()
        return self._best_edge().uplink_state(self.clock())

    def _record_offload(self, now: float, res: DispatchResult) -> None:
        """Feed one dispatch outcome into the measured network tracker
        (admitted offloads only — refusals return no round trip)."""
        if self.net_state is not None and res.outcome == OUTCOME_OFFLOADED:
            self.net_state.record(now, res.latency, res.breakdown)

    def open_session(
        self,
        *,
        ratio: Optional[float] = None,
        micro_batch: int = 8,
        telemetry_window: int = 64,
        staleness: Optional[Any] = None,
        scene_change: Optional[Any] = None,
        coverage_ttl: Optional[Any] = None,
        tracker: Optional[Any] = None,
        name: Optional[str] = None,
        tid: int = 1,
    ) -> OffloadSession:
        """A new per-stream session sharing the frozen engine; time-based
        policies see the runtime's manual clock, queue-aware policies
        (``queue_aware`` / ``value_iteration``) see live congestion probes
        over the runtime's fleet, and video runtimes thread their temporal
        probes (``staleness`` / ``scene_change``) and per-stream tracker
        through unchanged.  The runtime's ``obs`` handle (if any) rides
        into the session: its telemetry counters become registry-backed
        series labeled ``{stream=name}`` and its flush spans land on trace
        track ``tid``."""
        if self.obs is not None and self.obs.tracer is not None:
            self.obs.tracer.thread_name(
                tid, f"session:{tid - 1 if name is None else name}"
            )
        return OffloadSession(
            self.engine,
            ratio=ratio,
            micro_batch=micro_batch,
            telemetry_window=telemetry_window,
            clock=self.clock,
            congestion=self._congestion,
            state_probe=self._state_probe,
            staleness=staleness,
            scene_change=scene_change,
            coverage_ttl=coverage_ttl,
            tracker=tracker,
            obs=self.obs,
            name=name,
            tid=tid,
        )

    # ------------------------------------------------------------- streaming

    def serve(
        self,
        weak_outputs: Any = None,
        *,
        features: Optional[Any] = None,
        ratio: Optional[float] = None,
        micro_batch: int = 8,
        arrival_period: float = 1.0,
        set_ratio_at: Optional[Dict[int, float]] = None,
    ) -> StreamTrace:
        """Serve one finite stream end to end and return its exact trace.

        Frames arrive every ``arrival_period`` time units; decisions come
        out micro-batched (decision time = flush time); accepted offloads
        are dispatched immediately.  ``set_ratio_at`` maps arrival step ->
        new target ratio, applied before that frame is submitted (mid-stream
        re-budgeting, paper Table I); the pending micro-batch is flushed
        first so earlier arrivals are never re-budgeted retroactively."""
        prof = self.obs.profiler if self.obs is not None else None
        if prof is None:
            x = self.engine.features(weak_outputs, features=features)
        else:
            t0 = prof.begin()
            x = self.engine.features(weak_outputs, features=features)
            if x.device.type == "cuda":  # the phase ends when the features exist
                torch.cuda.synchronize(x.device)
            prof.add("serve.features", t0)
        session = self.open_session(ratio=ratio, micro_batch=micro_batch)
        rebudget = dict(set_ratio_at or {})
        t_arrival: Dict[int, float] = {}
        records: List[StepRecord] = []

        def settle(decisions: List[StepDecision]) -> None:
            now = self.clock()
            for d in decisions:
                if not d.offload:
                    records.append(
                        StepRecord(
                            step=d.step, t_arrival=t_arrival[d.step],
                            t_decision=now, estimate=d.estimate, offload=False,
                            edge=None, latency=None, outcome=OUTCOME_LOCAL,
                        )
                    )
                    continue
                res: DispatchResult = self.dispatcher.dispatch(
                    now, d.step, d.estimate
                )
                self._record_offload(now, res)
                if res.outcome == OUTCOME_OFFLOADED:
                    session.record_rtt(res.latency)
                    bd0 = res.breakdown
                    if bd0 is not None and bd0.transmit > 0.0:
                        session.record_bandwidth(1.0 / bd0.transmit)
                bd = res.breakdown
                records.append(
                    StepRecord(
                        step=d.step, t_arrival=t_arrival[d.step], t_decision=now,
                        estimate=d.estimate, offload=True, edge=res.edge,
                        latency=res.latency, outcome=res.outcome,
                        queue_delay=bd.queue if bd is not None else None,
                        transmit_delay=bd.transmit if bd is not None else None,
                        service_delay=bd.service if bd is not None else None,
                        downlink_delay=bd.downlink if bd is not None else None,
                    )
                )

        if prof is None:
            for step, row in enumerate(x):
                if step in rebudget:
                    # decide earlier arrivals at the old budget
                    settle(session.flush())
                    session.set_ratio(rebudget[step])
                t_arrival[step] = self.clock()
                settle(session.submit(features=row))
                self.clock.advance(arrival_period)
            settle(session.flush())
        else:
            # profiled serve loop: same schedule, host time attributed to
            # submit (enqueue+score+decide) vs settle (records+dispatch)
            for step, row in enumerate(x):
                if step in rebudget:
                    settle(session.flush())
                    session.set_ratio(rebudget[step])
                t_arrival[step] = self.clock()
                t0 = prof.begin()
                decisions = session.submit(features=row)
                prof.add("serve.submit", t0)
                t0 = prof.begin()
                settle(decisions)
                prof.add("serve.settle", t0)
                self.clock.advance(arrival_period)
            settle(session.flush())

        # drain: run the clock past the last in-flight completion
        horizon = max(
            [r.t_decision + r.latency for r in records if r.latency is not None],
            default=self.clock(),
        )
        self.clock.advance(max(horizon - self.clock(), 0.0) + 1e-9)
        self.dispatcher.poll(self.clock())

        records.sort(key=lambda r: r.step)
        return StreamTrace(
            records=records,
            telemetry=session.telemetry,
            dispatcher=self.dispatcher.stats(),
        )


def simulate(
    engine: OffloadEngine,
    weak_outputs: Any = None,
    *,
    features: Optional[Any] = None,
    edges: Optional[Sequence[EdgeWorker]] = None,
    n_edges: int = 3,
    strategy: str = "least_loaded",
    on_saturation: str = "degrade",
    ratio: Optional[float] = None,
    micro_batch: int = 8,
    arrival_period: float = 1.0,
    set_ratio_at: Optional[Dict[int, float]] = None,
    seed: int = 0,
    net_state: Optional[Any] = None,
    obs: Optional[Any] = None,
) -> StreamTrace:
    """One-call deterministic streaming simulation: 1 weak device emitting
    the given frames toward ``n_edges`` heterogeneous edges (or an explicit
    ``edges`` fleet), decisions via a session over ``engine``."""
    fleet = list(edges) if edges is not None else default_edge_fleet(n_edges, seed)
    runtime = OffloadRuntime(
        engine, fleet, strategy=strategy, on_saturation=on_saturation, seed=seed,
        net_state=net_state, obs=obs,
    )
    return runtime.serve(
        weak_outputs,
        features=features,
        ratio=ratio,
        micro_batch=micro_batch,
        arrival_period=arrival_period,
        set_ratio_at=set_ratio_at,
    )
