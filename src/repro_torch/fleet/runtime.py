"""City-scale serving: thousands of streams partitioned into shards, each
shard owning its own edge fleet on the shared manual clock.

``simulate()`` (repro_torch.runtime) serves one device's stream against one
fleet; :class:`FleetRuntime` is its city-scale shape — ``n_streams``
concurrent streams split contiguously into ``n_shards`` logical shards.
Per tick, *all* streams are scored in one call through the sharded data
plane (:class:`~repro_torch.fleet.plane.FleetPlane`), the estimates fan out to
one per-shard :class:`~repro_torch.runtime.session.OffloadSession` via the
``submit_scored`` seam (``fleet_fair`` policy, coordinated through a
shared :class:`~repro_torch.fleet.budget.FleetBudget`), and accepted offloads
dispatch to the shard's own ``MultiEdgeDispatcher``.  Everything runs on
one :class:`~repro_torch.runtime.clock.ManualClock`, so runs are deterministic
record-for-record; per-shard telemetry reduces into one
:class:`FleetTelemetry`.

Logical shards are independent of the device mesh: a 1-device host still
runs 4-shard fleets (the plane just scores single-device), while a plane
over N devices (or one device named N times) spreads scoring over them.

The port of ``repro.fleet.runtime``: host logic over the port's sessions and
dispatchers, copied; the scoring runs where the plane's devices are, by
default every visible CUDA device for an engine on the card and the CPU for
an engine on the CPU.  The profiler phases (``fleet.poll``,
``fleet.score``, ``fleet.decide_dispatch``, ``fleet.redistribute``) and the
``fleet.tick`` span are ``repro``'s.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.engine import OffloadEngine
from repro_torch.fleet.budget import FleetBudget
from repro_torch.fleet.plane import FleetPlane
from repro_torch.runtime.clock import ManualClock
from repro_torch.runtime.dispatch import (
    OUTCOME_DEGRADED,
    OUTCOME_DROPPED,
    OUTCOME_LOCAL,
    OUTCOME_OFFLOADED,
    MultiEdgeDispatcher,
)
from repro_torch.runtime.edge import EdgeWorker
from repro_torch.runtime.session import OffloadSession, SessionTelemetry
from repro_torch.runtime.simulate import default_linked_fleet

#: compact per-stream outcome codes for the array-valued step records
OUTCOME_CODES: Tuple[str, ...] = (
    OUTCOME_LOCAL, OUTCOME_OFFLOADED, OUTCOME_DEGRADED, OUTCOME_DROPPED
)
_CODE = {name: i for i, name in enumerate(OUTCOME_CODES)}


@dataclass(frozen=True)
class FleetStep:
    """One clock tick across the whole fleet, as arrays over streams."""

    t: float
    estimates: np.ndarray  # (S,) float64 reward estimates
    offload: np.ndarray  # (S,) bool policy decisions (budget spent)
    outcome: np.ndarray  # (S,) int8 index into OUTCOME_CODES
    latency: np.ndarray  # (S,) float64, nan where not offloaded

    def served_strong(self) -> np.ndarray:
        """Streams actually answered by an edge this tick."""
        return self.outcome == _CODE[OUTCOME_OFFLOADED]


@dataclass(frozen=True)
class FleetTelemetry:
    """Sharded telemetry reduced fleet-wide; ``per_shard`` keeps the full
    per-shard :class:`SessionTelemetry` payloads (fleet fields included)."""

    n_streams: int
    n_shards: int
    processed: int
    offloaded: int
    realized_ratio: float
    target_ratio: float
    mean_estimate: float
    reward_sum: float
    rewards_recorded: int
    budget_redistributions: int
    shard_shares: Tuple[float, ...]
    shard_ratios: Tuple[float, ...]  # per-shard realized offload ratios
    per_shard: Tuple[Dict[str, Any], ...] = field(default=())

    def as_dict(self, include_per_shard: bool = False) -> Dict[str, Any]:
        out = {
            "n_streams": self.n_streams,
            "n_shards": self.n_shards,
            "processed": self.processed,
            "offloaded": self.offloaded,
            "realized_ratio": self.realized_ratio,
            "target_ratio": self.target_ratio,
            "mean_estimate": self.mean_estimate,
            "reward_sum": self.reward_sum,
            "rewards_recorded": self.rewards_recorded,
            "budget_redistributions": self.budget_redistributions,
            "shard_shares": list(self.shard_shares),
            "shard_ratios": list(self.shard_ratios),
        }
        if include_per_shard:
            out["per_shard"] = list(self.per_shard)
        return out


def reduce_telemetry(
    telemetries: Sequence[SessionTelemetry],
    *,
    n_streams: int,
    target_ratio: float,
) -> FleetTelemetry:
    """Fold per-shard session telemetry into one fleet snapshot (counts sum,
    ratios re-derive from the summed counts, never averaged averages)."""
    processed = sum(t.processed for t in telemetries)
    offloaded = sum(t.offloaded for t in telemetries)
    est_sum = sum(t.mean_estimate * t.processed for t in telemetries)
    return FleetTelemetry(
        n_streams=n_streams,
        n_shards=len(telemetries),
        processed=processed,
        offloaded=offloaded,
        realized_ratio=offloaded / processed if processed else 0.0,
        target_ratio=float(target_ratio),
        mean_estimate=est_sum / processed if processed else 0.0,
        reward_sum=float(sum(t.reward_sum for t in telemetries)),
        rewards_recorded=sum(t.rewards_recorded for t in telemetries),
        budget_redistributions=max(
            (t.budget_redistributions for t in telemetries), default=0
        ),
        shard_shares=tuple(t.budget_share for t in telemetries),
        shard_ratios=tuple(
            t.offloaded / t.processed if t.processed else 0.0
            for t in telemetries
        ),
        per_shard=tuple(t.as_dict(include_fleet=True) for t in telemetries),
    )


@dataclass
class _Shard:
    """One logical shard: its stream slice, session, and private fleet."""

    index: int
    sl: slice
    session: OffloadSession
    dispatcher: MultiEdgeDispatcher


class FleetRuntime:
    """The city-scale served system — see the module docstring.

    Parameters
    ----------
    engine : OffloadEngine
        The fitted artifact; cloned per shard under the ``fleet_fair``
        policy (fitted components shared, policy state per shard).
    n_streams : int
        Total concurrent streams, partitioned contiguously into shards.
    n_shards : int
        Logical shard count (independent of the device mesh size).
    plane : FleetPlane or None
        The sharded scoring plane (``None`` builds one over every visible
        CUDA device for an engine on the card, over the CPU for one on the
        CPU).
    ratio : float or None
        Fleet-wide target offload ratio (defaults to the engine's).
    redistribute_every : float or None
        Budget redistribution cadence in clock time units; ``None`` = the
        static equal split.
    bucket_depth : float or None
        Per-shard token-bucket burst depth; ``None`` scales with the
        shard's stream count (2 ticks of its equal-split budget, >= 8).
    fleet_factory : callable or None
        ``shard_index -> list[EdgeWorker]`` building each shard's private
        edge fleet; defaults to ``default_linked_fleet(edges_per_shard)``
        — the heterogeneous profiles behind real ``ConstantRateLink``
        uplinks — with shard-prefixed names and shard-offset seeds, so
        city runs genuinely pay (and report) transit per frame.
    staleness_probe : callable or None
        ``shard_index -> staleness (frames)`` sampled every tick into the
        budget's redistribution signal (``FleetBudget.record_staleness``)
        — the seam video-serving fleets feed their served-result age
        through.  ``None`` leaves the staleness signal silent.
    """

    def __init__(
        self,
        engine: OffloadEngine,
        n_streams: int,
        *,
        n_shards: int = 4,
        plane: Optional[FleetPlane] = None,
        ratio: Optional[float] = None,
        gain: float = 0.05,
        redistribute_every: Optional[float] = None,
        min_share: float = 0.25,
        smooth: float = 0.5,
        congestion_weight: float = 0.5,
        staleness_weight: float = 0.5,
        bucket_depth: Optional[float] = None,
        edges_per_shard: int = 3,
        fleet_factory: Optional[Callable[[int], List[EdgeWorker]]] = None,
        staleness_probe: Optional[Callable[[int], float]] = None,
        strategy: str = "least_loaded",
        on_saturation: str = "degrade",
        arrival_period: float = 1.0,
        seed: int = 0,
        obs: Optional[Any] = None,
    ):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_shards > n_streams:
            raise ValueError(
                f"n_shards={n_shards} exceeds n_streams={n_streams}"
            )
        self.engine = engine
        self.n_streams = int(n_streams)
        self.n_shards = int(n_shards)
        if plane is None:
            plane = FleetPlane(None if engine.device.type == "cuda" else [engine.device])
        self.plane = plane
        self.ratio = float(engine.ratio if ratio is None else ratio)
        self.arrival_period = float(arrival_period)
        self.clock = ManualClock()
        per = -(-self.n_streams // self.n_shards)
        streams_per_shard = per
        if bucket_depth is None:
            # two ticks of a shard's equal-split budget of burst headroom
            bucket_depth = max(8.0, 2.0 * self.ratio * streams_per_shard)
        # global token rate: the fleet-wide budget in offloads per time unit
        self.budget = FleetBudget(
            self.ratio * self.n_streams / self.arrival_period,
            self.n_shards,
            depth=float(bucket_depth),
            clock=self.clock,
            redistribute_every=redistribute_every,
            min_share=min_share,
            smooth=smooth,
            congestion_weight=congestion_weight,
            staleness_weight=staleness_weight,
        )
        if fleet_factory is None:
            def fleet_factory(s: int) -> List[EdgeWorker]:
                return default_linked_fleet(
                    edges_per_shard, seed=seed + 1000 * s, prefix=f"s{s}_edge",
                    queue_depth=max(64, streams_per_shard),
                )
        self.staleness_probe = staleness_probe
        # observability: the fleet stamps spans in simulated time — tick
        # spans on track 0, one session track per shard (1+s), edge tracks
        # blocked out per shard from 100 in steps of 100
        self.obs = obs
        self._profiler = obs.profiler if obs is not None else None
        self._tracer = obs.tracer if obs is not None else None
        if obs is not None:
            obs.bind_clock(self.clock)
            if obs.tracer is not None:
                obs.tracer.thread_name(0, "fleet")
        self.shards: List[_Shard] = []
        for s in range(self.n_shards):
            sl = slice(s * per, min((s + 1) * per, self.n_streams))
            shard_engine = engine.with_policy(
                "fleet_fair",
                ratio=self.ratio,
                policy_kwargs={"gain": gain, "budget": self.budget, "shard": s},
            )
            if self._tracer is not None:
                self._tracer.thread_name(1 + s, f"shard:{s}")
            session = OffloadSession(
                shard_engine, micro_batch=1, clock=self.clock,
                obs=obs, name=f"shard{s}", tid=1 + s,
            )
            session.record_budget_share(float(self.budget.shares[s]))
            dispatcher = MultiEdgeDispatcher(
                fleet_factory(s), strategy,
                on_saturation=on_saturation, seed=seed + s,
            )
            dispatcher.attach_obs(obs, tid_base=100 + 100 * s)
            self.shards.append(
                _Shard(index=s, sl=sl, session=session, dispatcher=dispatcher)
            )
        self._tick = 0

    # ----------------------------------------------------------------- serve

    def step(self, features: np.ndarray) -> FleetStep:
        """Serve one tick: ``features`` is the (n_streams, F) matrix of this
        arrival across every stream.  Scores once through the sharded plane,
        decides per shard, dispatches to each shard's own fleet, then
        advances the shared clock by one arrival period."""
        x = np.asarray(features, np.float32)
        if x.shape[0] != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} stream rows, got {x.shape[0]}"
            )
        now = self.clock()
        prof = self._profiler
        if prof is None:
            for sh in self.shards:
                sh.dispatcher.poll(now)
            estimates = np.asarray(
                self.plane.score(self.engine, x), np.float64
            ).ravel()
        else:
            t0 = prof.begin()
            for sh in self.shards:
                sh.dispatcher.poll(now)
            prof.add("fleet.poll", t0)
            t0 = prof.begin()
            estimates = np.asarray(
                self.plane.score(self.engine, x), np.float64
            ).ravel()
            prof.add("fleet.score", t0)
            t0 = prof.begin()
        offload = np.zeros(self.n_streams, bool)
        outcome = np.zeros(self.n_streams, np.int8)
        latency = np.full(self.n_streams, np.nan)
        for sh in self.shards:
            decisions = sh.session.submit_scored(estimates[sh.sl])
            for i, d in enumerate(decisions):
                stream = sh.sl.start + i
                if not d.offload:
                    continue
                offload[stream] = True
                res = sh.dispatcher.dispatch(
                    now, self._tick * self.n_streams + stream, d.estimate
                )
                outcome[stream] = _CODE[res.outcome]
                if res.outcome == OUTCOME_OFFLOADED:
                    latency[stream] = res.latency
                    sh.session.record_rtt(res.latency)
                    # realized spend feeds the redistribution signal with
                    # the engine's own reward score for the frame
                    self.budget.record_reward(sh.index, d.estimate)
                    sh.session.record_reward(d.estimate)
                    bd = res.breakdown
                    if bd is not None and (bd.queue or bd.transmit):
                        # realized uplink sojourn — the congestion side of
                        # the redistribution signal on link-fronted fleets
                        self.budget.record_congestion(
                            sh.index, bd.queue + bd.transmit
                        )
        if prof is not None:
            prof.add("fleet.decide_dispatch", t0)
            t0 = prof.begin()
        if self.staleness_probe is not None:
            for sh in self.shards:
                self.budget.record_staleness(
                    sh.index, float(self.staleness_probe(sh.index))
                )
        if self.budget.maybe_redistribute(now):
            for sh in self.shards:
                sh.session.record_redistribution()
                sh.session.record_budget_share(
                    float(self.budget.shares[sh.index])
                )
        if prof is not None:
            prof.add("fleet.redistribute", t0)
        if self._tracer is not None:
            self._tracer.add_span(
                "fleet.tick", now, now + self.arrival_period, tid=0,
                args={
                    "tick": self._tick,
                    "offloaded": int(offload.sum()),
                },
            )
        self.clock.advance(self.arrival_period)
        self._tick += 1
        return FleetStep(
            t=now, estimates=estimates, offload=offload,
            outcome=outcome, latency=latency,
        )

    # ------------------------------------------------------------- telemetry

    @property
    def telemetry(self) -> FleetTelemetry:
        return reduce_telemetry(
            [sh.session.telemetry for sh in self.shards],
            n_streams=self.n_streams,
            target_ratio=self.ratio,
        )

    def dispatcher_stats(self) -> Dict[str, Any]:
        return {
            f"shard{sh.index}": sh.dispatcher.stats() for sh in self.shards
        }


@dataclass
class FleetTrace:
    """A full fleet run: per-tick array records + reduced telemetry."""

    steps: List[FleetStep]
    telemetry: FleetTelemetry
    dispatcher: Dict[str, Any]
    budget: Dict[str, Any]

    def offload_mask(self) -> np.ndarray:
        """(T, S) — streams actually served by an edge, per tick."""
        return np.stack([s.served_strong() for s in self.steps])

    def decision_mask(self) -> np.ndarray:
        """(T, S) — policy said offload (budget spent), per tick."""
        return np.stack([s.offload for s in self.steps])

    def realized_ratio(self) -> float:
        return float(np.mean(self.decision_mask()))

    def outcome_counts(self) -> Dict[str, int]:
        counts = np.zeros(len(OUTCOME_CODES), np.int64)
        for s in self.steps:
            counts += np.bincount(s.outcome, minlength=len(OUTCOME_CODES))
        return {
            name: int(c) for name, c in zip(OUTCOME_CODES, counts) if c
        }

    def summary(self) -> Dict[str, Any]:
        lats = np.concatenate([s.latency for s in self.steps])
        lats = lats[~np.isnan(lats)]
        return {
            "ticks": len(self.steps),
            "outcomes": self.outcome_counts(),
            "telemetry": self.telemetry.as_dict(),
            "budget": self.budget,
            "mean_offload_latency": float(np.mean(lats)) if lats.size else None,
        }


def simulate_fleet(
    engine: OffloadEngine,
    features: np.ndarray,
    **kwargs: Any,
) -> FleetTrace:
    """One-call deterministic city-scale simulation: ``features`` is a
    (T, n_streams, F) tensor — tick-major arrivals across every stream.
    Remaining kwargs go to :class:`FleetRuntime`."""
    x = np.asarray(features, np.float32)
    if x.ndim != 3:
        raise ValueError(f"features must be (T, n_streams, F), got {x.shape}")
    runtime = FleetRuntime(engine, x.shape[1], **kwargs)
    steps = [runtime.step(x[t]) for t in range(x.shape[0])]
    return FleetTrace(
        steps=steps,
        telemetry=runtime.telemetry,
        dispatcher=runtime.dispatcher_stats(),
        budget=runtime.budget.stats(),
    )
