"""`MobileRuntime` — moving clients served by a fixed edge fleet.

The paper's deployment picture with the clients finally in motion: N
embedded devices follow seeded :mod:`repro_torch.mobility.motion` traces across
a field of base stations (:mod:`repro_torch.mobility.coverage`), each streaming
frames through its own :class:`~repro_torch.runtime.session.OffloadSession` on
the shared manual clock.  Every offload is priced by position — the frame's
effective uplink size is ``frame_bits / rate_factor(rss)`` on the serving
station's real netsim queue, and the result pays the station's downlink
before it counts.  A per-client :class:`HandoverController` migrates the
serving station mid-stream (``mode="handover"``) or pins the station
attached at t=0 for life (``mode="static"`` — the baseline the acceptance
test beats), with configurable in-flight semantics at each migration.

Effective accuracy follows the video machinery's convention: a delivered
result covers later frames at ``stale_decay ** staleness`` of its strong
accuracy (the same per-frame decay :class:`repro_torch.video.track.VideoTracker`
applies when propagating stale detections), floored by the weak model the
device can always run locally; frames with no usable coverage serve weak.
Everything is seeded and manually clocked: two runs of a scenario are
record-for-record identical, including across handovers.

The port of ``repro.mobility.runtime``, over the port's ``OffloadRuntime``
(one session a client, ``micro_batch=1``: one ``estimator_mlp`` launch a
client-frame on the card).  The motion rollout runs on the engine's device;
the coverage, handover and delivery bookkeeping are host numpy, as in the
JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.api.engine import OffloadEngine
from repro_torch.mobility.coverage import CoverageMap, default_stations, station_fleet
from repro_torch.mobility.handover import (
    HandoverController,
    HandoverEvent,
    PendingResult,
    apply_in_flight,
)
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.mobility.motion import MotionConfig, rollout
from repro_torch.runtime.dispatch import OUTCOME_LOCAL, OUTCOME_OFFLOADED
from repro_torch.runtime.edge import EdgeWorker
from repro_torch.runtime.session import SessionTelemetry
from repro_torch.runtime.simulate import OffloadRuntime

MODES = ("handover", "static")


@dataclass(frozen=True)
class MobileStepRecord:
    """One client-frame's story: decision, dispatch outcome, signal, and
    what was effectively served."""

    client: int
    step: int
    t: float
    estimate: float
    offload: bool
    outcome: str
    serving: int
    rss_dbm: float
    latency: Optional[float]
    source: str                      # "weak" | "edge"
    staleness: Optional[float]
    effective_accuracy: float

    def as_dict(self) -> Dict[str, Any]:
        return {
            "client": self.client,
            "step": self.step,
            "t": self.t,
            "estimate": self.estimate,
            "offload": self.offload,
            "outcome": self.outcome,
            "serving": self.serving,
            "rss_dbm": self.rss_dbm,
            "latency": self.latency,
            "source": self.source,
            "staleness": self.staleness,
            "effective_accuracy": self.effective_accuracy,
        }


@dataclass
class MobileTrace:
    """Everything one serve produced: the seeded positions, per-frame
    records, per-client telemetry and handover logs, dispatcher stats."""

    mode: str
    in_flight: str
    positions: np.ndarray                 # (T, n_clients, 2) float32
    records: List[MobileStepRecord]
    telemetry: List[SessionTelemetry]
    handovers: List[List[HandoverEvent]] = field(default_factory=list)
    dispatcher: Dict[str, Any] = field(default_factory=dict)

    def mean_effective_accuracy(self) -> float:
        return float(np.mean([r.effective_accuracy for r in self.records]))

    def realized_ratio(self) -> float:
        """Offload decisions over frames, pooled across clients."""
        dec = sum(t.processed for t in self.telemetry)
        off = sum(t.offloaded for t in self.telemetry)
        return off / dec if dec else 0.0

    def offloaded_fraction(self) -> float:
        """Frames an edge actually served (admitted, not degraded away)."""
        n = len(self.records)
        k = sum(r.outcome == OUTCOME_OFFLOADED for r in self.records)
        return k / n if n else 0.0

    def n_handovers(self) -> int:
        return sum(len(h) for h in self.handovers)

    def summary(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "in_flight": self.in_flight,
            "clients": len(self.telemetry),
            "steps": len(self.records) // max(len(self.telemetry), 1),
            "mean_effective_accuracy": self.mean_effective_accuracy(),
            "realized_ratio": self.realized_ratio(),
            "offloaded_fraction": self.offloaded_fraction(),
            "handovers": self.n_handovers(),
            "telemetry": [
                t.as_dict(include_video=True, include_mobility=True)
                for t in self.telemetry
            ],
            "dispatcher": self.dispatcher,
        }


class MobileRuntime:
    """Drive moving clients against a fixed station fleet.

    Parameters
    ----------
    engine : OffloadEngine
        Fitted artifact; each client gets its own session over it.
    coverage : CoverageMap
        Station placements + radio model; must match ``edges`` order.
    edges : sequence of EdgeWorker or None
        One edge per station (defaults to ``station_fleet(coverage)``).
    motion : MotionConfig
        Client kinematics; the trace is rolled out once, seeded.
    mode : str
        ``"handover"`` (hysteresis migration) or ``"static"`` (pin the
        t=0 attachment for life).
    in_flight : str
        ``"survive"`` / ``"die"`` / ``"stale"`` — what a migration does to
        results outstanding on the old edge.
    hysteresis_db, min_dwell, stale_penalty :
        Forwarded to each client's :class:`HandoverController`.
    stale_decay : float
        Per-frame decay of a propagated result's accuracy (the video
        tracker's ``stale_decay`` convention).
    stale_horizon : int
        Frames after which a result stops covering at all.
    frame_bits : float
        Nominal uplink frame size at full signal.
    ttl_horizon : int
        Lookahead (steps) of the ``coverage_ttl`` probe wired into
        ``mobility_aware`` sessions.
    """

    def __init__(
        self,
        engine: OffloadEngine,
        coverage: CoverageMap,
        edges: Optional[Sequence[EdgeWorker]] = None,
        *,
        motion: Optional[MotionConfig] = None,
        mode: str = "handover",
        in_flight: str = "survive",
        hysteresis_db: float = 4.0,
        min_dwell: float = 8.0,
        stale_penalty: int = 4,
        stale_decay: float = 0.9,
        stale_horizon: int = 12,
        frame_bits: float = 1.0,
        ttl_horizon: int = 64,
        strategy: str = "least_loaded",
        seed: int = 0,
        obs: Optional[Any] = None,
    ):
        if mode not in MODES:
            raise KeyError(f"unknown mode {mode!r}; have {list(MODES)}")
        self.coverage = coverage
        fleet = list(edges) if edges is not None else station_fleet(
            coverage, seed=seed
        )
        if len(fleet) != len(coverage.stations):
            raise ValueError(
                f"{len(fleet)} edges for {len(coverage.stations)} stations"
            )
        self.rt = OffloadRuntime(
            engine, fleet, strategy=strategy, on_saturation="degrade",
            seed=seed, obs=obs,
        )
        self.motion = motion if motion is not None else MotionConfig()
        self.mode = mode
        self.in_flight = in_flight
        self.hysteresis_db = float(hysteresis_db)
        self.min_dwell = float(min_dwell)
        self.stale_penalty = int(stale_penalty)
        self.stale_decay = float(stale_decay)
        self.stale_horizon = int(stale_horizon)
        self.frame_bits = float(frame_bits)
        self.ttl_horizon = int(ttl_horizon)
        self.seed = int(seed)

    # ----------------------------------------------------------------- serve

    def serve(
        self,
        features: np.ndarray,     # (T, n_clients, F)
        weak_acc: np.ndarray,     # (T, n_clients)
        strong_acc: np.ndarray,   # (T, n_clients)
        *,
        ratio: Optional[float] = None,
        positions: Optional[np.ndarray] = None,
    ) -> MobileTrace:
        """One deterministic end-to-end serve of ``T`` frames from each of
        ``n_clients`` moving devices.  ``positions`` (T, n, 2) overrides
        the seeded rollout (tests pin traces with it)."""
        x = np.asarray(features, np.float32)
        if x.ndim != 3:
            raise ValueError(f"features must be (T, n_clients, F), got {x.shape}")
        T, n, _ = x.shape
        wa = np.broadcast_to(np.asarray(weak_acc, np.float64), (T, n))
        sa = np.broadcast_to(np.asarray(strong_acc, np.float64), (T, n))
        pos = (
            np.asarray(positions, np.float32)
            if positions is not None
            else rollout(self.motion, n, T, self.seed, device=self.rt.engine.device)
        )
        if pos.shape != (T, n, 2):
            raise ValueError(f"positions must be {(T, n, 2)}, got {pos.shape}")

        clock = self.rt.clock
        dispatcher = self.rt.dispatcher
        dt = self.motion.dt
        cur = [0] * n

        def ttl_probe(c: int):
            return lambda: self.coverage.time_to_loss(
                pos[:, c], cur[c], dt=dt, horizon=self.ttl_horizon
            )

        sessions = [
            self.rt.open_session(
                ratio=ratio, micro_batch=1, coverage_ttl=ttl_probe(c),
                name=f"client{c}", tid=c + 1,
            )
            for c in range(n)
        ]
        controllers = [
            HandoverController(
                self.coverage,
                hysteresis_db=self.hysteresis_db,
                min_dwell=self.min_dwell,
                in_flight=self.in_flight,
                stale_penalty=self.stale_penalty,
            )
            for _ in range(n)
        ]
        pending: List[List[PendingResult]] = [[] for _ in range(n)]
        newest: List[Optional[int]] = [None] * n   # newest delivered capture step
        handovers: List[List[HandoverEvent]] = [[] for _ in range(n)]
        records: List[MobileStepRecord] = []
        frame_rows: List[List[Dict[str, Any]]] = [[] for _ in range(n)]

        for t in range(T):
            now = clock()
            for c in range(n):
                cur[c] = t
                ctrl = controllers[c]
                if ctrl.serving is None:
                    ctrl.update(now, pos[t, c])       # initial attachment
                elif self.mode == "handover":
                    ev = ctrl.update(now, pos[t, c])
                    if ev is not None:
                        pending[c], _ = apply_in_flight(
                            pending[c], ev, ctrl.in_flight,
                            stale_penalty=ctrl.stale_penalty,
                            edges=dispatcher.edges,
                        )
                        handovers[c].append(ev)
                        sessions[c].record_handover()
                else:
                    # static pinning still *observes* the decaying signal
                    ctrl.last_rss = float(
                        self.coverage.rss(pos[t, c])[ctrl.serving]
                    )
                serving, rss = ctrl.serving, ctrl.last_rss
                sessions[c].record_coverage(rss)
                (d,) = sessions[c].submit(features=x[t, c])
                outcome, latency = OUTCOME_LOCAL, None
                if d.offload:
                    res = dispatcher.dispatch(
                        now,
                        d.step * n + c,   # fleet-unique step id per client
                        d.estimate,
                        prefer=serving,
                        pin=True,
                        size_bits=self.frame_bits
                        / self.coverage.rate_factor(rss),
                    )
                    outcome, latency = res.outcome, res.latency
                    if res.outcome == OUTCOME_OFFLOADED:
                        sessions[c].record_rtt(res.latency)
                        pending[c].append(
                            PendingResult(
                                t_done=now + res.latency,
                                capture_step=t,
                                step=d.step * n + c,
                                edge=serving,
                            )
                        )
                frame_rows[c].append(
                    {
                        "estimate": d.estimate, "offload": d.offload,
                        "outcome": outcome, "latency": latency,
                        "serving": serving, "rss": rss, "t": now,
                    }
                )

            # deliveries land, then frame t is scored with what the client
            # actually holds (a result offloaded at t arrives strictly later)
            for c in range(n):
                still: List[PendingResult] = []
                for p in pending[c]:
                    if p.t_done <= now:
                        if newest[c] is None or p.capture_step > newest[c]:
                            newest[c] = p.capture_step
                    else:
                        still.append(p)
                pending[c] = still
                row = frame_rows[c][t]
                source, staleness = "weak", None
                acc = float(wa[t, c])
                if newest[c] is not None:
                    s = t - newest[c]
                    if 0 <= s <= self.stale_horizon:
                        covered = float(
                            sa[max(newest[c], 0), c]
                        ) * self.stale_decay ** s
                        if covered > acc:
                            source, staleness, acc = "edge", float(s), covered
                            sessions[c].record_staleness(float(s))
                sessions[c].record_effective_accuracy(acc)
                records.append(
                    MobileStepRecord(
                        client=c, step=t, t=row["t"],
                        estimate=float(row["estimate"]),
                        offload=bool(row["offload"]),
                        outcome=row["outcome"],
                        serving=int(row["serving"]),
                        rss_dbm=float(row["rss"]),
                        latency=row["latency"],
                        source=source, staleness=staleness,
                        effective_accuracy=float(acc),
                    )
                )
            clock.advance(dt)

        dispatcher.poll(clock())
        records.sort(key=lambda r: (r.step, r.client))
        return MobileTrace(
            mode=self.mode,
            in_flight=self.in_flight,
            positions=pos,
            records=records,
            telemetry=[s.telemetry for s in sessions],
            handovers=handovers,
            dispatcher=dispatcher.stats(),
        )


# --------------------------------------------------------------- scenario


@dataclass
class MobileScenario:
    """A fitted engine + seeded synthetic mobile workload, reusable across
    modes so comparisons are equal-everything-but-the-dispatcher."""

    engine: OffloadEngine
    motion: MotionConfig
    coverage: CoverageMap
    features: np.ndarray      # (T, n_clients, F)
    weak_acc: np.ndarray      # (T, n_clients)
    strong_acc: np.ndarray    # (T, n_clients)
    seed: int

    def fleet(self, **kwargs: Any) -> List[EdgeWorker]:
        kwargs.setdefault("seed", self.seed)
        return station_fleet(self.coverage, **kwargs)


def _synth_frames(T: int, n: int, rng: np.random.Generator):
    """Seeded per-frame features with a planted reward direction: the
    strong model's edge over the weak one loads on feature 0, so a fitted
    estimator has signal to rank frames by."""
    x = rng.normal(0.0, 1.0, (T, n, 8)).astype(np.float32)
    gain = 0.45 / (1.0 + np.exp(-1.6 * x[..., 0].astype(np.float64)))
    weak = np.clip(0.35 + 0.06 * rng.normal(size=(T, n)), 0.1, 0.8)
    strong = np.clip(weak + gain, 0.0, 0.98)
    return x, weak, strong


def default_mobile_scenario(
    n_clients: int = 4,
    n_steps: int = 160,
    *,
    n_stations: int = 3,
    seed: int = 0,
    ratio: float = 0.35,
    policy: str = "mobility_aware",
    estimator_epochs: int = 12,
    area: tuple = (1200.0, 600.0),
    speed: float = 14.0,
    device: DeviceLike = "cuda",
) -> MobileScenario:
    """The seeded corridor scenario: ``n_stations`` stations along the
    midline of a wide area, waypoint clients crossing cells.  The engine is
    fitted on ``device`` on a disjoint calibration draw against the TRUE
    reward (strong minus weak accuracy), then switched to ``policy``."""
    from repro_torch.api.reward_model import MLPRewardModel
    from repro_torch.core.estimator import EstimatorConfig

    rng = np.random.default_rng(seed)
    cal_x, cal_w, cal_s = _synth_frames(64, 4, rng)
    engine = OffloadEngine(
        reward_model=MLPRewardModel(
            config=EstimatorConfig(
                hidden=(16,), epochs=estimator_epochs, batch_size=64, seed=seed
            ),
            device=device,
        ),
        ratio=ratio,
    )
    engine.fit(
        features=cal_x.reshape(-1, cal_x.shape[-1]),
        rewards=(cal_s - cal_w).ravel(),
    )
    if policy is not None and policy != engine.policy_name:
        engine = engine.with_policy(policy, ratio=ratio)
    x, weak, strong = _synth_frames(n_steps, n_clients, rng)
    return MobileScenario(
        engine=engine,
        motion=MotionConfig(model="waypoint", area=area, speed=speed),
        coverage=CoverageMap(default_stations(n_stations, area=area)),
        features=x,
        weak_acc=weak,
        strong_acc=strong,
        seed=seed,
    )


def run_mobile_scenario(
    scenario: MobileScenario,
    mode: str = "handover",
    *,
    in_flight: str = "survive",
    ratio: Optional[float] = None,
    obs: Optional[Any] = None,
    **runtime_kwargs: Any,
) -> MobileTrace:
    """One deterministic serve of the scenario in the given mode — the
    equal-budget comparison runs this twice (``"handover"`` vs
    ``"static"``) over the same scenario and seeded trace."""
    runtime = MobileRuntime(
        scenario.engine,
        scenario.coverage,
        scenario.fleet(),
        motion=scenario.motion,
        mode=mode,
        in_flight=in_flight,
        seed=scenario.seed,
        obs=obs,
        **runtime_kwargs,
    )
    return runtime.serve(
        scenario.features, scenario.weak_acc, scenario.strong_acc, ratio=ratio
    )
