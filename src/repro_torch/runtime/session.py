"""`OffloadSession` — the stateful per-stream serve loop over a frozen
:class:`repro_torch.api.OffloadEngine`.

The engine is the *fitted artifact* (features → estimator → rank transform →
policy construction recipe); a session is one device's *stream* through it:

- frames arrive one at a time and are buffered into micro-batches so reward
  scoring runs the engine's batched path (the ``estimator_mlp`` kernel for
  the deployable single-hidden-layer MLP),
- decisions are taken strictly in arrival order through a session-private
  policy instance, so stateful policies (``token_bucket``) carry their
  bucket level across the stream without cross-talk between sessions,
- rolling telemetry tracks the realized offload ratio and (optionally)
  realized rewards against the target budget,
- ``set_ratio`` re-budgets mid-stream without touching the shared engine.

Sessions never mutate the engine: N concurrent streams can serve from one
loaded artifact.

On the card the pending frames stay on the card: the buffer is one
preallocated ``(capacity, F)`` float32 tensor on ``engine.device``, a frame
enters it by a device-to-device copy, and a drain copies its estimates to
the host once, at the policy boundary.  The policy, the telemetry and the
trace are host numpy, as in the JAX package (``repro.runtime.session``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.engine import OffloadEngine
from repro_torch.api.policies import make_policy, policy_context_params
from repro_torch.detection.batch import DetectionsBatch
from repro_torch.obs.metrics import DEFAULT_TIME_BUCKETS, Counter, Gauge, Histogram
from repro_torch.obs.trace import stage

#: initial pending-buffer capacity (rows); grows geometrically — the hot
#: loop never allocates per frame after warmup
_MIN_BUFFER_ROWS = 64


def _host(estimates: Any) -> np.ndarray:
    """Estimates as a flat host float64 array — the one copy (and, on the
    card, the one wait) of a scoring call."""
    if isinstance(estimates, torch.Tensor):
        estimates = estimates.detach().cpu().numpy()
    return np.asarray(estimates, np.float64).ravel()


@dataclass(frozen=True)
class StepDecision:
    """One frame's serve-time decision, in arrival order."""

    step: int
    estimate: float
    offload: bool


@dataclass(frozen=True)
class SessionTelemetry:
    """Snapshot of a session's counters (cumulative + rolling window).

    The video counters (``covered_frames``/``mean_staleness``/
    ``effective_frames``/``mean_effective_accuracy``) stay zero unless the
    stream records temporal state (see ``record_staleness`` /
    ``record_effective_accuracy``); ``as_dict`` keeps them behind
    ``include_video`` so existing consumers see a byte-stable payload.
    The online counters (``mean_rtt``/``mean_bandwidth``/
    ``online_updates``) follow the same pattern behind ``include_online``:
    they stay zero unless the runtime records measured round trips
    (``record_rtt``/``record_bandwidth``) or closed-loop model updates
    (``record_update``).  The fleet counters (``budget_share``/
    ``budget_redistributions``) sit behind ``include_fleet`` the same way:
    zero unless a fleet runtime records the stream's coordinated budget
    state (``record_budget_share``/``record_redistribution``).  The
    mobility counters (``handovers``/``mean_coverage_dbm``) follow suit
    behind ``include_mobility``: zero unless a mobile runtime records edge
    migrations (``record_handover``) or received-signal-strength samples
    (``record_coverage``)."""

    processed: int
    offloaded: int
    realized_ratio: float
    rolling_ratio: float
    mean_estimate: float
    target_ratio: float
    pending: int
    reward_sum: float
    rewards_recorded: int
    covered_frames: int = 0
    mean_staleness: float = 0.0
    effective_frames: int = 0
    mean_effective_accuracy: float = 0.0
    rtt_samples: int = 0
    mean_rtt: float = 0.0
    bandwidth_samples: int = 0
    mean_bandwidth: float = 0.0
    online_updates: int = 0
    budget_share: float = 0.0
    budget_redistributions: int = 0
    handovers: int = 0
    coverage_samples: int = 0
    mean_coverage_dbm: float = 0.0

    def as_dict(
        self,
        include_video: bool = False,
        include_online: bool = False,
        include_fleet: bool = False,
        include_mobility: bool = False,
    ) -> Dict[str, Any]:
        out = {
            "processed": self.processed,
            "offloaded": self.offloaded,
            "realized_ratio": self.realized_ratio,
            "rolling_ratio": self.rolling_ratio,
            "mean_estimate": self.mean_estimate,
            "target_ratio": self.target_ratio,
            "pending": self.pending,
            "reward_sum": self.reward_sum,
            "rewards_recorded": self.rewards_recorded,
        }
        if include_video:
            out.update(
                {
                    "covered_frames": self.covered_frames,
                    "mean_staleness": self.mean_staleness,
                    "effective_frames": self.effective_frames,
                    "mean_effective_accuracy": self.mean_effective_accuracy,
                }
            )
        if include_online:
            out.update(
                {
                    "rtt_samples": self.rtt_samples,
                    "mean_rtt": self.mean_rtt,
                    "bandwidth_samples": self.bandwidth_samples,
                    "mean_bandwidth": self.mean_bandwidth,
                    "online_updates": self.online_updates,
                }
            )
        if include_fleet:
            out.update(
                {
                    "budget_share": self.budget_share,
                    "budget_redistributions": self.budget_redistributions,
                }
            )
        if include_mobility:
            out.update(
                {
                    "handovers": self.handovers,
                    "coverage_samples": self.coverage_samples,
                    "mean_coverage_dbm": self.mean_coverage_dbm,
                }
            )
        return out


class OffloadSession:
    """Stateful per-stream wrapper around a fitted ``OffloadEngine``.

    Parameters
    ----------
    engine : OffloadEngine
        Must be fitted (or loaded); the session builds its own policy
        instance from the engine's calibration scores so per-stream policy
        state is isolated.
    ratio : float or None
        Session-local target offloading ratio; defaults to the engine's.
    micro_batch : int
        Frames buffered before one batched scoring call.  1 = score every
        arrival immediately; larger values trade decision latency for
        scoring throughput through the ``estimator_mlp`` kernel.
    telemetry_window : int
        Length of the rolling window behind ``telemetry.rolling_ratio``.
    clock : callable or None
        Injected time source forwarded to time-based policies
        (``token_bucket``); ignored by stateless policies.  Never the wall
        clock in tests/simulations — see ``repro_torch.runtime.clock.ManualClock``.
    congestion : callable or None
        Zero-arg probe of the predicted uplink sojourn at the best edge,
        forwarded to policies that declare it (``queue_aware``); wired by
        ``OffloadRuntime.open_session`` from its link-fronted fleet.
    state_probe : callable or None
        Zero-arg probe of the observed ``(queue_depth, channel_state)``,
        forwarded to policies that declare it (``value_iteration``).
    staleness : callable or None
        Zero-arg probe of the stream's current edge-result staleness
        (frames since the newest covering result was captured, ``inf`` when
        none), forwarded to policies that declare it
        (``temporal_hysteresis``); wired by the video runtime.
    scene_change : callable or None
        Zero-arg probe of the stream's scene-change score in [0, 1],
        forwarded to policies that declare it (``keyframe``).
    coverage_ttl : callable or None
        Zero-arg probe of the stream's predicted time-to-coverage-loss
        (sim time units until the serving base station's signal drops
        below the usable floor, ``inf`` when not leaving coverage),
        forwarded to policies that declare it (``mobility_aware``); wired
        by the mobile runtime from its motion trace + coverage map.
    tracker : object or None
        Optional temporal state carried with the stream (the video runtime's
        :class:`repro_torch.video.VideoTracker`).  The session itself never calls
        it; it rides here so stream state travels as one object.
    obs : repro_torch.obs.Obs or None
        Observability handle.  The session's telemetry counters *are*
        metric instruments (``repro_torch.obs.metrics``); with an obs handle
        whose metrics plane is on they are created through its registry —
        labeled ``{stream=<name>}`` — so Prometheus/JSON exports see the
        live values with no second accounting path.  With ``obs=None``
        (default) the instruments are standalone objects and nothing else
        changes: ``telemetry.as_dict()`` payloads are byte-identical
        either way.  The tracer plane (when on) receives one
        ``session.flush`` span per scoring drain on track ``tid``; on the
        wall clock (no bound simulation clock) also the engine's stages
        (``engine.features`` / ``engine.estimator`` / ``engine.policy``),
        the same on the device fast path and the buffered one.
    name : str or None
        Stream label used for this session's metric series; auto-numbered
        within the registry when omitted.
    tid : int
        Trace track for this session's spans (runtimes assign one per
        stream).

    Each injected callable reaches the policy constructor only when the
    policy's ``context_params`` declares it — runtime wiring, never part of
    the engine artifact.  So does ``device`` (the engine's), for a policy
    that solves on the device (``value_iteration``).
    """

    def __init__(
        self,
        engine: OffloadEngine,
        *,
        ratio: Optional[float] = None,
        micro_batch: int = 8,
        telemetry_window: int = 64,
        clock: Optional[Callable[[], float]] = None,
        congestion: Optional[Callable[[], float]] = None,
        state_probe: Optional[Callable[[], tuple]] = None,
        staleness: Optional[Callable[[], float]] = None,
        scene_change: Optional[Callable[[], float]] = None,
        coverage_ttl: Optional[Callable[[], float]] = None,
        tracker: Optional[Any] = None,
        obs: Optional[Any] = None,
        name: Optional[str] = None,
        tid: int = 0,
    ):
        if engine.calibration_scores is None:
            raise RuntimeError("OffloadSession over an unfitted engine")
        self.engine = engine
        self.tracker = tracker
        self.micro_batch = max(int(micro_batch), 1)
        self._ratio = float(engine.ratio if ratio is None else ratio)
        kwargs = dict(engine.policy_kwargs)
        accepted = set(policy_context_params(engine.policy_name))
        context = {
            "clock": clock,
            "congestion": congestion,
            "state_probe": state_probe,
            "staleness": staleness,
            "scene_change": scene_change,
            "coverage_ttl": coverage_ttl,
            "device": engine.device,
        }
        kwargs.update(
            {k: v for k, v in context.items() if v is not None and k in accepted}
        )
        # kept so `recalibrate()` can rebuild the policy (same runtime
        # wiring) against refreshed engine calibration scores
        self._policy_build_kwargs = dict(kwargs)
        self.policy = make_policy(
            engine.policy_name, engine.calibration_scores, self._ratio, **kwargs
        )
        # pending features live in one preallocated (capacity, F) tensor on
        # the engine's device — rows [0, _pending_rows) are queued arrivals
        self._buf: Optional[torch.Tensor] = None
        self._pending_rows = 0
        self._next_step = 0                   # arrival index of next submit
        self._window = deque(maxlen=max(int(telemetry_window), 1))
        self._tracer = obs.tracer if obs is not None else None
        self._profiler = obs.profiler if obs is not None else None
        self._tid = int(tid)
        self._flush_t0: Optional[float] = None
        self._init_instruments(
            obs.metrics if obs is not None else None, name
        )

    def _init_instruments(self, reg, name: Optional[str]) -> None:
        """The telemetry counters ARE metric instruments: standalone
        objects when observability is off, registry-backed (walked by the
        exporters) when an obs handle carries a metrics plane.  One write
        path either way — `telemetry` is a view, never a second ledger."""
        if reg is not None:
            opened = reg.counter(
                "repro_sessions_total", help="sessions opened on this registry"
            )
            if name is None:
                name = str(opened.value)
            opened.inc()
            labels: Optional[Dict[str, str]] = {"stream": str(name)}
            counter, gauge, histogram = reg.counter, reg.gauge, reg.histogram
        else:
            labels = None
            counter = lambda n, labels=None, help="": Counter(n)
            gauge = lambda n, labels=None, help="", fn=None: Gauge(n, fn=fn)
            histogram = (
                lambda n, buckets=DEFAULT_TIME_BUCKETS, labels=None, help="":
                Histogram(n, buckets=buckets)
            )
        self._processed = counter(
            "repro_frames_processed_total", labels, help="frames decided"
        )
        self._offloaded = counter(
            "repro_frames_offloaded_total", labels,
            help="frames the policy sent to an edge",
        )
        self._estimate_sum = counter(
            "repro_estimate_sum_total", labels, help="sum of reward estimates"
        )
        self._reward_sum = counter(
            "repro_reward_sum_total", labels, help="sum of realized rewards"
        )
        self._rewards_recorded = counter(
            "repro_rewards_recorded_total", labels, help="realized rewards seen"
        )
        self._staleness_sum = counter(
            "repro_staleness_sum_total", labels,
            help="summed age of propagated edge results (frames)",
        )
        self._covered_frames = counter(
            "repro_covered_frames_total", labels,
            help="frames served from a propagated edge result",
        )
        self._accuracy_sum = counter(
            "repro_effective_accuracy_sum_total", labels,
            help="summed per-frame effective accuracy",
        )
        self._effective_frames = counter(
            "repro_effective_frames_total", labels,
            help="frames with an effective-accuracy sample",
        )
        self._rtt = histogram(
            "repro_offload_rtt", DEFAULT_TIME_BUCKETS, labels,
            help="measured offload round-trip time (sim time units)",
        )
        self._bandwidth_sum = counter(
            "repro_bandwidth_sum_total", labels,
            help="summed measured uplink goodput",
        )
        self._bandwidth_samples = counter(
            "repro_bandwidth_samples_total", labels, help="goodput samples"
        )
        self._online_updates = counter(
            "repro_online_updates_total", labels,
            help="closed-loop model updates visible to this stream",
        )
        self._budget_share = gauge(
            "repro_budget_share", labels,
            help="stream's share of the fleet offload budget",
        )
        self._budget_redistributions = counter(
            "repro_budget_redistributions_total", labels,
            help="fleet budget redistributions applied",
        )
        self._handovers = counter(
            "repro_handovers_total", labels,
            help="mid-stream edge handovers executed",
        )
        self._coverage_sum = counter(
            "repro_coverage_dbm_sum_total", labels,
            help="summed received signal strength samples (dBm)",
        )
        self._coverage_samples = counter(
            "repro_coverage_samples_total", labels,
            help="received signal strength samples",
        )
        self._coverage_dbm = gauge(
            "repro_coverage_dbm", labels,
            help="latest received signal strength from the serving edge (dBm)",
        )
        # live views with zero hot-path cost: evaluated only at collection
        gauge(
            "repro_realized_ratio", labels,
            help="offloaded / processed",
            fn=lambda: (
                self._offloaded.value / self._processed.value
                if self._processed.value else 0.0
            ),
        )
        gauge(
            "repro_pending_frames", labels,
            help="frames buffered awaiting a scoring flush",
            fn=lambda: self._pending_rows,
        )
        gauge(
            "repro_target_ratio", labels,
            help="session target offload ratio",
            fn=lambda: self._ratio,
        )

    # ------------------------------------------------------------- streaming

    def submit(
        self, weak_output: Any = None, *, features: Optional[Any] = None
    ) -> List[StepDecision]:
        """Enqueue one frame.  Returns the decisions flushed by this arrival
        — empty until the micro-batch fills, then ``micro_batch`` decisions
        in arrival order.

        ``features`` is one (F,) row, numpy or a tensor (a row of a device
        tensor enters the buffer by a device-to-device copy).  A
        ``weak_output`` is one frame's weak output: a ``Detections`` as in
        the JAX package, or a one-row ``DetectionsBatch`` as the detector
        leaves it on the card."""
        if features is not None:
            row = self.engine.features(features=features)
            if row.ndim != 1:
                raise ValueError(
                    f"submit() takes one frame; features must be 1-D, got {tuple(row.shape)}"
                )
            self._enqueue(row[None, :])
        else:
            if weak_output is None:
                raise ValueError("pass weak_output or features=")
            frame = weak_output if isinstance(weak_output, DetectionsBatch) else [weak_output]
            block = self.engine.features(frame, tracer=self._work_tracer())
            if block.shape[0] != 1:
                raise ValueError(
                    f"submit() takes one frame; the weak output holds {block.shape[0]}"
                )
            self._enqueue(block)
        if self._pending_rows >= self.micro_batch:
            return self.flush()
        return []

    def submit_batch(
        self,
        weak_outputs: Any = None,
        *,
        features: Optional[Any] = None,
        flush: bool = True,
    ) -> List[StepDecision]:
        """Stream a pre-batched matrix through the session in arrival order.

        Feature extraction happens once for the whole batch (adapters like
        ``detection_boxes`` consume a ``DetectionsBatch``, ``lm_logits``
        batch-shaped logits) and the rows enter the pending queue as ONE
        block — no per-item conversion or row-at-a-time Python.  Scoring
        drains in micro-batch chunks and decisions stay sequential; with
        ``flush=False`` a trailing partial micro-batch stays buffered for
        the next call.

        With ``flush=True`` and nothing already pending, the batch never
        touches the pending buffer at all: it goes through
        ``engine.score_device`` — for a padded ``DetectionsBatch`` under
        the detection extractor + fused MLP that is one ``score_pipeline``
        launch from boxes to estimates, else feature extraction and
        ``estimator_mlp`` — and converts once at the policy boundary.  The
        fused route and the buffered one (feature extraction, then
        ``estimator_mlp`` over micro-batches) sum in different orders, so
        their estimates agree to float32 rounding and only a row that close
        to the threshold can decide differently."""
        tracer = self._work_tracer()
        if flush and self._pending_rows == 0 and (
            features is None or np.ndim(features) == 2  # a tensor's .ndim, no copy
        ):
            if self._tracer is not None:
                # the flush span covers the scoring and the policy
                self._flush_t0 = self._tracer.clock()
            est = _host(self.engine.score_device(weak_outputs, features=features,
                                                 tracer=tracer, host=True))
            if est.size == 0:
                self._flush_t0 = None
                return []
            self._next_step += est.size
            return self._decide(est)
        self._enqueue(self.engine.features(weak_outputs, features=features, tracer=tracer))
        out: List[StepDecision] = []
        if flush:
            out.extend(self.flush())
        else:
            while self._pending_rows >= self.micro_batch:
                out.extend(self._drain(self.micro_batch))
        return out

    def _enqueue(self, block: torch.Tensor) -> None:
        if block.ndim != 2:
            raise ValueError(f"feature blocks must be 2-D, got {tuple(block.shape)}")
        rows = block.shape[0]
        if rows:
            if self._tracer is not None and self._pending_rows == 0:
                # the flush span opens when the first frame starts waiting
                self._flush_t0 = self._tracer.clock()
            need = self._pending_rows + rows
            width = block.shape[1]
            if self._buf is None or self._buf.shape[1] != width:
                cap = max(_MIN_BUFFER_ROWS, self.micro_batch, need)
                self._buf = torch.empty(
                    (cap, width), dtype=torch.float32, device=self.engine.device
                )
            elif need > self._buf.shape[0]:
                grown = torch.empty(
                    (max(need, 2 * self._buf.shape[0]), width),
                    dtype=torch.float32, device=self._buf.device,
                )
                grown[: self._pending_rows] = self._buf[: self._pending_rows]
                self._buf = grown
            self._buf[self._pending_rows : need].copy_(block)
            self._pending_rows = need
        self._next_step += rows

    def flush(self) -> List[StepDecision]:
        """Score everything pending (one kernel call) and decide each frame
        in arrival order through the session policy."""
        return self._drain(self._pending_rows)

    def _drain(self, rows: int) -> List[StepDecision]:
        """Score the first ``rows`` pending frames as one batch and decide
        them in arrival order."""
        if rows <= 0 or not self._pending_rows:
            return []
        rows = min(rows, self._pending_rows)
        head = self._buf[:rows]
        prof = self._profiler
        # device scoring; one host copy at the policy boundary, which waits
        # for the kernel, so the ``session.score`` phase ends after the work
        tracer = self._work_tracer()
        if prof is None:
            estimates = _host(self.engine.score_device(features=head, tracer=tracer, host=True))
        else:
            t0 = prof.begin()
            estimates = _host(self.engine.score_device(features=head, tracer=tracer, host=True))
            prof.add("session.score", t0)
        rem = self._pending_rows - rows
        if rem:
            # source and destination overlap: copy from a clone
            self._buf[:rem].copy_(self._buf[rows : self._pending_rows].clone())
        self._pending_rows = rem
        if prof is None:
            return self._decide(estimates)
        t0 = prof.begin()
        out = self._decide(estimates)
        prof.add("session.decide", t0)
        return out

    def submit_scored(self, estimates: Any) -> List[StepDecision]:
        """Decide a block of already-scored frames in arrival order — the
        seam for runtimes that score all streams centrally and fan the
        estimates out to per-stream sessions.  Mixing with buffered unscored
        arrivals would let scored frames jump the queue, so pending rows
        must be flushed first."""
        if self._pending_rows:
            raise RuntimeError(
                f"submit_scored() with {self._pending_rows} unscored frames "
                "pending — flush() first"
            )
        est = _host(estimates)
        self._next_step += est.size
        return self._decide(est)

    def _work_tracer(self):
        """The tracer for the engine's stages: the session's, while it runs
        on the wall clock (a simulation's trace keeps only its own spans)."""
        tr = self._tracer
        return tr if tr is not None and tr.wall else None

    def _decide(self, estimates: np.ndarray) -> List[StepDecision]:
        """Run already-scored estimates through the session policy in
        arrival order and account them in the telemetry."""
        with stage(self._work_tracer(), "engine.policy"):
            if getattr(self.policy, "batch_budget", False):
                # a per-batch budget (topk) would make streaming decisions
                # depend on micro-batch/flush boundaries (and offload nothing
                # at micro_batch=1) — such policies keep the per-item
                # semantics of decide()
                offload = np.fromiter(
                    (self.policy.decide(float(e)) for e in estimates),
                    dtype=bool, count=len(estimates),
                )
            else:
                # decide_batch is buffer-invariant here: vectorized for
                # threshold, internally sequential for token_bucket
                offload = np.asarray(self.policy.decide_batch(estimates), bool)
        # the queue held exactly the arrivals not yet decided, so the drained
        # rows are the arrival indices trailing the still-pending ones
        first = self._next_step - self._pending_rows - len(estimates)
        n_off = int(offload.sum())
        self._processed.inc(len(estimates))
        self._offloaded.inc(n_off)
        self._estimate_sum.inc(float(estimates.sum()))
        self._window.extend(bool(o) for o in offload)
        if self._tracer is not None:
            now = self._tracer.clock()
            t0 = now if self._flush_t0 is None else self._flush_t0
            self._tracer.add_span(
                "session.flush", t0, now, tid=self._tid,
                args={"frames": len(estimates), "offloaded": n_off},
            )
            self._flush_t0 = now if self._pending_rows else None
        return [
            StepDecision(step=first + i, estimate=float(est), offload=bool(off))
            for i, (est, off) in enumerate(zip(estimates, offload))
        ]

    # --------------------------------------------------------------- control

    def set_ratio(self, ratio: float) -> None:
        """Mid-stream budget change — affects only this session's policy."""
        self._ratio = float(ratio)
        self.policy.set_ratio(self._ratio)

    def recalibrate(self, calibration_scores: Optional[np.ndarray] = None) -> None:
        """Refresh the session policy's calibration distribution mid-stream
        (closed-loop adaptation: the engine's scores just moved).  Stateful
        policies with a sorted ``_cal`` array (the netsim/video/online
        controllers) are patched in place so integral budget state survives;
        anything else is rebuilt with the same runtime wiring."""
        cal = (
            self.engine.calibration_scores
            if calibration_scores is None
            else calibration_scores
        )
        if cal is None:
            raise RuntimeError("recalibrate() with no calibration scores")
        sorted_cal = np.sort(np.asarray(cal, np.float64))
        if hasattr(self.policy, "_cal"):
            self.policy._cal = sorted_cal
        else:
            self.policy = make_policy(
                self.engine.policy_name,
                sorted_cal,
                self._ratio,
                **self._policy_build_kwargs,
            )

    @property
    def ratio(self) -> float:
        return self._ratio

    def record_reward(self, reward: float) -> None:
        """Account a realized per-frame reward (e.g. observed quality delta)
        into the session telemetry."""
        self._reward_sum.inc(float(reward))
        self._rewards_recorded.inc()

    def record_staleness(self, staleness: float) -> None:
        """Account one frame served from a propagated (stale) edge result;
        ``staleness`` is the age of that result in frames."""
        self._staleness_sum.inc(float(staleness))
        self._covered_frames.inc()

    def record_effective_accuracy(self, accuracy: float) -> None:
        """Account one frame's effective accuracy — the AP of whatever was
        actually served for it (weak output or propagated edge result)."""
        self._accuracy_sum.inc(float(accuracy))
        self._effective_frames.inc()

    def record_rtt(self, rtt: float) -> None:
        """Account one completed offload's measured round trip."""
        self._rtt.observe(float(rtt))

    def record_bandwidth(self, bandwidth: float) -> None:
        """Account one measured uplink goodput sample (bits per time unit)."""
        self._bandwidth_sum.inc(float(bandwidth))
        self._bandwidth_samples.inc()

    def record_update(self) -> None:
        """Account one closed-loop model update visible to this stream."""
        self._online_updates.inc()

    def record_budget_share(self, share: float) -> None:
        """Stamp the stream's current share of the fleet-wide offload
        budget (stamped by :class:`repro_torch.fleet.FleetRuntime`)."""
        self._budget_share.set(float(share))

    def record_redistribution(self) -> None:
        """Account one fleet budget redistribution applied to this stream."""
        self._budget_redistributions.inc()

    def record_handover(self) -> None:
        """Account one mid-stream edge migration (serving edge changed)."""
        self._handovers.inc()

    def record_coverage(self, dbm: float) -> None:
        """Account one received-signal-strength sample from the stream's
        serving base station (dBm; stamped by
        :class:`repro_torch.mobility.MobileRuntime`)."""
        self._coverage_sum.inc(float(dbm))
        self._coverage_samples.inc()
        self._coverage_dbm.set(float(dbm))

    # ------------------------------------------------------------- telemetry

    @property
    def telemetry(self) -> SessionTelemetry:
        # a *view* over the metric instruments: every field derives from
        # instrument state the same way the old scalar counters did, so
        # payloads are byte-stable with observability on, off, or absent
        n = self._processed.value
        offloaded = self._offloaded.value
        covered = self._covered_frames.value
        effective = self._effective_frames.value
        bw_samples = self._bandwidth_samples.value
        roll = list(self._window)
        return SessionTelemetry(
            processed=n,
            offloaded=offloaded,
            realized_ratio=offloaded / n if n else 0.0,
            rolling_ratio=float(np.mean(roll)) if roll else 0.0,
            mean_estimate=self._estimate_sum.value / n if n else 0.0,
            target_ratio=self._ratio,
            pending=self._pending_rows,
            reward_sum=float(self._reward_sum.value),
            rewards_recorded=self._rewards_recorded.value,
            covered_frames=covered,
            mean_staleness=(
                self._staleness_sum.value / covered if covered else 0.0
            ),
            effective_frames=effective,
            mean_effective_accuracy=(
                self._accuracy_sum.value / effective if effective else 0.0
            ),
            rtt_samples=self._rtt.n,
            mean_rtt=self._rtt.mean,
            bandwidth_samples=bw_samples,
            mean_bandwidth=(
                self._bandwidth_sum.value / bw_samples if bw_samples else 0.0
            ),
            online_updates=self._online_updates.value,
            budget_share=float(self._budget_share.value),
            budget_redistributions=self._budget_redistributions.value,
            handovers=self._handovers.value,
            coverage_samples=self._coverage_samples.value,
            mean_coverage_dbm=(
                self._coverage_sum.value / self._coverage_samples.value
                if self._coverage_samples.value else 0.0
            ),
        )
