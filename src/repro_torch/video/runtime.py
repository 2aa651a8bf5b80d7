"""Temporal offloading over video streams — the serve-time driver.

``VideoRuntime`` extends :class:`repro_torch.runtime.simulate.OffloadRuntime`
with ``serve_clip``: B parallel camera streams step frame-locked through
one engine + edge fleet, and — unlike the per-image driver — offloaded
results have a *temporal afterlife*:

- an admitted offload's strong result comes back after the netsim link's
  queue + transmit + service delay, so it is already ``latency`` frames
  stale on arrival;
- every subsequent frame within ``max_stale`` of the newest delivered
  result is answered by *propagating* that result onto the current frame
  through the stream's tracker (:meth:`~repro_torch.video.track.VideoTracker
  .propagate`) instead of the weak output;
- each frame's **effective accuracy** — the AP of whatever was actually
  served (weak output or propagated edge result) against ground truth,
  via the existing AP engine — lands on the per-step trace, along with
  the serving source and staleness.

Temporal probes are wired per stream exactly like the netsim congestion
probes: ``temporal_hysteresis`` sees the stream's staleness (frames since
the newest covering result was captured, counting admitted in-flight
offloads — a frame about to be covered is worth less), ``keyframe`` sees
the scene-change score (tracker churn + weak-output frame difference).

``default_video_scenario`` builds the seeded 8-stream congested-fleet
acceptance scenario: the engine is fitted on a held-out calibration clip
with true per-frame rewards (strong AP − weak AP, rank-transformed), the
serve clip runs behind Gilbert–Elliott uplinks.  Its headline claim —
``temporal_hysteresis`` beats the per-image ``threshold`` policy in mean
effective accuracy at equal realized offload ratio — is asserted by
``tests/test_video.py`` in the JAX package and ``tests/test_torch_video.py``
here.

The port of ``repro.video.runtime``.  Everything a ``serve_clip`` runs on the
device runs on the engine's: the weak clip's features (one extraction over
the flattened clip), the tracker (one step a frame over every stream, on the
card one ``matrix`` launch of ``iou_matrix_batch``), each session's scoring
(``micro_batch=1``: one ``estimator_mlp`` launch a frame) and the scoring of
what was served (one ``match_batch``, on the card one ``match`` launch over
every frame of every stream).  The policies, the propagation and the
records are host numpy, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.api.engine import OffloadEngine
from repro_torch.detection.batch import (
    DetectionsBatch,
    GroundTruthBatch,
    match_batch,
    to_image_evals,
)
from repro_torch.detection.map_engine import APAccumulator, Detections, GroundTruth
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.runtime.dispatch import OUTCOME_LOCAL, OUTCOME_OFFLOADED
from repro_torch.runtime.simulate import (
    OffloadRuntime,
    StepRecord,
    StreamTrace,
    default_congested_fleet,
)
from repro_torch.video.features import frame_difference, scene_change_score
from repro_torch.video.scene import (
    STRONG_PROFILE,
    WEAK_PROFILE,
    DetectionClip,
    SceneConfig,
    VideoClip,
    generate_clip,
    synthesize_detections,
)
from repro_torch.video.track import TrackerConfig, VideoTracker, _iou_f32


def fuse_detections(
    primary: Detections, secondary: Detections, iou_thresh: float = 0.5
) -> Detections:
    """Serve-time fusion of a propagated edge result with the current weak
    output (SmartDet-style): every primary (edge) detection is kept, and
    secondary (weak) detections survive only where no primary box overlaps
    them (IoU < ``iou_thresh``, class-agnostic) — the weak output fills in
    objects the stale result cannot know about (entries, lost tracks) while
    the edge result owns everything it still covers."""
    if not len(primary):
        return secondary
    if not len(secondary):
        return primary
    iou = _iou_f32(secondary.boxes, primary.boxes)
    keep = iou.max(axis=1) < iou_thresh
    return Detections(
        np.concatenate([primary.boxes, secondary.boxes[keep]]),
        np.concatenate([primary.scores, secondary.scores[keep]]),
        np.concatenate([primary.classes, secondary.classes[keep]]),
    )


def frame_accuracies(
    dets: Sequence[Detections],
    gts: Sequence[GroundTruth],
    iou_thresholds: Sequence[float] = (0.5,),
    *,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Per-frame mAP of each detection set against its own ground truth —
    one batched ``match_batch`` call on ``device`` (on the card one launch of
    the IoU family's ``match`` route), then the standard AP engine per
    frame."""
    if len(dets) != len(gts):
        raise ValueError(f"{len(dets)} detection sets vs {len(gts)} ground truths")
    if not dets:
        return np.zeros(0)
    db = DetectionsBatch.from_list(list(dets), device=device)
    gb = GroundTruthBatch.from_list(list(gts), device=device)
    evs = to_image_evals(db, gb, match_batch(db, gb, iou_thresholds))
    out = np.empty(len(evs))
    for i, ev in enumerate(evs):
        acc = APAccumulator(iou_thresholds)
        acc.add(ev)
        out[i] = acc.map()
    return out


@dataclass
class VideoFleetTrace:
    """Per-stream :class:`StreamTrace` records + fleet-level aggregates of
    one ``serve_clip`` run."""

    streams: List[StreamTrace]
    dispatcher: Dict[str, Any]

    @property
    def n_streams(self) -> int:
        return len(self.streams)

    @property
    def n_frames(self) -> int:
        return len(self.streams[0].records) if self.streams else 0

    def realized_ratio(self) -> float:
        """Fraction of frames the policies spent offload budget on (admitted
        or saturated), over all streams."""
        n = sum(len(s.records) for s in self.streams)
        off = sum(sum(r.offload for r in s.records) for s in self.streams)
        return off / n if n else 0.0

    def mean_effective_accuracy(self) -> float:
        accs = [
            r.effective_accuracy
            for s in self.streams
            for r in s.records
            if r.effective_accuracy is not None
        ]
        return float(np.mean(accs)) if accs else 0.0

    def outcome_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for s in self.streams:
            for outcome, n in s.outcome_counts().items():
                counts[outcome] = counts.get(outcome, 0) + n
        return counts

    def staleness_profile(self) -> Dict[str, float]:
        stale = [
            r.staleness
            for s in self.streams
            for r in s.records
            if r.staleness is not None
        ]
        n = sum(len(s.records) for s in self.streams)
        return {
            "covered_fraction": len(stale) / n if n else 0.0,
            "mean_staleness": float(np.mean(stale)) if stale else 0.0,
        }

    def summary(self) -> Dict[str, Any]:
        return {
            "streams": self.n_streams,
            "frames": self.n_frames,
            "realized_ratio": self.realized_ratio(),
            "mean_effective_accuracy": self.mean_effective_accuracy(),
            "outcomes": self.outcome_counts(),
            "staleness": self.staleness_profile(),
            "dispatcher": self.dispatcher,
        }


class VideoRuntime(OffloadRuntime):
    """The served video system: engine + fleet + per-stream temporal state."""

    def serve_clip(
        self,
        weak: DetectionClip,
        strong: DetectionClip,
        clip: VideoClip,
        *,
        features: Optional[np.ndarray] = None,
        ratio: Optional[float] = None,
        max_stale: float = 6.0,
        fuse: bool = True,
        arrival_period: float = 1.0,
        tracker_config: Optional[TrackerConfig] = None,
        iou_thresholds: Sequence[float] = (0.5,),
    ) -> VideoFleetTrace:
        """Serve every stream of a clip end to end; deterministic under the
        seeded fleet.  ``weak`` is what the device sees each frame,
        ``strong`` what an edge would answer for a frame it receives,
        ``clip`` the ground truth the effective output is scored against.

        ``features`` optionally overrides feature extraction with a
        precomputed ``(T * B, F)`` time-major matrix (required when the
        engine has no feature extractor).  The features, the tracker and the
        accuracy scoring run on the engine's device."""
        T, B = weak.n_frames, weak.n_streams
        device = self.engine.device
        if (strong.n_frames, strong.n_streams) != (T, B) or (
            clip.n_frames, clip.n_streams
        ) != (T, B):
            raise ValueError(
                f"clip shape mismatch: weak {(T, B)}, strong "
                f"{(strong.n_frames, strong.n_streams)}, gt "
                f"{(clip.n_frames, clip.n_streams)}"
            )
        if features is None:
            if self.engine.feature_extractor is None:
                raise ValueError(
                    "engine has no feature extractor; pass features=(T*B, F)"
                )
            x = self.engine.features(weak.flatten(device=device))
        else:
            x = self.engine.features(features=features)
        if x.shape[0] != T * B:
            raise ValueError(f"features rows {x.shape[0]} != T*B = {T * B}")

        tracker = VideoTracker(B, tracker_config, device=device)
        streams = [
            {
                "frame": 0,
                "cover_frame": None,   # newest admitted capture (incl. in flight)
                "delivered": None,     # newest delivered capture frame
                "pending": [],         # (t_done, capture_frame) in flight
                "prev": None,          # previous weak Detections
                "scene": 0.0,
            }
            for _ in range(B)
        ]

        def make_staleness(st):
            def probe() -> float:
                if st["cover_frame"] is None:
                    return float("inf")
                return float(st["frame"] - st["cover_frame"])

            return probe

        def make_scene(st):
            return lambda: float(st["scene"])

        sessions = [
            self.open_session(
                ratio=ratio,
                micro_batch=1,
                staleness=make_staleness(st),
                scene_change=make_scene(st),
                tracker=tracker,
                name=str(b),
                tid=1 + b,
            )
            for b, st in enumerate(streams)
        ]
        prof = self.obs.profiler if self.obs is not None else None

        rows: List[List[Dict[str, Any]]] = [[] for _ in range(B)]
        served: List[List[Detections]] = [[] for _ in range(B)]
        for t in range(T):
            now = self.clock()
            self.dispatcher.poll(now)
            if prof is None:
                tf = tracker.update(weak.frame(t, device=device))
            else:
                _pt0 = prof.begin()
                tf = tracker.update(weak.frame(t, device=device))
                prof.add("video.track", _pt0)
                _pt0 = prof.begin()
            churn = tf.churn()
            for b, (st, session) in enumerate(zip(streams, sessions)):
                st["frame"] = t
                still = []
                for t_done, t0 in st["pending"]:
                    if t_done <= now:
                        if st["delivered"] is None or t0 > st["delivered"]:
                            st["delivered"] = t0
                    else:
                        still.append((t_done, t0))
                st["pending"] = still
                cur = weak.det(t, b)
                st["scene"] = scene_change_score(
                    frame_difference(st["prev"], cur)["overlap"], float(churn[b])
                )
                st["prev"] = cur

                d = session.submit(features=x[t * B + b])[0]
                edge = latency = bd = None
                outcome = OUTCOME_LOCAL
                if d.offload:
                    res = self.dispatcher.dispatch(now, t * B + b, d.estimate)
                    self._record_offload(now, res)
                    outcome, edge, latency, bd = (
                        res.outcome, res.edge, res.latency, res.breakdown,
                    )
                    if res.outcome == OUTCOME_OFFLOADED:
                        session.record_rtt(res.latency)
                        st["pending"].append((now + res.latency, t))
                        if st["cover_frame"] is None or t > st["cover_frame"]:
                            st["cover_frame"] = t
                t0 = st["delivered"]
                if t0 is not None and t - t0 <= max_stale:
                    eff = tracker.propagate(strong.det(t0, b), t0, t, stream=b)
                    if fuse:
                        eff = fuse_detections(eff, cur)
                    source, staleness = "edge", float(t - t0)
                else:
                    eff, source, staleness = cur, "weak", None
                served[b].append(eff)
                rows[b].append(
                    dict(
                        step=t, t_arrival=now, t_decision=now,
                        estimate=d.estimate, offload=d.offload, edge=edge,
                        latency=latency, outcome=outcome,
                        queue_delay=bd.queue if bd is not None else None,
                        transmit_delay=bd.transmit if bd is not None else None,
                        service_delay=bd.service if bd is not None else None,
                        source=source, staleness=staleness,
                    )
                )
            if prof is not None:
                prof.add("video.serve_frames", _pt0)
            self.clock.advance(arrival_period)
        self.dispatcher.poll(self.clock())

        # score what was actually served, one batched matcher call
        if prof is not None:
            _pt0 = prof.begin()
        acc = frame_accuracies(
            [d for per in served for d in per],
            [clip.gt(t, b) for b in range(B) for t in range(T)],
            iou_thresholds,
            device=device,
        ).reshape(B, T)
        if prof is not None:
            prof.add("video.score_accuracy", _pt0)
        traces = []
        for b, session in enumerate(sessions):
            records = []
            for t, row in enumerate(rows[b]):
                if row["staleness"] is not None:
                    session.record_staleness(row["staleness"])
                session.record_effective_accuracy(float(acc[b, t]))
                records.append(
                    StepRecord(effective_accuracy=float(acc[b, t]), **row)
                )
            traces.append(
                StreamTrace(
                    records=records,
                    telemetry=session.telemetry,
                    dispatcher=self.dispatcher.stats(),
                )
            )
        return VideoFleetTrace(streams=traces, dispatcher=self.dispatcher.stats())


# ------------------------------------------------------- seeded scenario


@dataclass
class VideoScenario:
    """A fully seeded video workload: fitted engine, serve clip, the weak /
    strong detection streams, and the congested fleet recipe."""

    engine: OffloadEngine
    clip: VideoClip
    weak: DetectionClip
    strong: DetectionClip
    seed: int = 0
    fleet_size: int = 3
    transmit_time: float = 1.0
    queue_depth: int = 6
    max_stale: float = 6.0

    def fleet(self):
        """A fresh seeded congested fleet (links carry per-run state, so
        every simulation builds its own)."""
        return default_congested_fleet(
            self.fleet_size,
            seed=self.seed,
            transmit_time=self.transmit_time,
            queue_depth=self.queue_depth,
        )


def default_video_scenario(
    n_streams: int = 8,
    n_frames: int = 96,
    *,
    seed: int = 0,
    scene: Optional[SceneConfig] = None,
    calibration_frames: int = 48,
    estimator_epochs: int = 15,
    ratio: float = 0.3,
    device: DeviceLike = "cuda",
) -> VideoScenario:
    """The seeded congested-fleet video scenario (8 streams by default).

    The engine is fitted the paper's way, on held-out calibration data: a
    disjoint clip's weak outputs are featurized through
    ``DetectionBoxFeatures`` and regressed (rank-transformed) onto the TRUE
    per-frame reward — strong AP minus weak AP, both against ground truth
    through the batched matcher.  The engine, the matching and the fit run
    on ``device``."""
    from repro_torch.api.features import DetectionBoxFeatures
    from repro_torch.api.reward_model import MLPRewardModel
    from repro_torch.core.estimator import EstimatorConfig
    from repro_torch.data.shapes import NUM_CLASSES

    cfg = scene or SceneConfig()
    cal_clip = generate_clip(4, calibration_frames, seed=seed + 101, config=cfg)
    cal_weak = synthesize_detections(cal_clip, WEAK_PROFILE, seed=seed + 102)
    cal_strong = synthesize_detections(cal_clip, STRONG_PROFILE, seed=seed + 103)
    gts = [
        cal_clip.gt(t, b)
        for t in range(cal_clip.n_frames)
        for b in range(cal_clip.n_streams)
    ]
    weak_list = [
        cal_weak.det(t, b)
        for t in range(cal_clip.n_frames)
        for b in range(cal_clip.n_streams)
    ]
    strong_list = [
        cal_strong.det(t, b)
        for t in range(cal_clip.n_frames)
        for b in range(cal_clip.n_streams)
    ]
    rewards = frame_accuracies(strong_list, gts, device=device) - frame_accuracies(
        weak_list, gts, device=device
    )
    engine = OffloadEngine(
        feature_extractor=DetectionBoxFeatures(
            num_classes=NUM_CLASSES, top_k=8, image_size=float(cfg.size), device=device
        ),
        reward_model=MLPRewardModel(
            config=EstimatorConfig(
                hidden=(32,), epochs=estimator_epochs, batch_size=64, seed=seed
            ),
            device=device,
        ),
        ratio=ratio,
    )
    engine.fit(cal_weak.flatten(device=device), rewards)

    clip = generate_clip(n_streams, n_frames, seed=seed, config=cfg)
    return VideoScenario(
        engine=engine,
        clip=clip,
        weak=synthesize_detections(clip, WEAK_PROFILE, seed=seed + 1),
        strong=synthesize_detections(clip, STRONG_PROFILE, seed=seed + 2),
        seed=seed,
    )


def run_video_scenario(
    scenario: VideoScenario,
    policy: Optional[str] = None,
    *,
    ratio: Optional[float] = None,
    policy_kwargs: Optional[Dict[str, Any]] = None,
    strategy: str = "least_loaded",
    seed: Optional[int] = None,
) -> VideoFleetTrace:
    """One deterministic serve of the scenario under a policy (``None``
    keeps the engine's own).  Equal-budget comparisons run this repeatedly
    with different ``policy`` / ``ratio`` over the same scenario, on the
    scenario engine's device."""
    engine = scenario.engine
    if policy is not None:
        engine = engine.with_policy(
            policy,
            ratio=ratio if ratio is not None else engine.ratio,
            policy_kwargs=policy_kwargs,
        )
    runtime = VideoRuntime(
        engine,
        scenario.fleet(),
        strategy=strategy,
        seed=scenario.seed if seed is None else seed,
    )
    return runtime.serve_clip(
        scenario.weak,
        scenario.strong,
        scenario.clip,
        ratio=ratio,
        max_stale=scenario.max_stale,
    )
