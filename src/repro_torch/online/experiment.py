"""The distribution-shift headline experiment: adaptive vs frozen engines.

Scenario: B camera streams served through one engine + edge fleet, with a
**mid-stream distribution shift** in the weak detector — the set of object
classes it localizes badly flips at ``shift_at`` (pre-shift hard classes
become easy and vice versa), modeled by the class-conditional
``DetectorProfile.hard_classes`` noise in the seeded scene generator.  The
flip changes *which frames are worth offloading*: the reward estimator was
fit pre-shift, so the frozen engine keeps spending its budget on frames
that no longer benefit, while the adaptive engine relearns from the
realized strong−weak rewards its own offloads return.

Both arms run the same ``queue_aware`` policy (its integral budget
controller pins the realized offload ratio to the target, making the
comparison equal-budget by construction); the adaptive arm additionally
feeds every completed offload back through :class:`AdaptiveEngine`.
Effective accuracy is per-frame: the strong detector's AP where the frame
was actually offloaded, the weak detector's AP otherwise.

The headline claim — asserted by ``tests/test_online.py`` in the JAX
package and ``tests/test_torch_online.py`` here — is that the adaptive arm's
*post-shift* mean effective accuracy strictly exceeds the frozen arm's at
equal realized offload ratio.

The port of ``repro.online.experiment``: the scenario's engine, its
matching and features live on ``device``; a run serves on the scenario
engine's device (one ``estimator_mlp`` launch a frame on the card, since
every session scores at ``micro_batch=1``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.engine import OffloadEngine
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.online.engine import AdaptiveEngine, OnlineConfig, clone_engine
from repro_torch.runtime.dispatch import OUTCOME_OFFLOADED
from repro_torch.runtime.edge import EdgeLatencyModel, EdgeWorker
from repro_torch.runtime.simulate import OffloadRuntime
from repro_torch.video.runtime import frame_accuracies
from repro_torch.video.scene import (
    STRONG_PROFILE,
    DetectionClip,
    DetectorProfile,
    SceneConfig,
    generate_clip,
    synthesize_detections,
)

#: the weak detector's two regimes: same global noise, opposite hard sets
PRE_SHIFT_PROFILE = DetectorProfile(
    box_jitter=0.8, flip=0.05, miss=0.08, hallucinate=0.05,
    score_lo=0.4, score_hi=0.9,
    hard_classes=(0, 1, 2, 3), hard_box_jitter=6.0,
)
POST_SHIFT_PROFILE = DetectorProfile(
    box_jitter=0.8, flip=0.05, miss=0.08, hallucinate=0.05,
    score_lo=0.4, score_hi=0.9,
    hard_classes=(4, 5, 6, 7), hard_box_jitter=6.0,
)


@dataclass
class ShiftScenario:
    """A fully seeded shift workload: engine fitted on the pre-shift
    distribution, spliced weak stream, and precomputed per-frame APs."""

    engine: OffloadEngine
    features: torch.Tensor  # (T*B, F) time-major, row t*B + b, on the engine's device
    weak_ap: np.ndarray  # (T, B) weak detector AP vs ground truth
    strong_ap: np.ndarray  # (T, B) strong detector AP vs ground truth
    shift_at: int
    seed: int = 0
    fleet_size: int = 3
    edge_latency: float = 2.0

    @property
    def n_frames(self) -> int:
        return self.weak_ap.shape[0]

    @property
    def n_streams(self) -> int:
        return self.weak_ap.shape[1]

    @property
    def rewards(self) -> np.ndarray:
        """(T, B) realized offload reward: strong − weak per-frame AP."""
        return self.strong_ap - self.weak_ap

    def fleet(self) -> List[EdgeWorker]:
        """A fresh modest fleet: latency-only (no links, no rate limits),
        so offloads admit and the experiment isolates the *decision*
        quality — but results still arrive ``edge_latency`` frames late,
        so supervision is delayed like in deployment."""
        return [
            EdgeWorker(
                f"edge{i}",
                capacity=max(self.n_streams, 4),
                latency=EdgeLatencyModel(base=self.edge_latency, jitter=0.1),
                seed=self.seed + i,
            )
            for i in range(self.fleet_size)
        ]


def default_shift_scenario(
    n_streams: int = 4,
    n_frames: int = 160,
    shift_at: int = 64,
    *,
    seed: int = 0,
    ratio: float = 0.35,
    calibration_frames: int = 48,
    estimator_epochs: int = 15,
    scene: Optional[SceneConfig] = None,
    device: DeviceLike = "cuda",
) -> ShiftScenario:
    """Build the seeded headline scenario.

    The engine is fitted the paper's way on a held-out pre-shift
    calibration clip (true strong−weak rewards, rank-transformed); the
    serve clip's weak stream is spliced: :data:`PRE_SHIFT_PROFILE` frames
    before ``shift_at``, :data:`POST_SHIFT_PROFILE` after.  Both profiles
    draw identical noise streams, so the shift is purely the hard-class
    flip.  The engine, the matching and the features run on ``device``."""
    from repro_torch.api.features import DetectionBoxFeatures
    from repro_torch.api.reward_model import MLPRewardModel
    from repro_torch.core.estimator import EstimatorConfig
    from repro_torch.data.shapes import NUM_CLASSES

    if not 0 < shift_at < n_frames:
        raise ValueError(f"need 0 < shift_at < n_frames, got {shift_at}/{n_frames}")
    cfg = scene or SceneConfig()

    # ---- calibration on the pre-shift distribution
    cal_clip = generate_clip(4, calibration_frames, seed=seed + 101, config=cfg)
    cal_weak = synthesize_detections(cal_clip, PRE_SHIFT_PROFILE, seed=seed + 102)
    cal_strong = synthesize_detections(cal_clip, STRONG_PROFILE, seed=seed + 103)
    order = [
        (t, b)
        for t in range(cal_clip.n_frames)
        for b in range(cal_clip.n_streams)
    ]
    gts = [cal_clip.gt(t, b) for t, b in order]
    cal_rewards = frame_accuracies(
        [cal_strong.det(t, b) for t, b in order], gts, device=device
    ) - frame_accuracies([cal_weak.det(t, b) for t, b in order], gts, device=device)
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
        policy="queue_aware",
        ratio=ratio,
    )
    engine.fit(cal_weak.flatten(device=device), cal_rewards)

    # ---- serve clip with the mid-stream splice
    clip = generate_clip(n_streams, n_frames, seed=seed, config=cfg)
    weak_pre = synthesize_detections(clip, PRE_SHIFT_PROFILE, seed=seed + 1)
    weak_post = synthesize_detections(clip, POST_SHIFT_PROFILE, seed=seed + 1)
    weak = DetectionClip.from_frames(
        [
            [
                (weak_pre if t < shift_at else weak_post).det(t, b)
                for b in range(n_streams)
            ]
            for t in range(n_frames)
        ]
    )
    strong = synthesize_detections(clip, STRONG_PROFILE, seed=seed + 2)
    serve_order = [(t, b) for t in range(n_frames) for b in range(n_streams)]
    serve_gts = [clip.gt(t, b) for t, b in serve_order]
    weak_ap = frame_accuracies(
        [weak.det(t, b) for t, b in serve_order], serve_gts, device=device
    ).reshape(n_frames, n_streams)
    strong_ap = frame_accuracies(
        [strong.det(t, b) for t, b in serve_order], serve_gts, device=device
    ).reshape(n_frames, n_streams)
    return ShiftScenario(
        engine=engine,
        features=engine.features(weak.flatten(device=device)),
        weak_ap=weak_ap,
        strong_ap=strong_ap,
        shift_at=shift_at,
        seed=seed,
    )


@dataclass
class ShiftRunResult:
    """One arm's full trajectory over the shift scenario."""

    effective: np.ndarray  # (T, B) per-frame effective accuracy
    offload: np.ndarray  # (T, B) decision mask (budget spent)
    served_strong: np.ndarray  # (T, B) frames actually answered by an edge
    shift_at: int
    updates: Dict[str, int] = field(default_factory=dict)
    telemetry: List[Dict[str, Any]] = field(default_factory=list)
    adaptive: Optional[AdaptiveEngine] = None  # the adapted engine (adaptive arm)

    def realized_ratio(self) -> float:
        return float(np.mean(self.offload))

    def mean_effective(self, *, post_shift: Optional[bool] = None) -> float:
        if post_shift is None:
            return float(np.mean(self.effective))
        sl = slice(self.shift_at, None) if post_shift else slice(0, self.shift_at)
        return float(np.mean(self.effective[sl]))

    def summary(self) -> Dict[str, Any]:
        return {
            "realized_ratio": self.realized_ratio(),
            "mean_effective": self.mean_effective(),
            "pre_shift_effective": self.mean_effective(post_shift=False),
            "post_shift_effective": self.mean_effective(post_shift=True),
            "updates": dict(self.updates),
        }


def run_shift_scenario(
    scenario: ShiftScenario,
    *,
    adaptive: bool = False,
    config: Optional[OnlineConfig] = None,
    ratio: Optional[float] = None,
    seed: Optional[int] = None,
) -> ShiftRunResult:
    """Serve the scenario end to end with one arm.

    The scenario's engine is cloned per run (adaptive runs mutate model
    params in place), so arms are independent and the scenario reusable.
    Deterministic: the manual clock drives everything, completed offloads
    feed back in delivery order, and the update cadence is counted in
    observations.  Feedback to the adaptive arm carries host copies of the
    offloaded frames' feature rows."""
    T, B = scenario.n_frames, scenario.n_streams
    engine = clone_engine(scenario.engine)
    ada = AdaptiveEngine(engine, config) if adaptive else None
    runtime = OffloadRuntime(
        engine,
        scenario.fleet(),
        strategy="least_loaded",
        seed=scenario.seed if seed is None else seed,
    )
    sessions = [runtime.open_session(ratio=ratio, micro_batch=1) for _ in range(B)]
    base_ratio = float(sessions[0].ratio)
    cur_scale = 1.0
    x = scenario.features.to(engine.device)
    rewards = scenario.rewards
    effective = np.array(scenario.weak_ap, np.float64)  # default: served weak
    offload = np.zeros((T, B), bool)
    served_strong = np.zeros((T, B), bool)
    pending: List[tuple] = []  # (t_done, t, b, estimate, rtt)

    for t in range(T):
        now = runtime.clock()
        runtime.dispatcher.poll(now)
        # deliver completed offloads -> feed the closed loop
        still: List[tuple] = []
        for t_done, t0, b0, est0, rtt0 in pending:
            if t_done <= now:
                if ada is not None:
                    ada.observe(x[t0 * B + b0].cpu().numpy(), est0, rewards[t0, b0])
                sessions[b0].record_rtt(rtt0)
            else:
                still.append((t_done, t0, b0, est0, rtt0))
        pending = still
        for b in range(B):
            d = sessions[b].submit(features=x[t * B + b])[0]
            if ada is not None:
                ada.observe_estimate(d.estimate)
            if not d.offload:
                continue
            offload[t, b] = True
            res = runtime.dispatcher.dispatch(now, t * B + b, d.estimate)
            if res.outcome == OUTCOME_OFFLOADED:
                served_strong[t, b] = True
                effective[t, b] = scenario.strong_ap[t, b]
                pending.append((now + res.latency, t, b, d.estimate, res.latency))
        if ada is not None:
            report = ada.maybe_update(now)
            if report.recalibrated:
                for s in sessions:
                    s.recalibrate()
                    s.record_update()
            if report.ratio_scale != cur_scale:
                cur_scale = report.ratio_scale
                widened = float(np.clip(base_ratio * cur_scale, 0.0, 1.0))
                for s in sessions:
                    s.set_ratio(widened)
        runtime.clock.advance(1.0)

    updates = (
        {
            "observations": ada.observations,
            "incremental_updates": ada.incremental_updates,
            "refits": ada.refits,
            "drift_events": ada.drift_events,
        }
        if ada is not None
        else {}
    )
    return ShiftRunResult(
        effective=effective,
        offload=offload,
        served_strong=served_strong,
        shift_at=scenario.shift_at,
        updates=updates,
        telemetry=[s.telemetry.as_dict(include_online=True) for s in sessions],
        adaptive=ada,
    )
