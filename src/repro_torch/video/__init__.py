"""Temporal offloading over video streams, on the batched data plane — the
port of ``repro.video``.

The paper scores each image independently; this package is the stream-level
layer its deployment setting actually needs — consecutive frames are
correlated, so both the reward estimate and an already-offloaded edge
result stay informative for several frames:

- :mod:`repro_torch.video.scene` — seeded synthetic video (moving shapes
  with entry/exit/occlusion/cuts) + temporally-correlated weak/strong
  detection synthesis, on padded ``(T, B, ...)`` host containers
  (:class:`VideoClip` / :class:`DetectionClip`), array for array the JAX
  package's,
- :mod:`repro_torch.video.track` — the device-resident tracker: one step a
  frame over every stream on the ``iou_matrix_batch`` kernel's ``matrix``
  route (:func:`track_clip`, streaming :class:`VideoTracker`), the numpy
  reference oracle (:func:`track_clip_ref`), and stale-edge-result
  ``propagate``,
- :mod:`repro_torch.video.features` — frame-difference / churn / EWMA
  temporal features,
- :mod:`repro_torch.video.policy` — the ``temporal_hysteresis`` and
  ``keyframe`` policies, registered in the ``repro_torch.api`` registry,
- :mod:`repro_torch.video.runtime` — :class:`VideoRuntime.serve_clip`
  (stale-result reuse + per-frame effective accuracy through the AP engine)
  and the seeded 8-stream congested scenario
  (:func:`default_video_scenario` / :func:`run_video_scenario`).
"""
from repro_torch.video.features import (
    EwmaSmoother,
    detection_overlap,
    frame_difference,
    scene_change_score,
)
from repro_torch.video.policy import KeyframePolicy, TemporalHysteresisPolicy
from repro_torch.video.runtime import (
    VideoFleetTrace,
    VideoRuntime,
    VideoScenario,
    default_video_scenario,
    frame_accuracies,
    run_video_scenario,
)
from repro_torch.video.scene import (
    STRONG_PROFILE,
    WEAK_PROFILE,
    DetectionClip,
    DetectorProfile,
    SceneConfig,
    VideoClip,
    generate_clip,
    render_frame,
    synthesize_detections,
)
from repro_torch.video.track import (
    TrackerConfig,
    TrackFrame,
    TrackHistory,
    VideoTracker,
    greedy_match_boxes,
    propagate_rematch_ref,
    track_clip,
    track_clip_ref,
)

__all__ = [
    "SceneConfig",
    "DetectorProfile",
    "WEAK_PROFILE",
    "STRONG_PROFILE",
    "VideoClip",
    "DetectionClip",
    "generate_clip",
    "synthesize_detections",
    "render_frame",
    "TrackerConfig",
    "TrackFrame",
    "TrackHistory",
    "VideoTracker",
    "track_clip",
    "track_clip_ref",
    "greedy_match_boxes",
    "propagate_rematch_ref",
    "EwmaSmoother",
    "detection_overlap",
    "frame_difference",
    "scene_change_score",
    "TemporalHysteresisPolicy",
    "KeyframePolicy",
    "VideoRuntime",
    "VideoFleetTrace",
    "VideoScenario",
    "frame_accuracies",
    "default_video_scenario",
    "run_video_scenario",
]
