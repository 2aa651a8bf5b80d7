"""Seeded synthetic video: moving coloured shapes + correlated detections.

Extends the procedural :mod:`repro_torch.data.shapes` dataset along the time
axis — the deployment picture the paper targets is a camera *stream*, not
i.i.d. images.  Per stream, objects move with constant velocity plus seeded
jitter (bouncing off the frame), enter and exit, get briefly occluded, and
the whole scene occasionally cuts to a fresh layout (the events keyframe
policies key on).  Everything is a pure function of the seed.

Copied from the JAX package (``repro.video.scene``): plain numpy, so both
packages draw the same clips and detections from one seed, array for array.
The containers stay host numpy; the methods that hand a frame to the batched
data plane (``frame``, ``flatten``, ``gt_frame``) build the port's padded
batches on ``device`` (``"cuda"`` unless the caller asks for the CPU).

* :class:`VideoClip` — ground truth, ``(T, B, N, ...)`` padded
  struct-of-arrays (``B`` parallel streams) with per-object identities and
  per-frame cut flags; ``gt_frame(t)`` is a ``GroundTruthBatch`` over the
  streams, ``gt(t, b)`` the host ``GroundTruth``.
* :class:`DetectionClip` — synthesized detector output on the same layout;
  ``frame(t)`` is a ``DetectionsBatch``, ready for the batched feature /
  matching kernels with zero per-image Python.

``synthesize_detections`` derives weak/strong detector streams from a clip
geometrically (no pixel rendering): noise is *temporally correlated* —
each object carries a persistent class-flip and a persistent miss
propensity, so weak-output quality varies scene to scene the way a real
weak detector's does.  ``render_frame`` rasterizes a frame through the
shapes painter when pixels are actually wanted (examples, demos).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.data.shapes import IMAGE_SIZE, NUM_CLASSES, _background, class_colour, paint_object
from repro_torch.detection.batch import DetectionsBatch, GroundTruthBatch, _pad_dim
from repro_torch.detection.map_engine import Detections, GroundTruth
from repro_torch.kernels.dispatch import DeviceLike


@dataclass(frozen=True)
class SceneConfig:
    """Knobs of the per-stream motion simulation (all rates per frame)."""

    size: int = IMAGE_SIZE
    min_objects: int = 2
    max_objects: int = 6
    speed: float = 1.5          # max |velocity| component at spawn, px/frame
    jitter: float = 0.15        # per-frame velocity perturbation (sigma)
    p_enter: float = 0.04       # new object appears (below max_objects)
    p_exit: float = 0.02        # object leaves the scene
    p_occlude: float = 0.03     # object hidden for a few frames
    occlude_max: int = 3        # max occlusion length, frames
    p_cut: float = 0.03         # full scene change (all objects replaced)

    def __post_init__(self) -> None:
        if not 1 <= self.min_objects <= self.max_objects:
            raise ValueError(
                f"need 1 <= min_objects <= max_objects, got "
                f"{self.min_objects}..{self.max_objects}"
            )


@dataclass(frozen=True)
class DetectorProfile:
    """Noise model of one detector tier over a clip.  ``flip`` and ``miss``
    are *persistent per object* (sampled once from the object identity), so
    the induced quality signal is temporally correlated like a real weak
    detector's failure modes.

    ``hard_classes`` makes localization quality *class-conditional*:
    objects whose true class is listed get ``hard_box_jitter`` corner noise
    instead of ``box_jitter`` — a detector that is simply bad at certain
    categories.  Two profiles differing only in the hard set draw identical
    noise streams (the gaussian scale rescales the same draws), which is
    what lets a mid-stream swap of the hard set model a pure distribution
    shift without perturbing anything else in the clip."""

    box_jitter: float = 0.6     # per-corner gaussian noise, px
    flip: float = 0.05          # P(object's class is persistently wrong)
    miss: float = 0.05          # mean per-frame miss probability
    hallucinate: float = 0.02   # P(extra spurious detection per frame)
    score_lo: float = 0.55
    score_hi: float = 0.95
    hard_classes: tuple = ()    # true classes with degraded localization
    hard_box_jitter: Optional[float] = None  # their corner noise, px

    def jitter_for(self, true_cls: int) -> float:
        if self.hard_box_jitter is not None and int(true_cls) in self.hard_classes:
            return self.hard_box_jitter
        return self.box_jitter


#: the two tiers of the paper's weak-device / strong-edge pair
WEAK_PROFILE = DetectorProfile(
    box_jitter=2.0, flip=0.35, miss=0.3, hallucinate=0.12,
    score_lo=0.35, score_hi=0.9,
)
STRONG_PROFILE = DetectorProfile()


@dataclass(kw_only=True)
class VideoClip:
    """Padded ground-truth video: ``boxes (T, B, N, 4)`` float32, ``classes``
    / ``ids (T, B, N)`` int32, ``mask (T, B, N)`` bool, ``cuts (T, B)``
    bool.  ``ids`` are per-stream object identities (stable across frames,
    -1 on padded slots); ``cuts[t, b]`` marks a scene change at frame t."""

    boxes: np.ndarray
    classes: np.ndarray
    ids: np.ndarray
    mask: np.ndarray
    cuts: np.ndarray
    size: int = IMAGE_SIZE

    @property
    def n_frames(self) -> int:
        return self.boxes.shape[0]

    @property
    def n_streams(self) -> int:
        return self.boxes.shape[1]

    @property
    def max_objects(self) -> int:
        return self.boxes.shape[2]

    def gt_frame(self, t: int, *, device: DeviceLike = "cuda") -> GroundTruthBatch:
        """Frame ``t`` across all streams as a padded batch on ``device``."""
        return GroundTruthBatch(
            boxes=self.boxes[t], classes=self.classes[t], mask=self.mask[t]
        ).to(device)

    def gt(self, t: int, b: int) -> GroundTruth:
        m = self.mask[t, b]
        return GroundTruth(self.boxes[t, b][m], self.classes[t, b][m])

    def gt_stream(self, b: int) -> List[GroundTruth]:
        return [self.gt(t, b) for t in range(self.n_frames)]


@dataclass(kw_only=True)
class DetectionClip:
    """Padded detector output over a clip: the ``DetectionsBatch`` fields
    with a leading time axis — ``boxes (T, B, K, 4)``, ``scores`` /
    ``classes`` / ``mask (T, B, K)``."""

    boxes: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    mask: np.ndarray

    @property
    def n_frames(self) -> int:
        return self.boxes.shape[0]

    @property
    def n_streams(self) -> int:
        return self.boxes.shape[1]

    @property
    def max_boxes(self) -> int:
        return self.boxes.shape[2]

    def frame(self, t: int, *, device: DeviceLike = "cuda") -> DetectionsBatch:
        """Frame ``t`` across all streams as a padded batch on ``device``."""
        return DetectionsBatch(
            boxes=self.boxes[t], scores=self.scores[t],
            classes=self.classes[t], mask=self.mask[t],
        ).to(device)

    def det(self, t: int, b: int) -> Detections:
        m = self.mask[t, b]
        return Detections(
            self.boxes[t, b][m], self.scores[t, b][m], self.classes[t, b][m]
        )

    def flatten(self, *, device: DeviceLike = "cuda") -> DetectionsBatch:
        """All ``T * B`` frames as one batch on ``device`` (time-major: row
        ``t * B + b``) — one copy into the batched feature/matching
        kernels."""
        T, B, K = self.boxes.shape[:3]
        return DetectionsBatch(
            boxes=self.boxes.reshape(T * B, K, 4),
            scores=self.scores.reshape(T * B, K),
            classes=self.classes.reshape(T * B, K),
            mask=self.mask.reshape(T * B, K),
        ).to(device)

    @classmethod
    def from_frames(cls, frames: Sequence[Sequence[Detections]]) -> "DetectionClip":
        """Pad ragged per-frame-per-stream detections (``frames[t][b]``)."""
        top = max(
            (len(d) for fr in frames for d in fr), default=0
        )
        k = _pad_dim(top)
        # padded on the host: the clip is a host container
        batches = [
            DetectionsBatch.from_list(list(fr), max_boxes=k, device="cpu") for fr in frames
        ]
        return cls(**{
            name: np.stack([getattr(fb, name).numpy() for fb in batches])
            for name in ("boxes", "scores", "classes", "mask")
        })


# --------------------------------------------------------------- generation


@dataclass
class _Object:
    box: np.ndarray      # (4,) float
    vel: np.ndarray      # (2,) float
    cls: int
    oid: int
    hidden_for: int = 0  # occlusion countdown


def _spawn(rng: np.random.Generator, cfg: SceneConfig, oid: int) -> _Object:
    cls = int(rng.integers(0, NUM_CLASSES))
    w = int(rng.integers(10, 31))
    h = int(rng.integers(10, 31))
    x1 = float(rng.integers(0, cfg.size - w))
    y1 = float(rng.integers(0, cfg.size - h))
    vel = rng.uniform(-cfg.speed, cfg.speed, 2)
    return _Object(
        box=np.array([x1, y1, x1 + w, y1 + h], float), vel=vel, cls=cls, oid=oid
    )


def _step_object(rng: np.random.Generator, cfg: SceneConfig, o: _Object) -> None:
    o.vel = o.vel + rng.normal(0.0, cfg.jitter, 2)
    o.vel = np.clip(o.vel, -2.0 * cfg.speed, 2.0 * cfg.speed)
    o.box = o.box + np.array([o.vel[0], o.vel[1], o.vel[0], o.vel[1]])
    # bounce off the frame, reflecting the velocity
    for ax, (lo_i, hi_i) in enumerate(((0, 2), (1, 3))):
        if o.box[lo_i] < 0.0:
            shift = -o.box[lo_i]
            o.box[lo_i] += shift
            o.box[hi_i] += shift
            o.vel[ax] = abs(o.vel[ax])
        elif o.box[hi_i] > cfg.size:
            shift = o.box[hi_i] - cfg.size
            o.box[lo_i] -= shift
            o.box[hi_i] -= shift
            o.vel[ax] = -abs(o.vel[ax])
    if o.hidden_for > 0:
        o.hidden_for -= 1


def generate_clip(
    n_streams: int,
    n_frames: int,
    *,
    seed: int = 0,
    config: Optional[SceneConfig] = None,
) -> VideoClip:
    """``B`` independent seeded streams of ``T`` frames each.  Streams use
    disjoint seed sequences ``(seed, b)``, so a clip is bit-identical for a
    given ``(n_streams, n_frames, seed, config)``."""
    cfg = config or SceneConfig()
    n = _pad_dim(cfg.max_objects)
    boxes = np.zeros((n_frames, n_streams, n, 4), np.float32)
    classes = np.full((n_frames, n_streams, n), -1, np.int32)
    ids = np.full((n_frames, n_streams, n), -1, np.int32)
    mask = np.zeros((n_frames, n_streams, n), bool)
    cuts = np.zeros((n_frames, n_streams), bool)
    for b in range(n_streams):
        rng = np.random.default_rng((seed, b))
        next_id = 0
        objects: List[_Object] = []

        def fresh_scene():
            nonlocal next_id, objects
            objects = []
            for _ in range(int(rng.integers(cfg.min_objects, cfg.max_objects + 1))):
                objects.append(_spawn(rng, cfg, next_id))
                next_id += 1

        fresh_scene()
        for t in range(n_frames):
            if t > 0:
                if rng.uniform() < cfg.p_cut:
                    fresh_scene()
                    cuts[t, b] = True
                else:
                    for o in objects:
                        _step_object(rng, cfg, o)
                    objects = [o for o in objects if rng.uniform() >= cfg.p_exit]
                    for o in objects:
                        if o.hidden_for == 0 and rng.uniform() < cfg.p_occlude:
                            o.hidden_for = int(rng.integers(1, cfg.occlude_max + 1))
                    if len(objects) < cfg.max_objects and rng.uniform() < cfg.p_enter:
                        objects.append(_spawn(rng, cfg, next_id))
                        next_id += 1
            visible = [o for o in objects if o.hidden_for == 0]
            for slot, o in enumerate(visible):
                boxes[t, b, slot] = o.box
                classes[t, b, slot] = o.cls
                ids[t, b, slot] = o.oid
                mask[t, b, slot] = True
    return VideoClip(
        boxes=boxes, classes=classes, ids=ids, mask=mask, cuts=cuts, size=cfg.size
    )


# ----------------------------------------------------- detection synthesis


def synthesize_detections(
    clip: VideoClip,
    profile: DetectorProfile = WEAK_PROFILE,
    *,
    seed: int = 0,
) -> DetectionClip:
    """Simulate one detector tier over a clip (geometrically, no pixels).

    Per stream, every object identity draws a persistent flipped class
    (prob ``flip``) and a persistent miss propensity ``U(0, 2 * miss)`` —
    the *same* object keeps failing the same way frame after frame, which
    is exactly the temporal correlation the video policies exploit.
    Box corners get i.i.d. gaussian jitter and scores are uniform in
    ``[score_lo, score_hi]``; occasional hallucinated boxes round it out.
    """
    T, B = clip.n_frames, clip.n_streams
    frames: List[List[Detections]] = [[] for _ in range(T)]
    for b in range(B):
        rng = np.random.default_rng((seed, b, 1))
        flip_cls: dict = {}
        miss_p: dict = {}
        for t in range(T):
            d_boxes, d_scores, d_cls = [], [], []
            for slot in np.flatnonzero(clip.mask[t, b]):
                oid = int(clip.ids[t, b, slot])
                if oid not in flip_cls:
                    if rng.uniform() < profile.flip:
                        wrong = int(rng.integers(0, NUM_CLASSES - 1))
                        true = int(clip.classes[t, b, slot])
                        flip_cls[oid] = wrong + (wrong >= true)
                    else:
                        flip_cls[oid] = int(clip.classes[t, b, slot])
                    miss_p[oid] = float(rng.uniform(0.0, 2.0 * profile.miss))
                if rng.uniform() < miss_p[oid]:
                    continue
                # scale is applied to the same unit draws, so profiles
                # differing only in jitter consume identical RNG streams
                sigma = profile.jitter_for(int(clip.classes[t, b, slot]))
                d_boxes.append(
                    clip.boxes[t, b, slot] + rng.normal(0.0, sigma, 4)
                )
                d_scores.append(rng.uniform(profile.score_lo, profile.score_hi))
                d_cls.append(flip_cls[oid])
            if rng.uniform() < profile.hallucinate:
                x1, y1 = rng.uniform(0, clip.size - 16, 2)
                w, h = rng.uniform(8, 24, 2)
                d_boxes.append(np.array([x1, y1, x1 + w, y1 + h]))
                d_scores.append(rng.uniform(0.1, 0.5))
                d_cls.append(int(rng.integers(0, NUM_CLASSES)))
            frames[t].append(
                Detections(
                    np.asarray(d_boxes, float).reshape(-1, 4),
                    np.asarray(d_scores, float),
                    np.asarray(d_cls, np.int64),
                )
            )
    return DetectionClip.from_frames(frames)


# ----------------------------------------------------------------- raster


def render_frame(
    clip: VideoClip, t: int, b: int, *, seed: int = 0
) -> np.ndarray:
    """Rasterize one frame through the shapes painter (for demos — the
    decision pipeline itself is purely geometric).  Background and object
    colours are functions of ``(seed, b)`` and the object identity, so a
    frame renders identically no matter which frames were drawn before."""
    rng = np.random.default_rng((seed, b, 2))
    img = _background(rng, clip.size)
    for slot in np.flatnonzero(clip.mask[t, b]):
        cls = int(clip.classes[t, b, slot])
        colour_rng = np.random.default_rng((seed, b, 3, int(clip.ids[t, b, slot])))
        paint_object(
            img, clip.boxes[t, b, slot], cls, class_colour(cls, colour_rng), colour_rng
        )
    return img
