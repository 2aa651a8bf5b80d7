"""Device-resident multi-object tracker over the batched detection plane.

The temporal subsystem needs two primitives the per-image stack lacks:

* **association** — which detection in frame ``t`` is the same object as a
  detection in frame ``t-1`` (greedy IoU, class-gated, score order — the
  matching idiom of ``repro_torch.detection.batch`` turned along time), and
* **propagation** — placing a *stale* result (an edge response that took a
  few frames to come back over the netsim link) onto the current frame.

The port of ``repro.video.track``.  One tracker step (:func:`_step`) is a
handful of batched tensor ops over all B streams on the tracker's device:
the per-frame IoU is one ``iou_matrix_batch`` call (on the card one launch
of the IoU family's ``matrix`` route, B streams x ``max_dets`` detections x
``max_tracks`` tracks), the greedy association the JAX package scans with
``lax.scan`` is a loop over the K score-ordered detection slots, each
iteration a few (B, N) ops, and the state update, death and spawn are
masked ops with the scatters written as gathers (a scatter's dropped
out-of-range index has no torch counterpart).  :func:`track_clip` loops the
step over T; the track state stays on the device and the host sees one copy
of each frame's :class:`TrackFrame` (streaming) or of the whole history
(clip).  The track state is a fixed ``max_tracks`` padded struct-of-arrays
per stream: box, constant-velocity estimate, confidence, age, class,
identity, active mask.

Update rules (all float32, deterministic):

- matched track: box := detection box, velocity := EMA of per-frame box
  deltas (``vel_smooth``), confidence pulled toward the detection score
  (``conf_update``), age reset;
- unmatched track: box coasts at constant velocity, confidence decays by
  ``conf_decay``, age grows; tracks die past ``max_age`` or below
  ``min_conf`` (dead slots are zeroed so state stays exactly reproducible);
- unmatched detections above ``spawn_score`` spawn into the lowest free
  slots in score order with fresh identities.

``track_clip_ref`` is the per-frame numpy reference associator (copied):
the tracker must produce identical association (identities, active masks,
matches) on any clip.  ``VideoTracker`` is the streaming form (one step per
frame, the function :func:`track_clip` loops) and carries
``propagate(edge_dets, t0, t1)``: stale edge detections are greedy-matched
onto the *current* tracks and snapped to their constant-velocity-updated
boxes, with scores decayed by ``stale_decay`` per frame of staleness — the
stale-result reuse primitive the video policies credit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.detection.batch import DetectionsBatch
from repro_torch.detection.map_engine import Detections
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.kernels.iou_matrix import iou_matrix_batch


@dataclass(frozen=True)
class TrackerConfig:
    """Tracker knobs; frozen (and hashable)."""

    max_tracks: int = 16
    max_dets: int = 16          # per-frame detection slots (streaming pad)
    iou_thresh: float = 0.3     # association gate
    vel_smooth: float = 0.5     # EMA weight on the previous velocity
    conf_update: float = 0.5    # pull toward the matched detection score
    conf_decay: float = 0.75    # per unmatched frame
    max_age: int = 3            # unmatched frames before a track dies
    min_conf: float = 0.05
    spawn_score: float = 0.1    # min detection score to open a track
    stale_decay: float = 0.9    # propagate(): score decay per stale frame
    prop_iou: float = 0.2       # propagate(): stale-det -> track gate


@dataclass(kw_only=True)
class TrackFrame:
    """One frame's track state across ``B`` streams (host arrays).

    ``det_track[b, k]`` is the track slot detection ``k`` matched (-1 for
    unmatched/padded detections); ``n_active``/``n_matched``/``n_new``/
    ``n_dead`` are per-stream counts after the update.
    """

    boxes: np.ndarray      # (B, N, 4) float32
    vel: np.ndarray        # (B, N, 4) float32
    conf: np.ndarray       # (B, N) float32
    age: np.ndarray        # (B, N) int32
    classes: np.ndarray    # (B, N) int32, -1 inactive
    ids: np.ndarray        # (B, N) int32, -1 inactive
    active: np.ndarray     # (B, N) bool
    det_track: np.ndarray  # (B, K) int32
    n_active: np.ndarray   # (B,) int32
    n_matched: np.ndarray  # (B,) int32
    n_new: np.ndarray      # (B,) int32
    n_dead: np.ndarray     # (B,) int32

    def churn(self) -> np.ndarray:
        """Per-stream track churn in [0, 1]: births + deaths over the live
        population — the scene-change signal the keyframe policy probes."""
        turn = self.n_new + self.n_dead
        return turn / np.maximum(self.n_active + self.n_dead, 1)


@dataclass(kw_only=True)
class TrackHistory:
    """Stacked per-frame track state over a clip: the :class:`TrackFrame`
    arrays with a leading time axis."""

    boxes: np.ndarray
    vel: np.ndarray
    conf: np.ndarray
    age: np.ndarray
    classes: np.ndarray
    ids: np.ndarray
    active: np.ndarray
    det_track: np.ndarray
    n_active: np.ndarray
    n_matched: np.ndarray
    n_new: np.ndarray
    n_dead: np.ndarray

    @property
    def n_frames(self) -> int:
        return self.boxes.shape[0]

    def frame(self, t: int) -> TrackFrame:
        return TrackFrame(
            **{f: getattr(self, f)[t] for f in _FRAME_FIELDS}
        )


_FRAME_FIELDS = (
    "boxes", "vel", "conf", "age", "classes", "ids", "active", "det_track",
    "n_active", "n_matched", "n_new", "n_dead",
)
# each field's host dtype; on the device every field travels as int32 words
# (float32 bits viewed as int32, bools widened), so a frame is one copy
_HOST_DTYPES = {
    "boxes": np.float32, "vel": np.float32, "conf": np.float32, "active": bool,
}


# ------------------------------------------------------------ device step


def _init_state(n_streams: int, cfg: TrackerConfig, device: torch.device):
    B, N = n_streams, cfg.max_tracks
    i32 = dict(dtype=torch.int32, device=device)
    return (
        torch.zeros((B, N, 4), dtype=torch.float32, device=device),  # boxes
        torch.zeros((B, N, 4), dtype=torch.float32, device=device),  # vel
        torch.zeros((B, N), dtype=torch.float32, device=device),     # conf
        torch.zeros((B, N), **i32),                                   # age
        torch.full((B, N), -1, **i32),                                # classes
        torch.full((B, N), -1, **i32),                                # ids
        torch.zeros((B, N), dtype=torch.bool, device=device),        # active
        torch.zeros((B,), **i32),                                     # next_id
    )


def _constants(cfg: TrackerConfig, device: torch.device) -> Dict[str, torch.Tensor]:
    """The step's float constants as float32 scalar tensors on ``device``,
    made once a tracker: every comparison and product is then float32, as
    with the JAX step's weakly typed constants."""
    vs, cu = cfg.vel_smooth, cfg.conf_update
    values = dict(neg=-1.0, ninf=-float("inf"), iou_thresh=cfg.iou_thresh, vel_keep=vs,
                  vel_new=1.0 - vs, conf_keep=1.0 - cu, conf_new=cu, conf_decay=cfg.conf_decay,
                  min_conf=cfg.min_conf, spawn_score=cfg.spawn_score)
    host = torch.tensor(list(values.values()), dtype=torch.float32).to(device)
    return dict(zip(values, host.unbind()))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, n]]`` for x (B, K) or (B, K, 4) and idx (B, N)."""
    if x.ndim == 3:
        return torch.take_along_dim(x, idx[:, :, None], dim=1)
    return x.gather(1, idx)


def _slot_of(target: torch.Tensor, N: int) -> torch.Tensor:
    """For per-detection slot targets (B, K), where ``N`` means "no slot",
    the detection each slot receives (B, N), -1 where none: the JAX step's
    ``.at[b, target].set(k, mode="drop")``, scattered into an extra column
    that takes every dropped index and is then cut off.  Targets below N are
    distinct within a row, so the scatter is deterministic there."""
    B, K = target.shape
    out = torch.full((B, N + 1), -1, dtype=torch.int64, device=target.device)
    k = torch.arange(K, device=target.device).expand(B, K)
    return out.scatter(1, target, k)[:, :N]


def _step(state, frame, cfg: TrackerConfig, c: Dict[str, torch.Tensor]):
    """One tracker update over all B streams; ``state``, ``frame`` (boxes
    (B, K, 4), scores, classes, mask (B, K)) and the constants ``c``
    (:func:`_constants`) on one device.  Returns the new state and the
    frame's outputs (device tensors)."""
    boxes, vel, conf, age, cls, ids, active, next_id = state
    d_boxes, d_scores, d_cls, d_mask = frame
    B, N = conf.shape
    K = d_scores.shape[1]
    dev = conf.device
    neg = c["neg"]

    # associate: IoU of detections vs constant-velocity-predicted tracks
    pred = boxes + vel
    iou = iou_matrix_batch(d_boxes, pred)  # (B, K, N)
    eligible = d_mask[:, :, None] & active[:, None, :] & (d_cls[:, :, None] == cls[:, None, :])
    miou = torch.where(eligible, iou, neg)
    keys = torch.where(d_mask, d_scores, c["ninf"])
    order = torch.argsort(-keys, dim=1, stable=True)  # (B, K)
    iou_s = torch.take_along_dim(miou, order[:, :, None], dim=1)

    # the greedy association in score order: the reference's lax.scan over
    # the K sorted slots, each step over every stream
    slot = torch.arange(N, device=dev)
    taken = torch.zeros((B, N), dtype=torch.bool, device=dev)
    hits, picks = [], []
    for k in range(K):
        avail = torch.where(taken, neg, iou_s[:, k])
        j = avail.argmax(dim=-1)  # the first maximum, as jnp.argmax
        hit = avail.gather(1, j[:, None])[:, 0] >= c["iou_thresh"]
        taken = taken | (hit[:, None] & (slot == j[:, None]))
        hits.append(hit)
        picks.append(j)
    inv = torch.argsort(order, dim=1)
    hit = torch.stack(hits, dim=1).gather(1, inv) if K else torch.zeros_like(d_mask)
    tj = torch.stack(picks, dim=1).gather(1, inv) if K else torch.zeros_like(order)
    no_slot = torch.full_like(tj, N)

    # track-side inverse map: which detection matched each track slot
    det_of = _slot_of(torch.where(hit, tj, no_slot), N)

    # update matched / coast unmatched
    matched = det_of >= 0
    sd = det_of.clamp(min=0)
    dbox_t = _gather_rows(d_boxes, sd)
    dscore_t = _gather_rows(d_scores, sd)
    new_vel = c["vel_keep"] * vel + c["vel_new"] * (dbox_t - boxes)
    boxes = torch.where(matched[:, :, None], dbox_t, pred)
    vel = torch.where(matched[:, :, None], new_vel, vel)
    conf = torch.where(
        matched,
        c["conf_keep"] * conf + c["conf_new"] * dscore_t,
        conf * c["conf_decay"],
    )
    age = torch.where(matched, torch.zeros_like(age), age + 1)
    survive = active & (matched | ((age <= cfg.max_age) & (conf >= c["min_conf"])))
    n_dead = (active & ~survive).sum(dim=1, dtype=torch.int32)
    active = survive
    # zero dead/inactive slots so state is exactly reproducible
    boxes = torch.where(active[:, :, None], boxes, torch.zeros_like(boxes))
    vel = torch.where(active[:, :, None], vel, torch.zeros_like(vel))
    conf = torch.where(active, conf, torch.zeros_like(conf))
    age = torch.where(active, age, torch.zeros_like(age))
    cls = torch.where(active, cls, torch.full_like(cls, -1))
    ids = torch.where(active, ids, torch.full_like(ids, -1))

    # spawn unmatched detections into the lowest free slots, score order
    spawn = d_mask & ~hit & (d_scores >= c["spawn_score"])
    rank = (torch.cumsum(spawn.gather(1, order), dim=1) - 1).gather(1, inv)  # (B, K) int64
    free_sorted = torch.sort(torch.where(active, N, slot), dim=1).values  # (B, N)
    free_padded = F.pad(free_sorted, (0, 1), value=N)
    target = torch.where(spawn, free_padded.gather(1, rank.clamp(0, N)), no_slot)
    placed = spawn & (target < N)
    n_new = placed.sum(dim=1, dtype=torch.int32)
    src = _slot_of(target, N)  # the detection spawned into each slot, -1 none
    new = src >= 0
    sk = src.clamp(min=0)
    boxes = torch.where(new[:, :, None], _gather_rows(d_boxes, sk), boxes)
    vel = torch.where(new[:, :, None], torch.zeros_like(vel), vel)
    conf = torch.where(new, _gather_rows(d_scores, sk), conf)
    age = torch.where(new, torch.zeros_like(age), age)
    cls = torch.where(new, _gather_rows(d_cls, sk), cls)
    ids = torch.where(new, next_id[:, None] + rank.gather(1, sk).to(torch.int32), ids)
    active = active | new
    next_id = next_id + n_new

    out = dict(
        boxes=boxes, vel=vel, conf=conf, age=age, classes=cls, ids=ids,
        active=active, det_track=torch.where(hit, tj, -1).to(torch.int32),
        n_active=active.sum(dim=1, dtype=torch.int32),
        n_matched=(hit & d_mask).sum(dim=1, dtype=torch.int32),
        n_new=n_new, n_dead=n_dead,
    )
    return (boxes, vel, conf, age, cls, ids, active, next_id), out


def _pack(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A step's outputs as one int32 tensor (B, words): float32 fields by
    their bits, bools widened; the inverse of :func:`_unpack`."""
    B = out["conf"].shape[0]
    parts = []
    for name in _FRAME_FIELDS:
        t = out[name]
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        parts.append(t.to(torch.int32).reshape(B, -1))
    return torch.cat(parts, dim=1)


def _unpack(words: np.ndarray, shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, np.ndarray]:
    """Host arrays from packed words (..., B, words) of :func:`_pack`."""
    lead = words.shape[:-1]
    out, at = {}, 0
    for name in _FRAME_FIELDS:
        shape = shapes[name]
        n = int(np.prod(shape[1:], dtype=np.int64))
        a = np.ascontiguousarray(words[..., at : at + n]).reshape(lead + shape[1:])
        at += n
        dtype = _HOST_DTYPES.get(name)
        if dtype is np.float32:
            a = a.view(np.float32)
        elif dtype is bool:
            a = a.astype(bool)
        out[name] = a
    return out


def _shapes(B: int, K: int, cfg: TrackerConfig) -> Dict[str, Tuple[int, ...]]:
    N = cfg.max_tracks
    return dict(boxes=(B, N, 4), vel=(B, N, 4), conf=(B, N), age=(B, N), classes=(B, N),
                ids=(B, N), active=(B, N), det_track=(B, K), n_active=(B,), n_matched=(B,),
                n_new=(B,), n_dead=(B,))


def _frame_tensors(batch: DetectionsBatch, max_dets: int, device: torch.device):
    """A frame's detection block padded to ``max_dets`` slots on ``device``."""
    k = batch.max_boxes
    if k > max_dets:
        raise ValueError(
            f"frame has {k} detection slots, tracker pads to max_dets={max_dets}"
        )
    batch = batch.to(device)
    pad = max_dets - k
    return (
        F.pad(batch.boxes, (0, 0, 0, pad)),
        F.pad(batch.scores, (0, pad)),
        F.pad(batch.classes, (0, pad), value=-1),
        F.pad(batch.mask, (0, pad)),
    )


def track_clip(
    dets: "DetectionClip",
    config: Optional[TrackerConfig] = None,
    *,
    device: DeviceLike = "cuda",
) -> TrackHistory:
    """Track a whole clip on ``device``: the clip goes to the device once,
    :func:`_step` runs once a frame over all streams, and the stacked
    history comes back to the host in one copy."""
    cfg = config or TrackerConfig()
    dev = resolve_device(device)
    T, B, K = dets.n_frames, dets.n_streams, dets.max_boxes
    frames = (
        torch.as_tensor(np.asarray(dets.boxes, np.float32)).to(dev),
        torch.as_tensor(np.asarray(dets.scores, np.float32)).to(dev),
        torch.as_tensor(np.asarray(dets.classes, np.int32)).to(dev),
        torch.as_tensor(np.asarray(dets.mask, bool)).to(dev),
    )
    state, consts = _init_state(B, cfg, dev), _constants(cfg, dev)
    words = []
    for t in range(T):
        state, out = _step(state, tuple(f[t] for f in frames), cfg, consts)
        words.append(_pack(out))
    if not words:
        raise ValueError("track_clip() of an empty clip")
    return TrackHistory(**_unpack(torch.stack(words).cpu().numpy(), _shapes(B, K, cfg)))


# ---------------------------------------------------------- numpy reference


def _iou_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The IoU kernels' arithmetic, elementwise in float32 — the reference
    associator must round identically to the device path."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, np.float32(0.0))
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(
        union > 0, inter / np.maximum(union, np.float32(1e-12)), np.float32(0.0)
    ).astype(np.float32)


def greedy_match_boxes(
    boxes: np.ndarray,
    scores: np.ndarray,
    targets: np.ndarray,
    iou_thresh: float,
    eligible: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Host-side greedy IoU assignment — the association idiom shared by
    ``propagate``, its rematch baseline, and the frame-difference feature:
    boxes claim targets in descending score order (stable), one target per
    box, gated by ``iou_thresh`` (and an optional ``(n_boxes, n_targets)``
    eligibility mask).  Returns the matched target index per box, -1 for
    unmatched."""
    match = np.full(len(boxes), -1, np.int32)
    if not len(boxes) or not len(targets):
        return match
    miou = _iou_f32(boxes, targets)
    if eligible is not None:
        miou = np.where(eligible, miou, np.float32(-1.0))
    taken = np.zeros(len(targets), bool)
    for k in np.argsort(-np.asarray(scores), kind="stable"):
        avail = np.where(taken, np.float32(-1.0), miou[k])
        j = int(np.argmax(avail))
        if avail[j] >= iou_thresh:
            taken[j] = True
            match[k] = j
    return match


def track_clip_ref(
    dets: "DetectionClip", config: Optional[TrackerConfig] = None
) -> TrackHistory:
    """Per-frame numpy reference tracker (float32 throughout) — the
    correctness oracle for :func:`track_clip`."""
    cfg = config or TrackerConfig()
    f32 = np.float32
    T, B, K = dets.n_frames, dets.n_streams, dets.max_boxes
    N = cfg.max_tracks
    out = {
        "boxes": np.zeros((T, B, N, 4), f32),
        "vel": np.zeros((T, B, N, 4), f32),
        "conf": np.zeros((T, B, N), f32),
        "age": np.zeros((T, B, N), np.int32),
        "classes": np.full((T, B, N), -1, np.int32),
        "ids": np.full((T, B, N), -1, np.int32),
        "active": np.zeros((T, B, N), bool),
        "det_track": np.full((T, B, K), -1, np.int32),
        "n_active": np.zeros((T, B), np.int32),
        "n_matched": np.zeros((T, B), np.int32),
        "n_new": np.zeros((T, B), np.int32),
        "n_dead": np.zeros((T, B), np.int32),
    }
    for b in range(B):
        boxes = np.zeros((N, 4), f32)
        vel = np.zeros((N, 4), f32)
        conf = np.zeros(N, f32)
        age = np.zeros(N, np.int32)
        cls = np.full(N, -1, np.int32)
        ids = np.full(N, -1, np.int32)
        active = np.zeros(N, bool)
        next_id = 0
        for t in range(T):
            d_boxes = dets.boxes[t, b].astype(f32)
            d_scores = dets.scores[t, b].astype(f32)
            d_cls = dets.classes[t, b]
            d_mask = dets.mask[t, b]
            pred = boxes + vel
            iou = _iou_f32(d_boxes, pred)
            eligible = (
                d_mask[:, None] & active[None, :] & (d_cls[:, None] == cls[None, :])
            )
            miou = np.where(eligible, iou, f32(-1.0))
            keys = np.where(d_mask, d_scores, -np.inf)
            order = np.argsort(-keys, kind="stable")
            taken = np.zeros(N, bool)
            hit = np.zeros(K, bool)
            tj = np.full(K, -1, np.int32)
            for k in order:
                avail = np.where(taken, f32(-1.0), miou[k])
                j = int(np.argmax(avail))
                if avail[j] >= cfg.iou_thresh:
                    taken[j] = True
                    hit[k] = True
                    tj[k] = j
            det_of = np.full(N, -1, np.int32)
            det_of[tj[hit]] = np.flatnonzero(hit)
            matched = det_of >= 0
            sd = np.maximum(det_of, 0)
            new_vel = f32(cfg.vel_smooth) * vel + f32(1.0 - cfg.vel_smooth) * (
                d_boxes[sd] - boxes
            )
            boxes = np.where(matched[:, None], d_boxes[sd], pred)
            vel = np.where(matched[:, None], new_vel, vel)
            conf = np.where(
                matched,
                f32(1.0 - cfg.conf_update) * conf + f32(cfg.conf_update) * d_scores[sd],
                conf * f32(cfg.conf_decay),
            ).astype(f32)
            age = np.where(matched, 0, age + 1).astype(np.int32)
            survive = active & (
                matched | ((age <= cfg.max_age) & (conf >= cfg.min_conf))
            )
            n_dead = int((active & ~survive).sum())
            active = survive
            boxes = np.where(active[:, None], boxes, f32(0.0))
            vel = np.where(active[:, None], vel, f32(0.0))
            conf = np.where(active, conf, f32(0.0)).astype(f32)
            age = np.where(active, age, 0).astype(np.int32)
            cls = np.where(active, cls, -1).astype(np.int32)
            ids = np.where(active, ids, -1).astype(np.int32)
            spawn = d_mask & ~hit & (d_scores >= cfg.spawn_score)
            free = np.flatnonzero(~active)
            n_new = 0
            for r, k in enumerate(order[spawn[order]]):
                if r >= free.size:
                    break
                slot = free[r]
                boxes[slot] = d_boxes[k]
                vel[slot] = 0.0
                conf[slot] = d_scores[k]
                age[slot] = 0
                cls[slot] = d_cls[k]
                ids[slot] = next_id + r
                active[slot] = True
                n_new += 1
            next_id += n_new
            out["boxes"][t, b] = boxes
            out["vel"][t, b] = vel
            out["conf"][t, b] = conf
            out["age"][t, b] = age
            out["classes"][t, b] = cls
            out["ids"][t, b] = ids
            out["active"][t, b] = active
            out["det_track"][t, b] = np.where(hit, tj, -1)
            out["n_active"][t, b] = int(active.sum())
            out["n_matched"][t, b] = int((hit & d_mask).sum())
            out["n_new"][t, b] = n_new
            out["n_dead"][t, b] = n_dead
    return TrackHistory(**out)


# ------------------------------------------------------------- streaming


class VideoTracker:
    """Streaming tracker over ``n_streams`` parallel streams on ``device``:
    one step per arriving frame (the function :func:`track_clip` loops), one
    host copy of its :class:`TrackFrame`, plus the stale-result
    ``propagate`` primitive."""

    def __init__(
        self,
        n_streams: int = 1,
        config: Optional[TrackerConfig] = None,
        *,
        device: DeviceLike = "cuda",
    ):
        self.config = config or TrackerConfig()
        self.n_streams = int(n_streams)
        self.device = resolve_device(device)
        self._consts = _constants(self.config, self.device)
        self.reset()

    def reset(self) -> None:
        self._state = _init_state(self.n_streams, self.config, self.device)
        self.frame_index = 0
        self._last: Optional[TrackFrame] = None

    @property
    def snapshot(self) -> Optional[TrackFrame]:
        """Track state after the most recent ``update`` (None before)."""
        return self._last

    def update(self, frame: DetectionsBatch) -> TrackFrame:
        """Advance every stream by one frame of detections (``len(frame)``
        must equal ``n_streams``); the frame moves to the tracker's device."""
        if len(frame) != self.n_streams:
            raise ValueError(
                f"frame batch has {len(frame)} streams, tracker {self.n_streams}"
            )
        cfg = self.config
        self._state, out = _step(
            self._state, _frame_tensors(frame, cfg.max_dets, self.device), cfg, self._consts
        )
        self.frame_index += 1
        words = _pack(out).cpu().numpy()
        self._last = TrackFrame(**_unpack(words, _shapes(self.n_streams, cfg.max_dets, cfg)))
        return self._last

    def propagate(
        self, dets: Detections, t0: float, t1: float, *, stream: int = 0
    ) -> Detections:
        """Reuse a stale edge result: place detections observed at frame
        ``t0`` onto frame ``t1`` by snapping them to the current tracks.

        Each stale detection greedy-matches by pure IoU (>= ``prop_iou``,
        score order) against the stream's active track boxes — which the
        tracker has been coasting/correcting since ``t0`` — and takes the
        matched track's box while KEEPING its own class: the tracks supply
        up-to-date geometry, the edge result supplies the (better) labels,
        so the association is deliberately class-agnostic — the weak
        detector's misclassified objects are exactly the ones a stale edge
        result must still land on.  Unmatched detections keep their stale
        geometry.  Scores decay by ``stale_decay ** (t1 - t0)``.  Host
        numpy over the last host :class:`TrackFrame`.
        """
        dt = float(t1) - float(t0)
        if dt < 0:
            raise ValueError(f"propagate backwards in time: t0={t0} > t1={t1}")
        scores = np.asarray(dets.scores, np.float64) * (self.config.stale_decay ** dt)
        out_boxes = np.asarray(dets.boxes, np.float64).copy()
        snap = self._last
        if len(dets) and snap is not None and snap.active[stream].any():
            t_boxes = snap.boxes[stream][np.flatnonzero(snap.active[stream])]
            match = greedy_match_boxes(
                dets.boxes, scores, t_boxes, self.config.prop_iou
            )
            hit = match >= 0
            out_boxes[hit] = t_boxes[match[hit]]
        return Detections(out_boxes, scores, np.asarray(dets.classes).copy())


def propagate_rematch_ref(
    edge_dets: Detections,
    weak_frames: Sequence[Detections],
    *,
    stale_decay: float = 0.9,
    iou_thresh: float = 0.2,
) -> Detections:
    """The naive alternative to tracked propagation: carry a stale result
    forward by re-matching it against EVERY intermediate frame's weak
    detections (per-frame Python greedy matching) — the O(T · N · M)
    baseline the tracker is compared against."""
    boxes = np.asarray(edge_dets.boxes, np.float64).copy()
    classes = np.asarray(edge_dets.classes)
    scores = np.asarray(edge_dets.scores, np.float64).copy()
    for wdet in weak_frames:
        # class-agnostic like VideoTracker.propagate: geometry from the
        # weak stream, labels from the edge result
        match = greedy_match_boxes(boxes, scores, wdet.boxes, iou_thresh)
        hit = match >= 0
        boxes[hit] = np.asarray(wdet.boxes, np.float64)[match[hit]]
    scores = scores * (stale_decay ** len(weak_frames))
    return Detections(boxes, scores, classes.copy())
