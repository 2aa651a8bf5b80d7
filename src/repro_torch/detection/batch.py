"""Batched detection data plane: padded struct-of-arrays containers on a
device, and the COCO greedy matcher on the IoU kernel family.

* ``DetectionsBatch`` / ``GroundTruthBatch`` hold float32 boxes, int32
  classes and a bool ``mask`` as tensors on one device.  ``from_list`` pads a
  ragged host list (padded boxes zero, classes -1, scores 0); the on-card
  detector route (``repro_torch.models.detector.decode_batch``) instead keeps
  all grid slots and carries the NMS keep mask as ``mask``.  Consumers rely on
  the mask only, so both give the same features and matches.
* ``match_batch`` reproduces COCO greedy matching (per class, detections by
  descending score, one GT per detection, per IoU threshold) through
  ``greedy_match``: on the card one launch of the IoU kernel family's
  ``match`` route (the score rank, the masked IoU tile and the greedy scan in
  one CTA an image), on the CPU its plain version ``greedy_match_ref``, the
  reference's ``lax.scan`` as a loop over the score-ordered slots; ``tp`` and
  ``match_gt`` equal ``repro.detection.batch.match_batch``'s.
* ``to_image_evals`` turns a ``MatchResult`` into the per-image ``ImageEval``
  list the AP accumulator consumes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.detection.map_engine import Detections, GroundTruth, ImageEval
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.kernels.iou_matrix import greedy_match


def _pad_dim(n: int, multiple: int = 8) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def _stack_padded(
    arrays: Sequence[np.ndarray], max_n: int, trailing: Tuple[int, ...], dtype, fill
) -> np.ndarray:
    out = np.full((len(arrays), max_n) + trailing, fill, dtype=dtype)
    for i, a in enumerate(arrays):
        out[i, : len(a)] = a
    return out


_DTYPES = {
    "boxes": torch.float32,
    "classes": torch.int32,
    "mask": torch.bool,
    "scores": torch.float32,
}


@dataclass(kw_only=True)
class _BoxBatch:
    """Shared padded core: ``boxes (B, N, 4)`` float32, ``classes (B, N)``
    int32, ``mask (B, N)`` bool, contiguous and all on one device.  Arrays
    that are not tensors become CPU tensors; ``to`` moves a batch."""

    boxes: torch.Tensor
    classes: torch.Tensor
    mask: torch.Tensor

    def __post_init__(self) -> None:
        devices = set()
        for f in dataclasses.fields(self):
            t = torch.as_tensor(getattr(self, f.name)).to(_DTYPES[f.name]).contiguous()
            setattr(self, f.name, t)
            devices.add(t.device)
        if len(devices) != 1:
            raise ValueError(f"batch fields on several devices: {sorted(map(str, devices))}")

    @staticmethod
    def _padded_fields(items, max_boxes: Optional[int]):
        """(resolved max_boxes, common numpy field dict) for a ragged item
        list; ``[]`` gives the zero-length batch with ``max_boxes`` at the
        padding floor."""
        ns = [len(it) for it in items]
        top = max(ns, default=0)
        if max_boxes is None:
            max_boxes = _pad_dim(top)
        elif top > max_boxes:
            raise ValueError(f"image with {top} boxes exceeds max_boxes={max_boxes}")
        fields = dict(
            boxes=_stack_padded([it.boxes for it in items], max_boxes, (4,), np.float32, 0.0),
            classes=_stack_padded([it.classes for it in items], max_boxes, (), np.int32, -1),
            mask=_stack_padded([np.ones(n, bool) for n in ns], max_boxes, (), bool, False),
        )
        return max_boxes, fields

    @classmethod
    def _from_numpy(cls, fields, device: DeviceLike):
        dev = resolve_device(device)
        return cls(**{k: torch.from_numpy(v).to(dev) for k, v in fields.items()})

    #: per-field image-axis padding fills (the box-axis conventions)
    _IMAGE_FILL = {"boxes": 0.0, "classes": -1, "scores": 0.0, "mask": False}

    def pad_images(self, n_images: int):
        """The batch extended to ``n_images`` along the image axis with empty
        (all-masked) images."""
        B = len(self)
        if n_images < B:
            raise ValueError(f"pad_images({n_images}) below batch size {B}")
        if n_images == B:
            return self
        kwargs = {}
        for f in dataclasses.fields(self):
            a = getattr(self, f.name)
            pad = torch.full(
                (n_images - B,) + tuple(a.shape[1:]), self._IMAGE_FILL[f.name],
                dtype=a.dtype, device=a.device,
            )
            kwargs[f.name] = torch.cat([a, pad])
        return type(self)(**kwargs)

    def to(self, device: DeviceLike):
        """This batch on ``device`` (itself when already there)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        return type(self)(
            **{f.name: getattr(self, f.name).to(dev) for f in dataclasses.fields(self)}
        )

    @property
    def device(self) -> torch.device:
        return self.boxes.device

    def __len__(self) -> int:
        return self.boxes.shape[0]

    @property
    def max_boxes(self) -> int:
        return self.boxes.shape[1]

    @property
    def counts(self) -> torch.Tensor:
        return self.mask.sum(dim=1)

    def to_list(self) -> list:
        host = self.to("cpu")
        return [host[i] for i in range(len(host))]


@dataclass(kw_only=True)
class GroundTruthBatch(_BoxBatch):
    """Padded per-image annotations: ``boxes (B, M, 4)``, ``classes (B, M)``,
    ``mask (B, M)``."""

    @classmethod
    def from_list(
        cls,
        gts: Sequence[GroundTruth],
        max_boxes: Optional[int] = None,
        *,
        device: DeviceLike = "cuda",
    ) -> "GroundTruthBatch":
        """Pad a ragged annotation list onto ``device``; ``[]`` yields the
        zero-length batch."""
        _, fields = cls._padded_fields(gts, max_boxes)
        return cls._from_numpy(fields, device)

    def __getitem__(self, i: int) -> GroundTruth:
        m = self.mask[i]
        return GroundTruth(
            self.boxes[i][m].cpu().numpy(), self.classes[i][m].cpu().numpy()
        )


@dataclass(kw_only=True)
class DetectionsBatch(_BoxBatch):
    """Padded per-image detector output: ``boxes (B, K, 4)``, ``scores
    (B, K)``, ``classes (B, K)``, ``mask (B, K)``."""

    scores: torch.Tensor

    @classmethod
    def from_list(
        cls,
        dets: Sequence[Detections],
        max_boxes: Optional[int] = None,
        *,
        device: DeviceLike = "cuda",
    ) -> "DetectionsBatch":
        """Pad a ragged detection list onto ``device``; ``[]`` yields the
        zero-length batch."""
        max_boxes, fields = cls._padded_fields(dets, max_boxes)
        fields["scores"] = _stack_padded(
            [d.scores for d in dets], max_boxes, (), np.float32, 0.0
        )
        return cls._from_numpy(fields, device)

    def __getitem__(self, i: int) -> Detections:
        m = self.mask[i]
        return Detections(
            self.boxes[i][m].cpu().numpy(),
            self.scores[i][m].cpu().numpy(),
            self.classes[i][m].cpu().numpy(),
        )


# ---------------------------------------------------------------------------
# Batched greedy matching
# ---------------------------------------------------------------------------

@dataclass
class MatchResult:
    """Batched matching output, aligned to the original detection slots.

    ``tp[b, t, k]`` — detection slot ``k`` of image ``b`` is a true positive
    at IoU threshold ``t``; ``match_gt[b, t, k]`` — the matched GT slot or -1.
    """

    tp: np.ndarray  # (B, T, K) bool
    match_gt: np.ndarray  # (B, T, K) int32
    iou_thresholds: Tuple[float, ...] = field(default=(0.5,))


def match_batch(
    det: DetectionsBatch,
    gt: GroundTruthBatch,
    iou_thresholds: Sequence[float] = (0.5,),
) -> MatchResult:
    """Batched COCO greedy matching on the batches' device; tp flags equal
    per-image :func:`repro_torch.detection.map_engine.match_detections`
    under the plane's float32 convention."""
    if len(det) != len(gt):
        raise ValueError(f"batch size mismatch: {len(det)} dets vs {len(gt)} gts")
    if det.device != gt.device:
        raise ValueError(f"detections on {det.device}, ground truth on {gt.device}")
    thresholds = torch.tensor(list(iou_thresholds), dtype=torch.float32, device=det.device)
    tp, mj = greedy_match(det.boxes, det.scores, det.classes, det.mask,
                          gt.boxes, gt.classes, gt.mask, thresholds)
    return MatchResult(
        tp=tp.cpu().numpy(),
        match_gt=mj.cpu().numpy(),
        iou_thresholds=tuple(float(t) for t in iou_thresholds),
    )


def to_image_evals(
    det: DetectionsBatch, gt: GroundTruthBatch, result: MatchResult
) -> List[ImageEval]:
    """Convert a batched :class:`MatchResult` into the per-image
    ``ImageEval`` list ``APAccumulator``/``RewardOracle`` consume — the same
    structure ``match_detections`` produces."""
    det, gt = det.to("cpu"), gt.to("cpu")
    d_mask, d_classes, d_scores = det.mask.numpy(), det.classes.numpy(), det.scores.numpy()
    g_mask, g_classes = gt.mask.numpy(), gt.classes.numpy()
    out: List[ImageEval] = []
    for b in range(len(det)):
        d_slots = np.where(d_mask[b])[0]
        g_slots = np.where(g_mask[b])[0]
        d_cls = d_classes[b][d_slots]
        g_cls = g_classes[b][g_slots]
        scores = d_scores[b].astype(np.float64)
        ev = ImageEval()
        for c in np.unique(g_cls):
            ev.gt_counts[int(c)] = int(np.sum(g_cls == c))
        if d_slots.size or g_slots.size:
            class_ids = np.unique(np.concatenate([d_cls, g_cls]))
        else:
            class_ids = np.zeros((0,), np.int64)
        for c in class_ids:
            c = int(c)
            d_idx = d_slots[d_cls == c]
            if d_idx.size == 0:
                continue
            order = np.argsort(-scores[d_idx], kind="stable")
            d_idx = d_idx[order]
            g_idx = g_slots[g_cls == c]  # ascending slot order == per-class order
            mj = result.match_gt[b][:, d_idx]  # (T, n) global GT slots
            local = np.searchsorted(g_idx, np.where(mj < 0, 0, mj))
            ev.per_class[c] = (scores[d_idx], result.tp[b][:, d_idx])
            ev.matched_gt[c] = np.where(mj < 0, -1, local).astype(np.int64)
        out.append(ev)
    return out
