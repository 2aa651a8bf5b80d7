"""mAP engine with incremental per-image evaluation.

The ORIC reward (repro_torch.core.reward) evaluates, for every image ``i``, the mAP
of ``{h_i} ∪ H_E`` where ``E`` is a ~1000-image context set.  Recomputing mAP
from scratch per image is O(|val| · |E|) box work; instead we match each
image's detections to its own ground truth once (matching is strictly
per-image), accumulate per-class (score, tp) lists for the context, and merge
a single image into the accumulator in O(n_class) when evaluating — exact,
not an approximation, because AP only needs globally score-sorted tp flags.

Conventions: COCO-style greedy matching (per class, detections by descending
score, each takes the best unmatched GT with IoU >= threshold); AP via
101-point interpolation; classes with zero ground truth in the evaluated set
are excluded from the mean (their false positives still never surface — the
exact mAPI blind spot the paper's context set fixes).

Copied from the JAX package (``repro.detection.map_engine``); plain numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.detection.boxes import box_iou_np

RECALL_GRID = np.linspace(0.0, 1.0, 101)


@dataclass
class Detections:
    """Per-image detector output."""

    boxes: np.ndarray  # (N, 4) xyxy
    scores: np.ndarray  # (N,)
    classes: np.ndarray  # (N,) int

    def __post_init__(self) -> None:
        self.boxes = np.asarray(self.boxes, dtype=np.float64).reshape(-1, 4)
        self.scores = np.asarray(self.scores, dtype=np.float64).reshape(-1)
        self.classes = np.asarray(self.classes, dtype=np.int64).reshape(-1)

    def __len__(self) -> int:
        return self.boxes.shape[0]

    def top_k(self, k: int) -> "Detections":
        # stable: ties keep insertion order, matching the batched data
        # plane's stable top-k selection (repro_torch.core.features)
        order = np.argsort(-self.scores, kind="stable")[:k]
        return Detections(self.boxes[order], self.scores[order], self.classes[order])


@dataclass
class GroundTruth:
    """Per-image annotations."""

    boxes: np.ndarray  # (M, 4) xyxy
    classes: np.ndarray  # (M,) int

    def __post_init__(self) -> None:
        self.boxes = np.asarray(self.boxes, dtype=np.float64).reshape(-1, 4)
        self.classes = np.asarray(self.classes, dtype=np.int64).reshape(-1)

    def __len__(self) -> int:
        return self.boxes.shape[0]


@dataclass
class ImageEval:
    """Matching result for one image: per-class scored tp flags + GT counts.

    ``per_class[c] = (scores (n,), tp (T, n))`` where T = #iou thresholds.
    ``matched_gt[c][t]`` holds, aligned with detections, the matched GT index
    (into the image's per-class GT list) or -1 — used by TIDE.
    """

    per_class: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    gt_counts: Dict[int, int] = field(default_factory=dict)
    matched_gt: Dict[int, np.ndarray] = field(default_factory=dict)


def match_detections(
    det: Detections,
    gt: GroundTruth,
    iou_thresholds: Sequence[float] = (0.5,),
) -> ImageEval:
    """Greedy per-class matching of one image's detections to its GT."""
    thresholds = np.asarray(iou_thresholds, dtype=np.float64)
    ev = ImageEval()
    for c in np.unique(gt.classes):
        ev.gt_counts[int(c)] = int(np.sum(gt.classes == c))
    class_ids = np.unique(np.concatenate([det.classes, gt.classes])) if (
        len(det) or len(gt)
    ) else np.zeros((0,), dtype=np.int64)
    for c in class_ids:
        c = int(c)
        d_idx = np.where(det.classes == c)[0]
        g_idx = np.where(gt.classes == c)[0]
        if d_idx.size == 0:
            continue
        order = np.argsort(-det.scores[d_idx], kind="stable")
        d_idx = d_idx[order]
        scores = det.scores[d_idx]
        tp = np.zeros((thresholds.size, d_idx.size), dtype=bool)
        match_ix = np.full((thresholds.size, d_idx.size), -1, dtype=np.int64)
        if g_idx.size:
            iou = box_iou_np(det.boxes[d_idx], gt.boxes[g_idx])  # (n, m)
            for t, thr in enumerate(thresholds):
                taken = np.zeros(g_idx.size, dtype=bool)
                for k in range(d_idx.size):
                    row = np.where(taken, -1.0, iou[k])
                    j = int(np.argmax(row)) if row.size else -1
                    if j >= 0 and row[j] >= thr:
                        taken[j] = True
                        tp[t, k] = True
                        match_ix[t, k] = j
        ev.per_class[c] = (scores, tp)
        ev.matched_gt[c] = match_ix
    return ev


def average_precision(
    scores: np.ndarray, tp: np.ndarray, n_gt: int
) -> float:
    """101-point interpolated AP from unsorted (score, tp) pairs."""
    if n_gt <= 0:
        return float("nan")
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order].astype(np.float64)
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(1.0 - tp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # precision envelope (monotone non-increasing from the right)
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    # max precision at recall >= r for each grid point
    idx = np.searchsorted(recall, RECALL_GRID, side="left")
    ap = np.where(idx < recall.size, prec_env[np.minimum(idx, recall.size - 1)], 0.0)
    return float(ap.mean())


class APAccumulator:
    """Per-class (scores, tp) accumulation over an image set, with O(classes)
    incremental evaluation of ``mAP(accumulated ∪ {one image})``."""

    def __init__(self, iou_thresholds: Sequence[float] = (0.5,)) -> None:
        self.iou_thresholds = tuple(iou_thresholds)
        self._scores: Dict[int, List[np.ndarray]] = {}
        self._tp: Dict[int, List[np.ndarray]] = {}
        self._gt: Dict[int, int] = {}
        self._frozen: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None
        self._ap_cache: Optional[Dict[int, np.ndarray]] = None

    def add(self, ev: ImageEval) -> None:
        self._frozen = None
        self._ap_cache = None
        for c, n in ev.gt_counts.items():
            self._gt[c] = self._gt.get(c, 0) + n
        for c, (scores, tp) in ev.per_class.items():
            self._scores.setdefault(c, []).append(scores)
            self._tp.setdefault(c, []).append(tp)

    def _freeze(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        if self._frozen is None:
            frozen = {}
            classes = set(self._scores) | set(self._gt)
            T = len(self.iou_thresholds)
            for c in classes:
                if c in self._scores:
                    s = np.concatenate(self._scores[c])
                    t = np.concatenate(self._tp[c], axis=1)
                else:
                    s = np.zeros((0,))
                    t = np.zeros((T, 0), dtype=bool)
                frozen[c] = (s, t)
            self._frozen = frozen
        return self._frozen

    def _base_aps(self) -> Dict[int, np.ndarray]:
        if self._ap_cache is None:
            frozen = self._freeze()
            cache: Dict[int, np.ndarray] = {}
            for c, (s, t) in frozen.items():
                n_gt = self._gt.get(c, 0)
                cache[c] = np.array(
                    [average_precision(s, t[ti], n_gt) for ti in range(t.shape[0])]
                )
            self._ap_cache = cache
        return self._ap_cache

    def map(self) -> float:
        """mAP of the accumulated set alone."""
        aps = self._base_aps()
        vals = [a for a in aps.values() if not np.all(np.isnan(a))]
        if not vals:
            return 0.0
        return float(np.nanmean(np.stack(vals)))

    def map_with_image(self, ev: ImageEval) -> float:
        """Exact ``mAP(accumulated ∪ {image})`` without mutating state.

        Only classes touched by the image are re-evaluated; the rest reuse
        the cached per-class APs.
        """
        frozen = self._freeze()
        base = self._base_aps()
        T = len(self.iou_thresholds)
        touched = set(ev.per_class) | set(ev.gt_counts)
        per_class_ap: Dict[int, np.ndarray] = dict(base)
        for c in touched:
            s0, t0 = frozen.get(c, (np.zeros((0,)), np.zeros((T, 0), dtype=bool)))
            if c in ev.per_class:
                s1, t1 = ev.per_class[c]
                s = np.concatenate([s0, s1])
                t = np.concatenate([t0, t1], axis=1)
            else:
                s, t = s0, t0
            n_gt = self._gt.get(c, 0) + ev.gt_counts.get(c, 0)
            per_class_ap[c] = np.array(
                [average_precision(s, t[ti], n_gt) for ti in range(T)]
            )
        vals = [a for a in per_class_ap.values() if not np.all(np.isnan(a))]
        if not vals:
            return 0.0
        return float(np.nanmean(np.stack(vals)))

    def map_with_images(self, evs: Sequence[ImageEval]) -> np.ndarray:
        """Batched ``map_with_image``: one array of exact mAP(accumulated ∪
        {image_i}) values.

        The base accumulator's AP sum/count are hoisted out of the per-image
        loop, so each image costs only its touched classes instead of a full
        O(classes) dict copy + nanmean pass per call.
        """
        frozen = self._freeze()
        base = self._base_aps()
        T = len(self.iou_thresholds)
        base_sum = 0.0
        base_cnt = 0
        for a in base.values():
            valid = ~np.isnan(a)
            base_sum += float(a[valid].sum())
            base_cnt += int(valid.sum())
        empty = (np.zeros((0,)), np.zeros((T, 0), dtype=bool))
        out = np.empty(len(evs), dtype=np.float64)
        for i, ev in enumerate(evs):
            total, count = base_sum, base_cnt
            for c in set(ev.per_class) | set(ev.gt_counts):
                s0, t0 = frozen.get(c, empty)
                if c in ev.per_class:
                    s1, t1 = ev.per_class[c]
                    s = np.concatenate([s0, s1])
                    t = np.concatenate([t0, t1], axis=1)
                else:
                    s, t = s0, t0
                n_gt = self._gt.get(c, 0) + ev.gt_counts.get(c, 0)
                new = np.array(
                    [average_precision(s, t[ti], n_gt) for ti in range(T)]
                )
                old = base.get(c)
                if old is not None:
                    valid = ~np.isnan(old)
                    total -= float(old[valid].sum())
                    count -= int(valid.sum())
                valid = ~np.isnan(new)
                total += float(new[valid].sum())
                count += int(valid.sum())
            out[i] = total / count if count else 0.0
        return out


def dataset_map(
    detections: Iterable[Detections],
    ground_truths: Iterable[GroundTruth],
    iou_thresholds: Sequence[float] = (0.5,),
) -> float:
    """mAP of a detector over a whole image set."""
    acc = APAccumulator(iou_thresholds)
    for det, gt in zip(detections, ground_truths):
        acc.add(match_detections(det, gt, iou_thresholds))
    return acc.map()
