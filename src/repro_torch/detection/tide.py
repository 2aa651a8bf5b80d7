"""TIDE-style decomposition of detection errors into six categories.

Following Bolya et al. [24] (as used in the paper's Fig. 6) we bucket every
false positive / missed ground truth into:

  * ``cls``      — right place, wrong label        (IoU >= tf with other-class GT)
  * ``loc``      — right label, wrong place        (tb <= IoU < tf, same class)
  * ``cls_loc``  — wrong label and place           (tb <= IoU < tf, other class)
  * ``dupe``     — re-detects an already-matched GT (IoU >= tf, same class, taken)
  * ``bkg``      — hallucination                   (IoU < tb with every GT)
  * ``miss``     — GT with no detection at IoU >= tb of any class

and report, per category, the **mAP gained by oracle-fixing it** (TIDE's
"amount of mAP reduction caused by the category").  This is a TIDE-lite: fix
semantics are the standard ones (cls/loc errors become TPs when their GT is
free, otherwise are removed; dupe/bkg/cls_loc detections are removed; misses
shrink the GT denominator), applied independently per category.

Copied from the JAX package (``repro.detection.tide``): host numpy over the
port's ``box_iou_np`` and mAP engine.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.detection.boxes import box_iou_np
from repro_torch.detection.map_engine import (
    APAccumulator,
    Detections,
    GroundTruth,
    ImageEval,
    match_detections,
)

CATEGORIES = ("cls", "loc", "cls_loc", "dupe", "bkg", "miss")


def _classify_image(
    det: Detections, gt: GroundTruth, tf: float, tb: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-detection error label + per-GT missed flag for one image.

    Returns ``(labels (N,), matched (N,), best_gt (N,), missed (M,))`` where
    labels are indices into CATEGORIES (-1 = true positive), ``best_gt`` is
    the index of the max-IoU ground-truth box (or -1).
    """
    n, m = len(det), len(gt)
    labels = np.full(n, -1, dtype=np.int64)
    matched = np.zeros(n, dtype=bool)
    best_gt = np.full(n, -1, dtype=np.int64)
    gt_taken = np.zeros(m, dtype=bool)
    if m:
        iou = box_iou_np(det.boxes, gt.boxes)  # (n, m)
    else:
        iou = np.zeros((n, 0))
    order = np.argsort(-det.scores, kind="stable")
    for k in order:
        c = det.classes[k]
        same = (gt.classes == c) if m else np.zeros((0,), dtype=bool)
        row = iou[k] if m else np.zeros((0,))
        # greedy TP matching at tf within class
        cand = np.where(same & ~gt_taken, row, -1.0)
        j = int(np.argmax(cand)) if m else -1
        if j >= 0 and cand[j] >= tf:
            matched[k] = True
            gt_taken[j] = True
            best_gt[k] = j
            continue
        iou_same = float(np.max(np.where(same, row, -1.0))) if m else -1.0
        iou_other = float(np.max(np.where(~same, row, -1.0))) if m else -1.0
        best_gt[k] = int(np.argmax(row)) if m else -1
        if iou_same >= tf:
            labels[k] = CATEGORIES.index("dupe")
        elif iou_other >= tf:
            labels[k] = CATEGORIES.index("cls")
        elif iou_same >= tb:
            labels[k] = CATEGORIES.index("loc")
        elif iou_other >= tb:
            labels[k] = CATEGORIES.index("cls_loc")
        else:
            labels[k] = CATEGORIES.index("bkg")
    if m:
        covered = (iou >= tb).any(axis=0) | gt_taken
        missed = ~covered
    else:
        missed = np.zeros((0,), dtype=bool)
    return labels, matched, best_gt, missed


def _fixed_eval(
    det: Detections,
    gt: GroundTruth,
    fix: str,
    tf: float,
    tb: float,
) -> ImageEval:
    """ImageEval for one image with error category ``fix`` oracle-corrected."""
    labels, matched, best_gt, missed = _classify_image(det, gt, tf, tb)
    fix_idx = CATEGORIES.index(fix)
    boxes = det.boxes.copy()
    classes = det.classes.copy()
    keep = np.ones(len(det), dtype=bool)
    sel = labels == fix_idx
    if fix in ("dupe", "bkg", "cls_loc"):
        keep[sel] = False
    elif fix == "cls":
        # relabel to the overlapped GT's class; dedup handled by re-matching
        for k in np.where(sel)[0]:
            if best_gt[k] >= 0:
                classes[k] = gt.classes[best_gt[k]]
            else:
                keep[k] = False
    elif fix == "loc":
        # snap the box onto the overlapped GT
        for k in np.where(sel)[0]:
            if best_gt[k] >= 0:
                boxes[k] = gt.boxes[best_gt[k]]
            else:
                keep[k] = False
    gt_boxes, gt_classes = gt.boxes, gt.classes
    if fix == "miss":
        gt_boxes = gt.boxes[~missed]
        gt_classes = gt.classes[~missed]
    det2 = Detections(boxes[keep], det.scores[keep], classes[keep])
    gt2 = GroundTruth(gt_boxes, gt_classes)
    return match_detections(det2, gt2, (tf,))


def tide_errors(
    detections: Sequence[Detections],
    ground_truths: Sequence[GroundTruth],
    tf: float = 0.5,
    tb: float = 0.1,
) -> Dict[str, float]:
    """Per-category delta-mAP (oracle fix gain) plus raw error counts.

    Returns ``{category: dmap, f"{category}_count": int, "base_map": float}``.
    """
    base_acc = APAccumulator((tf,))
    counts = {c: 0 for c in CATEGORIES}
    for det, gt in zip(detections, ground_truths):
        base_acc.add(match_detections(det, gt, (tf,)))
        labels, _, _, missed = _classify_image(det, gt, tf, tb)
        for ci, c in enumerate(CATEGORIES[:-1]):
            counts[c] += int(np.sum(labels == ci))
        counts["miss"] += int(np.sum(missed))
    base_map = base_acc.map()
    out: Dict[str, float] = {"base_map": base_map}
    for cat in CATEGORIES:
        acc = APAccumulator((tf,))
        for det, gt in zip(detections, ground_truths):
            acc.add(_fixed_eval(det, gt, cat, tf, tb))
        out[cat] = max(acc.map() - base_map, 0.0)
        out[f"{cat}_count"] = counts[cat]
    return out
