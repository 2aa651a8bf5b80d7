"""Fixed-size class-aware non-maximum suppression.

Works on padded detections: a box only suppresses later (lower-scored) boxes
of its own class whose IoU with it exceeds ``iou_threshold``, if it is itself
kept; boxes at or below ``score_threshold`` are never kept.

``nms_batch`` is the reference's per-image ``vmap`` written out over a
batch; ``nms`` is one image, as ``repro.detection.nms.nms``, and is
``nms_batch`` of that image.  On the card a batch is one launch of the IoU
kernel family's ``nms`` route (``kernels/iou_matrix``: the score rank, the IoU
tile, the suppression bitmask and the greedy scan in one CTA an image); on
the CPU it is the plain version ``nms_keep_ref``, the reference's
``fori_loop`` over the score-sorted slots as a loop over the sorted
positions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.iou_matrix import nms_keep


def nms(
    boxes: torch.Tensor,  # (N, 4)
    scores: torch.Tensor,  # (N,)
    classes: torch.Tensor,  # (N,)
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
) -> torch.Tensor:
    """Keep mask ``(N,)`` of bools for one image."""
    return nms_batch(boxes[None], scores[None], classes[None], iou_threshold, score_threshold)[0]


def nms_batch(
    boxes: torch.Tensor,  # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    classes: torch.Tensor,  # (B, N)
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
) -> torch.Tensor:
    """Keep mask ``(B, N)``: ``nms`` applied to every image."""
    return nms_keep(boxes, scores, classes, iou_threshold, score_threshold)
