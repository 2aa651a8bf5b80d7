"""Fixed-size class-aware non-maximum suppression.

Works on padded detections: a box only suppresses later (lower-scored) boxes
of its own class whose IoU with it exceeds ``iou_threshold``, if it is itself
kept; boxes at or below ``score_threshold`` are never kept.  The reference's
``fori_loop`` over the score-sorted list becomes a loop over the sorted
positions on the tensors' device.

``nms_batch`` is the reference's per-image ``vmap`` written out over a
batch; ``nms`` is one image, as ``repro.detection.nms.nms``, and is
``nms_batch`` of that image.  A batch takes its IoU from the
``iou_matrix_batch`` kernel and a single image from ``iou_matrix``, the
one-image launch of the same kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch


def _keep_sorted(
    iou: torch.Tensor,  # (B, N, N) IoU of the score-sorted boxes
    classes_s: torch.Tensor,  # (B, N)
    scores_s: torch.Tensor,  # (B, N)
    iou_threshold: float,
    score_threshold: float,
) -> torch.Tensor:
    n = iou.shape[-1]
    later = torch.ones((n, n), dtype=torch.bool, device=iou.device).triu(1)
    suppress = (iou > iou_threshold) & (classes_s[:, :, None] == classes_s[:, None, :]) & later
    keep = scores_s > score_threshold
    for i in range(n):
        # i suppresses the later boxes it overlaps, if i itself is kept
        keep = keep & ~(suppress[:, i] & keep[:, i : i + 1])
    return keep


def _sort(boxes, scores, classes):
    # jnp.argsort is stable: ties keep slot order
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.take_along_dim(boxes, order[..., None], dim=-2)
    return order, boxes_s, scores.gather(-1, order), classes.gather(-1, order)


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
    order, boxes_s, scores_s, classes_s = _sort(boxes, scores, classes)
    if boxes_s.shape[0] == 1:
        iou = iou_matrix(boxes_s[0], boxes_s[0])[None]
    else:
        iou = iou_matrix_batch(boxes_s, boxes_s)
    keep_s = _keep_sorted(iou, classes_s, scores_s, iou_threshold, score_threshold)
    return torch.zeros_like(keep_s).scatter(1, order, keep_s)
