"""Plain PyTorch versions of the iou_matrix family's three routes: the path
CPU tensors take, and what ``chip_smoke.py`` holds the CUDA kernels against
on the card.

* ``iou_matrix_ref`` / ``iou_matrix_batch_ref`` (the ``matrix`` route): like
  the kernel, they compute in float32 and return the input dtype, so a
  bfloat16 input differs from the kernel only by the final rounding.
* ``nms_keep_ref`` (the ``nms`` route): class-aware greedy NMS, the
  reference's ``fori_loop`` over the score-sorted slots
  (``repro/detection/nms.py``) as a loop over the sorted positions, each step
  over the whole batch.
* ``greedy_match_ref`` (the ``match`` route): COCO greedy matching, the
  reference's ``_match_inputs`` and ``lax.scan`` (``repro/detection/
  batch.py``) as a loop over the K score-ordered positions.

The two loops are exact (bool / int results); the kernels equal them
exactly, since their float32 IoU is bit-equal to ``box_iou``'s.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.detection.boxes import box_iou


def iou_matrix_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (N, 4), b: (M, 4) -> (N, M)."""
    return box_iou(a.float(), b.float()).to(a.dtype)


def iou_matrix_batch_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (B, K, 4), b: (B, M, 4) -> (B, K, M); image i only against its own
    row."""
    return box_iou(a.float(), b.float()).to(a.dtype)


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


def nms_keep_ref(
    boxes: torch.Tensor,  # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    classes: torch.Tensor,  # (B, N)
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
) -> torch.Tensor:
    """Keep mask ``(B, N)``: a box is kept if its score exceeds
    ``score_threshold`` and no kept, higher-scored box of its class overlaps
    it by more than ``iou_threshold``."""
    # jnp.argsort is stable: ties keep slot order
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.take_along_dim(boxes, order[..., None], dim=-2)
    scores_s, classes_s = scores.gather(-1, order), classes.gather(-1, order)
    iou = iou_matrix_batch_ref(boxes_s, boxes_s)
    keep_s = _keep_sorted(iou, classes_s, scores_s, iou_threshold, score_threshold)
    return torch.zeros_like(keep_s).scatter(1, order, keep_s)


def _greedy_match(
    iou: torch.Tensor,  # (B, K, M) masked: ineligible pairs hold -1
    order: torch.Tensor,  # (B, K) detection slots by descending score
    thresholds: torch.Tensor,  # (T,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``lax.scan`` over score-ordered slots as a loop over
    the K positions, each step a few ops over the whole batch."""
    B, K, M = iou.shape
    T = thresholds.shape[0]
    if M == 0 or K == 0:
        return (
            torch.zeros((B, T, K), dtype=torch.bool, device=iou.device),
            torch.full((B, T, K), -1, dtype=torch.int32, device=iou.device),
        )
    iou_s = torch.take_along_dim(iou, order[:, :, None], dim=1)
    taken = torch.zeros((B, T, M), dtype=torch.bool, device=iou.device)
    slot = torch.arange(M, device=iou.device)
    neg = torch.tensor(-1.0, dtype=iou.dtype, device=iou.device)
    hits, picks = [], []
    for k in range(K):
        avail = torch.where(taken, neg, iou_s[:, None, k, :])  # (B, T, M)
        j = avail.argmax(dim=-1)  # (B, T) first max, as np.argmax
        best = avail.gather(-1, j[..., None])[..., 0]
        hit = best >= thresholds
        taken |= hit[..., None] & (slot == j[..., None])
        hits.append(hit)
        picks.append(torch.where(hit, j, -1))
    tp_s = torch.stack(hits, dim=2)  # (B, T, K) in sorted-detection order
    mj_s = torch.stack(picks, dim=2).to(torch.int32)
    # scatter back to the original slots: inv[b, slot] = sorted position
    inv = torch.argsort(order, dim=1)
    tp = torch.take_along_dim(tp_s, inv[:, None, :], dim=2)
    mj = torch.take_along_dim(mj_s, inv[:, None, :], dim=2)
    return tp, mj


def _match_inputs(d_scores, d_classes, d_mask, g_classes, g_mask, iou):
    """Eligibility masking + the global score order that reproduces the
    per-class stable sort of ``match_detections``: one pass in descending
    score order with class-eligibility masking is the per-class loop; the
    stable sort keeps the reference's tie order and invalid slots sink with
    -inf keys."""
    eligible = (
        d_mask[:, :, None]
        & g_mask[:, None, :]
        & (d_classes[:, :, None] == g_classes[:, None, :])
    )
    masked = torch.where(eligible, iou, torch.full_like(iou, -1.0))
    keys = torch.where(d_mask, d_scores, torch.full_like(d_scores, -torch.inf))
    order = torch.argsort(-keys, dim=1, stable=True)
    return masked, order


def greedy_match_ref(
    det_boxes: torch.Tensor,  # (B, K, 4)
    det_scores: torch.Tensor,  # (B, K)
    det_classes: torch.Tensor,  # (B, K)
    det_mask: torch.Tensor,  # (B, K) bool
    gt_boxes: torch.Tensor,  # (B, M, 4)
    gt_classes: torch.Tensor,  # (B, M)
    gt_mask: torch.Tensor,  # (B, M) bool
    thresholds: torch.Tensor,  # (T,) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """COCO greedy matching of every image at every threshold: ``tp (B, T,
    K)`` bool and ``match_gt (B, T, K)`` int32 (the matched GT slot, -1 on a
    miss), at the detections' original slots."""
    iou = iou_matrix_batch_ref(det_boxes, gt_boxes)
    masked, order = _match_inputs(det_scores, det_classes, det_mask, gt_classes, gt_mask, iou)
    return _greedy_match(masked, order, thresholds)
