"""Box geometry on tensors, and the host-side numpy IoU.

Boxes are ``[x1, y1, x2, y2]`` with ``x2 >= x1`` and ``y2 >= y1``, in
normalized or pixel coordinates (the math is scale-free).  The tensor
functions take any leading batch dimensions.
"""
from __future__ import annotations

import numpy as np
import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of ``(..., 4)`` xyxy boxes."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between ``a: (..., N, 4)`` and ``b: (..., M, 4)`` ->
    ``(..., N, M)``; the same operations, in the same order, as
    ``repro.detection.boxes.box_iou``."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])  # (..., N, M, 2)
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(
        union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(inter)
    )


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Numpy pairwise IoU, ``(N, 4) x (M, 4) -> (N, M)`` (copied from the JAX
    package)."""
    a = np.asarray(a, dtype=np.float64).reshape(-1, 4)
    b = np.asarray(b, dtype=np.float64).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    out = np.zeros_like(inter)
    np.divide(inter, union, out=out, where=union > 0)
    return out


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` centre / size boxes -> ``[x1, y1, x2, y2]``."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` ``[x1, y1, x2, y2]`` boxes -> centre / size."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)

