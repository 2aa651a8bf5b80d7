"""Plain PyTorch versions of the IoU kernels: the path CPU tensors take, and
what ``chip_smoke.py`` holds the CUDA kernel against on the card.

Like the kernel, they compute in float32 and return the input dtype, so a
bfloat16 input differs from the kernel only by the final rounding."""
from __future__ import annotations

import torch

from repro_torch.detection.boxes import box_iou


def iou_matrix_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (N, 4), b: (M, 4) -> (N, M)."""
    return box_iou(a.float(), b.float()).to(a.dtype)


def iou_matrix_batch_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (B, K, 4), b: (B, M, 4) -> (B, K, M); image i only against its own
    row."""
    return box_iou(a.float(), b.float()).to(a.dtype)
