"""Wrappers for the IoU kernel (``kernels/csrc/iou_matrix.cu``).

``iou_matrix_batch`` replaces ``repro/kernels/iou_matrix/kernel.py:64``
(``iou_matrix_batch_pallas``) and ``iou_matrix`` replaces ``kernel.py:90``
(``iou_matrix_pallas``); the latter is the B = 1 launch of the same kernel.
A CUDA tensor launches the kernel, a CPU tensor takes the plain version in
``ref.py``.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import resolve_path
from repro_torch.kernels.iou_matrix.ref import iou_matrix_batch_ref, iou_matrix_ref

__all__ = ["iou_matrix", "iou_matrix_batch"]

_LIB = "iou_matrix"
_ENTRIES = {torch.float32: "iou_matrix_batch_f32", torch.bfloat16: "iou_matrix_batch_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(a: torch.Tensor, b: torch.Tensor, ndim: int) -> None:
    if a.ndim != ndim or b.ndim != ndim or a.shape[-1] != 4 or b.shape[-1] != 4:
        raise ValueError(
            f"expected boxes of rank {ndim} with 4 coordinates, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if ndim == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch size mismatch: {a.shape[0]} vs {b.shape[0]}")
    if a.device != b.device:
        raise ValueError(f"boxes on different devices: {a.device} vs {b.device}")
    if a.dtype != b.dtype or a.dtype not in _ENTRIES:
        raise TypeError(f"boxes must both be float32 or bfloat16, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("boxes must be contiguous")


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, K, 4) x (B, M, 4) -> (B, K, M) on the card; every size >= 1."""
    B, K, M = a.shape[0], a.shape[1], b.shape[1]
    out = torch.empty((B, K, M), dtype=a.dtype, device=a.device)
    fn = _build.function(_LIB, _ENTRIES[a.dtype], _ARGTYPES, a.device)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, K, M,
                _build.stream_ptr(a.device))
    _build.check(rc, _LIB, "iou_matrix")
    return out


def iou_matrix_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image pairwise IoU, image i matched only against its own row:
    ``out[i] = iou(a[i], b[i])`` with shape (B, K, M)."""
    _check(a, b, 3)
    if resolve_path(a) == "reference":
        return iou_matrix_batch_ref(a, b)
    if a.numel() == 0 or b.numel() == 0:
        return torch.zeros((a.shape[0], a.shape[1], b.shape[1]), dtype=a.dtype, device=a.device)
    out = _launch(a, b)
    iou_matrix_batch.launches += 1
    return out


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``(N, 4) x (M, 4) -> (N, M)``."""
    _check(a, b, 2)
    if resolve_path(a) == "reference":
        return iou_matrix_ref(a, b)
    if a.numel() == 0 or b.numel() == 0:
        return torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    out = _launch(a[None], b[None])[0]
    iou_matrix.launches += 1
    return out


iou_matrix_batch.launches = 0
iou_matrix.launches = 0
