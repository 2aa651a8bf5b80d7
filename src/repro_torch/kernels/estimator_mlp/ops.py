"""Wrapper for the estimator MLP kernel (``kernels/csrc/estimator_mlp.cu``),
which replaces ``repro/kernels/estimator_mlp/kernel.py:27``
(``estimator_mlp_pallas``).

A CUDA tensor launches the kernel, a CPU tensor takes ``estimator_mlp_ref``.
The kernel takes any F and H as they are (no padding).  Launches are counted
in ``estimator_mlp.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import resolve_path
from repro_torch.kernels.estimator_mlp.ref import estimator_mlp_ref

__all__ = ["estimator_mlp", "check_mlp_params"]

_LIB = "estimator_mlp"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def check_mlp_params(device, w1, b1, w2, b2) -> "tuple[int, int]":
    """Validate the head's weights against ``device``; returns (F, H)."""
    if w1.ndim != 2:
        raise ValueError(f"w1 must be (F, H), got {tuple(w1.shape)}")
    F, H = w1.shape
    for name, t, shape in (("w1", w1, (F, H)), ("b1", b1, (H,)), ("w2", w2, (H,)), ("b2", b2, ())):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, inputs on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return F, H


def estimator_mlp(
    x: torch.Tensor,  # (B, F)
    w1: torch.Tensor,  # (F, H)
    b1: torch.Tensor,  # (H,)
    w2: torch.Tensor,  # (H,)
    b2: torch.Tensor,  # ()
) -> torch.Tensor:
    """``sigmoid(gelu_tanh(x @ w1 + b1) @ w2 + b2)`` -> (B,) float32."""
    F, H = check_mlp_params(x.device, w1, b1, w2, b2)
    if x.ndim != 2 or x.shape[1] != F:
        raise ValueError(f"x must be (B, {F}), got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"x must be contiguous float32, got {x.dtype}")
    B = x.shape[0]
    if B == 0:  # a zero-sized grid is refused by CUDA
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    if resolve_path(x) == "reference":
        return estimator_mlp_ref(x, w1, b1, w2, b2)
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    fn = _build.function(_LIB, "estimator_mlp_f32", _ARGTYPES, x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), out.data_ptr(), B, F, H, _build.stream_ptr(x.device))
    _build.check(rc, _LIB, "estimator_mlp")
    estimator_mlp.launches += 1
    return out


estimator_mlp.launches = 0
