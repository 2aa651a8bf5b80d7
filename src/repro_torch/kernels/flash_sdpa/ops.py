"""Wrapper for the flash SDPA kernel (``kernels/csrc/flash_sdpa.cu``),
which replaces ``repro/kernels/flash_sdpa/kernel.py:65``
(``flash_sdpa_pallas``) and its wrapper ``repro/kernels/flash_sdpa/ops.py:17``.

A CUDA tensor launches the kernel, a CPU tensor takes ``flash_sdpa_ref``.
The kernel reads GQA K/V in the model's layout: no repeat, no transpose, no
padding of S or T.  Launches are counted in ``flash_sdpa.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import resolve_path
from repro_torch.kernels.flash_sdpa.ref import flash_sdpa_ref

__all__ = ["flash_sdpa"]

_LIB = "flash_sdpa"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, q_offset: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q must be (B, S, H, D) and k, v (B, T, K, D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] < 1 or H % k.shape[2] != 0:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[2]} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported; the kernel takes {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start on a 16-byte boundary (the kernel reads 16-byte vectors)")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window ({window}) and q_offset ({q_offset}) must be >= 0")


def flash_sdpa(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, K, D), H % K == 0
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Masked softmax attention -> (B, S, H, D) in q's dtype.  Query ``i``
    sits at position ``q_offset + i``; ``causal`` hides later keys and
    ``window > 0`` keys at or before ``position - window``.  A row that sees
    no key gives 0."""
    _check(q, k, v, window, q_offset)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if resolve_path(q) == "reference":
        return flash_sdpa_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    out = torch.empty_like(q)
    if out.numel() == 0 or T == 0:
        return out.zero_()
    fn = _build.function(_LIB, "flash_sdpa", _ARGTYPES, q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.bfloat16), B, S, T, H, K, D, int(causal),
                int(window), int(q_offset), _build.stream_ptr(q.device))
    _build.check(rc, _LIB, "flash_sdpa")
    flash_sdpa.launches += 1
    return out


flash_sdpa.launches = 0
