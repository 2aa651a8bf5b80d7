"""Wrapper for the WKV6 kernel (``kernels/csrc/wkv6.cu``), which replaces
``repro/kernels/wkv6/kernel.py:41`` (``wkv6_pallas``) and its wrapper
``repro/kernels/wkv6/ops.py:14``.

A CUDA tensor launches the kernel, a CPU tensor takes ``wkv6_ref``.  r/k/v
may be float32 or bfloat16 and w float32 or bfloat16 (the RWKV6 layer passes
its bfloat16 projections and its float32 decay as they are); u and s0 are
taken as float32.  Launches are counted in ``wkv6.launches``, and by shape
(``"prefill"``: T > 1, ``"decode"``: T = 1) in ``wkv6.launches_by_shape``.

Under grad mode, when an input requires grad, the call goes through a
``torch.autograd.Function`` (on either device): its forward is the same
launch (or, on the CPU, the plain version), it saves only its inputs, and
its backward recomputes ``wkv6_ref`` and differentiates that, for the
gradients of ``out`` and of ``sT`` that are given.  The TPU kernel has no
backward kernel either: ``repro`` differentiates its ``lax.scan``
recurrence.  The plain backward is a Python loop over T.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import meta_traced, refuse_dtensor, resolve_path, wants_grad
from repro_torch.kernels.wkv6.ref import wkv6_ref

__all__ = ["wkv6"]

_LIB = "wkv6"
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
KEY_DIMS = (8, 16, 32, 64)
MAX_VALUE_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)


def _check(r, k, v, w, u, s0) -> None:
    if r.ndim != 4 or v.ndim != 4:
        raise ValueError(f"r must be (B, T, H, K) and v (B, T, H, V); got {tuple(r.shape)}, {tuple(v.shape)}")
    B, T, H, K = r.shape
    V = v.shape[3]
    for name, t, shape in (("k", k, (B, T, H, K)), ("w", w, (B, T, H, K)),
                           ("v", v, (B, T, H, V)), ("u", u, (H, K)), ("s0", s0, (B, H, K, V))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if K not in KEY_DIMS or not 1 <= V <= MAX_VALUE_DIM:
        raise ValueError(f"K = {K}, V = {V} not supported; the kernel takes K in {KEY_DIMS}, V <= {MAX_VALUE_DIM}")
    if r.dtype not in DTYPES or not (r.dtype == k.dtype == v.dtype):
        raise TypeError(f"r, k, v must share float32 or bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype not in DTYPES or not (u.is_floating_point() and s0.is_floating_point()):
        raise TypeError(f"w must be float32 or bfloat16 (got {w.dtype}); u, s0 floating")
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("r, k, v, w must be contiguous")


def _forward(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on the CPU, the kernel on the card."""
    B, T, H, K = r.shape
    V = v.shape[3]
    if resolve_path(r) == "reference":
        return wkv6_ref(r, k, v, w, u, s0)
    u = u.to(torch.float32).contiguous()
    s0 = s0.to(torch.float32).contiguous()
    out = torch.empty((B, T, H, V), dtype=torch.float32, device=r.device)
    if B * H == 0 or T == 0:
        return out, s0.clone()
    sT = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    fn = _build.function(_LIB, "wkv6", _ARGTYPES, r.device)
    with torch.cuda.device(r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                s0.data_ptr(), out.data_ptr(), sT.data_ptr(), int(r.dtype == torch.bfloat16),
                int(w.dtype == torch.bfloat16), B, T, H, K, V, _build.stream_ptr(r.device))
    _build.check(rc, _LIB, "wkv6")
    wkv6.launches += 1
    wkv6.launches_by_shape["prefill" if T > 1 else "decode"] += 1
    return out, sT


class _Wkv6Grad(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)  # an unused sT gives None, not zeros
        return _forward(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, g_out, g_state):
        given = [(i, g) for i, g in enumerate((g_out, g_state)) if g is not None]
        if not given:
            return (None,) * 6
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            outs = wkv6_ref(*xs)
            got = iter(torch.autograd.grad([outs[i] for i, _ in given],
                                           [x for x in xs if x.requires_grad],
                                           [g for _, g in given], allow_unused=True))
        return tuple(next(got) if x.requires_grad else None for x in xs)


class _Wkv6Shapes(torch.autograd.Function):
    """The dry run's stand-in on meta tensors: the recurrence's output and
    state shapes, and its gradients' (a loop over T computes nothing on meta;
    the dry run counts the recurrence's FLOPs analytically)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.shapes = [(t.shape, t.dtype) for t in (r, k, v, w, u, s0)]
        B, T, H, _ = r.shape
        V = v.shape[3]
        return (r.new_empty((B, T, H, V), dtype=torch.float32),
                r.new_empty((B, H, r.shape[3], V), dtype=torch.float32))

    @staticmethod
    def backward(ctx, g_out, g_state):
        return tuple(g_out.new_empty(shape, dtype=dt) if need else None
                     for (shape, dt), need in zip(ctx.shapes, ctx.needs_input_grad))


def wkv6(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, T, H, V)
    w: torch.Tensor,  # (B, T, H, K) decay in (0, 1)
    u: torch.Tensor,  # (H, K) per-head bonus
    s0: torch.Tensor,  # (B, H, K, V) incoming state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 recurrence; returns (out (B, T, H, V), sT (B, H, K, V)),
    both float32."""
    refuse_dtensor(r, k, v, w, u, s0)
    _check(r, k, v, w, u, s0)
    if meta_traced(r):
        return _Wkv6Shapes.apply(r, k, v, w, u, s0)
    if wants_grad(r, k, v, w, u, s0):
        return _Wkv6Grad.apply(r, k, v, w, u, s0)
    return _forward(r, k, v, w, u, s0)


wkv6.launches = 0
wkv6.launches_by_shape = {"prefill": 0, "decode": 0}
