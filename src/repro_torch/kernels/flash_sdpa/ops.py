"""Wrapper for the flash SDPA kernels, which replace
``repro/kernels/flash_sdpa/kernel.py:65`` (``flash_sdpa_pallas``) and its
wrapper ``repro/kernels/flash_sdpa/ops.py:17``.

A CPU tensor takes ``flash_sdpa_ref``.  A CUDA tensor launches one of three
hand-written kernels, chosen by dtype and shape alone (:func:`flash_route`),
never by catching a failure:

``"wgmma"``   bfloat16, D in {64, 80, 128}, more than G = H / K query rows a
              KV head (prefill): ``csrc/flash_sdpa_wgmma.cu``, tensor-core
              products, TMA tiles, P rounded to bf16 before P V (D = 80 in
              the D = 128 layout, its last 48 columns zero-filled by TMA).
``"decode"``  bfloat16, D in {64, 80, 128}, S <= G and S G <= 64 (a decode
              step): ``csrc/flash_sdpa_decode.cu``, split-K over the key
              range with the GQA group in one CTA (:func:`decode_plan`), then
              a second launch that merges the splits (``"decode_combine"``).
``"simt"``    float32, or bfloat16 at D = 32: ``csrc/flash_sdpa.cu``,
              float32 products on the CUDA cores.

Every kernel reads GQA K/V in the model's (B, T, K, D) layout: no repeat, no
transpose, no padding of S or T.

Under grad mode, when q, k or v requires grad, the call goes through a
``torch.autograd.Function`` (on either device): its forward is the same
launch (or, on the CPU, the plain version), it saves only its inputs, and
its backward recomputes ``flash_sdpa_ref`` and differentiates that.  The
TPU kernel has no backward kernel either: ``repro`` differentiates its jnp
attention.  ``flash_sdpa.launches`` counts kernel
launches, ``flash_sdpa.launches_by_route`` the same by route and
``flash_sdpa.launches_by_shape`` by shape (``"prefill"``: S > 1,
``"decode"``: S = 1).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import refuse_dtensor, resolve_path, wants_grad
from repro_torch.kernels.flash_sdpa.ref import flash_sdpa_ref

__all__ = ["flash_sdpa", "flash_route", "decode_plan", "DecodePlan"]

_LIBS = {"simt": "flash_sdpa", "wgmma": "flash_sdpa_wgmma", "decode": "flash_sdpa_decode"}
_ARGTYPES = {
    "simt": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    "wgmma": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "decode": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
}
HEAD_DIMS = (32, 64, 80, 128)
TENSOR_CORE_HEAD_DIMS = (64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)
DECODE_MAX_ROWS = 64  # query rows (S G) one decode CTA holds
DECODE_TILE = 32  # keys a decode tile
H100_SMS = 132
INT32_MAX = 2**31 - 1


def flash_route(dtype: torch.dtype, S: int, D: int, G: int) -> str:
    """The kernel a CUDA call takes for queries of ``dtype``, S query rows,
    head dim D and G query heads a KV head: ``"wgmma"``, ``"decode"`` or
    ``"simt"``."""
    if dtype == torch.bfloat16 and D in TENSOR_CORE_HEAD_DIMS:
        return "decode" if S <= G and S * G <= DECODE_MAX_ROWS else "wgmma"
    return "simt"


class DecodePlan(NamedTuple):
    """How the decode route cuts the keys [kbeg, kend) a call may see into
    ``splits`` runs of ``tiles_per_split`` 32-key tiles, one CTA a (batch,
    KV head, split), each holding the ``rows`` = S G query rows of its group;
    the float32 scratch the splits write for the merge."""

    kbeg: int
    kend: int
    tiles: int
    splits: int
    tiles_per_split: int
    rows: int
    acc_shape: Tuple[int, ...]  # (B, K, splits, rows, D)
    ml_shape: Tuple[int, ...]  # (B, K, splits, rows, 2): running max, denominator


@functools.lru_cache(maxsize=4096)  # a decode step asks again for every layer
def decode_plan(B: int, S: int, T: int, H: int, K: int, D: int, causal: bool = True,
                window: int = 0, q_offset: int = 0, num_sms: int = H100_SMS) -> DecodePlan:
    """Splits enough for the grid to cover ``num_sms`` at least twice (or one
    a tile, when there are fewer tiles), then as few as give each split the
    same count of tiles, so that no split is empty."""
    kend = min(T, q_offset + S) if causal else T
    kbeg = max(0, q_offset - window + 1) if window > 0 else 0
    tiles = -(-max(kend - kbeg, 0) // DECODE_TILE)
    want = -(-2 * num_sms // (B * K))
    splits = max(1, min(tiles, want))
    per = -(-tiles // splits) if tiles else 0
    splits = -(-tiles // per) if tiles else 1
    rows = S * (H // K)
    return DecodePlan(kbeg, kend, tiles, splits, per, rows,
                      (B, K, splits, rows, D), (B, K, splits, rows, 2))


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
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, k and v must start on a 16-byte boundary (the kernels read 16-byte "
                         "vectors and TMA boxes)")
    if D * q.element_size() % 16:
        raise ValueError(f"a head of {D} {q.dtype} values is not a multiple of 16 bytes: TMA's "
                         f"strides (a head, a row of heads) and the 16-byte vector loads need it")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window ({window}) and q_offset ({q_offset}) must be >= 0")
    if max(q_offset + S, window, k.shape[1], B * H * S) > INT32_MAX:
        raise ValueError("sizes, window and q_offset + S must fit in 32 bits")


_SM_COUNT = {}


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SM_COUNT:
        _SM_COUNT[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev.index]


def _launch(route: str, q, k, v, out, causal: bool, window: int, q_offset: int) -> None:
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    dev = q.device
    lib = _LIBS[route]
    fn = _build.function(lib, lib, _ARGTYPES[route], dev)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        if route == "simt":
            rc = fn(*ptrs, int(q.dtype == torch.bfloat16), B, S, T, H, K, D, int(causal),
                    int(window), int(q_offset), _build.stream_ptr(dev))
        elif route == "wgmma":
            rc = fn(*ptrs, B, S, T, H, K, D, int(causal), int(window), int(q_offset),
                    _build.stream_ptr(dev))
        else:
            plan = decode_plan(B, S, T, H, K, D, bool(causal), int(window), int(q_offset),
                               _sm_count(dev))
            # one scratch allocation: the partial outputs, then (max, denominator) pairs
            n_acc = math.prod(plan.acc_shape)
            scratch = torch.empty(n_acc + math.prod(plan.ml_shape), dtype=torch.float32, device=dev)
            acc_ptr = scratch.data_ptr()
            rc = fn(*ptrs, acc_ptr, acc_ptr + 4 * n_acc, B, S, T, H, K, D, int(causal),
                    int(window), int(q_offset), plan.kbeg, plan.kend, plan.tiles_per_split,
                    plan.splits, _build.stream_ptr(dev))
    _build.check(rc, lib, f"flash_sdpa ({route} route)")
    kernels = ("decode", "decode_combine") if route == "decode" else (route,)
    for name in kernels:
        flash_sdpa.launches_by_route[name] += 1
    flash_sdpa.launches_by_shape["prefill" if S > 1 else "decode"] += len(kernels)
    flash_sdpa.launches += len(kernels)


def _forward(q, k, v, causal: bool, window: int, q_offset: int) -> torch.Tensor:
    """The plain version on the CPU, one of the kernels on the card."""
    if resolve_path(q) == "reference":
        return flash_sdpa_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0 or T == 0:
        return out.zero_()
    _launch(flash_route(q.dtype, S, D, H // K), q, k, v, out, causal, window, q_offset)
    return out


class _FlashSdpaGrad(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        return _forward(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = flash_sdpa_ref(*xs, *ctx.mask)
            got = iter(torch.autograd.grad(out, [x for x in xs if x.requires_grad], grad))
        return (*(next(got) if x.requires_grad else None for x in xs), None, None, None)


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
    no key gives 0, and a gradient of 0."""
    refuse_dtensor(q, k, v)
    _check(q, k, v, window, q_offset)
    if wants_grad(q, k, v):
        return _FlashSdpaGrad.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset)


flash_sdpa.launches = 0
flash_sdpa.launches_by_route = {"wgmma": 0, "decode": 0, "decode_combine": 0, "simt": 0}
flash_sdpa.launches_by_shape = {"prefill": 0, "decode": 0}  # S > 1 / S = 1
