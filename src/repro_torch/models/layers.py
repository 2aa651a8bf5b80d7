"""Transformer, MoE, MLA, RWKV6 and Mamba2 layers for the LM (the dense, VLM,
MoE, RWKV, hybrid and encoder-decoder families of ``repro.models.layers``).

Everything is functional, as in the JAX package: parameters are nested dicts
of tensors under ``repro``'s keys, and ``*_apply(params, x, ...)`` computes in
the activation type of ``x``, casting each weight to it where it is used (a
no-op for weights stored in that type; training keeps float32 leaves and
differentiates through the casts, as ``repro`` does).

Attention runs on the ``flash_sdpa`` kernel and the RWKV6 time-mix on the
``wkv6`` kernel; under grad mode both differentiate their plain versions
(see the kernels' ``ops.py``).  ``attention_apply`` and ``rwkv6_time_mix``
take ``plain``: ``True`` calls the kernel's plain PyTorch version instead,
whatever the device, so that a forward on the card can be held against the
same forward without the kernels.  (The wrappers themselves only take the
plain version for CPU tensors.)

The decode cache may be a ring (``window > 0``: slot ``pos % C``) and may
hold int8 keys and values with per-(slot, head) scales (``cache_scales``,
:func:`kv_quantize`), as in the JAX package.

Sharding: the JAX package's ``constrain`` hints sit at the same points
here (``launch.meshctx.constrain``): with no mesh bound each returns its
input, and under a bound mesh (``launch.meshctx.bind_mesh``) the
activations are ``DTensor``s and each hint redistributes them.  A kernel
takes plain tensors, so under a mesh ``flash_sdpa``, ``wkv6`` and the
Mamba2 scan run on each rank's local shards (``meshctx.local_call``), with
placements chosen a mesh dimension: the batch over the batch axes; whole
heads, and whole GQA groups, over ``model`` where both head counts divide
it; under ``AttnConfig.seq_shard`` (context parallelism) the query rows over
``model``, K / V whole, each rank attending at its rows' own ``q_offset``;
otherwise replicated.  A one-slot cache write on a slot-sharded cache is
made by the rank that owns the slot (:func:`write_slots`).  The MoE routes
and dispatches on each rank's groups, runs the experts sharded over
``expert`` and combines on the gathered expert outputs.

The JAX package's query chunking (``attn_chunk``) bounds memory without
changing any value of the forward; the flash kernel never forms the (S, T)
logits, so it has no counterpart here.  Its remat (``jax.checkpoint``
around a layer) is ``torch.utils.checkpoint`` in ``models.lm.forward``, and
``chunked_scan``'s chunk checkpoints have no counterpart: the ``wkv6``
Function saves only its inputs.  MLA's query chunking (``MLAConfig.attn_chunk``)
is the same kind of hint: each query row's softmax is its own, so MLA
attends over the whole sequence at once.

The MoE layer routes in float32 (the router stays float32 whatever the
activation type), dispatches each kept (token, expert) assignment into its
expert's capacity slot by assignment (the kept slots are distinct), and
combines each token's K slot outputs by a gather and a sum over K, on the
flat and on the grouped path: one fixed order, where a scatter-add would
use atomics on the card.  MLA (DeepSeek-V2) runs in plain PyTorch, as the
JAX package runs it in jnp: its q/k width (qk_nope + qk_rope = 192) is not
one the ``flash_sdpa`` kernel takes.

M-RoPE (Qwen2-VL) rotates each frequency band by the position id of its
axis (temporal, height, width); a query or key takes it where the config
has ``mrope_sections`` and the call is given ``positions_3d``, else 1-D
RoPE at ``positions``, as in the JAX package.

The Mamba2 (SSD) block has no TPU kernel: the JAX package scans the
recurrence with ``lax.scan`` in float32.  Here the scan is the chunked (SSD)
form in tensor ops (:func:`ssd_scan`), the same recurrence summed in
another order, so that a prefill is a few dozen launches a layer instead of
one a token, and autograd differentiates it as it stands.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.kernels.flash_sdpa import flash_sdpa, flash_sdpa_ref
from repro_torch.kernels.flash_sdpa.ref import sdpa_mask
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref
from repro_torch.launch import meshctx
from repro_torch.launch.meshctx import constrain
from repro_torch.obs.trace import stage

PyTree = Dict[str, object]

# ---------------------------------------------------------------------------
# init helpers (explicit torch.Generator; shapes and scales of repro's)
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape: Tuple[int, ...], dtype=torch.float32,
               scale: Optional[float] = None, *, stack: int = 0,
               device=None) -> torch.Tensor:
    """Normal weights scaled by ``scale`` (default ``fan_in ** -0.5`` with
    ``fan_in = shape[0]``); ``stack > 0`` draws ``(stack, *shape)`` at once,
    the layout of a stacked layer parameter."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else (1.0 / fan_in) ** 0.5
    full = (stack, *shape) if stack else tuple(shape)
    w = torch.randn(full, generator=generator, dtype=dtype, device=device)
    return w.mul_(scale)


def uniform_init(generator: torch.Generator, shape: Tuple[int, ...], dtype=torch.float32,
                 *, stack: int = 0, device=None) -> torch.Tensor:
    full = (stack, *shape) if stack else tuple(shape)
    return torch.rand(full, generator=generator, dtype=dtype, device=device)


def _const(shape, value: float, dtype, stack: int, device) -> torch.Tensor:
    full = (stack, *shape) if stack else tuple(shape)
    return torch.full(full, value, dtype=dtype, device=device)


def rmsnorm_init(dim: int, dtype=torch.float32, *, stack: int = 0, device=None) -> PyTree:
    return {"scale": _const((dim,), 1.0, dtype, stack, device)}


def layernorm_init(dim: int, dtype=torch.float32, *, stack: int = 0, device=None) -> PyTree:
    return {"scale": _const((dim,), 1.0, dtype, stack, device),
            "bias": _const((dim,), 0.0, dtype, stack, device)}


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

def rmsnorm(params: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params["scale"].to(x.dtype)


def layernorm(params: PyTree, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 1e6, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated by float32 ``angles`` (..., S, D/2), the cos
    and sin cast to x's type, as in the JAX package."""
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (D/2,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, sections: Tuple[int, int, int],
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); ``positions_3d``: (3, B, S)
    (temporal, height, width) position ids; ``sections`` split the D/2
    frequency bands among the three axes in order (e.g. (16, 24, 24) for
    D = 128): band j turns by the id of its axis.  Equal t / h / w ids give
    1-D RoPE exactly."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (D/2,)
    ang = positions_3d[..., None].to(torch.float32) * freqs  # (3, B, S, D/2)
    axis = torch.repeat_interleave(torch.arange(3, device=x.device),
                                   torch.tensor(sections, device=x.device),
                                   output_size=sum(sections))  # (D/2,)
    angles = ang.gather(0, axis.expand(1, *ang.shape[1:]))[0]  # (B, S, D/2)
    return _rotate(x, angles)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class AttnConfig(NamedTuple):
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int = 0  # 0 = full causal; >0 = sliding window
    rope_theta: float = 1e6
    use_rope: bool = True
    mrope_sections: Optional[Tuple[int, int, int]] = None
    seq_shard: bool = False  # context parallelism: query rows over `model`


def attention_init(generator: torch.Generator, cfg: AttnConfig, dtype=torch.float32, *,
                   stack: int = 0, device=None) -> PyTree:
    H, K, D, M = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(stack=stack, device=device)
    p: PyTree = {
        "wq": dense_init(generator, (M, H * D), dtype, **kw),
        "wk": dense_init(generator, (M, K * D), dtype, **kw),
        "wv": dense_init(generator, (M, K * D), dtype, **kw),
        "wo": dense_init(generator, (H * D, M), dtype, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = _const((H * D,), 0.0, dtype, stack, device)
        p["bk"] = _const((K * D,), 0.0, dtype, stack, device)
        p["bv"] = _const((K * D,), 0.0, dtype, stack, device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(D, dtype, **kw)
        p["k_norm"] = rmsnorm_init(D, dtype, **kw)
    return p


def split_heads(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(*shape)``, its last dim split into (heads, head size).
    Under a mesh, a head count that does not divide ``model`` gathers that
    dim first: the rules shard a projection's columns whenever they divide
    (4 KV heads x 128 over 8 ranks: half a head a rank), and a ``DTensor``
    cannot split a dim into an unevenly sharded one (XLA reshards there)."""
    if meshctx.is_sharded(t) and shape[-2] % meshctx.axis_size("model"):
        t = meshctx.unshard(t, t.ndim - 1)
    return t.reshape(*shape)


def _project_qkv(params, cfg: AttnConfig, x, positions, positions_3d=None):
    B, S, _ = x.shape
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = split_heads(q, B, S, H, D)
    k = split_heads(k, B, S, K, D)
    v = split_heads(v, B, S, K, D)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if not cfg.use_rope:
        pass
    elif cfg.mrope_sections is not None and positions_3d is not None:
        q = apply_mrope(q, positions_3d, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions_3d, cfg.mrope_sections, cfg.rope_theta)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def causal_mask(S: int, T: int, offset: int, window: int = 0, device=None) -> torch.Tensor:
    """(1, S, T) bool; query i (global pos offset+i) sees key j iff
    j <= offset+i and (window == 0 or j > offset+i-window)."""
    return sdpa_mask(S, T, True, window, offset, device=device)[None]


def _sdpa(q, k, v, *, window: int, q_offset: int, plain: bool = False,
          causal: bool = True, seq_shard: bool = False) -> torch.Tensor:
    """GQA attention (B, S, H, D) x (B, T, K, D) -> (B, S, H * D), causal
    unless ``causal`` is False (every key visible: ``window`` must be 0).
    ``DTensor`` inputs (a bound mesh) go to :func:`_sdpa_local`."""
    if not causal and window:
        raise ValueError(f"non-causal attention takes no window (got {window})")
    fn = flash_sdpa_ref if plain else flash_sdpa
    if meshctx.is_sharded(q):
        return _sdpa_local(fn, q, k, v, causal, window, q_offset, seq_shard)
    q, k, v = (meshctx.contiguous_grad(t) for t in (q, k, v))  # as on a mesh's local shards
    with stage(None, "lm.attention.core"):  # a profiler range: the kernel's host path
        out = fn(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return out.reshape(q.shape[0], q.shape[1], -1)


def _sdpa_local(fn, q, k, v, causal: bool, window: int, q_offset: int, seq_shard: bool):
    """Attention over each rank's shards: the batch over the batch axes;
    over ``model`` the query rows under ``seq_shard`` (K / V whole, each
    rank at the ``q_offset`` of its first row), else the heads where both
    head counts divide it (whole GQA groups), else nothing."""
    B, S, H, _ = q.shape
    K = k.shape[2]
    n = meshctx.axis_size("model")
    rows = seq_shard and S % n == 0
    heads = not rows and H % n == 0 and K % n == 0
    row_ax, head_ax = ("model" if rows else None), ("model" if heads else None)
    q_pl = meshctx.placements("batch", row_ax, head_ax, None, shape=q.shape)
    kv_pl = meshctx.placements("batch", None, head_ax, None, shape=k.shape)
    o_pl = meshctx.placements("batch", row_ax, head_ax, shape=(B, S, H * q.shape[3]))
    off = q_offset + (meshctx.local_offset(q, 1, q_pl) if rows else 0)

    def local(ql, kl, vl):
        o = fn(ql.contiguous(), kl.contiguous(), vl.contiguous(), causal=causal, window=window,
               q_offset=off)
        return o.reshape(o.shape[0], o.shape[1], -1)

    return meshctx.local_call(local, (q_pl, kv_pl, kv_pl), o_pl, q, k, v)


def attention_apply(
    params: PyTree,
    cfg: AttnConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    positions_3d: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    *,
    plain: bool = False,
    causal: bool = True,
):
    """Self-attention over the whole sequence (prefill); M-RoPE at
    ``positions_3d`` (3, B, S) where the config has sections.  Causal under
    ``cfg.window``, or with ``causal=False`` bidirectional over every key and
    no window (the JAX package's all-ones ``mask``: the whisper encoder).
    ``return_kv`` also returns the rotated (k, v) for the decode cache.
    ``cfg.seq_shard`` constrains the query rows over ``model`` and K / V
    whole (context parallelism, the JAX package's constraints)."""
    q, k, v = _project_qkv(params, cfg, x, positions, positions_3d)
    if cfg.seq_shard:
        q = constrain(q, "batch", "model", None, None)
        k = constrain(k, "batch", None, None, None)
        v = constrain(v, "batch", None, None, None)
    out = _sdpa(q, k, v, window=cfg.window if causal else 0, q_offset=0, plain=plain,
                causal=causal, seq_shard=cfg.seq_shard)
    if cfg.seq_shard:
        out = constrain(out, "batch", "model", None)
        # rows -> columns (an all-to-all) for the row-parallel ``wo``: a
        # DTensor matmul flattens (B, S), which a sharded S forbids
        out = constrain(out, "batch", None, "model")
    out = out @ params["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def kv_quantize(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(slot, head) symmetric int8 quantisation, k ~ q * s: k (..., K, D)
    -> (q int8 (..., K, D), s float32 (..., K)).  Both divisions are by
    tensors: CUDA turns a Python divisor into a multiply by its reciprocal,
    which can move ``round`` across .5; this way the card's values and scales
    equal the CPU's (and the JAX package's) bit for bit.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    kf = k.float()
    amax = kf.abs().amax(dim=-1)
    s = amax.clamp_min(1e-8) / torch.tensor(127.0, device=k.device)
    q = torch.round(kf / s[..., None]).clamp(-127, 127)
    return q.to(torch.int8), s


def kv_dequantize(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * s[..., None].float()).to(dtype)


def write_slots(out: torch.Tensor, arr: torch.Tensor, runs) -> torch.Tensor:
    """``out[:, d:d + n] = arr[:, s:s + n]`` for each run ``(d, s, n)``, IN
    PLACE (the cache's slots are dim 1 of both).  On a ``DTensor`` cache each
    rank writes the part of a run that falls in its own shard of the slots,
    from ``arr`` moved to the cache's placements with the slots whole: the
    owner-rank write (``DTensor`` has no rule for an indexed write on a
    sharded dimension)."""
    if not meshctx.is_sharded(out):
        for d, s, n in runs:
            if n:
                out[:, d:d + n] = arr[:, s:s + n]
        return out
    mesh, pl = out.device_mesh, tuple(out.placements)
    src_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in pl)
    src = meshctx.as_dtensor(arr, mesh).redistribute(mesh, src_pl).to_local()
    local = out.to_local()
    off, size = meshctx.local_offset(out, 1, pl), local.shape[1]
    for d, s, n in runs:
        lo, hi = max(d, off), min(d + n, off + size)
        if lo < hi:
            local[:, lo - off:hi - off] = src[:, s + lo - d:s + hi - d]
    return out


def attention_decode(
    params: PyTree,
    cfg: AttnConfig,
    x: torch.Tensor,  # (B, 1, M)
    cache_k: torch.Tensor,  # (B, C, K, D), C = cache capacity
    cache_v: torch.Tensor,
    pos: int,  # global position of this token
    positions_3d: Optional[torch.Tensor] = None,  # (3, B, 1) M-RoPE ids of this token
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B, C, K) each
):
    """One-token decode against a KV cache.  This token's k/v are written
    into slot ``pos`` (``pos % C`` for a ring, ``cfg.window > 0``) of
    ``cache_k``/``cache_v`` IN PLACE (the JAX package's
    ``dynamic_update_slice`` returns new arrays; here the preallocated cache
    is updated), then the kernel attends over slots 0..pos through its
    causal mask at ``q_offset = pos``.

    A ring holds every slot up to ``min(pos, C - 1)`` valid, as the JAX
    package does, and keys carry their positions from RoPE at write time: the
    kernel attends at ``q_offset = min(pos, C - 1)`` with no window.  Softmax
    does not depend on the slots' order, so only the summation order differs
    from the tokens' order.

    ``cache_scales`` = (k_s, v_s) makes the cache int8 with per-(slot, head)
    scales: this token's k/v are quantized into it, and the whole cache is
    dequantized to ``x``'s type before attention, as in the JAX package.
    Returns (out, cache_k, cache_v), and the scales when given."""
    B = x.shape[0]
    C = cache_k.shape[1]
    ring = cfg.window > 0
    if pos < 0 or (not ring and pos >= C):
        raise ValueError(f"position {pos} outside the cache's {C} slots")
    slot = pos % C if ring else pos
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, positions_3d)
    run = [(slot, 0, 1)]
    if cache_scales is not None:
        k_s, v_s = cache_scales
        (k_q, k_sc), (v_q, v_sc) = kv_quantize(k), kv_quantize(v)
        for dst, src in ((cache_k, k_q), (k_s, k_sc), (cache_v, v_q), (v_s, v_sc)):
            write_slots(dst, src, run)
        k_full = kv_dequantize(cache_k, k_s, x.dtype)
        v_full = kv_dequantize(cache_v, v_s, x.dtype)
    else:
        write_slots(cache_k, k, run)
        write_slots(cache_v, v, run)
        k_full, v_full = cache_k, cache_v
    out = _sdpa(q, k_full, v_full, window=0, q_offset=min(pos, C - 1) if ring else pos)
    out = out @ params["wo"].to(x.dtype)
    if cache_scales is not None:
        return out, cache_k, cache_v, (k_s, v_s)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32, *,
                stack: int = 0, device=None) -> PyTree:
    kw = dict(stack=stack, device=device)
    return {
        "gate": dense_init(generator, (d_model, d_ff), dtype, **kw),
        "up": dense_init(generator, (d_model, d_ff), dtype, **kw),
        "down": dense_init(generator, (d_ff, d_model), dtype, **kw),
    }


def swiglu(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ params["gate"].to(x.dtype))
    u = x @ params["up"].to(x.dtype)
    return (g * u) @ params["down"].to(x.dtype)


def gelu_mlp_init(generator: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32, *,
                  stack: int = 0, device=None) -> PyTree:
    kw = dict(stack=stack, device=device)
    return {
        "up": dense_init(generator, (d_model, d_ff), dtype, **kw),
        "up_b": _const((d_ff,), 0.0, dtype, stack, device),
        "down": dense_init(generator, (d_ff, d_model), dtype, **kw),
        "down_b": _const((d_model,), 0.0, dtype, stack, device),
    }


def gelu_mlp(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """The whisper MLP: GELU in its tanh approximation, ``jax.nn.gelu``'s
    default, between two biased projections."""
    h = F.gelu(x @ params["up"].to(x.dtype) + params["up_b"].to(x.dtype), approximate="tanh")
    return h @ params["down"].to(x.dtype) + params["down_b"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based static dispatch; shared + routed)
# ---------------------------------------------------------------------------

class MoEConfig(NamedTuple):
    d_model: int
    d_ff_expert: int
    num_experts: int
    top_k: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    aux_weight: float = 0.001
    groups: int = 0  # >0: group-local dispatch (moe_apply_grouped)


def moe_init(generator: torch.Generator, cfg: MoEConfig, dtype=torch.float32, *,
             stack: int = 0, device=None) -> PyTree:
    """The keys, shapes and scales of ``repro``'s ``moe_init``: the expert
    weights are (E, in, out), so their fan-in is E, as there; the router is
    float32 whatever ``dtype`` is."""
    E, M, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    kw = dict(stack=stack, device=device)
    p: PyTree = {
        "router": dense_init(generator, (M, E), torch.float32, **kw),
        "w_gate": dense_init(generator, (E, M, F_), dtype, **kw),
        "w_up": dense_init(generator, (E, M, F_), dtype, **kw),
        "w_down": dense_init(generator, (E, F_, M), dtype, **kw),
    }
    if cfg.num_shared:
        p["shared"] = swiglu_init(generator, M, cfg.num_shared * F_, dtype, **kw)
    return p


class MoERouting(NamedTuple):
    """One MoE call's routing over its dispatch groups (G = 1 on the flat
    path): ``probs`` (G, Tg, E) float32, ``gate`` (G, Tg, K) in the
    activation type, ``expert_ids`` (G, Tg, K), ``pos`` (G, Tg * K) each
    assignment's slot in its expert (token-major), ``keep`` = pos < capacity."""
    probs: torch.Tensor
    gate: torch.Tensor
    expert_ids: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def moe_grouped(cfg: MoEConfig, tokens: int) -> bool:
    """``moe_apply``'s rule: the grouped path when ``cfg.groups`` is set and
    divides the token count, else the flat path."""
    return bool(cfg.groups) and tokens % cfg.groups == 0


def moe_routing(params: PyTree, cfg: MoEConfig, tok: torch.Tensor, G: int) -> MoERouting:
    """Route ``tok`` (T, M) in G groups of Tg = T / G tokens.  Each group
    has capacity int(Tg * K / E * capacity_factor) + 1 per expert (both of
    the JAX package's paths); an assignment past it is dropped.

    The top K is a stable descending sort, so ties go to the lower expert
    index, as in ``jax.lax.top_k``.  A token's K experts are distinct, so
    their order moves no position: ``pos`` counts, in token order, the
    group's earlier assignments to the same expert."""
    T, M = tok.shape
    E, K = cfg.num_experts, cfg.top_k
    Tg = T // G
    cap = int((Tg * K / E) * cfg.capacity_factor) + 1
    logits = tok.reshape(G, Tg, M).float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (G, Tg, E)
    expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :K]
    return moe_assign(probs, expert_ids, cap, tok.dtype)


def moe_assign(probs: torch.Tensor, expert_ids: torch.Tensor, capacity: int, dtype) -> MoERouting:
    """The routing of a chosen set of experts a token (``expert_ids`` (G, Tg,
    K), distinct in each token): the gate, their probabilities over max(their
    sum, 1e-9) cast to ``dtype``, and each assignment's position in its
    expert and whether it fits in ``capacity``."""
    G, Tg, K = expert_ids.shape
    gate = probs.gather(-1, expert_ids)
    gate = (gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)).to(dtype)
    flat_e = expert_ids.reshape(G, Tg * K)
    onehot = F.one_hot(flat_e, probs.shape[-1])
    pos = (onehot.cumsum(dim=1) - 1).gather(-1, flat_e[..., None])[..., 0]
    return MoERouting(probs, gate, expert_ids, pos, pos < capacity, capacity)


def _moe_experts(params: PyTree, buf: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its slots: buf (G, E, C, M) -> (G, E, C, M)."""
    dt = buf.dtype
    g = F.silu(torch.einsum("gecm,emf->gecf", buf, params["w_gate"].to(dt)))
    u = torch.einsum("gecm,emf->gecf", buf, params["w_up"].to(dt))
    return torch.einsum("gecf,efm->gecm", g * u, params["w_down"].to(dt))


def _moe_dispatch(r: MoERouting, tok: torch.Tensor) -> torch.Tensor:
    """tok (G, Tg, M) -> the experts' slots (G, E, capacity, M): each kept
    assignment into its own slot; a dropped one into a spare slot past the
    capacity, cut off before the experts run."""
    G, Tg, M = tok.shape
    K, E = r.expert_ids.shape[-1], r.probs.shape[-1]
    flat_e = r.expert_ids.reshape(G, Tg * K)
    g_idx = torch.arange(G, device=tok.device)[:, None].expand(G, Tg * K)
    slot = torch.where(r.keep, r.pos, r.capacity)
    buf = tok.new_zeros((G, E, r.capacity + 1, M)).index_put(
        (g_idx, flat_e, slot), tok.repeat_interleave(K, dim=1))
    return buf[:, :, :r.capacity]


def _moe_combine(y: torch.Tensor, r: MoERouting) -> torch.Tensor:
    """The experts' outputs y (G, E, capacity, M) -> each token's K slot
    outputs, gated (0 where dropped), summed over K: (G * Tg, M)."""
    G, Tg, K = r.expert_ids.shape
    flat_e = r.expert_ids.reshape(G, Tg * K)
    g_idx = torch.arange(G, device=y.device)[:, None].expand(G, Tg * K)
    safe = torch.where(r.keep, r.pos, r.capacity - 1)
    w = r.gate.reshape(G, Tg * K, 1) * r.keep[..., None].to(y.dtype)
    return (y[g_idx, flat_e, safe] * w).reshape(G * Tg, K, -1).sum(dim=1)


def _moe(params: PyTree, cfg: MoEConfig, x: torch.Tensor, G: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both paths of the JAX package's MoE, over G dispatch groups."""
    if meshctx.is_sharded(x):
        return _moe_sharded(params, cfg, x, G)
    B, S, M = x.shape
    T, E = B * S, cfg.num_experts
    tok = x.reshape(T, M)
    r = moe_routing(params, cfg, tok, G)
    y = _moe_experts(params, _moe_dispatch(r, tok.reshape(G, T // G, M)))
    out = _moe_combine(y, r)
    if cfg.num_shared and "shared" in params:
        out = out + swiglu(params["shared"], tok)
    # load-balance aux loss (Switch): E * sum_e f_e * pbar_e
    f = (F.one_hot(r.expert_ids, E).sum(dim=2) > 0).float().mean(dim=(0, 1))
    aux = cfg.aux_weight * E * torch.sum(f * r.probs.mean(dim=(0, 1)))
    return out.reshape(B, S, M), aux


def _moe_sharded(params: PyTree, cfg: MoEConfig, x, G: int):
    """``_moe`` under a bound mesh, at the JAX package's constraints: the
    groups over the batch axes (one group, the flat path, routes every
    token on every rank: its capacity is global), routing and dispatch on
    each rank's groups, the experts' slots constrained over ``expert`` (the
    experts run on their own rank's weights), then the combine on each
    rank's groups from the gathered expert outputs.  The load-balance
    statistics are summed a rank and reduced (``Partial``)."""
    B, S, M = x.shape
    T, E = B * S, cfg.num_experts
    Tg = T // G
    # (B, S, M) <-> (G, Tg, M) a rank: the groups follow the batch's shards
    # where both divide the batch axes, else every rank holds them all
    nb = meshctx.axis_size("batch")
    even = G % nb == 0 and B % nb == 0
    x_pl = meshctx.placements("batch" if even else None, None, None, shape=x.shape)
    g_pl = meshctx.placements("batch" if even else None, None, None, shape=(G, Tg, M))
    tok = meshctx.local_call(lambda t: t.reshape(-1, Tg, M), (x_pl,), g_pl, x)
    part = tuple(Partial() if isinstance(p, Shard) else p for p in g_pl)

    def route(tl, router):
        r = moe_routing({"router": router}, cfg, tl.reshape(-1, M), tl.shape[0])
        f = (F.one_hot(r.expert_ids, E).sum(dim=2) > 0).float().sum(dim=(0, 1))
        return (_moe_dispatch(r, tl), r.probs, r.gate, r.expert_ids, r.pos, r.keep, f,
                r.probs.sum(dim=(0, 1)))

    router = params["router"]
    buf, probs, gate, ids, pos, keep, f_sum, p_sum = meshctx.local_call(
        route, (g_pl, meshctx.placements(None, None, shape=router.shape)),
        [g_pl] * 6 + [part, part], tok, router)
    buf = constrain(buf, "batch", "expert", None, None)
    w_pl = meshctx.placements("expert", None, None, shape=params["w_gate"].shape)
    y = meshctx.local_call(
        lambda b, wg, wu, wd: _moe_experts({"w_gate": wg, "w_up": wu, "w_down": wd}, b),
        (buf.placements, w_pl, w_pl, w_pl), buf.placements,
        buf, params["w_gate"], params["w_up"], params["w_down"])
    y = constrain(y, "batch", "expert", None, None)
    cap = buf.shape[2]

    def combine(yl, pl, gl, il, ql, kl):
        return _moe_combine(yl, MoERouting(pl, gl, il, ql, kl, cap)).reshape(il.shape[0], Tg, M)

    out = meshctx.local_call(combine, (meshctx.placements("batch", None, None, None,
                                                          shape=y.shape),) + (g_pl,) * 5,
                             g_pl, y, probs, gate, ids, pos, keep)
    out = meshctx.local_call(lambda t: t.reshape(-1, S, M), (g_pl,), x_pl,
                             constrain(out, "batch", None, None))
    if cfg.num_shared and "shared" in params:
        out = out + swiglu(params["shared"], x)
    aux = cfg.aux_weight * E * torch.sum((f_sum / T) * (p_sum / T))
    return out, aux


def moe_apply(params: PyTree, cfg: MoEConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, M) -> (out, aux float32): the grouped path when ``cfg.groups``
    divides B * S, else the flat path (``moe_grouped``)."""
    if moe_grouped(cfg, x.shape[0] * x.shape[1]):
        return moe_apply_grouped(params, cfg, x)
    return moe_apply_flat(params, cfg, x)


def moe_apply_flat(params: PyTree, cfg: MoEConfig, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dispatch group over all T = B * S tokens: capacity
    int(T * K / E * capacity_factor) + 1 per expert."""
    return _moe(params, cfg, x, 1)


def moe_apply_grouped(params: PyTree, cfg: MoEConfig, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cfg.groups`` dispatch groups of Tg = T / groups consecutive tokens,
    each with capacity int(Tg * K / E * capacity_factor) + 1 per expert."""
    return _moe(params, cfg, x, cfg.groups)


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

class MLAConfig(NamedTuple):
    d_model: int
    num_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 1e6
    attn_chunk: int = 0  # the JAX package's query chunking (no counterpart here)


def mla_init(generator: torch.Generator, cfg: MLAConfig, dtype=torch.float32, *,
             stack: int = 0, device=None) -> PyTree:
    M, H = cfg.d_model, cfg.num_heads
    R, N, P, V = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim
    kw = dict(stack=stack, device=device)
    return {
        "wq": dense_init(generator, (M, H * (N + P)), dtype, **kw),
        "w_dkv": dense_init(generator, (M, R), dtype, **kw),  # compress
        "w_kr": dense_init(generator, (M, P), dtype, **kw),  # shared rope key
        "w_uk": dense_init(generator, (R, H * N), dtype, **kw),  # decompress K
        "w_uv": dense_init(generator, (R, H * V), dtype, **kw),  # decompress V
        "wo": dense_init(generator, (H * V, M), dtype, **kw),
        "kv_norm": rmsnorm_init(R, dtype, **kw),
    }


def _mla_scale(cfg: MLAConfig, dtype) -> float:
    """1 / sqrt(N + P) as the JAX package computes it: the float32 square
    root rounded to ``dtype``, its reciprocal rounded to ``dtype``.  A
    Python float holding that value multiplies a ``dtype`` tensor as the
    ``dtype`` scalar would, and needs no copy to the device."""
    root = torch.tensor(float(cfg.qk_nope_dim + cfg.qk_rope_dim)).sqrt().to(dtype)
    return float(1.0 / root)


def _mla_softmax(logits: torch.Tensor, mask: torch.Tensor, dtype) -> torch.Tensor:
    """Masked logits take finfo.min; the softmax runs in float32."""
    logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    return torch.softmax(logits.float(), dim=-1).to(dtype)


def _mla_project(params, cfg: MLAConfig, x, positions):
    """(q_nope, q_rope (rotated), c (normed latent), k_rope (rotated, B, S, P))."""
    B, S, _ = x.shape
    H, N, P = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = split_heads(x @ params["wq"].to(x.dtype), B, S, H, N + P)
    q_rope = apply_rope(q[..., N:], positions, cfg.rope_theta)
    c = rmsnorm(params["kv_norm"], x @ params["w_dkv"].to(x.dtype))
    k_rope = apply_rope((x @ params["w_kr"].to(x.dtype))[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q[..., :N], q_rope, c, k_rope


def _mla_core(q_nope, q_rope, k_nope, k_rope, v, scale: float) -> torch.Tensor:
    """Causal MLA attention of (B, S, H, N) / (B, S, H, P) queries against
    (B, S, H, N) keys, the (B, S, P) rope key shared by the heads and
    (B, S, H, V) values -> (B, S, H * V)."""
    B, S, H, V = v.shape
    logits = (torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
              + torch.einsum("bshp,btp->bhst", q_rope, k_rope)) * scale
    probs = _mla_softmax(logits, causal_mask(S, S, 0, device=v.device)[:, None], v.dtype)
    return torch.einsum("bhst,bthv->bshv", probs, v).reshape(B, S, H * V)


def mla_apply(params: PyTree, cfg: MLAConfig, x: torch.Tensor, positions: torch.Tensor,
              return_kv: bool = False):
    """Training / prefill, the expanded-KV form: K and V decompressed from
    the latent a head each, the rope key shared by the heads.  Causal over
    the whole sequence.  ``return_kv`` also returns (latent (B, S, R), rope
    key (B, S, P)) for the decode cache.  Under a mesh the attention runs on
    each rank's heads (``model``, where H divides it) and batch shard."""
    B, S, _ = x.shape
    H, N, V = cfg.num_heads, cfg.qk_nope_dim, cfg.v_dim
    q_nope, q_rope, c, k_rope = _mla_project(params, cfg, x, positions)
    k_nope = split_heads(c @ params["w_uk"].to(x.dtype), B, S, H, N)
    v = split_heads(c @ params["w_uv"].to(x.dtype), B, S, H, V)
    scale = _mla_scale(cfg, x.dtype)
    args = (q_nope, q_rope, k_nope, k_rope, v)
    if meshctx.is_sharded(v):
        head = "model" if H % meshctx.axis_size("model") == 0 else None
        hpl = meshctx.placements("batch", None, head, None, shape=v.shape)
        out = meshctx.local_call(
            lambda *a: _mla_core(*(t.contiguous() for t in a), scale),
            (hpl, hpl, hpl, meshctx.placements("batch", None, None, shape=k_rope.shape), hpl),
            meshctx.placements("batch", None, head, shape=(B, S, H * V)), *args)
    else:
        out = _mla_core(*args, scale)
    out = out @ params["wo"].to(x.dtype)
    if return_kv:
        return out, (c, k_rope)
    return out


def mla_decode(
    params: PyTree,
    cfg: MLAConfig,
    x: torch.Tensor,  # (B, 1, M)
    cache_c: torch.Tensor,  # (B, C, R) compressed latent cache
    cache_kr: torch.Tensor,  # (B, C, P) shared rope-key cache
    pos: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode in the absorbed form: the cache holds only the
    R-wide latent and the P-wide rope key a token; W_uk goes into the query
    and W_uv into the output.  This token's latent and rope key are written
    into slot ``pos`` IN PLACE, clamped to C - 1 as the JAX package's
    ``dynamic_update_slice`` clamps (no ring: MLA ignores the window); the
    token attends over the slots 0..pos."""
    B = x.shape[0]
    H, N, P, V, R = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim, cfg.kv_lora_rank
    C = cache_c.shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope, c, k_rope = _mla_project(params, cfg, x, positions)
    slot = min(max(pos, 0), C - 1)
    write_slots(cache_c, c, [(slot, 0, 1)])
    write_slots(cache_kr, k_rope, [(slot, 0, 1)])
    w_uk = split_heads(params["w_uk"].to(x.dtype), R, H, N)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    logits = (torch.einsum("bhr,bcr->bhc", q_lat, cache_c)
              + torch.einsum("bhp,bcp->bhc", q_rope[:, 0], cache_kr)) * _mla_scale(cfg, x.dtype)
    valid = (torch.arange(C, device=x.device) <= pos)[None, None, :]
    probs = _mla_softmax(logits, valid, x.dtype)
    ctx = torch.einsum("bhc,bcr->bhr", probs, cache_c)  # attend in latent space
    w_uv = split_heads(params["w_uv"].to(x.dtype), R, H, V)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv).reshape(B, 1, H * V)
    return out @ params["wo"].to(x.dtype), cache_c, cache_kr


# ---------------------------------------------------------------------------
# RWKV6 ("Finch") — data-dependent decay linear attention
# ---------------------------------------------------------------------------

class RWKV6Config(NamedTuple):
    d_model: int
    head_size: int = 64
    lora_rank: int = 32
    ffn_mult: float = 3.5  # d_ff = 7168 for d=2048

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_size


def rwkv6_init(generator: torch.Generator, cfg: RWKV6Config, dtype=torch.float32, *,
               stack: int = 0, device=None) -> PyTree:
    """The keys, shapes and scales of ``repro.models.layers.rwkv6_init``;
    ``bonus`` is float32 whatever ``dtype`` is, as the layer uses it."""
    M, Hd, H, r = cfg.d_model, cfg.head_size, cfg.num_heads, cfg.lora_rank
    d_ff = int(cfg.ffn_mult * M)
    kw = dict(stack=stack, device=device)
    return {
        "mix_base": uniform_init(generator, (5, M), dtype, **kw),
        "mix_lora_a": dense_init(generator, (M, 5 * r), dtype, **kw),
        "mix_lora_b": dense_init(generator, (5 * r, 5 * M), dtype, scale=0.01, **kw),
        "wr": dense_init(generator, (M, M), dtype, **kw),
        "wk": dense_init(generator, (M, M), dtype, **kw),
        "wv": dense_init(generator, (M, M), dtype, **kw),
        "wg": dense_init(generator, (M, M), dtype, **kw),
        "wo": dense_init(generator, (M, M), dtype, **kw),
        "decay_base": _const((M,), 0.0, dtype, stack, device),
        "decay_lora_a": dense_init(generator, (M, 2 * r), dtype, **kw),
        "decay_lora_b": dense_init(generator, (2 * r, M), dtype, scale=0.01, **kw),
        "bonus": _const((H, Hd), 0.0, torch.float32, stack, device),
        "ln_x": layernorm_init(M, dtype, **kw),
        "cm_mix": uniform_init(generator, (M,), dtype, **kw),
        "cm_k": dense_init(generator, (M, d_ff), dtype, **kw),
        "cm_v": dense_init(generator, (d_ff, M), dtype, **kw),
        "cm_r": dense_init(generator, (M, M), dtype, **kw),
    }


def _shift(x: torch.Tensor, x_last: Optional[torch.Tensor]) -> torch.Tensor:
    """x shifted right by one token, ``x_last`` (or zeros) in front."""
    B, _, M = x.shape
    if x_last is None:
        x_last = torch.zeros((B, M), dtype=x.dtype, device=x.device)
    return torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv6_mix(params, x, x_prev):
    """Data-dependent token-shift lerp producing the 5 mixed streams
    (r, k, v, g, w).  x: (B,S,M); x_prev: x shifted right by one."""
    B, S, M = x.shape
    dx = x_prev - x
    base = params["mix_base"].to(x.dtype)  # (5, M)
    lora = torch.tanh(x @ params["mix_lora_a"].to(x.dtype))  # (B,S,5r)
    lora = (lora @ params["mix_lora_b"].to(x.dtype)).reshape(B, S, 5, M)
    mix = base[None, None] + lora  # (B,S,5,M)
    return x[:, :, None, :] + dx[:, :, None, :] * mix  # (B,S,5,M)


def rwkv6_time_mix(
    params: PyTree,
    cfg: RWKV6Config,
    x: torch.Tensor,
    state: Optional[torch.Tensor] = None,  # (B, H, Hd, Hd) float32 wkv state
    x_last: Optional[torch.Tensor] = None,  # (B, M) last token (decode)
    *,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new_state, new_x_last) for S >= 1 tokens; the
    recurrence is one ``wkv6`` launch over the whole sequence."""
    B, S, M = x.shape
    H, Hd = cfg.num_heads, cfg.head_size
    mixed = _rwkv6_mix(params, x, _shift(x, x_last))  # (B,S,5,M)
    xr, xk, xv, xg, xw = mixed.unbind(dim=2)
    r = split_heads(xr @ params["wr"].to(x.dtype), B, S, H, Hd)
    k = split_heads(xk @ params["wk"].to(x.dtype), B, S, H, Hd)
    v = split_heads(xv @ params["wv"].to(x.dtype), B, S, H, Hd)
    g = F.silu(xg @ params["wg"].to(x.dtype))
    # data-dependent decay w_t = exp(-exp(base + lora(xw))), in float32
    dl = torch.tanh(xw @ params["decay_lora_a"].to(x.dtype))
    dl = dl @ params["decay_lora_b"].to(x.dtype)
    w = torch.exp(-torch.exp((params["decay_base"].to(x.dtype) + dl).to(torch.float32)))
    w = split_heads(w, B, S, H, Hd)
    u = params["bonus"].to(torch.float32)  # (H, Hd)
    if state is None:
        state = torch.zeros((B, H, Hd, Hd), dtype=torch.float32, device=x.device)
    fn = wkv6_ref if plain else wkv6
    if meshctx.is_sharded(r):
        out, state = _heads_local(fn, (r, k, v, w, u, state), (2, 2, 2, 2, 0, 1), (2, 1), H)
    else:
        out, state = fn(r, k, v, w, u, state)
    out = out.reshape(B, S, M).to(x.dtype)
    out = layernorm(params["ln_x"], out) * g
    out = out @ params["wo"].to(x.dtype)
    return out, state, x[:, -1, :]


def _heads_local(fn, args, head_dims, out_head_dims, H: int):
    """``fn(*args)`` on each rank's shards: a tensor's heads (its dim in
    ``head_dims``, one an argument; -1: it has none) over ``model`` where
    ``H`` divides it, and its dim 0 over the batch axes unless that is the
    heads' dim; the outputs likewise (``out_head_dims``: 2 shaped like the
    first argument, 1 like the last).  For ``wkv6`` and the Mamba2 scan:
    every head runs its recurrence on its own."""
    heads = H % meshctx.axis_size("model") == 0

    def pl(t, hd):
        spec = [None] * t.ndim
        if hd != 0:
            spec[0] = "batch"
        if heads and hd >= 0:
            spec[hd] = "model"
        return meshctx.placements(*spec, shape=t.shape)

    in_pl = tuple(pl(t, hd) for t, hd in zip(args, head_dims))
    out_pl = [pl(args[0] if hd == 2 else args[-1], hd) for hd in out_head_dims]
    return meshctx.local_call(lambda *a: tuple(fn(*a)), in_pl, out_pl, *args)


def rwkv6_channel_mix(
    params: PyTree, x: torch.Tensor, x_last: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    xk = x + (_shift(x, x_last) - x) * params["cm_mix"].to(x.dtype)
    k = torch.square(F.relu(xk @ params["cm_k"].to(x.dtype)))
    rgate = torch.sigmoid(xk @ params["cm_r"].to(x.dtype))
    return rgate * (k @ params["cm_v"].to(x.dtype)), x[:, -1, :]


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

class Mamba2Config(NamedTuple):
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_init(generator: torch.Generator, cfg: Mamba2Config, dtype=torch.float32, *,
                stack: int = 0, device=None) -> PyTree:
    """The keys, shapes and scales of ``repro.models.layers.mamba2_init``;
    ``A_log``, ``D`` and ``dt_bias`` are float32 whatever ``dtype`` is, as
    the block uses them (``in_proj`` -> [z, x, B, C, dt])."""
    M, Di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.num_heads
    kw = dict(stack=stack, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=device))
    return {
        "in_proj": dense_init(generator, (M, 2 * Di + 2 * N + H), dtype, **kw),
        "conv_w": dense_init(generator, (cfg.conv_width, Di + 2 * N), dtype, scale=0.5, **kw),
        "conv_b": _const((Di + 2 * N,), 0.0, dtype, stack, device),
        "A_log": a_log.expand(stack, H).clone() if stack else a_log,
        "D": _const((H,), 1.0, torch.float32, stack, device),
        "dt_bias": _const((H,), 0.0, torch.float32, stack, device),
        "norm": rmsnorm_init(Di, dtype, **kw),
        "out_proj": dense_init(generator, (Di, M), dtype, **kw),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv over time: x (B, S, C), w (W, C), b (C,);
    ``conv_state`` (B, W - 1, C) is the context before x (zeros when None).
    The taps are summed in the JAX package's order.  Returns (out, the last
    W - 1 rows of the context and x: the next call's ``conv_state``)."""
    W, S = w.shape[0], x.shape[1]
    pad = x.new_zeros((x.shape[0], W - 1, x.shape[2])) if conv_state is None else conv_state
    xp = torch.cat([pad, x], dim=1)  # (B, S + W - 1, C)
    out = xp[:, :S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, xp[:, S:]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, state: torch.Tensor, chunk: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 recurrence, all float32: with decay_t = exp(dt_t A),
    s_t = decay_t s_{t-1} + dt_t x_t B_t^T and y_t = s_t C_t, from
    ``state`` s_0.  x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N),
    state (B, H, P, N) -> (y (B, S, H, P), s_S).

    S = 1 (a decode step) is the recurrence step itself.  Longer inputs go
    by the chunked (SSD) form, in chunks of ``chunk`` tokens (the whole
    sequence when 0): inside a chunk, with log-decays a_t = dt_t A,
      y_t = exp(sum_{tau<=t} a_tau) s_0 C_t
            + sum_{s<=t} (C_t . B_s) exp(sum_{s<tau<=t} a_tau) dt_s x_s,
    the decay sums taken as cumulative sums of a masked (t, s) matrix, so a
    near pair's sum is short and exact to float32 (a difference of two long
    cumulative sums would lose the small one); then the state carries to the
    next chunk, s <- exp(sum a) s + sum_s exp(sum_{s<tau} a_tau) dt_s x_s
    B_s^T.  A last chunk shorter than the rest is padded with dt = 0 and
    x = B = C = 0: no decay, nothing added, its rows dropped."""
    Bsz, S, H, P = x.shape
    if S == 1:
        decay = torch.exp(dt[:, 0] * A)  # (B, H)
        dbx = torch.einsum("bhp,bn,bh->bhpn", x[:, 0], Bm[:, 0], dt[:, 0])
        state = decay[..., None, None] * state + dbx
        return torch.einsum("bhpn,bn->bhp", state, Cm[:, 0])[:, None], state
    N = Bm.shape[-1]
    L = min(chunk, S) if chunk > 0 else S
    nc = -(-S // L)
    a, xdt = dt * A, x * dt[..., None]
    if nc * L > S:
        pad = nc * L - S
        a, xdt, Bm, Cm = (F.pad(t, (0,) * (2 * (t.ndim - 2)) + (0, pad)) for t in (a, xdt, Bm, Cm))
    a = a.reshape(Bsz, nc, L, H).permute(0, 1, 3, 2)  # (B, nc, H, L)
    xc = xdt.reshape(Bsz, nc, L, H, P)
    Bc, Cc = Bm.reshape(Bsz, nc, L, N), Cm.reshape(Bsz, nc, L, N)
    ones = torch.ones((L, L), dtype=torch.bool, device=x.device)
    # seg[..., t, s] = sum_{s < tau <= t} a_tau, -inf above the diagonal
    seg = a[..., :, None].expand(*a.shape, L).masked_fill(~ones.tril(-1), 0.0).cumsum(dim=-2)
    decay = torch.exp(seg.masked_fill(~ones.tril(), float("-inf")))  # (B, nc, H, t, s)
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    y = torch.einsum("bchts,bcshp->bcthp", cb[:, :, None] * decay, xc)
    # each chunk's own addition to the state, decayed to its end
    tail = xc * decay[..., -1, :].permute(0, 1, 3, 2)[..., None]  # (B, nc, L, H, P)
    into = torch.einsum("bcshp,bcsn->bchpn", tail, Bc)
    from_start = torch.exp(a.cumsum(dim=-1))  # (B, nc, H, L): decay since the chunk's start
    carried = []
    for c in range(nc):
        carried.append(torch.einsum("bhpn,btn->bthp", state, Cc[:, c])
                       * from_start[:, c].transpose(1, 2)[..., None])
        state = from_start[:, c, :, -1, None, None] * state + into[:, c]
    y = (y + torch.stack(carried, dim=1)).reshape(Bsz, nc * L, H, P)[:, :S]
    return y, state


def mamba2_apply(
    params: PyTree,
    cfg: Mamba2Config,
    x: torch.Tensor,
    ssm_state: Optional[torch.Tensor] = None,  # (B, H, head_dim, N) float32
    conv_state: Optional[torch.Tensor] = None,  # (B, W - 1, Di + 2N)
    chunk: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new_ssm_state, new_conv_state) for S >= 1 tokens; the
    scan is :func:`ssd_scan` in chunks of ``chunk`` (the JAX package's remat
    chunk of the same scan)."""
    B, S, _ = x.shape
    Di, N, H, P = cfg.d_inner, cfg.d_state, cfg.num_heads, cfg.head_dim
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z = zxbcdt[..., :Di]
    xbc, new_conv = _causal_conv(zxbcdt[..., Di:2 * Di + 2 * N], params["conv_w"].to(x.dtype),
                                 params["conv_b"].to(x.dtype), conv_state)
    xbc = F.silu(xbc)
    xs = split_heads(xbc[..., :Di], B, S, H, P).float()
    dt = F.softplus(zxbcdt[..., -H:].float() + params["dt_bias"].float())  # (B, S, H)
    A = -torch.exp(params["A_log"].float())  # (H,)
    if ssm_state is None:
        ssm_state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    args = (xs, dt, A, xbc[..., Di:Di + N].float(), xbc[..., Di + N:].float(), ssm_state)
    if meshctx.is_sharded(xs):
        y, ssm_state = _heads_local(lambda *a: ssd_scan(*a, chunk), args, (2, 2, 0, -1, -1, 1),
                                    (2, 1), H)
    else:
        y, ssm_state = ssd_scan(*args, chunk)
    y = y + params["D"].float()[:, None] * xs
    y = y.reshape(B, S, Di).to(x.dtype)
    y = rmsnorm(params["norm"], y) * F.silu(z)
    return y @ params["out_proj"].to(x.dtype), ssm_state, new_conv
