"""LM assembly for the dense and RWKV6 families (``repro.models.lm``).

One ``LMConfig`` (every field of the JAX package's, so the config files copy
verbatim) drives the block patterns; this port runs ``arch_type`` ``dense``
and ``rwkv``, and the other families (moe, hybrid, encdec, vlm) raise until
ROADMAP queue A item 9 brings them.

Parameters keep ``repro``'s key paths and its STACKED layout: every layer
parameter is one ``(L, ...)`` tensor under ``params["layers"]``.  The layer
loop is a Python loop over ``[i]`` views of those stacks (the JAX package's
``lax.scan``), so a truncated stack (``serving.cascade_serving.truncate_params``)
is a view and never a copy of the weights.

API (all functional, as in ``repro``):
  init_params(cfg, generator, device)  seeded params on ``device``
  forward(params, cfg, batch)          (logits (B, S, V), aux)
  loss_fn(params, cfg, batch)          mean token cross-entropy (+ aux)
  init_cache(cfg, B, capacity, device) decode cache
  prefill(params, cfg, batch, capacity) -> (last_logits, cache)
  decode_step(params, cfg, cache, tokens, pos) -> (logits, cache)

``forward`` and ``loss_fn`` are differentiable: training holds float32
parameters (``init_params(..., dtype=torch.float32)``) and differentiates
through the casts to ``cfg.act_dtype``; with ``cfg.remat`` each layer is
recomputed in the backward pass.  The decode cache may be a ring
(``cfg.window > 0``, capacity below the prompt) and may be int8
(``cfg.kv_quant``).  ``plain=True`` on ``forward`` / ``loss_fn`` runs the
kernels' plain PyTorch versions instead of the kernels (see
``models.layers``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.models.layers import (
    AttnConfig,
    RWKV6Config,
    attention_apply,
    attention_decode,
    attention_init,
    dense_init,
    kv_quantize,
    layernorm,
    layernorm_init,
    rmsnorm,
    rmsnorm_init,
    rwkv6_channel_mix,
    rwkv6_init,
    rwkv6_time_mix,
    swiglu,
    swiglu_init,
)

PyTree = Dict[str, Any]

PORTED_ARCHS = ("dense", "rwkv")


def check_arch(cfg: "LMConfig") -> None:
    if cfg.arch_type not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) comes with the port's LM "
            f"stack (ROADMAP.md queue A item 9); ported: {PORTED_ARCHS}"
        )


@dataclass(frozen=True)
class LMConfig:
    name: str
    arch_type: str  # dense | moe | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    window: int = 0  # >0: sliding-window attention (long-context variant)
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    first_k_dense: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0
    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    # RWKV6
    rwkv_head_size: int = 64
    # hybrid (zamba2)
    ssm_state: int = 64
    mamba_head_dim: int = 64
    shared_attn_period: int = 6
    # encdec (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # vlm (qwen2-vl)
    mrope_sections: Optional[Tuple[int, int, int]] = None
    vision_tokens: int = 0
    use_rope: bool = True
    # numerics / execution (remat: each layer recomputed in the backward pass,
    # torch.utils.checkpoint; scan_chunk, attn_chunk, attn_seq_shard and
    # layer_unroll steer the JAX package's compilation and sharding only)
    dtype: str = "bfloat16"
    remat: bool = True
    scan_chunk: int = 128
    attn_chunk: int = 1024
    attn_seq_shard: bool = False
    kv_quant: bool = False
    layer_unroll: int = 1

    @property
    def act_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def attn(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm,
            window=self.window,
            rope_theta=self.rope_theta,
            use_rope=self.use_rope,
            mrope_sections=self.mrope_sections,
        )

    def rwkv(self) -> RWKV6Config:
        return RWKV6Config(
            d_model=self.d_model,
            head_size=self.rwkv_head_size,
            ffn_mult=self.d_ff / self.d_model,
        )


def reduced(cfg: LMConfig, **overrides) -> LMConfig:
    """Smoke-test variant: 2 layers, d_model<=256, <=4 experts."""
    small: Dict[str, Any] = dict(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
        scan_chunk=16,
        encoder_frames=32 if cfg.arch_type == "encdec" else cfg.encoder_frames,
        vision_tokens=8 if cfg.arch_type == "vlm" else 0,
    )
    if cfg.arch_type == "encdec":
        small["encoder_layers"] = 2
    if cfg.num_experts:
        small.update(num_experts=4, top_k=2, d_ff_expert=64,
                     num_shared_experts=min(cfg.num_shared_experts, 1),
                     first_k_dense=min(cfg.first_k_dense, 1),
                     capacity_factor=8.0)
    if cfg.use_mla:
        small.update(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16, head_dim=32)
    if cfg.arch_type == "rwkv":
        small.update(rwkv_head_size=32, num_heads=4)
    if cfg.arch_type == "hybrid":
        small.update(num_layers=4, shared_attn_period=2, mamba_head_dim=32,
                     ssm_state=16, head_dim=32)
    if cfg.mrope_sections is not None:
        small["mrope_sections"] = (4, 6, 6)
    small.update(overrides)
    return replace(cfg, name=cfg.name + "-smoke", **small)


# ===========================================================================
# init
# ===========================================================================

def init_params(cfg: LMConfig, generator: torch.Generator, device: DeviceLike = "cuda", *,
                dtype: Optional[torch.dtype] = None) -> PyTree:
    """Seeded parameters with the shapes and scales of ``repro``'s
    ``init_params``, drawn on ``device`` from ``generator`` (which must live
    there) and stored in ``dtype``: by default the type each is used in,
    ``cfg.act_dtype`` (float32 for the RWKV6 ``bonus``); training passes
    ``torch.float32``, the type of ``repro``'s leaves.  The numbers differ
    from ``repro``'s (another generator); tests carry weights across with
    ``convert.lm_params_from_jax``."""
    check_arch(cfg)
    dev = resolve_device(device)
    dt, L, M = dtype or cfg.act_dtype, cfg.num_layers, cfg.d_model
    p: PyTree = {
        "embed": dense_init(generator, (cfg.vocab_size, M), dt, scale=0.02, device=dev),
        "final_norm": (layernorm_init(M, dt, device=dev) if cfg.arch_type == "rwkv"
                       else rmsnorm_init(M, dt, device=dev)),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, (M, cfg.vocab_size), dt, scale=0.02, device=dev)
    kw = dict(stack=L, device=dev)
    if cfg.arch_type == "dense":
        p["layers"] = {
            "norm1": rmsnorm_init(M, dt, **kw),
            "attn": attention_init(generator, cfg.attn(), dt, **kw),
            "norm2": rmsnorm_init(M, dt, **kw),
            "mlp": swiglu_init(generator, M, cfg.d_ff, dt, **kw),
        }
    else:  # rwkv
        p["layers"] = {
            "ln1": layernorm_init(M, dt, **kw),
            "tm": rwkv6_init(generator, cfg.rwkv(), dt, **kw),
            "ln2": layernorm_init(M, dt, **kw),
        }
    return p


def layer_params(stack: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked parameter tree, as views."""
    return tree_map(lambda a: a[i], stack)


# ===========================================================================
# forward (prefill)
# ===========================================================================

def _tokens(batch: Dict, device: torch.device) -> torch.Tensor:
    tok = batch["tokens"]
    if not isinstance(tok, torch.Tensor):
        tok = torch.from_numpy(np.asarray(tok))
    return tok.to(device=device, dtype=torch.int64)


def _embed(params, cfg: LMConfig, batch) -> torch.Tensor:
    table = params["embed"]
    return table.to(cfg.act_dtype)[_tokens(batch, table.device)]


def _logits(params, cfg: LMConfig, h) -> torch.Tensor:
    h = (layernorm(params["final_norm"], h) if cfg.arch_type == "rwkv"
         else rmsnorm(params["final_norm"], h))
    w = params["embed"].to(h.dtype).T if cfg.tie_embeddings else params["unembed"].to(h.dtype)
    return h @ w


def _dense_block(lp, cfg: LMConfig, h, positions, plain: bool = False, return_kv: bool = False):
    a = attention_apply(lp["attn"], cfg.attn(), rmsnorm(lp["norm1"], h), positions,
                        return_kv=return_kv, plain=plain)
    a, kv = a if return_kv else (a, None)
    h = h + a
    h = h + swiglu(lp["mlp"], rmsnorm(lp["norm2"], h))
    return h, kv


def _rwkv_block(lp, cfg: LMConfig, h, state, x_tm, x_cm, plain: bool = False):
    a, state, x_tm = rwkv6_time_mix(lp["tm"], cfg.rwkv(), layernorm(lp["ln1"], h), state,
                                    x_tm, plain=plain)
    h = h + a
    c, x_cm = rwkv6_channel_mix(lp["tm"], layernorm(lp["ln2"], h), x_cm)
    return h + c, state, x_tm, x_cm


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _layers(params, cfg: LMConfig):
    n = int(next(tree_leaves(params["layers"])).shape[0])
    if n != cfg.num_layers:
        raise ValueError(f"params hold {n} layers, config {cfg.name} says {cfg.num_layers}")
    return (layer_params(params["layers"], i) for i in range(n))


def _remat(body, on: bool):
    """``body`` recomputed in the backward pass when ``on`` (the JAX
    package's ``jax.checkpoint`` around a layer, ``_maybe_remat``): only the
    layer's input is kept.  ``wkv6``'s Function saves only its own inputs,
    which is what ``chunked_scan``'s chunk checkpoints bound in the JAX
    package, so no ``scan_chunk`` code is needed."""
    if not on:
        return body
    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def forward(params: PyTree, cfg: LMConfig, batch: Dict, *, plain: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, V), aux = 0).
    Differentiable; with ``cfg.remat``, each layer is checkpointed when a
    parameter requires grad under grad mode (serving builds no graph)."""
    check_arch(cfg)
    h = _embed(params, cfg, batch)
    B, S, _ = h.shape
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))
    if cfg.arch_type == "dense":
        positions = _positions(B, S, h.device)
        body = _remat(lambda hh, lp: _dense_block(lp, cfg, hh, positions, plain)[0], remat)
    else:
        body = _remat(lambda hh, lp: _rwkv_block(lp, cfg, hh, None, None, None, plain)[0], remat)
    for lp in _layers(params, cfg):
        h = body(h, lp)
    return _logits(params, cfg, h), torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(params: PyTree, cfg: LMConfig, batch: Dict, *, plain: bool = False) -> torch.Tensor:
    """Mean cross-entropy over the tokens whose label is >= 0, plus aux (0 for
    the dense and RWKV families).  The logits go to float32 first; the gold
    logit is a gather (``repro`` sums an iota mask over a vocab-sharded axis,
    which adds exact zeros to the same logit)."""
    logits, aux = forward(params, cfg, batch, plain=plain)
    labels = batch["labels"]
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels))
    labels = labels.to(device=logits.device, dtype=torch.int64)
    valid = labels >= 0
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = (lse - gold) * valid
    return nll.sum() / valid.sum().clamp_min(1) + aux


# ===========================================================================
# decode path
# ===========================================================================

def init_cache(cfg: LMConfig, batch: int, capacity: int, device: DeviceLike = "cuda") -> PyTree:
    """Zeroed decode cache: ``k``/``v`` (L, B, C, K, D) in the activation type
    for dense stacks (``capacity`` C is the window for a ring cache); with
    ``cfg.kv_quant`` ``k``/``v`` int8 and their scales ``k_s``/``v_s`` float32
    (L, B, C, K).  For RWKV the float32 wkv ``state`` (L, B, H, hd, hd) and
    the last token of each mix, ``tm_x``/``cm_x`` (L, B, M)."""
    check_arch(cfg)
    dev = resolve_device(device)
    L, B, C, dt = cfg.num_layers, batch, capacity, cfg.act_dtype
    if cfg.arch_type == "dense":
        shape = (L, B, C, cfg.num_kv_heads, cfg.head_dim)
        if cfg.kv_quant:
            return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                    "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev)}
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}
    H, hd, M = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size, cfg.d_model
    return {
        "state": torch.zeros((L, B, H, hd, hd), dtype=torch.float32, device=dev),
        "tm_x": torch.zeros((L, B, M), dtype=dt, device=dev),
        "cm_x": torch.zeros((L, B, M), dtype=dt, device=dev),
    }


@torch.no_grad()
def decode_step(params: PyTree, cfg: LMConfig, cache: PyTree, tokens, pos: int
                ) -> Tuple[torch.Tensor, PyTree]:
    """One-token decode at position ``pos``; returns (logits (B, V), cache).
    The cache is updated IN PLACE (each layer writes its slot or state into
    its ``[i]`` view of the stacked buffers) and returned."""
    check_arch(cfg)
    table = params["embed"]
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    h = table.to(cfg.act_dtype)[tokens.to(device=table.device, dtype=torch.int64)][:, None, :]
    pos = int(pos)
    if cfg.arch_type == "dense":
        acfg = cfg.attn()
        for i, lp in enumerate(_layers(params, cfg)):
            scales = (cache["k_s"][i], cache["v_s"][i]) if cfg.kv_quant else None
            a = attention_decode(lp["attn"], acfg, rmsnorm(lp["norm1"], h),
                                 cache["k"][i], cache["v"][i], pos, scales)[0]
            h = h + a
            h = h + swiglu(lp["mlp"], rmsnorm(lp["norm2"], h))
    else:
        for i, lp in enumerate(_layers(params, cfg)):
            h, st, xt, xc = _rwkv_block(lp, cfg, h, cache["state"][i], cache["tm_x"][i],
                                        cache["cm_x"][i])
            cache["state"][i].copy_(st)
            cache["tm_x"][i].copy_(xt)
            cache["cm_x"][i].copy_(xc)
    return _logits(params, cfg, h)[:, 0, :], cache


def _fill_slots(arr: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """(B, S, ...) sequence -> the (B, C, ...) cache slots ``out``.  When
    S > C (a ring cache) the last C tokens land at their ring slots pos % C."""
    S, C = arr.shape[1], out.shape[1]
    if S > C:
        slots = torch.arange(S - C, S, device=arr.device) % C
        out[:, slots] = arr[:, S - C:]
    else:
        out[:, :S] = arr
    return out


@torch.no_grad()
def prefill(params: PyTree, cfg: LMConfig, batch: Dict, capacity: Optional[int] = None
            ) -> Tuple[torch.Tensor, PyTree]:
    """Parallel prefill: the full forward, filling a decode cache of
    ``capacity`` slots (default S) in the same pass; a capacity below S
    keeps the last ``capacity`` tokens at their ring slots (a window model's
    ring cache).  Returns (last-token logits (B, V), cache ready for
    ``decode_step`` at position S)."""
    check_arch(cfg)
    h = _embed(params, cfg, batch)
    B, S, _ = h.shape
    C = capacity or S
    cache = init_cache(cfg, B, C, device=h.device)
    if cfg.arch_type == "dense":
        positions = _positions(B, S, h.device)
        for i, lp in enumerate(_layers(params, cfg)):
            h, (k, v) = _dense_block(lp, cfg, h, positions, return_kv=True)
            if cfg.kv_quant:
                (k, k_s), (v, v_s) = kv_quantize(k), kv_quantize(v)
                _fill_slots(k_s, cache["k_s"][i])
                _fill_slots(v_s, cache["v_s"][i])
            _fill_slots(k, cache["k"][i])
            _fill_slots(v, cache["v"][i])
    else:
        for i, lp in enumerate(_layers(params, cfg)):
            h, st, xt, xc = _rwkv_block(lp, cfg, h, None, None, None)
            cache["state"][i].copy_(st)
            cache["tm_x"][i].copy_(xt)
            cache["cm_x"][i].copy_(xc)
    return _logits(params, cfg, h[:, -1:, :])[:, 0, :], cache


__all__ = [
    "LMConfig",
    "PORTED_ARCHS",
    "reduced",
    "init_params",
    "layer_params",
    "tree_leaves",
    "tree_map",
    "forward",
    "loss_fn",
    "init_cache",
    "decode_step",
    "prefill",
]
