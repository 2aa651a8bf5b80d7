"""LM assembly for the dense, VLM, MoE, RWKV6, hybrid and encoder-decoder
families (``repro.models.lm``).

One ``LMConfig`` (every field of the JAX package's, so the config files copy
verbatim) drives the block patterns: ``arch_type`` ``dense``, ``vlm``,
``moe`` (with or without MLA), ``rwkv``, ``hybrid`` and ``encdec``.

Parameters keep ``repro``'s key paths and its STACKED layout: every layer
parameter is one ``(L, ...)`` tensor under ``params["layers"]``, or for the
MoE family under two stacks, ``params["dense_layers"]`` (the first
``first_k_dense`` layers, a dense MLP each) and ``params["moe_layers"]``.
The layer loop is a Python loop over ``[i]`` views of those stacks (the JAX
package's ``lax.scan``), so a truncated stack
(``serving.cascade_serving.truncate_params``) is a view and never a copy of
the weights.  The decode cache stacks the layers of both stacks in order.

The VLM family (Qwen2-VL) is the dense stack with two batch fields:
``vision_embeds`` (B, vision_tokens, d_model) replaces the embeddings of the
first ``vision_tokens`` positions, and ``positions_3d`` (3, B, S), when
given, rotates queries and keys by M-RoPE.  The hybrid family (Zamba2) is
G = ``num_shared_attn`` groups, each ``shared_attn_period - 1`` Mamba2
layers (``params["mamba_groups"]``, every leaf (G, per, ...)) and then the
one ``params["shared_block"]`` (attention + SwiGLU, the same weights in
every group, each application with its own KV cache).  The encoder-decoder
family (Whisper) has ``params["enc_layers"]`` (LayerNorm, bidirectional
attention, GELU MLP) over the batch's ``audio_frames`` (B, encoder_frames,
d_model) plus a sinusoid, closed by ``enc_norm``, and ``params["dec_layers"]``
(causal self-attention, cross-attention to the encoder output, GELU MLP)
over the token embeddings plus a sinusoid; no RoPE.  Its decode cache holds
the self-attention's ``k``/``v`` and the cross-attention's ``xk``/``xv``,
computed once at prefill; it ignores ``kv_quant``, as the JAX package does.

API (all functional, as in ``repro``):
  init_params(cfg, generator, device)  seeded params on ``device``
  abstract_params(cfg)                 meta tensors (dry run, no allocation)
  forward(params, cfg, batch)          (logits (B, S, V), MoE aux loss)
  loss_fn(params, cfg, batch)          mean token cross-entropy (+ aux)
  init_cache(cfg, B, capacity, device) decode cache
  prefill(params, cfg, batch, capacity) -> (last_logits, cache)
  decode_step(params, cfg, cache, tokens, pos) -> (logits, cache)

Under a bound mesh (``launch.meshctx.bind_mesh``, parameters, batch and
cache ``DTensor``s by ``launch.sharding``) the same code runs sharded: the
JAX package's ``constrain`` hints sit at the same points, and the kernels
take each rank's local shards (see ``models.layers``).

``forward`` and ``loss_fn`` are differentiable: training holds float32
parameters (``init_params(..., dtype=torch.float32)``) and differentiates
through the casts to ``cfg.act_dtype``; with ``cfg.remat`` each layer is
recomputed in the backward pass.  The decode cache may be a ring
(``cfg.window > 0``, capacity below the prompt) and may be int8
(``cfg.kv_quant``); MLA's cache holds the latent and the rope key instead
(``c``, ``kr``), written at slot ``pos`` with no ring.  ``plain=True`` on
``forward`` / ``loss_fn`` runs the kernels' plain PyTorch versions instead
of the kernels (see ``models.layers``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.launch import meshctx
from repro_torch.launch.meshctx import constrain
from repro_torch.obs.trace import Tracer, stage
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.models.layers import (
    AttnConfig,
    Mamba2Config,
    MLAConfig,
    MoEConfig,
    RWKV6Config,
    attention_apply,
    attention_decode,
    attention_init,
    dense_init,
    gelu_mlp,
    gelu_mlp_init,
    kv_quantize,
    layernorm,
    layernorm_init,
    mamba2_apply,
    mamba2_init,
    mla_apply,
    mla_decode,
    mla_init,
    moe_apply,
    moe_init,
    rmsnorm,
    rmsnorm_init,
    rwkv6_channel_mix,
    rwkv6_init,
    rwkv6_time_mix,
    swiglu,
    split_heads,
    swiglu_init,
    write_slots,
    _sdpa,
)

PyTree = Dict[str, Any]

PORTED_ARCHS = ("dense", "vlm", "moe", "rwkv", "hybrid", "encdec")


def check_arch(cfg: "LMConfig") -> None:
    if cfg.arch_type not in PORTED_ARCHS:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r} ({cfg.name}); "
                         f"known: {PORTED_ARCHS}")


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
    # torch.utils.checkpoint; attn_seq_shard: context-parallel attention
    # under a bound mesh; scan_chunk, attn_chunk and layer_unroll steer the
    # JAX package's compilation only)
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
            seq_shard=self.attn_seq_shard,
        )

    def moe(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model,
            d_ff_expert=self.d_ff_expert,
            num_experts=self.num_experts,
            top_k=self.top_k,
            num_shared=self.num_shared_experts,
            capacity_factor=self.capacity_factor,
            groups=self.moe_groups,
        )

    def mla(self) -> MLAConfig:
        return MLAConfig(
            d_model=self.d_model,
            num_heads=self.num_heads,
            kv_lora_rank=self.kv_lora_rank,
            qk_nope_dim=self.qk_nope_dim,
            qk_rope_dim=self.qk_rope_dim,
            v_dim=self.head_dim,
            rope_theta=self.rope_theta,
            attn_chunk=self.attn_chunk,
        )

    def rwkv(self) -> RWKV6Config:
        return RWKV6Config(
            d_model=self.d_model,
            head_size=self.rwkv_head_size,
            ffn_mult=self.d_ff / self.d_model,
        )

    def mamba(self) -> Mamba2Config:
        return Mamba2Config(
            d_model=self.d_model,
            d_state=self.ssm_state,
            head_dim=self.mamba_head_dim,
        )

    @property
    def num_shared_attn(self) -> int:
        """Shared-attention applications (groups) in a hybrid stack."""
        if self.arch_type != "hybrid":
            return 0
        return self.num_layers // self.shared_attn_period

    @property
    def num_mamba_layers(self) -> int:
        return self.num_layers - self.num_shared_attn


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

def _stack_init(generator: torch.Generator, cfg: LMConfig, kind: str, n: int, dt, dev) -> PyTree:
    """``n`` layers of ``kind`` (dense | moe | rwkv | mamba | enc | dec)
    stacked: each parameter one (n, ...) tensor (``n`` = 0: one layer,
    unstacked, as the hybrid's shared block is).  A dense layer of the MoE
    family (``first_k_dense``) attends through MLA when ``cfg.use_mla``, as a
    MoE layer does."""
    M, kw = cfg.d_model, dict(stack=n, device=dev)
    if kind == "enc":
        return {"norm1": layernorm_init(M, dt, **kw),
                "attn": attention_init(generator, cfg.attn(), dt, **kw),
                "norm2": layernorm_init(M, dt, **kw),
                "mlp": gelu_mlp_init(generator, M, cfg.d_ff, dt, **kw)}
    if kind == "dec":
        return {"norm1": layernorm_init(M, dt, **kw),
                "self_attn": attention_init(generator, cfg.attn(), dt, **kw),
                "norm_x": layernorm_init(M, dt, **kw),
                "cross_attn": attention_init(generator, cfg.attn(), dt, **kw),
                "norm2": layernorm_init(M, dt, **kw),
                "mlp": gelu_mlp_init(generator, M, cfg.d_ff, dt, **kw)}
    if kind == "rwkv":
        return {
            "ln1": layernorm_init(M, dt, **kw),
            "tm": rwkv6_init(generator, cfg.rwkv(), dt, **kw),
            "ln2": layernorm_init(M, dt, **kw),
        }
    if kind == "mamba":
        return {"norm": rmsnorm_init(M, dt, **kw), "mamba": mamba2_init(generator, cfg.mamba(), dt, **kw)}
    attn = (mla_init(generator, cfg.mla(), dt, **kw) if cfg.use_mla
            else attention_init(generator, cfg.attn(), dt, **kw))
    p: PyTree = {"norm1": rmsnorm_init(M, dt, **kw), "attn": attn, "norm2": rmsnorm_init(M, dt, **kw)}
    if kind == "moe":
        p["moe"] = moe_init(generator, cfg.moe(), dt, **kw)
    else:
        p["mlp"] = swiglu_init(generator, M, cfg.d_ff, dt, **kw)
    return p


def init_params(cfg: LMConfig, generator: Optional[torch.Generator], device: DeviceLike = "cuda", *,
                dtype: Optional[torch.dtype] = None) -> PyTree:
    """Seeded parameters with the shapes and scales of ``repro``'s
    ``init_params``, drawn on ``device`` from ``generator`` (which must live
    there) and stored in ``dtype``: by default the type each is used in,
    ``cfg.act_dtype`` (float32 for the RWKV6 ``bonus`` and the MoE
    ``router``); training passes ``torch.float32``, the type of ``repro``'s
    leaves.  The numbers differ from ``repro``'s (another generator); tests
    carry weights across with ``convert.lm_params_from_jax``.  The MoE
    family has two stacks, ``dense_layers`` (``first_k_dense``) and
    ``moe_layers`` (the rest); a stack of no layer is left out.  The hybrid
    family has ``mamba_groups`` (every leaf (G, per, ...)) and one
    ``shared_block``; its ``A_log``, ``D`` and ``dt_bias`` are float32.  The
    encoder-decoder family has ``enc_layers``, ``dec_layers`` and
    ``enc_norm``.  On ``device="meta"`` nothing is drawn or allocated (the
    generator may be None): :func:`abstract_params`."""
    check_arch(cfg)
    dev = resolve_device(device, allow_meta=True)
    dt, L, M = dtype or cfg.act_dtype, cfg.num_layers, cfg.d_model
    p: PyTree = {
        "embed": dense_init(generator, (cfg.vocab_size, M), dt, scale=0.02, device=dev),
        "final_norm": (layernorm_init(M, dt, device=dev) if cfg.arch_type in ("rwkv", "encdec")
                       else rmsnorm_init(M, dt, device=dev)),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, (M, cfg.vocab_size), dt, scale=0.02, device=dev)
    if cfg.arch_type == "moe":
        for key, kind, n in (("dense_layers", "dense", cfg.first_k_dense),
                             ("moe_layers", "moe", L - cfg.first_k_dense)):
            if n:
                p[key] = _stack_init(generator, cfg, kind, n, dt, dev)
    elif cfg.arch_type == "hybrid":
        G, per = cfg.num_shared_attn, cfg.shared_attn_period - 1
        p["mamba_groups"] = tree_map(lambda a: a.reshape(G, per, *a.shape[1:]),
                                     _stack_init(generator, cfg, "mamba", G * per, dt, dev))
        p["shared_block"] = _stack_init(generator, cfg, "dense", 0, dt, dev)
    elif cfg.arch_type == "encdec":
        p["enc_layers"] = _stack_init(generator, cfg, "enc", cfg.encoder_layers, dt, dev)
        p["dec_layers"] = _stack_init(generator, cfg, "dec", L, dt, dev)
        p["enc_norm"] = layernorm_init(M, dt, device=dev)
    else:
        p["layers"] = _stack_init(generator, cfg, "rwkv" if cfg.arch_type == "rwkv" else "dense",
                                  L, dt, dev)
    return p


def abstract_params(cfg: LMConfig) -> PyTree:
    """``repro``'s ``abstract_params`` as meta tensors: the shapes of
    ``init_params``, every float32 leaf re-typed to ``cfg.act_dtype`` (the
    MoE router, the RWKV6 bonus and Mamba2's float32 leaves too, as there).
    Nothing is allocated."""
    params = init_params(cfg, None, device="meta", dtype=torch.float32)
    return tree_map(lambda t: t.to(cfg.act_dtype) if t.dtype == torch.float32 else t, params)


def layer_params(stack: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked parameter tree, as views."""
    return tree_map(lambda a: a[i], stack)


def unstack(stack: PyTree, n: int):
    """The ``n`` layers of a stacked parameter tree, as views: one
    ``unbind`` a leaf, whose gradient stacks the layers' gradients once (a
    view of each layer alone would add a zero-padded (L, ...) gradient a
    layer, bytes quadratic in depth).  A stack sharded over its layers
    (``fsdp`` shards a parameter's first free dim) is gathered first."""
    parts = tree_map(lambda a: (meshctx.unshard(a, 0) if meshctx.is_sharded(a) else a).unbind(0),
                     stack)
    return [tree_map(lambda t, i=i: t[i], parts) for i in range(n)]


# ===========================================================================
# forward (prefill)
# ===========================================================================

def _as_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A batch field (a tensor or host numpy) on ``device``, in ``dtype``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _tokens(batch: Dict, device: torch.device) -> torch.Tensor:
    return _as_tensor(batch["tokens"], device, torch.int64)


def _positions_3d(batch: Dict, device: torch.device) -> Optional[torch.Tensor]:
    """The batch's M-RoPE ids (3, B, S) on ``device``, or None."""
    p3d = batch.get("positions_3d")
    return None if p3d is None else _as_tensor(p3d, device, torch.int64)


def _lookup(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """``table`` rows at ``tokens``, in ``dtype``.  A ``DTensor`` table (a
    bound mesh) is looked up on each rank's shard: the tokens over the batch
    axes, the table's d_model shard as it is, its vocab whole (gathered
    under ``fsdp``)."""
    if not meshctx.is_sharded(table):
        return table.to(dtype)[tokens]
    from torch.distributed.tensor import Replicate, Shard

    t_pl = meshctx.placements("batch", *(None,) * (tokens.ndim - 1), shape=tokens.shape)
    w_pl = tuple(Replicate() if p == Shard(0) else p for p in table.placements)
    o_pl = tuple(Shard(tokens.ndim) if p == Shard(1) else t for p, t in zip(w_pl, t_pl))
    return meshctx.local_call(lambda w, t: w.to(dtype)[t], (w_pl, t_pl), o_pl, table, tokens)


def _embed(params, cfg: LMConfig, batch) -> torch.Tensor:
    """Token embeddings in the activation type; for the VLM family the first
    ``vision_tokens`` positions are the batch's ``vision_embeds`` instead."""
    table = params["embed"]
    emb = _lookup(table, _tokens(batch, table.device), cfg.act_dtype)
    if cfg.arch_type == "vlm" and cfg.vision_tokens:
        ve = _as_tensor(batch["vision_embeds"], table.device, cfg.act_dtype)
        emb = torch.cat([ve, emb[:, cfg.vision_tokens:]], dim=1)
    return constrain(emb, "batch", None, None)


def _logits(params, cfg: LMConfig, h) -> torch.Tensor:
    h = (layernorm(params["final_norm"], h) if cfg.arch_type in ("rwkv", "encdec")
         else rmsnorm(params["final_norm"], h))
    if cfg.tie_embeddings:
        # the table is d_model-sharded for the lookup; vocab-sharded here
        w = constrain(params["embed"].to(h.dtype).T, None, "model")
    else:
        w = params["unembed"].to(h.dtype)
    return constrain(h @ w, "batch", None, "model")


def _attend(lp, cfg: LMConfig, h, positions, positions_3d, plain: bool, return_kv: bool):
    """The attention half of a block: (output, kv) where kv is the rotated
    (k, v), or MLA's (latent, rope key), with ``return_kv``, else None."""
    hn = rmsnorm(lp["norm1"], h)
    if cfg.use_mla:  # plain PyTorch either way: no kernel to hold it against
        a = mla_apply(lp["attn"], cfg.mla(), hn, positions, return_kv=return_kv)
    else:
        a = attention_apply(lp["attn"], cfg.attn(), hn, positions, positions_3d,
                            return_kv=return_kv, plain=plain)
    return a if return_kv else (a, None)


def _add(h, x):
    """The residual add of a sublayer's output, constrained whole over
    ``model`` under a mesh (the JAX package constrains the attention's;
    ``DTensor`` chooses each operation's layout on its own, so the port
    pins every sublayer's partial sums to one all-reduce, the
    tensor-parallel layout XLA propagates from that constraint)."""
    return h + constrain(x, "batch", None, None)


# A block's halves are host ranges of the profiler's trace while it records
# (``stage`` with no tracer): a layer launches more host operations than a
# device trace's reader looks back over to find the range a gap lies in.

def _dense_block(lp, cfg: LMConfig, h, positions, positions_3d=None, plain: bool = False,
                 return_kv: bool = False):
    """A dense layer, or the hybrid's shared block (the same keys)."""
    with stage(None, "lm.attention"):
        a, kv = _attend(lp, cfg, h, positions, positions_3d, plain, return_kv)
        h = h + constrain(a, "batch", None, None)
    with stage(None, "lm.mlp"):
        h = _add(h, swiglu(lp["mlp"], rmsnorm(lp["norm2"], h)))
    return h, kv


def _moe_block(lp, cfg: LMConfig, h, positions, plain: bool = False, return_kv: bool = False):
    """A MoE layer: (h, its aux loss, kv)."""
    with stage(None, "lm.attention"):
        a, kv = _attend(lp, cfg, h, positions, None, plain, return_kv)
        h = h + constrain(a, "batch", None, None)
    with stage(None, "lm.moe"):
        out, aux = moe_apply(lp["moe"], cfg.moe(), rmsnorm(lp["norm2"], h))
        return _add(h, out), aux, kv


def _ffn(lp, cfg: LMConfig, h):
    """The second half of a dense or MoE layer at decode: h + MLP or MoE."""
    if "mlp" in lp:
        return _add(h, swiglu(lp["mlp"], rmsnorm(lp["norm2"], h)))
    return _add(h, moe_apply(lp["moe"], cfg.moe(), rmsnorm(lp["norm2"], h))[0])


def _rwkv_block(lp, cfg: LMConfig, h, state, x_tm, x_cm, plain: bool = False):
    with stage(None, "lm.time_mix"):
        a, state, x_tm = rwkv6_time_mix(lp["tm"], cfg.rwkv(), layernorm(lp["ln1"], h), state,
                                        x_tm, plain=plain)
        h = _add(h, a)
    with stage(None, "lm.channel_mix"):
        c, x_cm = rwkv6_channel_mix(lp["tm"], layernorm(lp["ln2"], h), x_cm)
        return _add(h, c), state, x_tm, x_cm


def _mamba_block(lp, cfg: LMConfig, h, ssm, conv):
    """A hybrid Mamba2 layer: (h, its SSM state, its conv state)."""
    out, ssm, conv = mamba2_apply(lp["mamba"], cfg.mamba(), rmsnorm(lp["norm"], h), ssm, conv,
                                  chunk=cfg.scan_chunk)
    return _add(h, out), ssm, conv


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _layers(params, cfg: LMConfig):
    """(kind, layer params) of every layer in order, kind ``dense`` / ``moe``
    / ``rwkv``: ``params["layers"]``, or the MoE family's two stacks (the
    dense one first; either may be absent or of length 0, as a truncated
    stack is).  The stacks must hold ``cfg.num_layers`` layers together,
    ``first_k_dense`` of them dense."""
    if cfg.arch_type == "moe":
        stacks = (("dense", "dense_layers", cfg.first_k_dense),
                  ("moe", "moe_layers", cfg.num_layers - cfg.first_k_dense))
    else:
        stacks = (("rwkv" if cfg.arch_type == "rwkv" else "dense", "layers", cfg.num_layers),)
    held = {key: int(next(tree_leaves(params[key])).shape[0]) if key in params else 0
            for _, key, _ in stacks}
    if any(held[key] != n for _, key, n in stacks):
        raise ValueError(f"params hold {held} layers, config {cfg.name} says "
                         f"{ {key: n for _, key, n in stacks} }")
    return ((kind, lp) for kind, key, _ in stacks if held[key]
            for lp in unstack(params[key], held[key]))


def _groups(params, cfg: LMConfig):
    """The hybrid's groups in order: each a list of its Mamba2 layers'
    params (views).  ``params["mamba_groups"]`` must be (G, per, ...) as
    ``cfg`` says."""
    G, per = cfg.num_shared_attn, cfg.shared_attn_period - 1
    shape = tuple(next(tree_leaves(params["mamba_groups"])).shape[:2])
    if shape != (G, per):
        raise ValueError(f"params hold mamba groups {shape}, config {cfg.name} says {(G, per)}")
    return [unstack(gp, per) for gp in unstack(params["mamba_groups"], G)]


def _remat(body, on: bool):
    """``body`` recomputed in the backward pass when ``on`` (the JAX
    package's ``jax.checkpoint`` around a layer, ``_maybe_remat``): only the
    layer's input is kept.  ``wkv6``'s Function saves only its own inputs,
    which is what ``chunked_scan``'s chunk checkpoints bound in the JAX
    package, so no ``scan_chunk`` code is needed."""
    if not on:
        return body
    body = meshctx.carry(body)  # the recompute may run on the autograd engine's thread
    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def _stack(params, key: str, n: int):
    """The ``n`` layers of the stack ``params[key]`` in order (views)."""
    held = int(next(tree_leaves(params[key])).shape[0])
    if held != n:
        raise ValueError(f"params hold {held} layers in {key}, the config says {n}")
    return unstack(params[key], n)


def _sinusoid(n: int, d: int, dtype, device=None, *, start: int = 0) -> torch.Tensor:
    """(n, d) absolute positions start..start+n-1: sin, then cos, of
    pos / 10000^(2 i / d) for i < d / 2, the angles in float32, then cast."""
    pos = torch.arange(start, start + n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoid_at(pos: int, d: int, dtype, device=None) -> torch.Tensor:
    """The (d,) row of :func:`_sinusoid` at position ``pos``."""
    return _sinusoid(1, d, dtype, device, start=pos)[0]


def _encode(params, cfg: LMConfig, batch, plain: bool = False, remat: bool = False) -> torch.Tensor:
    """The Whisper encoder over the batch's precomputed frame embeddings
    ``audio_frames`` (the conv frontend is a stub): frames + sinusoid, then
    per layer bidirectional attention and the GELU MLP (each with a
    LayerNorm first), then ``enc_norm``.  (B, F, d_model)."""
    x = _as_tensor(batch["audio_frames"], params["embed"].device, cfg.act_dtype)
    h = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    acfg = cfg.attn()

    def body(hh, lp):
        hh = _add(hh, attention_apply(lp["attn"], acfg, layernorm(lp["norm1"], hh), None,
                                      causal=False, plain=plain))
        return _add(hh, gelu_mlp(lp["mlp"], layernorm(lp["norm2"], hh)))

    body = _remat(body, remat)
    for lp in _stack(params, "enc_layers", cfg.encoder_layers):
        h = body(h, lp)
    return layernorm(params["enc_norm"], h)


def _cross_kv(ap, cfg: LMConfig, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's keys and values (B, F, K, D) from the encoder
    output: its ``wk`` / ``wv`` without bias, as in the JAX package."""
    B = enc.shape[0]
    K, D = cfg.num_kv_heads, cfg.head_dim
    k = split_heads(enc @ ap["wk"].to(enc.dtype), B, enc.shape[1], K, D)
    v = split_heads(enc @ ap["wv"].to(enc.dtype), B, enc.shape[1], K, D)
    return k, v


def _cross_attention_cached(ap, cfg: LMConfig, x, xk, xv, plain: bool = False) -> torch.Tensor:
    """Cross-attention of the queries of ``x`` (B, S, M) against the keys and
    values ``xk`` / ``xv`` (B, F, K, D): every frame visible, no window."""
    B, S, _ = x.shape
    q = x @ ap["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + ap["bq"].to(x.dtype)
    q = split_heads(q, B, S, cfg.num_heads, cfg.head_dim)
    out = _sdpa(q, xk, xv, window=0, q_offset=0, plain=plain, causal=False)
    return out @ ap["wo"].to(x.dtype)


def _cross_attention(ap, cfg: LMConfig, x, enc, plain: bool = False) -> torch.Tensor:
    """Cross-attention reusing the GQA projections: q from ``x``, k / v from
    the encoder output ``enc``."""
    return _cross_attention_cached(ap, cfg, x, *_cross_kv(ap, cfg, enc), plain)


def _dec_block(lp, cfg: LMConfig, h, enc, plain: bool = False, return_kv: bool = False):
    """A Whisper decoder layer over the whole sequence: causal
    self-attention (under ``cfg.window``), cross-attention to ``enc``, the
    GELU MLP.  Returns (h, kv): with ``return_kv`` the self-attention's
    (k, v) and the cross-attention's (xk, xv), else None."""
    a = attention_apply(lp["self_attn"], cfg.attn(), layernorm(lp["norm1"], h), None,
                        return_kv=return_kv, plain=plain)
    a, kv = a if return_kv else (a, None)
    h = _add(h, a)
    xk, xv = _cross_kv(lp["cross_attn"], cfg, enc)
    h = _add(h, _cross_attention_cached(lp["cross_attn"], cfg, layernorm(lp["norm_x"], h), xk,
                                        xv, plain))
    h = _add(h, gelu_mlp(lp["mlp"], layernorm(lp["norm2"], h)))
    return h, (kv + (xk, xv) if return_kv else None)


def forward(params: PyTree, cfg: LMConfig, batch: Dict, *, plain: bool = False,
            tracer: Optional[Tracer] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, V), aux): the MoE
    layers' load-balance losses summed in float32 (0 for the other
    families).  Differentiable; with ``cfg.remat``, each layer (a hybrid:
    each group; an encoder-decoder: each encoder and each decoder layer) is
    checkpointed when a parameter requires grad under grad mode (serving
    builds no graph).  Given a ``tracer``, or while ``torch.profiler``
    records, each layer of the dense, MoE and RWKV stacks is an
    ``lm.layer`` stage (arg ``i``)."""
    check_arch(cfg)
    h = _embed(params, cfg, batch)
    B, S, _ = h.shape
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))
    positions, p3d = _positions(B, S, h.device), _positions_3d(batch, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.arch_type == "encdec":
        enc = _encode(params, cfg, batch, plain, remat)
        h = h + _sinusoid(S, cfg.d_model, h.dtype, h.device)[None]
        body = _remat(lambda hh, lp, e: _dec_block(lp, cfg, hh, e, plain)[0], remat)
        for lp in _stack(params, "dec_layers", cfg.num_layers):
            h = body(h, lp, enc)
        return _logits(params, cfg, h), aux
    if cfg.arch_type == "hybrid":
        sp = params["shared_block"]

        def group_body(hh, layers):
            for lp in layers:
                hh = _mamba_block(lp, cfg, hh, None, None)[0]
            return _dense_block(sp, cfg, hh, positions, plain=plain)[0]

        body = _remat(group_body, remat)
        for layers in _groups(params, cfg):
            h = body(h, layers)
        return _logits(params, cfg, h), aux
    body = {
        "dense": _remat(lambda hh, lp: _dense_block(lp, cfg, hh, positions, p3d, plain)[0], remat),
        "moe": _remat(lambda hh, lp: _moe_block(lp, cfg, hh, positions, plain)[:2], remat),
        "rwkv": _remat(lambda hh, lp: _rwkv_block(lp, cfg, hh, None, None, None, plain)[0], remat),
    }
    with stage(None, "lm.unstack"):  # the layers' views: host work the card waits on
        layers = list(_layers(params, cfg))
    for i, (kind, lp) in enumerate(layers):
        with stage(tracer, "lm.layer", i=i):
            if kind == "moe":
                h, aux_l = body[kind](h, lp)
                aux = aux + aux_l
            else:
                h = body[kind](h, lp)
    return _logits(params, cfg, h), aux


class _ShardedLogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of vocab-sharded logits without
    gathering them (``DTensor``'s own rule gathers the whole (B, S, V)):
    the steps of ATen's kernel (the max, set to 0 where infinite; the sum
    of the exponentials; its log plus the max), each a reduction ``DTensor``
    keeps sharded, and ATen's gradient, g exp(x - lse).  On one rank every
    value is the library call's, bit for bit."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(dim=-1, keepdim=True)
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        lse = (x - m).exp().sum(dim=-1).log() + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * (x - lse[..., None]).exp()


def loss_fn(params: PyTree, cfg: LMConfig, batch: Dict, *, plain: bool = False) -> torch.Tensor:
    """Mean cross-entropy over the tokens whose label is >= 0, plus aux (the
    MoE load-balance loss; 0 for the other families).  The logits go to
    float32 first; the gold logit is a gather (``repro`` sums an iota mask
    over a vocab-sharded axis, which adds exact zeros to the same logit; so
    does a sharded run here, with a log-sum-exp that stays sharded)."""
    logits, aux = forward(params, cfg, batch, plain=plain)
    labels = _as_tensor(batch["labels"], logits.device, torch.int64)
    valid = labels >= 0
    logits = constrain(logits.float(), "batch", None, "model")
    if meshctx.is_sharded(logits):  # vocab-sharded: repro's iota mask, exact zeros added
        lse = _ShardedLogSumExp.apply(logits)
        iota = torch.arange(logits.shape[-1], device=logits.device)
        gold = constrain(torch.where(iota == labels.clamp_min(0)[..., None], logits, 0.0),
                         "batch", None, "model").sum(dim=-1)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = (lse - gold) * valid
    return nll.sum() / valid.sum().clamp_min(1) + aux


# ===========================================================================
# decode path
# ===========================================================================

def init_cache(cfg: LMConfig, batch: int, capacity: int, device: DeviceLike = "cuda") -> PyTree:
    """:func:`zero_cache`, as ``DTensor``s placed by the bound cache mode
    under a bound mesh (``launch.meshctx.shard_cache``)."""
    return meshctx.shard_cache(zero_cache(cfg, batch, capacity, device))


def zero_cache(cfg: LMConfig, batch: int, capacity: int, device: DeviceLike = "cuda") -> PyTree:
    """Zeroed decode cache: ``k``/``v`` (L, B, C, K, D) in the activation type
    for dense / VLM stacks and the MoE family's attention (``capacity`` C is
    the window for a ring cache); with ``cfg.kv_quant`` ``k``/``v`` int8 and
    their scales ``k_s``/``v_s`` float32 (L, B, C, K).  MLA: the latent
    ``c`` (L, B, C, kv_lora_rank) and the rope key ``kr`` (L, B, C,
    qk_rope_dim).  For RWKV the float32 wkv ``state`` (L, B, H, hd, hd) and
    the last token of each mix, ``tm_x``/``cm_x`` (L, B, M).  For the hybrid
    the float32 ``ssm`` (G, per, B, H, P, N), the ``conv`` context (G, per,
    B, W - 1, Di + 2N) and each group's shared-attention cache
    ``shared_k``/``shared_v`` (G, B, C, K, D).  For the encoder-decoder
    ``k``/``v`` (L, B, C, K, D) of the decoder's self-attention and the
    cross-attention's ``xk``/``xv`` (L, B, encoder_frames, K, D), whatever
    ``kv_quant`` says.  ``device="meta"`` allocates nothing (the dry run's
    specs)."""
    check_arch(cfg)
    dev = resolve_device(device, allow_meta=True)
    L, B, C, dt = cfg.num_layers, batch, capacity, cfg.act_dtype
    if cfg.arch_type == "encdec":
        self_kv = (L, B, C, cfg.num_kv_heads, cfg.head_dim)
        cross_kv = (L, B, cfg.encoder_frames, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(self_kv, dtype=dt, device=dev),
                "v": torch.zeros(self_kv, dtype=dt, device=dev),
                "xk": torch.zeros(cross_kv, dtype=dt, device=dev),
                "xv": torch.zeros(cross_kv, dtype=dt, device=dev)}
    if cfg.use_mla:
        return {"c": torch.zeros((L, B, C, cfg.kv_lora_rank), dtype=dt, device=dev),
                "kr": torch.zeros((L, B, C, cfg.qk_rope_dim), dtype=dt, device=dev)}
    if cfg.arch_type == "hybrid":
        mc, G, per = cfg.mamba(), cfg.num_shared_attn, cfg.shared_attn_period - 1
        kv = (G, B, C, cfg.num_kv_heads, cfg.head_dim)
        return {
            "ssm": torch.zeros((G, per, B, mc.num_heads, mc.head_dim, mc.d_state),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((G, per, B, mc.conv_width - 1, mc.d_inner + 2 * mc.d_state),
                                dtype=dt, device=dev),
            "shared_k": torch.zeros(kv, dtype=dt, device=dev),
            "shared_v": torch.zeros(kv, dtype=dt, device=dev),
        }
    if cfg.arch_type != "rwkv":
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
def decode_step(params: PyTree, cfg: LMConfig, cache: PyTree, tokens, pos: int,
                positions_3d=None) -> Tuple[torch.Tensor, PyTree]:
    """One-token decode at position ``pos``; returns (logits (B, V), cache).
    The cache is updated IN PLACE (each layer writes its slot or state into
    its ``[i]`` view of the stacked buffers) and returned.  A MoE layer
    routes the step's B tokens as one batch of B tokens (the flat path
    unless ``moe_groups`` divides B).  ``positions_3d`` (3, B, 1), optional
    as in ``repro``, rotates a VLM's query and key by M-RoPE; without it
    they take 1-D RoPE at ``pos``.  An encoder-decoder step adds the
    sinusoid at ``pos``, attends over its self-attention cache and then
    over the whole of the prefill's cross-attention cache (``xk``/``xv``,
    read only)."""
    check_arch(cfg)
    table = params["embed"]
    h = _lookup(table, _as_tensor(tokens, table.device, torch.int64), cfg.act_dtype)[:, None, :]
    h = constrain(h, "batch", None, None)
    pos = int(pos)
    if cfg.arch_type == "rwkv":
        for i, (_, lp) in enumerate(_layers(params, cfg)):
            h, st, xt, xc = _rwkv_block(lp, cfg, h, cache["state"][i], cache["tm_x"][i],
                                        cache["cm_x"][i])
            cache["state"][i].copy_(st)
            cache["tm_x"][i].copy_(xt)
            cache["cm_x"][i].copy_(xc)
        return _logits(params, cfg, h)[:, 0, :], cache
    acfg = cfg.attn()
    if cfg.arch_type == "encdec":
        h = h + _sinusoid_at(pos, cfg.d_model, h.dtype, h.device)
        for i, lp in enumerate(_stack(params, "dec_layers", cfg.num_layers)):
            h = _add(h, attention_decode(lp["self_attn"], acfg, layernorm(lp["norm1"], h),
                                         cache["k"][i], cache["v"][i], pos)[0])
            h = _add(h, _cross_attention_cached(lp["cross_attn"], cfg, layernorm(lp["norm_x"], h),
                                                cache["xk"][i], cache["xv"][i]))
            h = _add(h, gelu_mlp(lp["mlp"], layernorm(lp["norm2"], h)))
        return _logits(params, cfg, h)[:, 0, :], cache
    if cfg.arch_type == "hybrid":
        sp = params["shared_block"]
        for g, layers in enumerate(_groups(params, cfg)):
            for i, lp in enumerate(layers):
                h, ssm, conv = _mamba_block(lp, cfg, h, cache["ssm"][g, i], cache["conv"][g, i])
                cache["ssm"][g, i].copy_(ssm)
                cache["conv"][g, i].copy_(conv)
            a = attention_decode(sp["attn"], acfg, rmsnorm(sp["norm1"], h), cache["shared_k"][g],
                                 cache["shared_v"][g], pos)[0]
            h = _ffn(sp, cfg, _add(h, a))
        return _logits(params, cfg, h)[:, 0, :], cache
    p3d = None if positions_3d is None else _as_tensor(positions_3d, h.device, torch.int64)
    for i, (_, lp) in enumerate(_layers(params, cfg)):
        hn = rmsnorm(lp["norm1"], h)
        if cfg.use_mla:
            a = mla_decode(lp["attn"], cfg.mla(), hn, cache["c"][i], cache["kr"][i], pos)[0]
        else:
            scales = (cache["k_s"][i], cache["v_s"][i]) if cfg.kv_quant else None
            a = attention_decode(lp["attn"], acfg, hn, cache["k"][i], cache["v"][i], pos, p3d,
                                 scales)[0]
        h = _ffn(lp, cfg, _add(h, a))
    return _logits(params, cfg, h)[:, 0, :], cache


def _fill_slots(arr: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """(B, S, ...) sequence -> the (B, C, ...) cache slots ``out``.  When
    S > C (a ring cache) the last C tokens land at their ring slots pos % C:
    tokens S - C.. to slots S % C.., the last S % C tokens to slots 0...
    (``layers.write_slots``, on the owner ranks of a sharded cache)."""
    S, C = arr.shape[1], out.shape[1]
    if S > C:
        r = S % C
        return write_slots(out, arr, [(r, S - C, C - r), (0, S - r, r)])
    return write_slots(out, arr, [(0, 0, S)])


@torch.no_grad()
def prefill(params: PyTree, cfg: LMConfig, batch: Dict, capacity: Optional[int] = None
            ) -> Tuple[torch.Tensor, PyTree]:
    """Parallel prefill: the full forward, filling a decode cache of
    ``capacity`` slots (default S) in the same pass; a capacity below S
    keeps the last ``capacity`` tokens at their ring slots (a window model's
    ring cache, the hybrid's shared attention under a window too; MLA's
    latents are laid out the same way, as in the JAX package; an
    encoder-decoder's cross-attention cache holds every frame).  Returns
    (last-token logits (B, V), cache ready for ``decode_step`` at position
    S)."""
    check_arch(cfg)
    h = _embed(params, cfg, batch)
    B, S, _ = h.shape
    C = capacity or S
    cache = init_cache(cfg, B, C, device=h.device)
    if cfg.arch_type == "rwkv":
        for i, (_, lp) in enumerate(_layers(params, cfg)):
            h, st, xt, xc = _rwkv_block(lp, cfg, h, None, None, None)
            cache["state"][i].copy_(st)
            cache["tm_x"][i].copy_(xt)
            cache["cm_x"][i].copy_(xc)
        return _logits(params, cfg, h[:, -1:, :])[:, 0, :], cache
    if cfg.arch_type == "encdec":
        enc = _encode(params, cfg, batch)
        h = h + _sinusoid(S, cfg.d_model, h.dtype, h.device)[None]
        for i, lp in enumerate(_stack(params, "dec_layers", cfg.num_layers)):
            h, (k, v, xk, xv) = _dec_block(lp, cfg, h, enc, return_kv=True)
            _fill_slots(k, cache["k"][i])
            _fill_slots(v, cache["v"][i])
            cache["xk"][i].copy_(xk)
            cache["xv"][i].copy_(xv)
        return _logits(params, cfg, h[:, -1:, :])[:, 0, :], cache
    positions, p3d = _positions(B, S, h.device), _positions_3d(batch, h.device)
    if cfg.arch_type == "hybrid":
        sp = params["shared_block"]
        for g, layers in enumerate(_groups(params, cfg)):
            for i, lp in enumerate(layers):
                h, ssm, conv = _mamba_block(lp, cfg, h, None, None)
                cache["ssm"][g, i].copy_(ssm)
                cache["conv"][g, i].copy_(conv)
            h, (k, v) = _dense_block(sp, cfg, h, positions, return_kv=True)
            _fill_slots(k, cache["shared_k"][g])
            _fill_slots(v, cache["shared_v"][g])
        return _logits(params, cfg, h[:, -1:, :])[:, 0, :], cache
    for i, (kind, lp) in enumerate(_layers(params, cfg)):
        if kind == "moe":
            h, _, kv = _moe_block(lp, cfg, h, positions, return_kv=True)
        else:
            h, kv = _dense_block(lp, cfg, h, positions, p3d, return_kv=True)
        if cfg.use_mla:
            _fill_slots(kv[0], cache["c"][i])
            _fill_slots(kv[1], cache["kr"][i])
            continue
        k, v = kv
        if cfg.kv_quant:
            (k, k_s), (v, v_s) = kv_quantize(k), kv_quantize(v)
            _fill_slots(k_s, cache["k_s"][i])
            _fill_slots(v_s, cache["v_s"][i])
        _fill_slots(k, cache["k"][i])
        _fill_slots(v, cache["v"][i])
    return _logits(params, cfg, h[:, -1:, :])[:, 0, :], cache


__all__ = [
    "LMConfig",
    "PORTED_ARCHS",
    "reduced",
    "init_params",
    "abstract_params",
    "layer_params",
    "tree_leaves",
    "tree_map",
    "forward",
    "loss_fn",
    "init_cache",
    "decode_step",
    "prefill",
]
