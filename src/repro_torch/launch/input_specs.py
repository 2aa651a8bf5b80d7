"""Meta-tensor stand-ins for every (architecture x input shape)
(``repro.launch.input_specs``).

The four assigned shapes:

  train_4k       seq= 4,096  global_batch=256   train_step
  prefill_32k    seq=32,768  global_batch= 32   prefill_step
  decode_32k     seq=32,768  global_batch=128   serve_step (1 token vs cache)
  long_500k      seq=524,288 global_batch=  1   serve_step, sub-quadratic

``long_500k`` swaps in the sliding-window (8192) attention variant for
attention archs (``configs.long_context_variant``); RWKV state decode needs
no window.  Every spec is a tensor on ``device="meta"``: a shape and a
dtype, no memory, where the JAX package has a ``ShapeDtypeStruct``.  The
float types are the same; the integer ones are ``int64`` where the JAX
package's are ``int32`` (token ids, labels, M-RoPE ids and the decode
position: the port indexes with them, and PyTorch indexes with int64).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import get_config, long_context_variant
from repro_torch.models.lm import LMConfig, init_cache

SHAPES: Dict[str, Dict] = {
    "train_4k": {"seq_len": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "batch": 1, "kind": "decode"},
}

WINDOW = 8192  # sliding window for long_500k attention variants

INDEX_DTYPE = torch.int64  # the JAX package's int32 ids and positions


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def resolve_config(arch: str, shape: str) -> LMConfig:
    cfg = get_config(arch)
    if shape == "long_500k":
        cfg = long_context_variant(cfg, WINDOW)
    return cfg


def batch_specs(cfg: LMConfig, B: int, seq: int) -> Dict[str, torch.Tensor]:
    """A training / prefill batch: tokens, and the VLM's vision prefix and
    M-RoPE ids or the encoder-decoder's audio frames."""
    batch = {"tokens": _meta((B, seq), INDEX_DTYPE)}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = _meta((B, cfg.vision_tokens, cfg.d_model), cfg.act_dtype)
        batch["positions_3d"] = _meta((3, B, seq), INDEX_DTYPE)
    if cfg.arch_type == "encdec":
        batch["audio_frames"] = _meta((B, cfg.encoder_frames, cfg.d_model), cfg.act_dtype)
    return batch


def input_specs(arch: str, shape: str) -> Tuple[LMConfig, Dict[str, Any]]:
    """Returns (cfg, specs) where specs' structure depends on the shape kind:

      train   -> {"batch": {tokens, labels, ...}}
      prefill -> {"batch": {tokens, ...}}
      decode  -> {"cache": <cache tree>, "tokens": (B,), "pos": (), "capacity": C}
    """
    cfg = resolve_config(arch, shape)
    return cfg, specs(cfg, shape)


def specs(cfg: LMConfig, shape: str) -> Dict[str, Any]:
    """:func:`input_specs`' specs for a given config (a probe depth, an
    override)."""
    meta = SHAPES[shape]
    B, seq, kind = meta["batch"], meta["seq_len"], meta["kind"]
    if kind == "train":
        batch = batch_specs(cfg, B, seq)
        batch["labels"] = _meta((B, seq), INDEX_DTYPE)
        return {"kind": kind, "batch": batch}
    if kind == "prefill":
        return {"kind": kind, "batch": batch_specs(cfg, B, seq)}
    # decode: ONE token against a seq-deep cache (a window's ring under long_500k)
    capacity = min(seq, cfg.window) if cfg.window > 0 else seq
    return {
        "kind": kind,
        "cache": init_cache(cfg, B, capacity, device="meta"),
        "tokens": _meta((B,), INDEX_DTYPE),
        "pos": _meta((), INDEX_DTYPE),
        "capacity": capacity,
    }
