"""Single-card dry run (the one-device half of ``repro.launch.dryrun``): for
each (architecture x input shape), the bytes of the step's arguments, summed
from meta tensors, whether they fit one card, the model's FLOPs, and a
roofline against the card.

  python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
  python -m repro_torch.launch.dryrun --all

Prints one JSON object a line, one per (arch, shape).  Nothing is allocated
and nothing runs on a device: the arguments are ``abstract_params``, plus
``abstract_opt_state`` for a train step and the batch, or the decode cache,
the token and the position for a decode step (``launch.input_specs``).

``model_flops`` is the JAX package's (6 N D for training, 2 N D otherwise,
N the parameters a token touches, D the tokens of the step), and
``recurrence_flops`` its count of the RWKV6 / Mamba2 recurrences, here over
the whole batch on the one card.  The roofline takes ``compute_s`` = model
FLOPs / the bf16 peak and ``memory_s`` = argument bytes / the HBM rate;
``dominant`` is the larger.  The card's memory is
``torch.cuda.get_device_properties`` where a card is visible, else the H100
SXM data sheet's 80 GB; the rates are always the data sheet's (3.35 TB/s,
989 TFLOP/s dense bf16).  Each report names which it used.  The
multi-device lowering (sharding rules, the production mesh, collectives) is
not part of this module.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.launch.input_specs import SHAPES, input_specs
from repro_torch.launch.steps import abstract_opt_state
from repro_torch.models.lm import LMConfig, abstract_params
from repro_torch.tree import tree_leaves

DATA_SHEET = "NVIDIA H100 SXM data sheet"
H100_MEMORY_BYTES = 80e9
H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS_PER_S = 989e12  # dense, tensor cores


def model_flops(cfg: LMConfig, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D, N the active parameters a token
    (MoE: shared + top-k experts), D the step's tokens."""
    meta = SHAPES[shape_name]
    D = meta["batch"] * (meta["seq_len"] if meta["kind"] != "decode" else 1)
    M, L = cfg.d_model, cfg.num_layers
    emb = 2 * cfg.vocab_size * M  # embed+unembed
    if cfg.arch_type == "moe":
        if cfg.use_mla:
            attn = M * cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim) + \
                M * (cfg.kv_lora_rank + cfg.qk_rope_dim) + \
                cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim + cfg.head_dim) + \
                cfg.num_heads * cfg.head_dim * M
        else:
            attn = 2 * M * cfg.num_heads * cfg.head_dim + 2 * M * cfg.num_kv_heads * cfg.head_dim
        ff_act = 3 * M * cfg.d_ff_expert * (cfg.top_k + cfg.num_shared_experts)
        dense_ff = 3 * M * cfg.d_ff
        n_active = (L - cfg.first_k_dense) * (attn + ff_act) + cfg.first_k_dense * (attn + dense_ff) + emb
    elif cfg.arch_type == "rwkv":
        per = 5 * M * M + M * M + 2 * M * cfg.d_ff  # time-mix + channel-mix
        n_active = L * per + emb
    elif cfg.arch_type == "hybrid":
        mc = cfg.mamba()
        per_m = M * (2 * mc.d_inner + 2 * mc.d_state + mc.num_heads) + mc.d_inner * M
        shared = 4 * M * cfg.num_heads * cfg.head_dim + 3 * M * cfg.d_ff
        n_active = cfg.num_mamba_layers * per_m + cfg.num_shared_attn * shared + emb
    elif cfg.arch_type == "encdec":
        per_dec = 8 * M * cfg.num_heads * cfg.head_dim + 2 * M * cfg.d_ff
        per_enc = 4 * M * cfg.num_heads * cfg.head_dim + 2 * M * cfg.d_ff
        n_active = L * per_dec + cfg.encoder_layers * per_enc + emb
    else:  # dense / vlm
        attn = 2 * M * cfg.num_heads * cfg.head_dim + 2 * M * cfg.num_kv_heads * cfg.head_dim
        n_active = L * (attn + 3 * M * cfg.d_ff) + emb
    mult = 6 if meta["kind"] == "train" else 2
    return float(mult) * n_active * D


def recurrence_flops(cfg: LMConfig, shape: str) -> float:
    """The RWKV6 / Mamba2 time recurrences' FLOPs (elementwise outer
    products, outside N), over the whole batch: one card holds no batch
    shard of it."""
    meta = SHAPES[shape]
    B = meta["batch"]
    S = meta["seq_len"] if meta["kind"] != "decode" else 1
    if cfg.arch_type == "rwkv":
        return 8.0 * B * S * cfg.num_layers * cfg.d_model * cfg.rwkv_head_size
    if cfg.arch_type == "hybrid":
        mc = cfg.mamba()
        return 8.0 * B * S * cfg.num_mamba_layers * mc.d_inner * mc.d_state
    return 0.0


def nbytes(tree) -> int:
    """Bytes of the tensors of a (nested dict of) meta tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def card_spec() -> Dict:
    """The card the report is read against: its memory (the visible card's
    when there is one, else the data sheet's) and the data sheet's rates."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        memory, source = props.total_memory, f"torch.cuda.get_device_properties(0): {props.name}"
    else:
        memory, source = H100_MEMORY_BYTES, DATA_SHEET
    return {"memory_bytes": memory, "memory_source": source,
            "hbm_bytes_per_s": H100_HBM_BYTES_PER_S, "bf16_flops_per_s": H100_BF16_FLOPS_PER_S,
            "rates_source": DATA_SHEET}


def report(arch: str, shape: str, card: Optional[Dict] = None) -> Dict:
    """The single-card report of one (arch, shape)."""
    card = card or card_spec()
    cfg, specs = input_specs(arch, shape)
    params = abstract_params(cfg)
    args = {"params": nbytes(params)}
    if specs["kind"] == "train":
        opt = abstract_opt_state(params)
        args["opt_state"] = nbytes(opt.step) + nbytes(opt.mu) + nbytes(opt.nu)
    if specs["kind"] == "decode":
        args["cache"] = nbytes(specs["cache"])
        args["token_and_pos"] = nbytes(specs["tokens"]) + nbytes(specs["pos"])
    else:
        args["batch"] = nbytes(specs["batch"])
    total = sum(args.values())
    flops = model_flops(cfg, shape)
    roof = {"compute_s": flops / card["bf16_flops_per_s"],
            "memory_s": total / card["hbm_bytes_per_s"]}
    roof["dominant"] = max(roof, key=roof.get)
    meta = SHAPES[shape]
    return {
        "arch": arch, "shape": shape, "kind": specs["kind"], "batch": meta["batch"],
        "seq_len": meta["seq_len"], "window": cfg.window, "dtype": cfg.dtype,
        "argument_bytes": {**args, "total": total},
        "fits_one_card": total <= card["memory_bytes"],
        "model_flops": flops, "recurrence_flops": recurrence_flops(cfg, shape),
        "roofline": roof, "card": card,
    }


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """The reports, each also printed as one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="every architecture x shape")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("pass --arch and --shape, or --all")
    archs = ARCH_IDS if args.all else [args.arch]
    shapes = list(SHAPES) if args.all else [args.shape]
    card = card_spec()
    out = []
    for arch in archs:
        for shape in shapes:
            out.append(report(arch, shape, card))
            print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
