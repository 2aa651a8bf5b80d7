"""End-to-end driver: train a ~100M-parameter dense LM for a few hundred
steps on synthetic token streams with the framework's train step (the same
code path the dry run sizes for the production mesh), and write the
checkpoint ``examples/serve_cascade.py`` (either package's) serves
(``examples/train_lm.py``).

Run:  python -m repro_torch.examples.train_lm [--steps 150] [--arch yi_6b] [--device cpu]

The model is the assigned architecture's family scaled to ~100M params;
the full config is sized by ``repro_torch.launch.dryrun``.  Parameters are
float32, as ``repro``'s are, and ``artifacts/lm_100m.npz`` has the key
layout of ``repro.train.checkpoint.save_pytree``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.examples import artifact, parser
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import init_params
from repro_torch.train.adamw import adamw_init
from repro_torch.train.checkpoint import save_pytree
from repro_torch.tree import tree_leaves

CKPT = "lm_100m.npz"


def scaled_100m(arch: str):
    """~100M-param variant of the assigned arch family."""
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-100m",
        num_layers=10,
        d_model=640,
        num_heads=10,
        num_kv_heads=2,  # must divide num_heads (GQA)
        head_dim=64,
        d_ff=2560,
        vocab_size=32768,
        dtype="float32",
        vision_tokens=0,
        mrope_sections=None,
        attn_chunk=0,
    )


def n_params(params) -> int:
    return sum(int(np.prod(p.shape)) for p in tree_leaves(params))


def run(device="cuda", *, arch: str = "yi_6b", steps: int = 150, batch: int = 4,
        seq: int = 256, lr: float = 3e-4) -> dict:
    """``{"model", "n_params", "losses", "first10", "last10", "it_per_s",
    "ckpt"}``; the trained parameters are written to ``artifacts/lm_100m.npz``."""
    dev = resolve_device(device)
    cfg = scaled_100m(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=torch.float32)
    count = n_params(params)
    print(f"model {cfg.name}: {count / 1e6:.1f}M params")
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=lr)

    rng = np.random.default_rng(0)
    t0 = time.time()
    losses = []
    rate = 0.0
    for it in range(steps):
        toks, labels = synth_lm_batch(rng, batch, seq, cfg.vocab_size)
        params, opt, loss = step(
            params, opt,
            {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev)},
        )
        losses.append(float(loss))
        if it % 10 == 0 or it == steps - 1:
            rate = (it + 1) / (time.time() - t0)
            print(f"step {it:4d}  loss {losses[-1]:.4f}  ({rate:.2f} it/s)")
    path = artifact(CKPT)
    save_pytree(path, params)
    return {"model": cfg.name, "n_params": count, "losses": losses,
            "first10": float(np.mean(losses[:10])), "last10": float(np.mean(losses[-10:])),
            "it_per_s": rate, "ckpt": path}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)
    out = run(args.device, arch=args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
              lr=args.lr)
    print(f"loss: first10={out['first10']:.4f}  last10={out['last10']:.4f}")
    print(f"checkpoint written to {out['ckpt']}")
    return out


if __name__ == "__main__":
    main()
