"""Training launcher (``repro.launch.train``), local mode: trains the reduced
variant of ``--arch`` on synthetic tokens with ``launch.steps``'
``make_train_step``.

  python -m repro_torch.launch.train --arch yi_6b --steps 30
  python -m repro_torch.launch.train --arch rwkv6_1b6 --steps 4 --device cpu
  python -m repro_torch.launch.train --arch deepseek_moe_16b --steps 4 --device cpu
  python -m repro_torch.launch.train --arch qwen2_vl_2b --steps 4 --device cpu
  python -m repro_torch.launch.train --arch zamba2_2b7 --steps 4 --device cpu
  python -m repro_torch.launch.train --arch whisper_base --steps 4 --device cpu
  python -m repro_torch.launch.train --arch yi_6b --dryrun
  python -m repro_torch.launch.train --arch yi_6b --dryrun --mesh single_pod

Runs on ``cuda`` unless ``--device cpu`` is given.  Parameters are float32,
as ``repro``'s are; ``--ckpt`` writes them in ``repro``'s ``save_pytree``
format.  A VLM batch carries ``repro``'s launcher's vision prefix (zeros)
and M-RoPE ids (the positions 0..S-1 on all three axes), an encoder-decoder
batch its audio frames, drawn from the batch generator after each step's
tokens (``launch.serve.audio_frames``).  ``--dryrun`` prints the single-card
dry-run report of ``--arch`` at ``train_4k`` (``launch.dryrun``) and trains
nothing; with ``--mesh single_pod|multi_pod|both`` the dry run's
multi-device half instead: the train step on the production mesh of a fake
process group (this process's).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch.serve import audio_frames
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import init_params, reduced
from repro_torch.train.adamw import adamw_init
from repro_torch.train.checkpoint import save_pytree

def main(argv: Optional[Sequence[str]] = None) -> Tuple[dict, List[float]]:
    """The trained parameters and the losses of the steps (with ``--dryrun``
    the report and no loss)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--mesh", default=None, choices=("single_pod", "multi_pod", "both"),
                    help="with --dryrun: on the production mesh")
    args = ap.parse_args(argv)
    if args.dryrun and args.mesh:
        reps = dryrun.main(["--mesh", args.mesh, "--arch", args.arch, "--shape", "train_4k"])
        return reps, []
    if args.dryrun:
        rep = dryrun.report(args.arch, "train_4k")
        print(json.dumps(rep), flush=True)
        return rep, []

    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=torch.float32)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=args.lr)
    rng = np.random.default_rng(0)
    losses: List[float] = []
    t0 = time.time()
    for it in range(args.steps):
        toks, labels = synth_lm_batch(rng, args.batch, args.seq, cfg.vocab_size)
        batch = {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev)}
        if cfg.arch_type == "vlm":
            batch["vision_embeds"] = torch.zeros((args.batch, cfg.vision_tokens, cfg.d_model),
                                                 dtype=torch.float32, device=dev)
            batch["positions_3d"] = torch.arange(args.seq, device=dev).expand(3, args.batch, args.seq)
        if cfg.arch_type == "encdec":
            batch["audio_frames"] = audio_frames(rng, args.batch, cfg, dev)
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        if it % 10 == 0 or it == args.steps - 1:
            print(f"[{cfg.name}] step {it} loss {losses[-1]:.4f} "
                  f"({(it + 1) / (time.time() - t0):.2f} it/s)")
    if args.ckpt:
        save_pytree(args.ckpt, params)
        print("saved", args.ckpt)
    return params, losses


if __name__ == "__main__":
    main()
