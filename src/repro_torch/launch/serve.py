"""Serving launcher: batched prefill + greedy decode on a reduced config (the
generate mode of ``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch qwen2_7b --tokens 16
  python -m repro_torch.launch.serve --arch rwkv6_1b6 --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--cascade`` (fit an
``LMCascade`` and serve through it) needs the port's training slice
(ROADMAP.md queue A item 1) and raises until then.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.lm import init_params, reduced
from repro_torch.serving.decode_loop import generate


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cascade", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.cascade:
        raise NotImplementedError(
            "--cascade fits an LMCascade, which comes with the port's training slice "
            "(ROADMAP.md queue A item 1); fit with `python -m repro.launch.serve "
            "--cascade` and serve the saved engine through LMCascade.load"
        )
    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    toks, _ = synth_lm_batch(np.random.default_rng(args.seed), args.batch, args.prompt_len,
                             cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}

    t0 = time.perf_counter()
    out = generate(params, cfg, batch, steps=args.tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[{cfg.name}] generated {tuple(out.shape)} on {dev} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")
    print("first row:", out[0, :12].cpu().numpy())
    return out


if __name__ == "__main__":
    main()
