"""Serving launcher: batched prefill + greedy decode on a reduced config,
with optional ORIC cascade gating (``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch qwen2_7b --tokens 16
  python -m repro_torch.launch.serve --arch rwkv6_1b6 --device cpu
  python -m repro_torch.launch.serve --arch qwen2_7b --cascade
  python -m repro_torch.launch.serve --arch deepseek_v2_lite_16b --cascade
  python -m repro_torch.launch.serve --arch qwen2_vl_2b --cascade
  python -m repro_torch.launch.serve --arch zamba2_2b7 --device cpu
  python -m repro_torch.launch.serve --arch whisper_base --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--cascade`` fits an
``LMCascade`` on one calibration batch and serves that batch through it;
the hybrid and encoder-decoder families have no cascade (as in ``repro``)
and generate instead.  A VLM batch carries ``repro``'s launcher's vision
prefix (zeros) and M-RoPE ids (the positions 0..S-1 on all three axes), an
encoder-decoder batch its ``audio_frames`` (B, encoder_frames, d_model),
N(0, 1) from the launcher's generator after the tokens, as ``repro``'s
launcher draws them.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.lm import init_params, reduced
from repro_torch.serving.cascade_serving import LMCascade
from repro_torch.serving.decode_loop import generate


def audio_frames(rng: np.random.Generator, B: int, cfg, device: torch.device) -> torch.Tensor:
    """An encoder-decoder batch's frame embeddings as ``repro``'s launchers
    draw them: N(0, 1) of shape (B, encoder_frames, d_model), float32."""
    x = rng.normal(0, 1, (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def main(argv: Optional[Sequence[str]] = None) -> Union[torch.Tensor, Dict]:
    """The generated tokens, or with ``--cascade`` the served batch's result
    (``LMCascade.serve_batch``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cascade", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    rng = np.random.default_rng(args.seed)
    toks, labels = synth_lm_batch(rng, args.batch, args.prompt_len, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.zeros((args.batch, cfg.vision_tokens, cfg.d_model),
                                             dtype=torch.float32, device=dev)
        batch["positions_3d"] = torch.arange(args.prompt_len, device=dev).expand(
            3, args.batch, args.prompt_len)
    if cfg.arch_type == "encdec":
        batch["audio_frames"] = audio_frames(rng, args.batch, cfg, dev)

    if args.cascade and cfg.arch_type in ("dense", "vlm", "moe", "rwkv"):
        cal = dict(batch, labels=torch.from_numpy(labels).to(dev))
        cascade = LMCascade.fit(params, cfg, exit_layer=max(cfg.num_layers // 2, 1),
                                calib_batches=[cal], ratio=0.25, epochs=10)
        out = cascade.serve_batch(params, cal)
        print(f"cascade: offload_ratio={out['offload_ratio']:.2f} "
              f"nll weak={out['nll_weak'].mean():.4f} "
              f"strong={out['nll_strong'].mean():.4f} "
              f"final={out['nll_final'].mean():.4f}")
        return out

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
