"""Cascade serving example: the paper's offloading pipeline applied to LM
early-exit serving (paper §V-A: the approach "is readily applicable to
edge frameworks with embedded early exits").

A small decoder serves batches of requests; the early-exit head (weak) runs
"locally", the unified ``OffloadEngine`` (logits features -> MORIC
estimator -> runtime-adjustable threshold policy) decides per request
whether to escalate to full depth ("edge"), and the calibrated engine is
saved and reloaded as a deployable artifact (``examples/serve_cascade.py``).

Run:  python -m repro_torch.examples.serve_cascade [--device cpu]

Serves ``artifacts/lm_100m.npz`` when it exists: written by
``repro_torch.examples.train_lm`` or by ``examples/train_lm.py`` (the key
layout is ``repro``'s, read through ``convert.lm_params_from_jax``); else a
seeded 6-layer reduced qwen2-7b.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.examples import artifact, parser, train_lm
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.lm import init_params, reduced
from repro_torch.serving.cascade_serving import LMCascade
from repro_torch.train.checkpoint import load_pytree
from repro_torch.tree import tree_map

ENGINE = "lm_cascade_engine"
RATIOS = (0.1, 0.25, 0.5)


def load_checkpoint(path: str, cfg, device):
    """A ``save_pytree`` checkpoint of ``cfg``'s parameters (either
    package's) on ``device``, each leaf in the type ``repro`` uses it in."""
    like = tree_map(lambda t: np.zeros(tuple(t.shape), np.float32),
                    init_params(cfg, None, device="meta", dtype=torch.float32))
    return lm_params_from_jax(load_pytree(path, like), cfg, device)


def run(device="cuda", *, batch: int = 32, seq: int = 48, n_calib: int = 4,
        epochs: int = 25) -> dict:
    """``{"model", "loaded", "exit_layer", "ratios": {budget: {"actual",
    "nll_weak", "nll_strong", "nll_cascade"}}, "decisions_identical",
    "fused", "engine_path"}``."""
    dev = resolve_device(device)
    ckpt = artifact(train_lm.CKPT)
    loaded = os.path.exists(ckpt)
    if loaded:
        # the ~100M model trained by train_lm: a real weak (early-exit) /
        # strong (full-depth) quality gap
        cfg = train_lm.scaled_100m("yi_6b")
        params = load_checkpoint(ckpt, cfg, dev)
        print(f"loaded trained checkpoint {ckpt} ({cfg.name})")
    else:
        cfg = dataclasses.replace(
            reduced(get_config("qwen2_7b"), num_layers=6), name="qwen2-cascade-demo"
        )
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    def mk(seed, B=batch, S=seq):
        toks, labels = synth_lm_batch(np.random.default_rng(seed), B, S, cfg.vocab_size)
        return {"tokens": torch.from_numpy(toks).to(dev), "labels": torch.from_numpy(labels).to(dev)}

    exit_layer = max(cfg.num_layers // 2, 1)
    print(f"== fit cascade (exit layer {exit_layer} of {cfg.num_layers}) ==")
    cascade = LMCascade.fit(
        params, cfg, exit_layer=exit_layer,
        calib_batches=[mk(s) for s in range(1, n_calib + 1)],
        ratio=0.25, epochs=epochs,
    )
    ratios = {}
    for ratio in RATIOS:
        cascade.set_ratio(ratio)  # runtime budget adjustment (via the engine)
        out = cascade.serve_batch(params, mk(99))
        ratios[ratio] = {"actual": float(out["offload_ratio"]),
                         "nll_weak": float(out["nll_weak"].mean()),
                         "nll_strong": float(out["nll_strong"].mean()),
                         "nll_cascade": float(out["nll_final"].mean())}

    # the calibrated decision stack is a deployable artifact
    path = artifact(ENGINE)
    cascade.save(path)
    reloaded = LMCascade.load(path, cfg, device=dev)
    out_a = cascade.serve_batch(params, mk(123))
    out_b = reloaded.serve_batch(params, mk(123))
    identical = bool(np.array_equal(out_a["offload"], out_b["offload"]))
    assert identical
    return {"model": cfg.name, "loaded": loaded, "exit_layer": exit_layer, "ratios": ratios,
            "decisions_identical": identical, "fused": cascade.engine.reward_model.fused,
            "engine_path": path}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    for ratio, r in out["ratios"].items():
        print(f"budget={ratio:.2f}  actual={r['actual']:.2f}  NLL weak={r['nll_weak']:.4f}  "
              f"strong={r['nll_strong']:.4f}  cascade={r['nll_cascade']:.4f}")
    print(f"saved+reloaded engine {out['engine_path']}.npz: decisions identical "
          f"(fused kernel scoring: {out['fused']})")
    return out


if __name__ == "__main__":
    main()
