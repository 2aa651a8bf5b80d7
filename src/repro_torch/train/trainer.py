"""Detector training loop (``repro.train.trainer``): the weak and strong
models of the reproduction, trained with AdamW under a warm-up + cosine
schedule on seeded ``ShapesDataset`` batches.

There is no backward kernel: ``repro`` differentiates plain ``jnp`` code
(``detector_loss`` through ``lax.conv``), and the port differentiates the
module's PyTorch forward with autograd (convolutions in cuDNN on the card)."""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.data.shapes import ShapesDataset
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.models.detector import Detector, DetectorConfig, build_targets, detector_loss
from repro_torch.train.adamw import adamw_init, adamw_update
from repro_torch.train.schedule import warmup_cosine


def train_detector(
    cfg: DetectorConfig,
    dataset: ShapesDataset,
    steps: int = 600,
    batch_size: int = 64,
    peak_lr: float = 3e-3,
    seed: int = 0,
    log_every: int = 100,
    *,
    device: DeviceLike = "cuda",
) -> Tuple[Detector, List[float]]:
    """Returns (the trained detector on ``device``, the loss trace).  The
    detector starts from He-normal weights drawn from ``seed`` on the CPU,
    so the same on every device (``repro`` draws from ``jax.random``).  The
    batches and their order come from ``np.random.default_rng(seed + 1)``,
    as in ``repro``."""
    dev = resolve_device(device)
    detector = Detector(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    leaves = dict(detector.named_parameters())
    opt_state = adamw_init({k: p.detach() for k, p in leaves.items()})
    sched = warmup_cosine(peak_lr, max(steps // 10, 1), steps)

    rng = np.random.default_rng(seed + 1)
    losses: List[float] = []
    it = 0
    t0 = time.time()
    while it < steps:
        for imgs, boxes, classes in dataset.batches(batch_size, rng):
            obj_t, cls_t, box_t = build_targets(cfg, boxes, classes)
            loss = detector_loss(detector, imgs, obj_t, cls_t, box_t)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            new, opt_state = adamw_update(
                dict(zip(leaves, grads)), opt_state, {k: p.detach() for k, p in leaves.items()},
                sched(it), weight_decay=1e-4,
            )
            with torch.no_grad():
                for k, p in leaves.items():
                    p.copy_(new[k])
            losses.append(float(loss.detach()))
            it += 1
            if log_every and it % log_every == 0:
                rate = it / (time.time() - t0)
                print(f"  [{cfg.name}] step {it}/{steps} loss {losses[-1]:.4f} ({rate:.1f} it/s)")
            if it >= steps:
                break
    return detector, losses
