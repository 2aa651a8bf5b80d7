"""Offloading baselines the paper compares against (§V-C):

  * Adaptive Feeding [13] — linear SVM binary classifier (easy/difficult by
    sign of ORI), class weight c₊₁ controls the offload fraction at TRAIN
    time (not runtime); we train one SVM per c₊₁ as the paper does.
  * DCSB [14] — rule policy thresholding (#objects, min box area) from the
    weak output, thresholds grid-searched to maximise prediction accuracy of
    "strong detects more objects"; offload ratio is whatever the rule yields.
  * Random — offloads a uniform random subset at the target ratio.

Copied from the JAX package (``repro.core.baselines``).  The SVM's fit runs
on ``device`` with ``torch.autograd`` and the port's AdamW; its
standardization and ``decision`` / ``predict`` stay host numpy, and the DCSB
and random baselines are numpy throughout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.detection.map_engine import Detections
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.train.adamw import adamw_init, adamw_update


class AdaptiveFeedingSVM:
    """Linear SVM with hinge loss and positive-class weight c₊₁ [13].

    Labels: +1 (difficult, offload) iff ORI > 0.  Trained by full-batch
    subgradient descent on ``mean(w_y · max(0, 1 − y·(xw+b))) + λ‖w‖²``.
    """

    def __init__(
        self, c_plus: float = 1.0, l2: float = 1e-4, lr: float = 1e-2,
        epochs: int = 80, seed: int = 0, *, device: DeviceLike = "cuda",
    ) -> None:
        self.c_plus = c_plus
        self.l2 = l2
        self.lr = lr
        self.epochs = epochs
        self.seed = seed
        self.device = resolve_device(device)
        self.w: Optional[np.ndarray] = None
        self.b: float = 0.0

    def fit(self, x: np.ndarray, difficult: np.ndarray) -> "AdaptiveFeedingSVM":
        self._mu = np.asarray(x, np.float32).mean(axis=0)
        self._sigma = np.asarray(x, np.float32).std(axis=0) + 1e-6
        x = (x - self._mu) / self._sigma
        dev = self.device
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        y = torch.as_tensor(np.where(difficult, 1.0, -1.0).astype(np.float32), device=dev)
        wgt = torch.where(y > 0, torch.tensor(float(self.c_plus), device=dev),
                          torch.tensor(1.0, device=dev))
        zero = torch.zeros((), device=dev)
        params = {
            "w": torch.zeros((x.shape[1],), dtype=torch.float32, device=dev),
            "b": torch.zeros((), dtype=torch.float32, device=dev),
        }

        def loss_fn(p):
            margin = y * (x @ p["w"] + p["b"])
            # torch.maximum, as jnp.maximum: half the gradient at a tie
            # (margin exactly 1), where clamp / relu would pass all of it
            hinge = torch.maximum(zero, 1.0 - margin)
            return torch.mean(wgt * hinge) + self.l2 * torch.sum(torch.square(p["w"]))

        opt = adamw_init(params)
        for _ in range(self.epochs):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = loss_fn(leaves)
            gw, gb = torch.autograd.grad(loss, (leaves["w"], leaves["b"]))
            params, opt = adamw_update({"w": gw, "b": gb}, opt, params, self.lr,
                                       weight_decay=0.0)
        self.w = params["w"].cpu().numpy()
        self.b = float(params["b"])
        return self

    def decision(self, x: np.ndarray) -> np.ndarray:
        x = (x - self._mu) / self._sigma
        return x @ self.w + self.b

    def predict(self, x: np.ndarray) -> np.ndarray:
        """True = offload."""
        return self.decision(x) > 0


@dataclass
class DCSBRule:
    """Offload iff #detected objects <= thr_count OR min box area <= thr_area."""

    thr_count: float
    thr_area: float

    def predict_signals(self, counts: np.ndarray, min_areas: np.ndarray) -> np.ndarray:
        return (counts <= self.thr_count) | (min_areas <= self.thr_area)


def dcsb_signals(dets: Sequence[Detections], score_floor: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """(num objects, smallest box area) from weak outputs."""
    counts, areas = [], []
    for d in dets:
        keep = d.scores >= score_floor
        counts.append(int(keep.sum()))
        if keep.any():
            b = d.boxes[keep]
            a = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
            areas.append(float(a.min()))
        else:
            areas.append(0.0)
    return np.array(counts, dtype=np.float64), np.array(areas, dtype=np.float64)


def fit_dcsb(
    weak_dets: Sequence[Detections],
    strong_dets: Sequence[Detections],
    score_floor: float = 0.1,
) -> DCSBRule:
    """Grid-search thresholds maximising accuracy of predicting
    "strong detects more objects than weak" [14]."""
    counts, areas = dcsb_signals(weak_dets, score_floor)
    s_counts, _ = dcsb_signals(strong_dets, score_floor)
    label = s_counts > counts  # strong finds more -> should offload
    count_grid = np.unique(np.concatenate([[-1.0], counts]))
    area_grid = np.unique(np.concatenate([[-1.0], np.quantile(areas, np.linspace(0, 1, 33))]))
    best = (-1.0, DCSBRule(-1.0, -1.0))
    for tc in count_grid:
        pred_c = counts <= tc
        for ta in area_grid:
            pred = pred_c | (areas <= ta)
            acc = float(np.mean(pred == label))
            if acc > best[0]:
                best = (acc, DCSBRule(float(tc), float(ta)))
    return best[1]


def random_offload_mask(n: int, ratio: float, rng: np.random.Generator) -> np.ndarray:
    k = int(round(ratio * n))
    mask = np.zeros(n, dtype=bool)
    mask[rng.choice(n, size=k, replace=False)] = True
    return mask
