"""Reward estimator (paper §V), inference half: the MLP that maps
weak-detector features to a predicted (M)ORIC value.

The parameters keep the JAX package's layout — ``{"layer<i>": {"w": (in,
out), "b": (out,)}}`` — so an artifact written by either package loads in the
other.  Training (``fit``, the weighted-MSE loss, AdamW) and the CNN
estimator of the §V-A input study come with the port's training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import DeviceLike, resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


def mlp_init(
    generator: torch.Generator, in_dim: int, hidden: Sequence[int] = (128, 64)
) -> Params:
    """He-normal weights and zero biases, drawn on the CPU from
    ``generator``.  (The JAX package draws from ``jax.random``; the two give
    different numbers from one seed, so trained weights cross as artifacts.)"""
    params: Params = {}
    dims = [in_dim, *hidden, 1]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"layer{i}"] = {
            "w": torch.randn((a, b), generator=generator) * float(np.sqrt(2.0 / a)),
            "b": torch.zeros((b,)),
        }
    return params


def mlp_apply(params: Params, x: torch.Tensor, *, sigmoid_out: bool) -> torch.Tensor:
    n_layers = len(params)
    h = x
    for i in range(n_layers):
        p = params[f"layer{i}"]
        h = h @ p["w"] + p["b"]
        if i < n_layers - 1:
            h = F.gelu(h, approximate="tanh")
    out = h[..., 0]
    return torch.sigmoid(out) if sigmoid_out else out


@dataclass
class EstimatorConfig:
    hidden: Tuple[int, ...] = (256, 128)
    weighted: bool = True  # Eq. 7 loss
    sigmoid_out: bool = True  # targets are MORIC ranks in [0, 1]
    lr: float = 2e-3
    weight_decay: float = 1e-4
    epochs: int = 80
    batch_size: int = 256
    standardize: bool = True
    seed: int = 0


class RewardEstimator:
    """Inference wrapper around the MLP; ``params`` live on ``device``,
    ``_mu``/``_sigma`` (the standardize statistics) on the host, as in the
    JAX package."""

    def __init__(
        self,
        in_dim: int,
        config: Optional[EstimatorConfig] = None,
        *,
        device: DeviceLike = "cuda",
    ):
        self.config = config = config if config is not None else EstimatorConfig()
        self.in_dim = in_dim
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(config.seed)
        self.params = {
            name: {k: v.to(self.device) for k, v in layer.items()}
            for name, layer in mlp_init(gen, in_dim, config.hidden).items()
        }
        self._mu = np.zeros((in_dim,), np.float32)
        self._sigma = np.ones((in_dim,), np.float32)

    def predict(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if self.config.standardize:
            x = (x - self._mu) / self._sigma
        xt = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        out = mlp_apply(self.params, xt, sigmoid_out=self.config.sigmoid_out)
        return out.cpu().numpy()
