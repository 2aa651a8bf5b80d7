"""Reward estimators (paper §V): the MLP that maps weak-detector features to
a predicted (M)ORIC value, trained with the Eq. 7 weighted MSE (weights =
targets) when ``weighted=True``, and the small CNN over feature maps of the
§V-A input study.

The MLP's parameters keep the JAX package's layout — ``{"layer<i>": {"w":
(in, out), "b": (out,)}}`` — so an artifact written by either package loads
in the other.  Training is autograd on the plain PyTorch forward, as
``repro`` differentiates ``mlp_apply`` and not its kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.models.detector import conv2d_same
from repro_torch.train.adamw import adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.train.schedule import warmup_cosine

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


def host_array(x) -> np.ndarray:
    """Host or device features as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def weighted_mse_loss(
    params: Params, x: torch.Tensor, y: torch.Tensor, *, weighted: bool, sigmoid_out: bool
) -> torch.Tensor:
    """Eq. 7: mean of y_i * (e(x_i) - y_i)^2 (y clipped at 0); the plain MSE
    if not ``weighted``."""
    pred = mlp_apply(params, x, sigmoid_out=sigmoid_out)
    err = torch.square(pred - y)
    if weighted:
        err = torch.clamp(y, min=0.0) * err
    return torch.mean(err)


def value_and_grad(loss_fn, params, *args):
    """(loss, grads): ``jax.value_and_grad`` over a nested dict of tensors."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_fn(leaves, *args)
    flat = list(tree_leaves(leaves))
    by_id = {id(t): g for t, g in zip(flat, torch.autograd.grad(loss, flat))}
    return loss.detach(), tree_map(lambda t: by_id[id(t)], leaves)


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
    """Train/eval wrapper around the MLP; ``params`` live on ``device``,
    ``_mu``/``_sigma`` (the standardize statistics) on the host, as in the
    JAX package.  The serve path's kernel (``estimator_mlp``) runs in
    ``MLPRewardModel``."""

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

    def fit(self, x, y, log_every: int = 0) -> List[float]:
        """Fit on host features ``x`` (B, F) and targets ``y``: standardize
        by the features' statistics (numpy, as ``repro``), then AdamW under
        ``warmup_cosine(lr, total // 20, total)`` on minibatches drawn by
        ``np.random.default_rng(seed)``.  Returns the loss trace."""
        cfg = self.config
        x = host_array(x)
        if cfg.standardize:
            self._mu = x.mean(axis=0)
            self._sigma = x.std(axis=0) + 1e-6
            x = (x - self._mu) / self._sigma
        xt = torch.tensor(x, dtype=torch.float32, device=self.device)
        yt = torch.tensor(host_array(y), device=self.device)
        n = xt.shape[0]
        steps_per_epoch = max(n // cfg.batch_size, 1)
        total = cfg.epochs * steps_per_epoch
        sched = warmup_cosine(cfg.lr, max(total // 20, 1), total)
        opt_state = adamw_init(self.params)

        def loss_fn(p, xb, yb):
            return weighted_mse_loss(p, xb, yb, weighted=cfg.weighted, sigmoid_out=cfg.sigmoid_out)

        rng = np.random.default_rng(cfg.seed)
        losses: List[float] = []
        params = self.params
        it = 0
        for _ in range(cfg.epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(self.device)
            for s in range(steps_per_epoch):
                idx = perm[s * cfg.batch_size : (s + 1) * cfg.batch_size]
                loss, grads = value_and_grad(loss_fn, params, xt[idx], yt[idx])
                params, opt_state = adamw_update(
                    grads, opt_state, params, sched(it), weight_decay=cfg.weight_decay
                )
                it += 1
                losses.append(float(loss))
                if log_every and it % log_every == 0:
                    print(f"  estimator step {it}/{total} loss {losses[-1]:.5f}")
        self.params = params
        return losses

    @torch.no_grad()
    def predict(self, x) -> np.ndarray:
        x = host_array(x)
        if self.config.standardize:
            x = (x - self._mu) / self._sigma
        xt = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        out = mlp_apply(self.params, xt, sigmoid_out=self.config.sigmoid_out)
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# CNN estimator over feature maps (paper §V-A hidden-layer input study)
# ---------------------------------------------------------------------------


def cnn_init(generator: torch.Generator, in_channels: int, width: int = 16) -> Params:
    """Two stride-2 3x3 convs (OIHW, He-normal) and a dense head ((in, out),
    as the MLP's), drawn on the CPU from ``generator``; ``repro``'s
    ``cnn_init`` draws from ``jax.random`` (``convert.cnn_params_from_jax``
    carries its weights over)."""

    def conv(cin, cout):
        w = torch.randn((cout, cin, 3, 3), generator=generator) * float(np.sqrt(2.0 / (9 * cin)))
        return {"w": w, "b": torch.zeros((cout,))}

    head = torch.randn((2 * width, 1), generator=generator) * float(np.sqrt(2.0 / (2 * width)))
    return {
        "conv0": conv(in_channels, width),
        "conv1": conv(width, 2 * width),
        "head": {"w": head, "b": torch.zeros((1,))},
    }


def cnn_apply(params: Params, fmap: torch.Tensor) -> torch.Tensor:
    """fmap (B, H, W, C) -> (B,) sigmoid reward estimate: two SAME stride-2
    convs with GELU, a global average pool, the dense head."""
    h = fmap.permute(0, 3, 1, 2)
    for name in ("conv0", "conv1"):
        p = params[name]
        h = F.gelu(conv2d_same(h, p["w"], p["b"], 2), approximate="tanh")
    h = torch.mean(h, dim=(2, 3))  # global average pool
    out = h @ params["head"]["w"] + params["head"]["b"]
    return torch.sigmoid(out[..., 0])
