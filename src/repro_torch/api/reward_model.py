"""Reward-model interface for the OffloadEngine.

``MLPRewardModel`` wraps :class:`repro_torch.core.estimator.RewardEstimator`.
When the MLP has a single hidden layer and a sigmoid head (the deployable
shape), batched prediction runs the ``estimator_mlp`` kernel on the model's
device and the engine's detection path runs the fused ``score_pipeline``
kernel on the bundle :meth:`MLPRewardModel.pipeline_params` returns.
``predict_device`` is the variant that keeps its result on the device.  The
CNN variant from the §V-A input study sits behind the same interface.
Artifacts (``state``) hold ``repro``'s layouts, so either package loads the
other's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.convert import cnn_params_from_jax, cnn_params_to_jax
from repro_torch.core.estimator import (
    EstimatorConfig,
    RewardEstimator,
    cnn_apply,
    cnn_init,
    host_array,
    value_and_grad,
)
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.kernels.estimator_mlp import estimator_mlp
from repro_torch.kernels.score_pipeline.ops import pipeline_params
from repro_torch.train.adamw import adamw_init, adamw_update


@runtime_checkable
class RewardModel(Protocol):
    """fit/predict over (B, F) features (or feature maps for the CNN), plus
    its checkpoint state."""

    kind: str

    def fit(self, x, y): ...

    def predict(self, x) -> np.ndarray: ...

    def state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(arrays, meta) for checkpointing."""
        ...


class MLPRewardModel:
    """MLP reward estimator with the fused kernel batched-predict path."""

    kind = "mlp"

    def __init__(
        self,
        in_dim: Optional[int] = None,
        config: Optional[EstimatorConfig] = None,
        use_fused: bool = True,
        *,
        device: DeviceLike = "cuda",
    ):
        self.config = config if config is not None else EstimatorConfig(hidden=(128,))
        self.in_dim = in_dim
        self.use_fused = use_fused
        self.device = resolve_device(device)
        self.estimator: Optional[RewardEstimator] = (
            RewardEstimator(in_dim, self.config, device=self.device)
            if in_dim is not None
            else None
        )
        # (source leaves, bundle) — see pipeline_params()
        self._pipeline_cache: Optional[Tuple[Tuple, Dict[str, torch.Tensor]]] = None

    def _ensure(self, in_dim: int) -> RewardEstimator:
        if self.estimator is None:
            self.in_dim = in_dim
            self.estimator = RewardEstimator(in_dim, self.config, device=self.device)
        return self.estimator

    @property
    def fused(self) -> bool:
        """True when batched predict runs the fused kernel: exactly one
        hidden layer (params = layer0 + layer1) and a sigmoid head."""
        return (
            self.use_fused
            and self.estimator is not None
            and len(self.estimator.params) == 2
            and self.config.sigmoid_out
        )

    def fit(self, x, y):
        """Fit the estimator on host or device features; returns its loss
        trace."""
        x = host_array(x)
        return self._ensure(int(x.shape[1])).fit(x, host_array(y))

    def predict(self, x) -> np.ndarray:
        """Host estimates for host or device features."""
        if self.estimator is None:
            raise RuntimeError("predict() before fit()")
        if not self.fused:
            return self.estimator.predict(torch.as_tensor(x).cpu().numpy())
        return self.predict_device(x).cpu().numpy()

    def predict_device(self, x) -> torch.Tensor:
        """(B,) estimates on the model's device for host or device features:
        standardize, then the ``estimator_mlp`` kernel."""
        if self.estimator is None:
            raise RuntimeError("predict_device() before fit()")
        if not self.fused:
            return torch.as_tensor(self.predict(x), device=self.device)
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        p = self.pipeline_params()
        if self.config.standardize:
            x = (x - p["mu"]) / p["sigma"]
        return estimator_mlp(x.contiguous(), p["w1"], p["b1"], p["w2"], p["b2"])

    def pipeline_params(self) -> Dict[str, torch.Tensor]:
        """The device bundle for ``score_pipeline`` (requires the fused
        shape), cached by the *identity* of its sources: installing new
        weights or statistics replaces those objects, so it misses the cache
        and rebuilds."""
        est = self.estimator
        if not self.fused:
            return pipeline_params(self)  # raises with the explanatory message
        p = est.params
        srcs = (
            est,
            p["layer0"]["w"], p["layer0"]["b"],
            p["layer1"]["w"], p["layer1"]["b"],
            est._mu, est._sigma,
        )
        cached = self._pipeline_cache
        if cached is not None and all(a is b for a, b in zip(cached[0], srcs)):
            return cached[1]
        bundle = pipeline_params(self)
        self._pipeline_cache = (srcs, bundle)
        return bundle

    def state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        if self.estimator is None:
            raise RuntimeError("state() before fit()")
        est = self.estimator
        params = {
            name: {k: v.detach().cpu().numpy() for k, v in layer.items()}
            for name, layer in est.params.items()
        }
        arrays = {"params": params, "mu": est._mu, "sigma": est._sigma}
        meta = {
            "kind": self.kind,
            "in_dim": self.in_dim,
            "use_fused": self.use_fused,
            "config": dataclasses.asdict(self.config),
        }
        return arrays, meta

    @classmethod
    def from_state(
        cls, arrays: Dict[str, Any], meta: Dict[str, Any], *, device: DeviceLike = "cuda"
    ) -> "MLPRewardModel":
        ckw = dict(meta["config"])
        ckw["hidden"] = tuple(ckw["hidden"])
        model = cls(
            in_dim=int(meta["in_dim"]),
            config=EstimatorConfig(**ckw),
            use_fused=bool(meta.get("use_fused", True)),
            device=device,
        )
        est = model.estimator
        est.params = {
            name: {
                k: torch.as_tensor(np.asarray(v, np.float32)).to(model.device)
                for k, v in layer.items()
            }
            for name, layer in dict(arrays["params"]).items()
        }
        est._mu = np.asarray(arrays["mu"], np.float32)
        est._sigma = np.asarray(arrays["sigma"], np.float32)
        return model


class CNNRewardModel:
    """CNN over weak-backbone feature maps (§V-A early-exit input study),
    behind the same fit/predict contract.  ``x`` is (B, H, W, C)."""

    kind = "cnn"

    def __init__(
        self,
        in_channels: Optional[int] = None,
        width: int = 16,
        lr: float = 2e-3,
        epochs: int = 30,
        batch_size: int = 256,
        weighted: bool = True,
        seed: int = 0,
        *,
        device: DeviceLike = "cuda",
    ):
        self.in_channels = in_channels
        self.width = width
        self.lr = lr
        self.epochs = epochs
        self.batch_size = batch_size
        self.weighted = weighted
        self.seed = seed
        self.device = resolve_device(device)
        self.params = self._init(in_channels) if in_channels is not None else None

    def _init(self, in_channels: int):
        params = cnn_init(torch.Generator().manual_seed(self.seed), in_channels, self.width)
        return {n: {k: v.to(self.device) for k, v in p.items()} for n, p in params.items()}

    @property
    def fused(self) -> bool:
        return False

    def fit(self, x, y):
        """AdamW (``repro``'s defaults: weight decay 0.01, clip 1.0) at a
        constant lr over every minibatch of each epoch, the last one short;
        returns the loss trace."""
        x = torch.tensor(host_array(x), device=self.device)
        y = torch.tensor(host_array(y), device=self.device)
        if self.params is None:
            self.in_channels = int(x.shape[-1])
            self.params = self._init(self.in_channels)
        weighted = self.weighted

        def loss_fn(p, xb, yb):
            err = torch.square(cnn_apply(p, xb) - yb)
            if weighted:
                err = torch.clamp(yb, min=0.0) * err
            return torch.mean(err)

        params, opt = self.params, adamw_init(self.params)
        rng = np.random.default_rng(self.seed)
        losses = []
        for _ in range(self.epochs):
            perm = torch.from_numpy(rng.permutation(x.shape[0])).to(self.device)
            for s in range(0, len(perm), self.batch_size):
                sel = perm[s : s + self.batch_size]
                loss, grads = value_and_grad(loss_fn, params, x[sel], y[sel])
                params, opt = adamw_update(grads, opt, params, self.lr)
                losses.append(float(loss))
        self.params = params
        return losses

    @torch.no_grad()
    def predict(self, x) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("predict() before fit()")
        x = torch.tensor(host_array(x), device=self.device)
        return cnn_apply(self.params, x).cpu().numpy()

    def state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        if self.params is None:
            raise RuntimeError("state() before fit()")
        meta = {
            "kind": self.kind,
            "in_channels": self.in_channels,
            "width": self.width,
            "lr": self.lr,
            "epochs": self.epochs,
            "batch_size": self.batch_size,
            "weighted": self.weighted,
            "seed": self.seed,
        }
        return {"params": cnn_params_to_jax(self.params)}, meta

    @classmethod
    def from_state(
        cls, arrays: Dict[str, Any], meta: Dict[str, Any], *, device: DeviceLike = "cuda"
    ) -> "CNNRewardModel":
        kw = {k: v for k, v in meta.items() if k != "kind"}
        model = cls(**kw, device=device)
        model.params = cnn_params_from_jax(dict(arrays["params"]), device=model.device)
        return model


_MODELS = {"mlp": MLPRewardModel, "cnn": CNNRewardModel}


def reward_model_from_state(
    arrays: Dict[str, Any], meta: Dict[str, Any], *, device: DeviceLike = "cuda"
) -> RewardModel:
    kind = meta["kind"]
    if kind not in _MODELS:
        raise KeyError(f"unknown reward model kind {kind!r}")
    return _MODELS[kind].from_state(arrays, meta, device=device)
