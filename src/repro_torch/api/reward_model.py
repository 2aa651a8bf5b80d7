"""Reward-model interface for the OffloadEngine.

``MLPRewardModel`` wraps :class:`repro_torch.core.estimator.RewardEstimator`.
When the MLP has a single hidden layer and a sigmoid head (the deployable
shape), batched prediction runs the ``estimator_mlp`` kernel on the model's
device and the engine's detection path runs the fused ``score_pipeline``
kernel on the bundle :meth:`MLPRewardModel.pipeline_params` returns.
``predict_device`` is the variant that keeps its result on the device.  The
CNN reward model and ``fit`` come with the port's training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.core.estimator import EstimatorConfig, RewardEstimator
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.kernels.estimator_mlp import estimator_mlp
from repro_torch.kernels.score_pipeline.ops import pipeline_params


@runtime_checkable
class RewardModel(Protocol):
    """predict over (B, F) features, plus its checkpoint state."""

    kind: str

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


_MODELS = {"mlp": MLPRewardModel}


def reward_model_from_state(
    arrays: Dict[str, Any], meta: Dict[str, Any], *, device: DeviceLike = "cuda"
) -> RewardModel:
    kind = meta["kind"]
    if kind == "cnn":
        raise NotImplementedError(
            "the CNN reward model comes with the port's training slice "
            "(ROADMAP.md, queue A)"
        )
    if kind not in _MODELS:
        raise KeyError(f"unknown reward model kind {kind!r}")
    return _MODELS[kind].from_state(arrays, meta, device=device)
