"""`OffloadEngine` — the decision stack.

    weak output --FeatureExtractor--> features
                --RewardModel-------> reward estimate        (§V MLP/CNN)
                --RankTransform-----> MORIC rank target      (Eq. 6, fit time)
                --Policy------------> offload decision       (§III threshold /
                                                              topk / token_bucket)

An engine is fitted once (``fit``), decides batches at serve time, and
round-trips through ``save``/``load`` as the ``.npz`` artifact whose layout
both packages share (an engine either package fitted loads in the other).
Estimates stay on the device from the detections to the policy boundary,
where ``decide`` copies them to the host once.

Given a tracer (``tracer=``), or while ``torch.profiler`` records, scoring
opens the stages ``engine.features`` (the adapter, where one runs),
``engine.estimator`` (the launch and, for host estimates, the copy that
waits for it) and ``engine.policy`` (:func:`repro_torch.obs.trace.stage`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.api.features import DetectionBoxFeatures, FeatureExtractor, make_feature_extractor
from repro_torch.api.policies import Policy, make_policy, policy_context_params
from repro_torch.api.reward_model import MLPRewardModel, RewardModel, reward_model_from_state
from repro_torch.core.reward import CdfTransform
from repro_torch.detection.batch import DetectionsBatch
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.kernels.score_pipeline import score_pipeline
from repro_torch.obs.trace import Tracer, stage
from repro_torch.train.checkpoint import load_flat, save_flat


@dataclass
class DecisionBatch:
    """One served batch: per-item reward estimates + offload mask."""

    estimates: np.ndarray
    offload: np.ndarray

    @property
    def ratio(self) -> float:
        return float(np.mean(self.offload)) if self.offload.size else 0.0


class OffloadEngine:
    """The decision stack; see module docstring.

    Parameters
    ----------
    feature_extractor : FeatureExtractor or None
        Registered adapter mapping weak outputs to features.  ``None`` means
        callers pass ready-made feature matrices.
    reward_model : RewardModel
        Defaults to a single-hidden-layer MLP on ``device``.
    transform : "cdf" | None
        The rank transform the reward model was fitted on (MORIC, Eq. 6).
    policy : str
        Registered policy name: "threshold" (default), "topk", "token_bucket".
    ratio : float
        Target offloading ratio; adjustable later via ``set_ratio``.
    device :
        Device of the default reward model; the engine's device is its
        reward model's.
    """

    def __init__(
        self,
        feature_extractor: Optional[FeatureExtractor] = None,
        reward_model: Optional[RewardModel] = None,
        transform: Optional[str] = "cdf",
        policy: str = "threshold",
        ratio: float = 0.2,
        policy_kwargs: Optional[Dict[str, Any]] = None,
        *,
        device: DeviceLike = "cuda",
    ):
        if transform not in ("cdf", None):
            raise ValueError(f"unknown transform {transform!r} (use 'cdf' or None)")
        self.feature_extractor = feature_extractor
        self.reward_model: RewardModel = (
            reward_model if reward_model is not None else MLPRewardModel(device=device)
        )
        self.transform_kind = transform
        self.transform: Optional[CdfTransform] = None
        self.policy_name = policy
        self.policy_kwargs = dict(policy_kwargs or {})
        self.ratio = float(ratio)
        self.policy: Optional[Policy] = None
        self.calibration_scores: Optional[np.ndarray] = None
        self.extra_meta: Dict[str, Any] = {}

    @property
    def device(self) -> torch.device:
        return self.reward_model.device

    # ------------------------------------------------------------ features

    def features(self, weak_outputs: Any = None, *, features=None,
                 tracer: Optional[Tracer] = None) -> torch.Tensor:
        """Resolve weak outputs (or ready-made ``features``) to the (B, F)
        float32 feature tensor the reward model consumes, on the engine's
        device.  Weak outputs go through the ``engine.features`` stage."""
        if features is None:
            if weak_outputs is None:
                raise ValueError("pass weak_outputs or features=")
            with stage(tracer, "engine.features", device=self.device):
                # no adapter: weak outputs ARE the features
                return self._as_features(
                    weak_outputs if self.feature_extractor is None
                    else self.feature_extractor(weak_outputs)
                )
        return self._as_features(features)

    def _as_features(self, features) -> torch.Tensor:
        if isinstance(features, torch.Tensor):
            return features.to(self.device, torch.float32)
        return torch.tensor(np.asarray(features), dtype=torch.float32, device=self.device)

    def fit(self, weak_outputs: Any = None, rewards=None, *, features=None) -> "OffloadEngine":
        """Fit the rank transform and the reward model on calibration data,
        then derive the policy from the calibration estimates (on the card
        the ``estimator_mlp`` kernel's, for the fused MLP)."""
        if rewards is None:
            raise ValueError("fit() needs rewards")
        x = self.features(weak_outputs, features=features)
        r = np.asarray(rewards, np.float64)
        if self.transform_kind == "cdf":
            self.transform = CdfTransform(r)
            y = self.transform(r)
        else:
            self.transform = None
            y = r
        self.reward_model.fit(x, y)
        self.calibration_scores = np.asarray(self.reward_model.predict(x), np.float64)
        self.policy = self._make_policy()
        return self

    def _make_policy(self) -> Policy:
        """The policy of ``policy_name`` over the calibration scores.  A
        policy that declares ``device`` among its ``context_params`` (the
        value-iteration solve) runs on the engine's device."""
        kwargs = dict(self.policy_kwargs)
        if "device" in policy_context_params(self.policy_name):
            kwargs.setdefault("device", self.device)
        return make_policy(self.policy_name, self.calibration_scores, self.ratio, **kwargs)

    # ---------------------------------------------------------------- serve

    def score(self, weak_outputs: Any = None, *, features=None) -> np.ndarray:
        """Batched reward estimates on the host, through the composed
        features -> reward model route."""
        return np.asarray(self.reward_model.predict(self.features(weak_outputs, features=features)))

    def _fused_pipeline_ready(self, weak_outputs: Any, features) -> bool:
        """True when scoring can take the one-launch fused pipeline: a padded
        detection block, the box feature extractor and the fused MLP."""
        return (
            features is None
            and isinstance(weak_outputs, DetectionsBatch)
            and isinstance(self.feature_extractor, DetectionBoxFeatures)
            and getattr(self.reward_model, "fused", False)
        )

    def score_device(self, weak_outputs: Any = None, *, features=None,
                     tracer: Optional[Tracer] = None, host: bool = False):
        """(B,) estimates on the engine's device (with ``host``, copied to a
        host array inside the ``engine.estimator`` stage).  A
        :class:`DetectionsBatch` under the box extractor + fused MLP runs the
        whole boxes->estimates pipeline as one ``score_pipeline`` launch;
        anything else goes through feature extraction and the model's
        ``predict_device``."""
        if self._fused_pipeline_ready(weak_outputs, features):
            fx = self.feature_extractor
            with stage(tracer, "engine.estimator", device=self.device, fused=True):
                est = score_pipeline(
                    weak_outputs.to(self.device),
                    self.reward_model.pipeline_params(),
                    num_classes=fx.num_classes,
                    top_k=fx.top_k,
                    image_size=fx.image_size,
                )
                return est.cpu().numpy() if host else est
        x = self.features(weak_outputs, features=features, tracer=tracer)
        model = self.reward_model
        with stage(tracer, "engine.estimator", device=self.device):
            if hasattr(model, "predict_device"):
                est = model.predict_device(x)
            else:
                est = torch.as_tensor(model.predict(x), device=self.device)
            return est.cpu().numpy() if host else est

    def decide(self, weak_outputs: Any = None, *, features=None,
               tracer: Optional[Tracer] = None) -> DecisionBatch:
        """Estimates (copied to the host here, once) and the policy's offload
        mask."""
        if self.policy is None:
            raise RuntimeError("decide() before fit()/load()")
        est = self.score_device(weak_outputs, features=features, tracer=tracer, host=True)
        with stage(tracer, "engine.policy"):
            mask = np.asarray(self.policy.decide_batch(est), bool)
        return DecisionBatch(estimates=est, offload=mask)

    def set_ratio(self, ratio: float) -> None:
        """Runtime budget adjustment (paper Table I row 3)."""
        self.ratio = float(ratio)
        if self.policy is not None:
            self.policy.set_ratio(ratio)

    def with_policy(
        self,
        policy: str,
        *,
        ratio: Optional[float] = None,
        policy_kwargs: Optional[Dict[str, Any]] = None,
    ) -> "OffloadEngine":
        """A clone sharing every fitted component under a different decision
        policy."""
        if self.calibration_scores is None:
            raise RuntimeError("with_policy() before fit()/load()")
        live_ratio = float(getattr(self.policy, "ratio", self.ratio))
        clone = OffloadEngine(
            feature_extractor=self.feature_extractor,
            reward_model=self.reward_model,
            transform=self.transform_kind,
            policy=policy,
            ratio=live_ratio if ratio is None else float(ratio),
            policy_kwargs=policy_kwargs,
        )
        clone.transform = self.transform
        clone.calibration_scores = self.calibration_scores
        clone.extra_meta = dict(self.extra_meta)
        clone.policy = clone._make_policy()
        return clone

    # ------------------------------------------------------------ save/load

    def artifact_state(
        self, extra_meta: Optional[Dict[str, Any]] = None
    ) -> "tuple[Dict[str, Any], Dict[str, Any]]":
        """The calibrated stack as checkpoint ``(arrays, meta)`` — what
        ``save`` writes, in the JAX package's layout."""
        if self.calibration_scores is None:
            raise RuntimeError("save() before fit()/load()")
        model_arrays, model_meta = self.reward_model.state()
        arrays: Dict[str, Any] = {
            "model": model_arrays,
            "calibration": self.calibration_scores,
        }
        if self.transform is not None:
            arrays["transform_sorted"] = self.transform.state()["sorted_rewards"]
        fx = self.feature_extractor
        # the policy may have been re-budgeted directly: its ratio is the live one
        live_ratio = float(getattr(self.policy, "ratio", self.ratio))
        # injected callables (clocks, probes) are runtime wiring, never saved
        context = set(policy_context_params(self.policy_name))
        policy_kwargs = {k: v for k, v in self.policy_kwargs.items() if k not in context}
        meta = {
            "kind": "offload_engine",
            "version": 1,
            "ratio": live_ratio,
            "transform": self.transform_kind,
            "policy": {"name": self.policy_name, "kwargs": policy_kwargs},
            "feature_extractor": (
                {"name": fx.name, "spec": fx.spec()} if fx is not None else None
            ),
            "reward_model": model_meta,
            "extra": extra_meta if extra_meta is not None else self.extra_meta,
        }
        return arrays, meta

    def save(self, path: str, extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """Persist the calibrated stack as one ``.npz`` artifact."""
        arrays, meta = self.artifact_state(extra_meta)
        save_flat(path, arrays, meta)

    @classmethod
    def from_artifact_state(
        cls, arrays: Dict[str, Any], meta: Dict[str, Any], *, device: DeviceLike = "cuda"
    ) -> "OffloadEngine":
        """Rebuild a fitted engine on ``device`` from checkpoint ``(arrays,
        meta)`` (the inverse of ``artifact_state``)."""
        fx_meta = meta.get("feature_extractor")
        fx = (
            make_feature_extractor(fx_meta["name"], **fx_meta["spec"], device=device)
            if fx_meta
            else None
        )
        engine = cls(
            feature_extractor=fx,
            reward_model=reward_model_from_state(
                arrays["model"], meta["reward_model"], device=device
            ),
            transform=meta["transform"],
            policy=meta["policy"]["name"],
            ratio=meta["ratio"],
            policy_kwargs=meta["policy"]["kwargs"],
        )
        if "transform_sorted" in arrays:
            engine.transform = CdfTransform.from_state(
                {"sorted_rewards": arrays["transform_sorted"]}
            )
        engine.extra_meta = meta.get("extra", {})
        engine.calibration_scores = np.asarray(arrays["calibration"], np.float64)
        engine.policy = engine._make_policy()
        return engine

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = "cuda") -> "OffloadEngine":
        arrays, meta = load_flat(path)
        if meta is None or meta.get("kind") != "offload_engine":
            raise ValueError(f"{path} is not an OffloadEngine checkpoint")
        return cls.from_artifact_state(arrays, meta, device=device)
