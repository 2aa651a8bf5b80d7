"""Feature-extractor protocol + registered adapters (OffloadEngine inputs).

A ``FeatureExtractor`` turns a batch of *weak* model outputs into the fixed
(B, F) float matrix the reward estimator consumes.  Adapters register under
a string name so a saved engine can rebuild its extractor; the device an
extractor pads host inputs onto is a constructor argument, never part of its
``spec``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Protocol, Sequence, Union, runtime_checkable

import numpy as np

import torch

from repro_torch.core.features import extract_features_batch, feature_dim
from repro_torch.detection.batch import DetectionsBatch
from repro_torch.detection.map_engine import Detections
from repro_torch.kernels.dispatch import DeviceLike, resolve_device


@runtime_checkable
class FeatureExtractor(Protocol):
    """Batch of weak outputs -> (B, F) feature matrix."""

    name: str

    def __call__(self, weak_outputs: Any) -> torch.Tensor: ...

    def spec(self) -> Dict[str, Any]:
        """Constructor kwargs sufficient to rebuild this extractor."""
        ...


_EXTRACTORS: Dict[str, Callable[..., FeatureExtractor]] = {}


def register_feature_extractor(name: str):
    """Class decorator: register under ``name`` for save/load resolution."""

    def deco(cls):
        cls.name = name
        _EXTRACTORS[name] = cls
        return cls

    return deco


def list_feature_extractors() -> List[str]:
    return sorted(_EXTRACTORS)


def make_feature_extractor(name: str, **kwargs) -> FeatureExtractor:
    if name not in _EXTRACTORS:
        raise KeyError(
            f"unknown feature extractor {name!r}; have {list_feature_extractors()}"
        )
    return _EXTRACTORS[name](**kwargs)


@register_feature_extractor("detection_boxes")
class DetectionBoxFeatures:
    """Top-K box features + global summary stats of a weak detector.

    Accepts a padded :class:`DetectionsBatch` (features on the batch's
    device) or a ragged list of ``Detections`` (padded onto ``device``).
    """

    def __init__(
        self,
        num_classes: int,
        top_k: int = 25,
        image_size: float = 1.0,
        *,
        device: DeviceLike = "cuda",
    ):
        self.num_classes = int(num_classes)
        self.top_k = int(top_k)
        self.image_size = float(image_size)
        self.device = resolve_device(device)

    @property
    def feature_dim(self) -> int:
        return feature_dim(self.num_classes, self.top_k)

    def __call__(
        self, weak_outputs: Union[Sequence[Detections], DetectionsBatch]
    ) -> torch.Tensor:
        return extract_features_batch(
            weak_outputs, self.num_classes, self.top_k, self.image_size,
            device=self.device,
        )

    def spec(self) -> Dict[str, Any]:
        return {
            "num_classes": self.num_classes,
            "top_k": self.top_k,
            "image_size": self.image_size,
        }


def logits_features(
    logits: torch.Tensor, labels=None, top_k: int = 8
) -> torch.Tensor:
    """Per-request features from WEAK-head logits only (deployable inputs):
    mean/max entropy, mean margin, mean max-prob, mean top-k probs, as a
    (B, 4 + top_k) float32 tensor on the logits' device.

    ``labels`` marks valid positions (>= 0); ``None`` treats every position
    as valid (the decode-time case where no gold labels exist).  At full
    vocabulary width the float32 intermediates are each as large as the
    logits in float32, so they stay on the device and only the (B, F)
    result is small."""
    lf = torch.log_softmax(logits.float(), dim=-1)
    p = lf.exp()
    if labels is None:
        vmask = torch.ones(logits.shape[:-1], dtype=torch.bool, device=logits.device)
    else:
        if not isinstance(labels, torch.Tensor):
            labels = torch.from_numpy(np.asarray(labels))
        vmask = labels.to(logits.device) >= 0
    entropy = -(p * lf).sum(-1)  # (B, S)
    del lf
    topv = torch.topk(p, top_k, dim=-1).values  # (B, S, k)
    del p
    margin = topv[..., 0] - topv[..., 1]
    vm = vmask.to(torch.float32)
    denom = vmask.sum(-1).clamp(min=1).to(torch.float32)

    def mavg(x):
        return (x * vm).sum(-1) / denom

    return torch.cat(
        [
            mavg(entropy)[:, None],
            (entropy * vm).max(dim=-1).values[:, None],
            mavg(margin)[:, None],
            mavg(topv[..., 0])[:, None],
            (topv * vm[..., None]).sum(1) / denom[:, None],  # mean top-k probs
        ],
        dim=-1,
    )


@register_feature_extractor("lm_logits")
class LMLogitsFeatures:
    """Entropy/margin/top-k summary of weak-head logits (the LM analogue of
    top-25 box confidences).  Accepts ``(logits, labels)`` tuples or dicts
    with ``logits``/``labels`` keys; ``labels`` may be None at decode time.
    Features are computed where the logits lie; ``device`` only completes
    the extractor protocol (the logits are already on the device)."""

    def __init__(self, top_k: int = 8, *, device: DeviceLike = "cuda"):
        self.top_k = int(top_k)
        self.device = resolve_device(device)

    @property
    def feature_dim(self) -> int:
        return 4 + self.top_k

    def __call__(self, weak_outputs: Any) -> torch.Tensor:
        if isinstance(weak_outputs, dict):
            logits, labels = weak_outputs["logits"], weak_outputs.get("labels")
        else:
            logits, labels = weak_outputs
        return logits_features(logits, labels, self.top_k)

    def spec(self) -> Dict[str, Any]:
        return {"top_k": self.top_k}
