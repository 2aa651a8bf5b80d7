"""Feature-extractor protocol + registered adapters (OffloadEngine inputs).

A ``FeatureExtractor`` turns a batch of *weak* model outputs into the fixed
(B, F) float matrix the reward estimator consumes.  Adapters register under
a string name so a saved engine can rebuild its extractor; the device an
extractor pads host inputs onto is a constructor argument, never part of its
``spec``.  The LM-logits adapter comes with the port's LM slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Protocol, Sequence, Union, runtime_checkable

import torch

from repro_torch.core.features import extract_features_batch
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
