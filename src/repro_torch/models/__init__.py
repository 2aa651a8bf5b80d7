"""The weak/strong grid detectors (``detector``) and the dense and RWKV6
language models of the early-exit cascade (``lm``, ``layers``)."""
from repro_torch.models.detector import (
    STRONG,
    WEAK,
    Detector,
    DetectorConfig,
    build_targets,
    decode_batch,
    decode_detections,
    detector_apply,
    detector_forward,
    detector_loss,
)

__all__ = [
    "STRONG",
    "WEAK",
    "Detector",
    "DetectorConfig",
    "build_targets",
    "decode_batch",
    "decode_detections",
    "detector_apply",
    "detector_forward",
    "detector_loss",
]
