"""The weak/strong grid detectors (``detector``) and the language models of
every assigned family (``lm``, ``layers``)."""
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
