"""Detection substrate: box ops (``boxes``), NMS (``nms``), the padded batch
data plane with its greedy matcher (``batch``), the host-side numpy mAP
engine (``map_engine``) and the TIDE error decomposition (``tide``).

The names ``repro.detection`` exports are exported here too, but resolved
on first use (a module ``__getattr__``): ``batch`` and ``nms`` import the
kernels, and the IoU kernel's plain version reads ``boxes``, so importing
this package must not import ``repro_torch.kernels``.  (The JAX package
imports them eagerly, which gives it an import cycle: ``repro.detection``
has to be imported before ``repro.kernels.iou_matrix``.)
"""
from __future__ import annotations

import importlib
import sys
import types

from repro_torch.detection.tide import CATEGORIES, tide_errors

#: each lazily exported name -> the submodule that defines it
_LAZY = {
    "DetectionsBatch": "batch",
    "GroundTruthBatch": "batch",
    "MatchResult": "batch",
    "match_batch": "batch",
    "to_image_evals": "batch",
    "box_area": "boxes",
    "box_iou": "boxes",
    "box_iou_np": "boxes",
    "cxcywh_to_xyxy": "boxes",
    "xyxy_to_cxcywh": "boxes",
    "Detections": "map_engine",
    "GroundTruth": "map_engine",
    "average_precision": "map_engine",
    "dataset_map": "map_engine",
    "match_detections": "map_engine",
    "nms": "nms",
}

__all__ = [*_LAZY, "tide_errors", "CATEGORIES"]


class _Package(types.ModuleType):
    """Keeps the export ``nms`` (a function) from being shadowed by the
    submodule ``nms``: importing a submodule sets it as an attribute of its
    package, which would hide the name from ``__getattr__``."""

    def __setattr__(self, name, value):
        if name in _LAZY and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
