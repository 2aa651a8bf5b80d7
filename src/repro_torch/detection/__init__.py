"""Detection substrate: box ops (``boxes``), NMS (``nms``), the padded batch
data plane with its greedy matcher (``batch``), the host-side numpy mAP
engine (``map_engine``) and the TIDE error decomposition (``tide``).  Only
``tide``'s names are re-exported here, as the JAX package does: it is host
numpy over ``boxes`` and ``map_engine``.  Import everything else from its
submodule (the IoU kernel's plain version reads ``boxes``, so this package
must not import the kernels).
"""
from repro_torch.detection.tide import CATEGORIES, tide_errors

__all__ = ["CATEGORIES", "tide_errors"]
