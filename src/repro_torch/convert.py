"""Carry weights from the JAX package's layout into the port's.

The reward model and the engine need no converter: they cross as the
``.npz`` artifact ``save_flat`` writes, whose layout both packages share.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def detector_params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """A ``repro.models.detector`` parameter pytree, as numpy arrays
    (``{"stage0_a": {"w": (k, k, cin, cout) HWIO, "b": (cout,)}, ...}``), to
    the state dict of :class:`repro_torch.models.detector.Detector`
    (OIHW weights) on the CPU."""
    state: Dict[str, torch.Tensor] = {}
    for name, p in tree.items():
        w = np.asarray(p["w"], np.float32)
        if w.ndim != 4:
            raise ValueError(f"{name}/w must be HWIO (rank 4), got shape {w.shape}")
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(p["b"], np.float32).copy())
    return state
