"""Carry weights from the JAX package's layout into the port's.

The reward model and the engine need no converter: they cross as the
``.npz`` artifact ``save_flat`` writes, whose layout both packages share.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.models.lm import check_arch


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


# LM parameters the JAX layers use in float32 whatever the activation type
# (``repro/models/layers.py:788``: ``u = params["bonus"].astype(jnp.float32)``)
_F32_LEAVES = ("bonus",)


def lm_params_from_jax(tree: Mapping[str, Any], cfg, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A ``repro.models.lm`` parameter pytree, as nested dicts of numpy
    arrays with the same key paths and stacked ``(L, ...)`` layers, to the
    port's tensors on ``device``.

    Each leaf is stored in the type ``repro`` casts it to where it is used:
    ``cfg.act_dtype`` for matmul weights, norms, embeddings and mix factors,
    float32 for the RWKV6 ``bonus``.  That is the value of the reference's
    cast at every use, made once here instead of on every call."""
    check_arch(cfg)
    dev = resolve_device(device)

    def conv(name: str, v):
        if isinstance(v, Mapping):
            return {k: conv(k, x) for k, x in v.items()}
        dtype = torch.float32 if name in _F32_LEAVES else cfg.act_dtype
        arr = np.array(v, np.float32)  # a writable float32 copy
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    return {k: conv(k, v) for k, v in tree.items()}
