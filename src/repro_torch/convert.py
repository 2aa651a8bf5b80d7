"""Carry weights between the JAX package's layout and the port's, both ways.

Convolution weights are HWIO in ``repro`` and OIHW in the port; the MLP's
``{"layer<i>": {"w": (in, out), "b": (out,)}}`` is the same in both.  The
``*_to_jax`` functions give numpy arrays in ``repro``'s layout, which is also
what the port writes to files (detector ``.npz`` caches, reward-model
artifacts), so that either package reads what the other wrote.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def detector_params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`detector_params_from_jax`: a ``Detector``
    state dict (OIHW) to ``repro``'s parameter pytree as numpy (HWIO)."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for key, t in state.items():
        name, kind = key.rsplit(".", 1)
        arr = t.detach().cpu().numpy()
        if kind == "weight":
            tree.setdefault(name, {})["w"] = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        else:
            tree.setdefault(name, {})["b"] = arr.copy()
    return tree


def mlp_params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                        device: DeviceLike = "cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """``repro.core.estimator`` MLP parameters (numpy) to float32 tensors on
    ``device``; the layout is the same."""
    dev = resolve_device(device)
    return {name: {k: torch.tensor(np.asarray(v, np.float32), device=dev) for k, v in layer.items()}
            for name, layer in tree.items()}


def mlp_params_to_jax(params: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's MLP parameters to numpy in ``repro``'s (the same) layout."""
    return {name: {k: v.detach().cpu().numpy() for k, v in layer.items()}
            for name, layer in params.items()}


def cnn_params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                        device: DeviceLike = "cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """``repro.core.estimator.cnn_init``'s pytree (conv weights HWIO) to the
    port's (OIHW) on ``device``; the dense head keeps its (in, out) layout."""
    dev = resolve_device(device)
    out = {}
    for name, p in tree.items():
        w = np.asarray(p["w"], np.float32)
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w
        out[name] = {"w": torch.tensor(np.ascontiguousarray(w), device=dev),
                     "b": torch.tensor(np.asarray(p["b"], np.float32), device=dev)}
    return out


def cnn_params_to_jax(params: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`cnn_params_from_jax`, as numpy."""
    out = {}
    for name, p in params.items():
        w = p["w"].detach().cpu().numpy()
        out[name] = {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)) if w.ndim == 4 else w,
                     "b": p["b"].detach().cpu().numpy()}
    return out


# LM parameters the JAX layers use in float32 whatever the activation type
# (``repro/models/layers.py:788``: ``u = params["bonus"].astype(jnp.float32)``;
# the MoE router, ``:458`` / ``:524``: ``tok.astype(jnp.float32) @ router``;
# Mamba2's ``A_log``, used uncast, and ``dt_bias`` / ``D``, cast to float32 at
# use, ``:907-910`` / ``:939``)
_F32_LEAVES = ("bonus", "router", "A_log", "dt_bias", "D")


def lm_params_from_jax(tree: Mapping[str, Any], cfg, device: DeviceLike = "cuda", *,
                       dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A ``repro.models.lm`` parameter pytree, as nested dicts of numpy
    arrays with the same key paths and stacked ``(L, ...)`` layers, to the
    port's tensors on ``device``.

    By default each leaf is stored in the type ``repro`` casts it to where it
    is used: ``cfg.act_dtype`` for matmul weights, norms, embeddings and mix
    factors, float32 for the RWKV6 ``bonus``, the MoE ``router`` and Mamba2's
    ``A_log`` / ``dt_bias`` / ``D``.  The MoE family's ``dense_layers`` /
    ``moe_layers`` stacks, the hybrid's ``mamba_groups`` (G, per, ...) /
    ``shared_block`` and the encoder-decoder's ``enc_layers`` /
    ``dec_layers`` / ``enc_norm`` (its LayerNorms and GELU biases in the
    activation type) carry across as any other subtree.  That is the value of the
    reference's cast at every use, made once here instead of on every call.
    ``dtype`` stores every leaf in that type instead: training keeps
    ``torch.float32`` leaves, as ``repro`` does, and casts at each use."""
    check_arch(cfg)
    dev = resolve_device(device)

    def conv(name: str, v):
        if isinstance(v, Mapping):
            return {k: conv(k, x) for k, x in v.items()}
        dt = dtype or (torch.float32 if name in _F32_LEAVES else cfg.act_dtype)
        arr = np.array(v, np.float32)  # a writable float32 copy
        return torch.from_numpy(arr).to(device=dev, dtype=dt)

    return {k: conv(k, v) for k, v in tree.items()}
