"""Self-describing ``.npz`` checkpoints: a nested string-keyed dict of arrays
plus a JSON metadata block, the format ``OffloadEngine.save`` writes.

The key paths (``"model/params/layer0/w"``) and the meta key are those of
``repro.train.checkpoint.save_flat``, so an artifact written by either
package loads in the other.  Tensors are written from the host.  The
template-driven ``save_pytree``/``load_pytree`` of the JAX package come with
the training slice.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_META_KEY = "__meta__"


def _as_numpy(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten_strdict(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten_strdict(v, key))
        else:
            out[key] = _as_numpy(v)
    return out


def save_flat(path: str, arrays: Dict[str, Any], meta: Optional[dict] = None) -> None:
    """Save a nested string-keyed dict of arrays (+ JSON meta) to one .npz."""
    flat = _flatten_strdict(arrays)
    if meta is not None:
        flat[_META_KEY] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_flat(path: str) -> Tuple[Dict[str, Any], Optional[dict]]:
    """Inverse of ``save_flat``: (nested numpy arrays dict, meta-or-None)."""
    meta = None
    tree: Dict[str, Any] = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            if key == _META_KEY:
                meta = json.loads(str(data[key].item()))
                continue
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree, meta
