"""``.npz`` checkpoints in the JAX package's two formats
(``repro.train.checkpoint``), so that a file written by either package loads
in the other.  Tensors are written from the host.

* ``save_pytree``/``load_pytree``: model parameters, a nested dict keyed as
  JAX flattens it (``"['stage0_a']||['w']"``); loading needs a ``like``
  template.
* ``save_flat``/``load_flat``: a self-describing nested string-keyed dict of
  arrays (``"model/params/layer0/w"``) plus a JSON metadata block, the format
  ``OffloadEngine.save`` writes.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "||"
_META_KEY = "__meta__"


def _as_numpy(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _key_paths(tree: Dict[str, Any], path: Tuple[str, ...] = ()):
    """(key, leaf) of a nested dict in JAX's order (sorted keys), each key
    the ``str`` of JAX's ``DictKey`` path joined by ``||``:
    ``"['stage0_a']||['w']"``."""
    for k in sorted(tree):
        v, p = tree[k], path + (f"[{k!r}]",)
        if isinstance(v, dict):
            yield from _key_paths(v, p)
        else:
            yield _SEP.join(p), v


def save_pytree(path: str, tree: Dict[str, Any]) -> None:
    """Save a nested dict of tensors or arrays as ``repro``'s
    ``save_pytree`` does (``repro.train.checkpoint.load_pytree`` reads it)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: _as_numpy(v) for k, v in _key_paths(tree)})


def load_pytree(path: str, like: Dict[str, Any]) -> Dict[str, Any]:
    """Load a checkpoint into the structure of ``like``: each leaf takes the
    dtype and shape of ``like``'s, and a tensor leaf its device."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        def load(tree, prefix):
            out = {}
            for k, v in tree.items():
                p = prefix + (f"[{k!r}]",)
                if isinstance(v, dict):
                    out[k] = load(v, p)
                    continue
                arr = data[_SEP.join(p)].reshape(tuple(v.shape))
                out[k] = (torch.from_numpy(np.array(arr)).to(device=v.device, dtype=v.dtype)
                          if isinstance(v, torch.Tensor) else arr.astype(np.asarray(v).dtype))
            return out

        return load(like, ())


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
