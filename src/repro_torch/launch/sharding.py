"""Sharding rules: parameter / optimizer / batch / cache partition specs, and
their ``DTensor`` placements (``repro.launch.sharding``).

The rule tables are the JAX package's, copied: a pattern over the
flattened parameter path (e.g. ``layers/attn/wq``), first hit wins, and a
spec of *logical* axes per trailing dimension.  :func:`_resolve` maps
them to mesh axes and drops (replicates) an axis that does not divide its
dimension, the MaxText-style fallback, so e.g. KV-head dimensions smaller
than the model axis replicate instead of failing.

A spec here is a tuple with one entry a dimension: ``None``, a mesh axis
name, or a tuple of names (``("pod", "data")``), the entries of a JAX
``PartitionSpec``.  A :class:`Sharding` pairs it with its mesh, and
:meth:`Sharding.placements` gives ``DTensor`` placements: ``Shard(d)`` on
every mesh dimension that dimension ``d`` names, ``Replicate()`` on the
others.  ``mesh`` is a ``DeviceMesh``, or a ``launch.mesh.MeshShape`` when
only the specs are wanted (no process group).
"""
from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Any, Dict, Tuple, Union

from repro_torch.launch.mesh import axis_names, axis_sizes

PyTree = Any
AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]

# (pattern, logical spec per dim). "model"/"batch"/"expert" are logical.
PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # embed is d_model-sharded: a vocab-sharded table turns the lookup into a
    # full-vocab one-hot matmul whose gradient all-reduces (B, S, V) a step
    ("*embed", (None, "model")),
    ("*unembed", (None, "model")),
    # attention
    ("*attn/wq", (None, "model")),
    ("*attn/wk", (None, "model")),
    ("*attn/wv", (None, "model")),
    ("*attn/wo", ("model", None)),
    ("*attn/bq", ("model",)),
    ("*attn/bk", ("model",)),
    ("*attn/bv", ("model",)),
    # MLA
    ("*attn/w_dkv", (None, "model")),
    ("*attn/w_kr", (None, None)),
    ("*attn/w_uk", (None, "model")),
    ("*attn/w_uv", (None, "model")),
    # MLP
    ("*mlp/gate", (None, "model")),
    ("*mlp/up", (None, "model")),
    ("*mlp/down", ("model", None)),
    ("*mlp/up_b", ("model",)),
    ("*mlp/down_b", (None,)),
    # MoE (leading expert dim -> expert parallel)
    ("*moe/router", (None, None)),
    ("*moe/w_gate", ("expert", None, None)),
    ("*moe/w_up", ("expert", None, None)),
    ("*moe/w_down", ("expert", None, None)),
    ("*moe/shared/gate", (None, "model")),
    ("*moe/shared/up", (None, "model")),
    ("*moe/shared/down", ("model", None)),
    # RWKV6
    ("*tm/wr", (None, "model")),
    ("*tm/wk", (None, "model")),
    ("*tm/wv", (None, "model")),
    ("*tm/wg", (None, "model")),
    ("*tm/wo", ("model", None)),
    ("*tm/cm_k", (None, "model")),
    ("*tm/cm_v", ("model", None)),
    ("*tm/cm_r", (None, "model")),
    # RWKV LoRAs replicate: sharding mix_lora_b's fused (5 M) output crosses
    # the stream boundary at the (B, S, 5, M) reshape
    ("*tm/mix_lora_a", (None, None)),
    ("*tm/mix_lora_b", (None, None)),
    ("*tm/decay_lora_a", (None, None)),
    ("*tm/decay_lora_b", (None, None)),
    # Mamba2
    ("*mamba/in_proj", (None, "model")),
    ("*mamba/out_proj", ("model", None)),
    ("*mamba/conv_w", (None, "model")),
    ("*mamba/conv_b", ("model",)),
    # whisper dec blocks
    ("*self_attn/wq", (None, "model")),
    ("*self_attn/wk", (None, "model")),
    ("*self_attn/wv", (None, "model")),
    ("*self_attn/wo", ("model", None)),
    ("*cross_attn/wq", (None, "model")),
    ("*cross_attn/wk", (None, "model")),
    ("*cross_attn/wv", (None, "model")),
    ("*cross_attn/wo", ("model", None)),
)

# Cache rules keyed by cache field.  Baseline ("seq"): KV caches shard the
# slot (sequence) dim over `model` and batch over data; recurrent states
# shard heads over `model`.  "heads" shards kv-heads over `model` instead
# (replicated when the head count does not divide); "batch" shards only the
# batch dim; "headdim" shards head_dim over `model`, so the one-slot write
# is local on every shard.
CACHE_RULES: Dict[str, Tuple] = {
    "k": (None, "batch", "model", None, None),
    "v": (None, "batch", "model", None, None),
    "k_s": (None, "batch", "model", None),
    "v_s": (None, "batch", "model", None),
    "c": (None, "batch", "model", None),
    "kr": (None, "batch", "model", None),
    "xk": (None, "batch", None, None, None),
    "xv": (None, "batch", None, None, None),
    "state": (None, "batch", "model", None, None),
    "tm_x": (None, "batch", None),
    "cm_x": (None, "batch", None),
    "ssm": (None, None, "batch", "model", None, None),
    "conv": (None, None, "batch", None, "model"),
    "shared_k": (None, "batch", "model", None, None),
    "shared_v": (None, "batch", "model", None, None),
}

CACHE_RULES_HEADS: Dict[str, Tuple] = {
    **CACHE_RULES,
    "k": (None, "batch", None, "model", None),
    "v": (None, "batch", None, "model", None),
    "shared_k": (None, "batch", None, "model", None),
    "shared_v": (None, "batch", None, "model", None),
    "c": (None, "batch", None, "model"),  # latent dim over model
    "kr": (None, "batch", None, None),
}

CACHE_RULES_BATCH: Dict[str, Tuple] = {
    k: tuple(a if a == "batch" else None for a in v) for k, v in CACHE_RULES.items()
}

CACHE_RULES_HEADDIM: Dict[str, Tuple] = {
    **CACHE_RULES,
    "k": (None, "batch", None, None, "model"),
    "v": (None, "batch", None, None, "model"),
    "shared_k": (None, "batch", None, None, "model"),
    "shared_v": (None, "batch", None, None, "model"),
    "c": (None, "batch", None, "model"),
    "kr": (None, "batch", None, None),
}

CACHE_MODES = {
    "seq": CACHE_RULES,
    "heads": CACHE_RULES_HEADS,
    "batch": CACHE_RULES_BATCH,
    "headdim": CACHE_RULES_HEADDIM,
}


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec

    def placements(self) -> tuple:
        """``DTensor`` placements, one a mesh dimension."""
        return spec_placements(self.mesh, self.spec)


def spec_placements(mesh, spec: Spec) -> tuple:
    """``Shard(d)`` on each mesh dimension that dimension ``d`` of ``spec``
    names (in mesh order, so ``("pod", "data")`` is pod-major, as in JAX),
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, axes in enumerate(spec):
        for a in (() if axes is None else axes if isinstance(axes, tuple) else (axes,)):
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dimensions of {spec}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in axis_names(mesh))


def _axes_size(axes: AxisVal, sizes) -> int:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


def _resolve(spec_logical: Tuple, mapping: Dict[str, AxisVal], shape, mesh) -> Spec:
    """Logical spec -> spec, dropping non-divisible axes.

    Leading stacked-layer dims (len(shape) > len(spec)) are left unsharded:
    the rule spec aligns to the TRAILING dims of the array."""
    sizes = axis_sizes(mesh)
    pad = len(shape) - len(spec_logical)
    out: list = [None] * pad
    for dim, logical in zip(range(pad, len(shape)), spec_logical):
        axes = None if logical is None else mapping.get(logical)
        if axes is None:
            out.append(None)
        elif shape[dim] % _axes_size(axes, sizes) == 0:
            out.append(axes)
        else:
            out.append(None)  # replicate: dim not divisible
    return tuple(out)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree, path=()):
    """(path, leaf) pairs of nested dicts and NamedTuples (by field name)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _flatten(getattr(tree, k), path + (k,))
    else:
        yield path, tree


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, k), path + (k,))
                            for k in tree._fields))
    return fn(path, tree)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def param_spec(path: str, shape, mesh, mapping: Dict[str, AxisVal], mode: str = "tp") -> Spec:
    """The spec of one parameter: the first rule whose pattern matches
    ``path`` (replicated when none does); ``mode="fsdp"`` then shards the
    first free dim of a parameter of 1M elements or more over ``data``."""
    spec: Spec = ()
    for pattern, logical in PARAM_RULES:
        if fnmatch.fnmatch(path, pattern):
            spec = _resolve(logical, mapping, shape, mesh)
            break
    if mode == "fsdp" and _numel(shape) >= 1_000_000:
        data_axis = mapping.get("data_only", "data")
        data_size = axis_sizes(mesh).get(data_axis, 1) if not isinstance(data_axis, tuple) else 1
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for d in range(len(shape)):
            if parts[d] is None and shape[d] % data_size == 0:
                parts[d] = data_axis
                break
        spec = tuple(parts)
    return spec


def param_shardings(params_abstract: PyTree, mesh, mapping: Dict[str, AxisVal],
                    mode: str = "tp") -> PyTree:
    """:class:`Sharding` tree matching ``params_abstract`` (a parameter tree,
    or an ``AdamWState`` of them: its ``step`` replicates).

    mode="tp" (baseline): tensor-parallel over `model`, replicated over the
    data axes (gradients all-reduce across data).  mode="fsdp": additionally
    shards each large parameter's first free dim over `data` (ZeRO-3 style:
    parameters all-gather at use, gradients reduce-scatter)."""
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"unknown param mode {mode!r}; use 'tp' or 'fsdp'")

    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        return Sharding(mesh, param_spec(_path_str(path), shape, mesh, mapping, mode))

    return _map_with_path(one, params_abstract)


def batch_shardings(batch_abstract: Dict, mesh, mapping: Dict[str, AxisVal]) -> Dict:
    """Batch inputs: leading batch dim over the (pod x) data axes, except
    ``positions_3d`` whose batch dim is axis 1."""
    out = {}
    for k, v in batch_abstract.items():
        if k == "positions_3d":
            logical = (None, "batch") + (None,) * (len(v.shape) - 2)
        else:
            logical = ("batch",) + (None,) * (len(v.shape) - 1)
        out[k] = Sharding(mesh, _resolve(logical, mapping, tuple(v.shape), mesh))
    return out


def cache_shardings(cache_abstract: Dict, mesh, mapping: Dict[str, AxisVal],
                    mode: str = "seq") -> Dict:
    rules = CACHE_MODES[mode]
    return {k: Sharding(mesh, _resolve(rules[k], mapping, tuple(v.shape), mesh))
            for k, v in cache_abstract.items()}


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def distribute(tree: PyTree, shardings: PyTree) -> PyTree:
    """``DTensor``s of the tensors of ``tree`` under the matching
    ``shardings`` (a tree of the same structure).  A tensor holding the
    global value is split by ``distribute_tensor`` (every rank passes the
    same global value); a meta tensor becomes a ``DTensor`` whose local part
    is rank 0's shard, allocated nowhere.  A leaf that is no tensor (the
    optimizer's Python ``step``) is left as it is."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(path, leaf):
        sh = _lookup(shardings, path)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        placements = sh.placements()
        if leaf.device.type == "meta":
            from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

            local, _ = compute_local_shape_and_global_offset(tuple(leaf.shape), sh.mesh,
                                                              placements)
            return DTensor.from_local(torch.empty(local, dtype=leaf.dtype, device="meta"),
                                      sh.mesh, placements, run_check=False,
                                      shape=leaf.shape, stride=leaf.stride())
        out = distribute_tensor(leaf.detach(), sh.mesh, placements)
        return out.requires_grad_(leaf.requires_grad)

    return _map_with_path(one, tree)


def _lookup(tree, path):
    for k in path:
        tree = getattr(tree, k) if isinstance(tree, tuple) and hasattr(tree, "_fields") else tree[k]
    return tree
