"""Mesh context for sharding constraints inside model code
(``repro.launch.meshctx``).

Model code calls ``constrain(x, "batch", None, "model")`` with *logical*
axis names; the launcher binds logical -> mesh axes here.  With no mesh
bound (one device) a constraint returns its input itself, so the same model
code runs on one card and on a mesh of ranks.

Under a bound mesh the constraint is a ``DTensor`` redistribution: a
``DTensor`` moves to the spec's placements (an all-gather, a reduce-scatter
or an all-reduce where its placements differ), and a plain tensor, which
holds the global value on every rank, becomes a replicated ``DTensor``
first.  A logical axis whose mesh size does not divide its dimension
replicates, as the parameter rules do (``launch.sharding._resolve``).
While a mesh is bound, plain tensors that meet ``DTensor``s in an
operation count as replicated (``implicit_replication``): the positions,
masks and zeros that model code makes from global shapes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.launch.sharding import (CACHE_MODES, Sharding, _resolve, cache_shardings,
                                         distribute)

AxisVal = Union[None, str, Tuple[str, ...]]

_state = threading.local()


def current() -> Optional[Tuple[object, Dict[str, AxisVal]]]:
    """(mesh, logical mapping) bound on this thread, or None."""
    bound = getattr(_state, "bound", None)
    return None if bound is None else bound[:2]


@contextlib.contextmanager
def bind_mesh(mesh, logical_axes: Dict[str, AxisVal], *, cache_mode: str = "seq"):
    """Bind a ``DeviceMesh`` + logical-axis mapping, e.g.
    ``{"batch": ("pod", "data"), "model": "model"}``; ``cache_mode`` (one of
    ``launch.sharding.CACHE_MODES``) places the decode caches that
    ``models.lm.init_cache`` makes under it."""
    if cache_mode not in CACHE_MODES:
        raise ValueError(f"unknown cache mode {cache_mode!r}; use one of {tuple(CACHE_MODES)}")
    # implicit replication on, and back to what it was on exit (the library's
    # own context manager turns it off, which a nested binding must not do)
    dispatcher = DTensor._op_dispatcher
    prev = getattr(_state, "bound", None), dispatcher._allow_implicit_replication
    _state.bound = (mesh, logical_axes, cache_mode)
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        _state.bound, dispatcher._allow_implicit_replication = prev


def carry(fn):
    """``fn`` run under this thread's binding wherever it is called: a remat
    recompute runs on the autograd engine's device thread (CUDA), where the
    thread-local binding is not set."""
    bound = getattr(_state, "bound", None)
    if bound is None:
        return fn
    mesh, mapping, mode = bound

    def run(*args, **kwargs):
        with bind_mesh(mesh, mapping, cache_mode=mode):
            return fn(*args, **kwargs)

    return run


def shard_cache(cache: Dict) -> Dict:
    """A decode cache as ``DTensor``s under the bound mesh and cache mode
    (``launch.sharding.cache_shardings``); itself if no mesh is bound."""
    bound = getattr(_state, "bound", None)
    if bound is None:
        return cache
    mesh, mapping, mode = bound
    return distribute(cache, cache_shardings(cache, mesh, mapping, mode))


def named_sharding(*logical_axes: Optional[str], shape=None) -> Optional[Sharding]:
    """The :class:`Sharding` of a logical spec under the bound mesh (None if
    unbound).  With ``shape``, an axis that does not divide its dimension
    replicates."""
    bound = current()
    if bound is None:
        return None
    mesh, mapping = bound
    if shape is None:
        return Sharding(mesh, tuple(None if a is None else mapping.get(a) for a in logical_axes))
    return Sharding(mesh, _resolve(tuple(logical_axes), mapping, tuple(shape), mesh))


def is_sharded(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (the model code's test for running
    under a bound mesh)."""
    return isinstance(x, DTensor)


def axis_size(logical: str) -> int:
    """The size of the mesh axes a logical axis maps to (1 if unbound or
    unmapped)."""
    bound = current()
    if bound is None or bound[1].get(logical) is None:
        return 1
    mesh, mapping = bound
    axes = mapping[logical]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


def placements(*logical_axes: Optional[str], shape) -> tuple:
    """``DTensor`` placements of a logical spec on the bound mesh, an axis
    that does not divide its dimension replicated."""
    return named_sharding(*logical_axes, shape=shape).placements()


def local_offset(x, dim: int, placements_: tuple) -> int:
    """Where this rank's shard of ``x`` under ``placements_`` starts along
    ``dim`` (its real start, also for an uneven split)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = current()[0]
    return int(compute_local_shape_and_global_offset(tuple(x.shape), mesh, placements_)[1][dim])


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a ``DTensor`` view of a
    local gradient assumes the global layout's strides."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, whose gradient is made contiguous (when one is asked
    for).  ``local_call`` does this to every input; the unbound attention
    does it too, so that a one-rank mesh sums every later gradient in the
    same memory order as the unbound path (bit-equal)."""
    return _ContiguousGrad.apply(t) if torch.is_grad_enabled() and t.requires_grad else t


def local_call(fn, in_placements, out_placements, *args):
    """``fn`` over this rank's shards (``local_map``): each tensor argument
    is moved to its ``in_placements`` (a plain tensor, holding the global
    value, counts as replicated) and passed as its local shard, and ``fn``'s
    outputs are wrapped as ``DTensor``s of ``out_placements`` (a list: one
    a output, ``fn`` returning a tuple; else ``fn`` returns one tensor).

    Gradients: an input replicated over a mesh dimension along which an
    output is split (the work divided, as K / V under context parallelism
    or a weight under batch sharding) receives a partial gradient on each
    rank, so its gradient placement there is ``Partial()``."""
    from torch.distributed.tensor.experimental import local_map

    mesh = current()[0]
    args = [as_dtensor(a, mesh) if isinstance(a, torch.Tensor) else a for a in args]
    outs = out_placements if isinstance(out_placements, list) else [out_placements]
    split = {i for pl in outs for i, p in enumerate(pl) if not isinstance(p, Replicate)}
    grads = tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and i in split else p for i, p in enumerate(pl))
        for pl in in_placements)
    # local_map reads a tuple as one entry an output, a list as one output's
    out_pl = tuple(tuple(pl) for pl in outs) if isinstance(out_placements, list) else list(
        out_placements)

    def run(*local):
        return fn(*(contiguous_grad(a) if isinstance(a, torch.Tensor) else a for a in local))

    return local_map(run, out_placements=out_pl, in_placements=tuple(
        None if pl is None else tuple(pl) for pl in in_placements), in_grad_placements=grads,
        redistribute_inputs=True, device_mesh=mesh)(*args)


def unshard(x, dim: int):
    """``x`` gathered whole along ``dim`` (its other placements kept)."""
    from torch.distributed.tensor import Shard

    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` as a ``DTensor`` on ``mesh``: itself if it is one, else the
    replicated ``DTensor`` of its (global) value."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def constrain(x, *logical_axes: Optional[str]):
    """A sharding constraint in logical axis names; ``x`` itself if no mesh
    is bound."""
    sh = named_sharding(*logical_axes, shape=x.shape) if current() is not None else None
    if sh is None:
        return x
    y = as_dtensor(x, sh.mesh)
    placements = sh.placements()
    if tuple(y.placements) == placements:
        return y
    return y.redistribute(sh.mesh, placements)
