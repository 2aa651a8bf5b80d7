"""Step builders (``repro.launch.steps``): the train, prefill and serve
steps of every family, and the dry run's abstract optimizer state.

``repro`` builds these for ``jax.jit`` with ``cfg`` closed over; here they
are plain functions over the port's parameter trees, functional as there:
a step returns new parameters and optimizer state and leaves its inputs as
they are.
"""
from __future__ import annotations

import torch

from repro_torch.core.estimator import value_and_grad
from repro_torch.launch.input_specs import INDEX_DTYPE
from repro_torch.launch import meshctx
from repro_torch.launch.meshctx import constrain
from repro_torch.models.lm import LMConfig, decode_step, loss_fn, prefill
from repro_torch.train.adamw import AdamWState, adamw_update
from repro_torch.tree import Tree, tree_map


def make_train_step(cfg: LMConfig, lr: float = 1e-4):
    """(params, opt_state, batch) -> (params, opt_state, loss): ``loss_fn``,
    its gradient over every leaf of ``params`` (``torch.autograd.grad``),
    then one AdamW step (``train.adamw``)."""

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            value, grads = value_and_grad(loss_fn, params, cfg, batch)
        grads = tree_map(_placed_like, grads, params)
        params, opt_state = adamw_update(grads, opt_state, params, lr)
        return params, opt_state, constrain(value)  # replicated under a mesh

    return train_step


def _placed_like(g, p):
    """A gradient reduced once to its parameter's placements under a mesh
    (it comes back partial over the batch axes, and each elementwise op of
    the update that needs it whole would reduce it again); else itself."""
    if not meshctx.is_sharded(g) or tuple(g.placements) == tuple(p.placements):
        return g
    from torch.distributed.tensor import Shard

    # first to the parameter's shards (a slice, or a reduce-scatter of a
    # partial sum), so that the reductions over the other axes move only
    # the shard
    sliced = tuple(q if isinstance(q, Shard) else h for h, q in zip(g.placements, p.placements))
    if sliced != tuple(g.placements):
        g = g.redistribute(p.device_mesh, sliced)
    return g.redistribute(p.device_mesh, p.placements)


def make_prefill_step(cfg: LMConfig, capacity: int):
    """(params, batch) -> (last-token logits, decode cache)."""

    def prefill_step(params, batch):
        return prefill(params, cfg, batch, capacity=capacity)

    return prefill_step


def make_serve_step(cfg: LMConfig):
    """(params, cache, tokens, pos) -> (logits, cache): ONE new token against
    the cache (updated in place, see ``models.lm.decode_step``).  A VLM's
    token takes M-RoPE ids (3, B, 1) all equal to ``pos``, as ``repro``'s
    serve step gives it."""

    def serve_step(params, cache, tokens, pos):
        if cfg.arch_type == "vlm":
            p3d = torch.full((3, int(tokens.shape[0]), 1), int(pos), dtype=torch.int64,
                             device=params["embed"].device)
            return decode_step(params, cfg, cache, tokens, pos, p3d)
        return decode_step(params, cfg, cache, tokens, pos)

    return serve_step


def abstract_opt_state(params_abstract: Tree) -> AdamWState:
    """The AdamW state of ``params_abstract`` (meta tensors, from
    ``models.lm.abstract_params``) as meta tensors: ``mu`` and ``nu`` like
    the parameters, ``step`` a scalar (int64 where the JAX package's is
    int32).  Nothing is allocated."""
    def like(t):
        return torch.empty_like(t, device="meta")

    return AdamWState(step=torch.empty((), dtype=INDEX_DTYPE, device="meta"),
                      mu=tree_map(like, params_abstract), nu=tree_map(like, params_abstract))
