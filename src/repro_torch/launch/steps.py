"""Step builders (``repro.launch.steps``): the train, prefill and serve
steps of the ported families (dense, VLM, MoE with or without MLA, RWKV6,
hybrid).

``repro`` builds these for ``jax.jit`` with ``cfg`` closed over; here they
are plain functions over the port's parameter trees, functional as there:
a step returns new parameters and optimizer state and leaves its inputs as
they are.  ``abstract_opt_state`` belongs to the dry run and comes with the
rest of ``launch/`` (ROADMAP.md queue A item 9g).
"""
from __future__ import annotations

import torch

from repro_torch.core.estimator import value_and_grad
from repro_torch.models.lm import LMConfig, decode_step, loss_fn, prefill
from repro_torch.train.adamw import adamw_update


def make_train_step(cfg: LMConfig, lr: float = 1e-4):
    """(params, opt_state, batch) -> (params, opt_state, loss): ``loss_fn``,
    its gradient over every leaf of ``params`` (``torch.autograd.grad``),
    then one AdamW step (``train.adamw``)."""

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            value, grads = value_and_grad(loss_fn, params, cfg, batch)
        params, opt_state = adamw_update(grads, opt_state, params, lr)
        return params, opt_state, value

    return train_step


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
