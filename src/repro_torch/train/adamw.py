"""AdamW on nested dicts of tensors (``repro.train.adamw``), with its exact
formula: a global-norm clip ``scale = min(1, clip / sqrt(sum g^2 + 1e-12))``,
bias corrections from a float32 step count, and the decoupled decay inside
the step, ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.

``torch.optim.AdamW`` differs in both places (it decays ``p *= 1 - lr * wd``
before the step; ``clip_grad_norm_`` divides by ``norm + 1e-6``), so the
port writes the step out.  Like the JAX version it is functional: the new
parameters and moments are new tensors, the inputs are left as they are.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def adamw_init(params: Tree) -> AdamWState:
    return AdamWState(step=0, mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params))


@torch.no_grad()
def adamw_update(
    grads: Tree,
    state: AdamWState,
    params: Tree,
    lr: Union[float, torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    grad_clip: Union[float, None] = 1.0,
) -> Tuple[Tree, AdamWState]:
    """One AdamW step; returns (new_params, new_state)."""
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in tree_leaves(grads)) + 1e-12)
        scale = torch.clamp(grad_clip / gnorm, max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    step = state.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g), state.nu, grads)
    # float32 bias corrections, as jnp's ``b ** step.astype(float32)``, held
    # as tensors on the parameters' device: a Python divisor would be turned
    # into a multiply by its reciprocal on CUDA
    dev = next(tree_leaves(params)).device
    t = torch.tensor(float(step), dtype=torch.float32, device=dev)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=dev) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=dev) ** t

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        return p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)

    return tree_map(upd, params, mu, nu), AdamWState(step=step, mu=mu, nu=nu)
