"""Seeded weights on the card, drawn by the benchmark over the port's
parameter tree.

The tree's keys and shapes come from the program
(``repro_torch.models.lm.abstract_params``, meta tensors).  The values are
the benchmark's: every normal leaf of the tree is a view into one buffer
filled by one ``normal_`` call of a generator on the device, and every
uniform leaf into one buffer filled by one ``uniform_`` call; each leaf is
then scaled in place by its rule.  The rules are data, in the
configuration file's ``init`` section, keyed by a leaf's last key:

* ``["normal", s]``: N(0, 1) times ``s``, or times fan_in^-1/2 for ``s`` =
  ``"fan_in"`` (fan_in the first dim of one layer's matrix);
* ``["uniform", lo, hi]``;
* ``["const", c]``;
* ``["rwkv6_decay"]``: the published RWKV-6 decay ramp,
  -6 + 5 (c / (M - 1))^(0.7 + 1.3 l / (L - 1)) for channel c of layer l.

Leaves named in ``float32_leaves`` are held in float32, the others in the
configuration's activation type, as the program serves them.  The program
and the reference are handed the same tensors.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _leaves(tree, path=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)])
    return out


def _set(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _stacked(path) -> bool:
    return path[0] in ("layers", "dense_layers", "moe_layers")


def _rule(init: Dict, path) -> list:
    return init.get(path[-1], init["default"])


def rwkv6_decay(shape, device) -> torch.Tensor:
    """The RWKV-6 paper's decay initialisation for a (L, M) stack."""
    L, M = shape
    c = torch.arange(M, dtype=torch.float64, device=device) / max(M - 1, 1)
    l = torch.arange(L, dtype=torch.float64, device=device)[:, None] / max(L - 1, 1)
    return -6.0 + 5.0 * c[None, :] ** (0.7 + 1.3 * l)


def make_params(abstract: Dict, init: Dict, float32_leaves, dtype: torch.dtype, seed: int,
                device: torch.device) -> Dict:
    """The seeded parameter tree with ``abstract``'s keys and shapes."""
    gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    leaves = _leaves(abstract)
    kinds: Dict[str, List] = {"normal": [], "uniform": []}
    params: Dict = {}
    for path, meta in leaves:
        dt = torch.float32 if path[-1] in float32_leaves else dtype
        rule = _rule(init, path)
        if rule[0] in kinds:
            kinds[rule[0]].append((path, tuple(meta.shape), dt, rule))
        elif rule[0] == "const":
            _set(params, path, torch.full(tuple(meta.shape), float(rule[1]), dtype=dt, device=device))
        elif rule[0] == "rwkv6_decay":
            _set(params, path, rwkv6_decay(tuple(meta.shape), device).to(dt))
        else:
            raise ValueError(f"unknown init rule {rule!r} for {'/'.join(path)}")
    for kind, items in kinds.items():
        for dt in sorted({d for _, _, d, _ in items}, key=str):  # a fixed draw order
            group = [it for it in items if it[2] == dt]
            total = sum(torch.Size(s).numel() for _, s, _, _ in group)
            buf = torch.empty(total, dtype=dt, device=device)
            (buf.normal_ if kind == "normal" else buf.uniform_)(generator=gen)
            at = 0
            for path, shape, _, rule in group:
                n = torch.Size(shape).numel()
                leaf = buf[at:at + n].view(shape)
                at += n
                if kind == "normal":
                    one = shape[1:] if _stacked(path) else shape
                    scale = (one[0] ** -0.5 if rule[1] == "fan_in" and len(one) >= 2
                             else 1.0 if rule[1] == "fan_in" else float(rule[1]))
                    leaf.mul_(scale)
                else:
                    leaf.mul_(float(rule[2]) - float(rule[1])).add_(float(rule[1]))
                _set(params, path, leaf)
    return params
