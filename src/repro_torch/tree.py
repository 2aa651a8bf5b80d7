"""Nested dicts of tensors as the port's parameter trees (JAX's pytrees of
dicts): map over their leaves and list them in JAX's order."""
from __future__ import annotations

from typing import Any, Callable, Dict

Tree = Dict[str, Any]  # nested dicts with tensor leaves


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its keys)."""
    return {
        k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
        else fn(v, *(r[k] for r in rest))
        for k, v in tree.items()
    }


def tree_leaves(tree: Tree):
    """The leaves in JAX's order (sorted keys), so that sums over them add
    in ``repro``'s order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v
