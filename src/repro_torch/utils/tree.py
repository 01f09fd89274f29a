"""Dict-of-tensors utilities (port of the part of ``repro.utils.tree`` the
serving and training paths use)."""
from __future__ import annotations

from collections.abc import Callable, Mapping
from typing import Any

Pytree = Any


def tree_index(tree: Pytree, i) -> Pytree:
    """Select index ``i`` along the leading (client) axis of every leaf."""
    return tree_map(lambda x: x[i], tree)


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """Apply ``fn`` leaf by leaf over (nested) dicts and lists of the same
    structure (a tuple counts as a list), dict keys in sorted order — the
    order ``jax.tree`` visits them, so a reduction over the leaves sums in
    the reference's order."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Pytree) -> list:
    """Every leaf of (nested) dicts and lists, in key / index order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(lambda x, y: x - y, a, b)


def tree_sq_norm(tree: Pytree) -> Any:
    """Squared norm of each client's slice of a stacked tree: every leaf
    ``(m, ...)`` squared and summed over all axes but the first, then the
    leaves added -> ``(m,)``."""
    leaves = tree_leaves(tree)
    total = leaves[0].square().reshape(leaves[0].shape[0], -1).sum(dim=1)
    for leaf in leaves[1:]:
        total = total + leaf.square().reshape(leaf.shape[0], -1).sum(dim=1)
    return total
