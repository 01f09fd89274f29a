"""Dict-of-tensors utilities (port of ``repro.utils.tree``).

A pytree here is (nested) dicts and lists of tensors; every walk visits
dict keys in sorted order, the order ``jax.tree`` visits them, so a
reduction over the leaves adds them in the reference's order.  Most of the
core works on *stacked* trees: every leaf carries a leading client axis.

``tree_sq_norm`` is the one function that differs from the reference's:
here it is per client of a stacked tree (``(m,)``), the form the FedProx
loss needs; the reference's is ``tree_dot(tree, tree)``.
"""
from __future__ import annotations

import functools
from collections.abc import Callable, Mapping
from typing import Any

import torch

Pytree = Any


def tree_stack(trees: list[Pytree]) -> Pytree:
    """Stack a list of identically-structured pytrees along a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_unstack(tree: Pytree, n: int) -> list[Pytree]:
    """Inverse of :func:`tree_stack`."""
    return [tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


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


def tree_zeros_like(tree: Pytree) -> Pytree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(tree: Pytree, s) -> Pytree:
    return tree_map(lambda x: x * s, tree)


def tree_dot(a: Pytree, b: Pytree) -> torch.Tensor:
    """Global inner product of two pytrees: each leaf pair's ``vdot``, the
    leaves then added in key order."""
    dots = tree_leaves(tree_map(
        lambda x, y: torch.vdot(x.reshape(-1), y.reshape(-1)), a, b))
    return functools.reduce(torch.add, dots)


def tree_size(tree: Pytree) -> int:
    """Total number of scalar parameters in the tree."""
    return int(sum(x.numel() for x in tree_leaves(tree)))


def tree_bytes(tree: Pytree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def tree_flatten_vector(tree: Pytree, dtype=torch.float32) -> torch.Tensor:
    """Flatten a pytree into one 1-D vector, leaves in key order (hashing
    and clustering diagnostics, not the aggregation path)."""
    return torch.cat([x.reshape(-1).to(dtype) for x in tree_leaves(tree)])


def tree_cast(tree: Pytree, dtype) -> Pytree:
    return tree_map(lambda x: x.to(dtype), tree)


def tree_map_stacked(fn: Callable, tree: Pytree) -> Pytree:
    """``fn`` mapped over the leading client axis of ``tree``
    (``torch.func.vmap``)."""
    return torch.func.vmap(fn)(tree)


def tree_any_nan(tree: Pytree) -> torch.Tensor:
    flags = [torch.isnan(x).any() for x in tree_leaves(tree)]
    return functools.reduce(torch.logical_or, flags, torch.tensor(False))


def tree_weighted_mean(tree: Pytree, weights: torch.Tensor) -> Pytree:
    """Weighted mean over the leading client axis. ``weights`` shape (n,)."""
    wsum = weights.sum()

    def leaf(x):
        w = weights.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return (x * w).sum(dim=0) / wsum.to(x.dtype)

    return tree_map(leaf, tree)


def tree_sq_norm(tree: Pytree) -> Any:
    """Squared norm of each client's slice of a stacked tree: every leaf
    ``(m, ...)`` squared and summed over all axes but the first, then the
    leaves added -> ``(m,)``."""
    leaves = tree_leaves(tree)
    total = leaves[0].square().reshape(leaves[0].shape[0], -1).sum(dim=1)
    for leaf in leaves[1:]:
        total = total + leaf.square().reshape(leaf.shape[0], -1).sum(dim=1)
    return total
