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
    """Apply ``fn`` leaf by leaf over (nested) dicts of the same structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)

