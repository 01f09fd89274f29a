"""Dict-of-tensors utilities (port of the part of ``repro.utils.tree`` the
serving path uses)."""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

Pytree = Any


def tree_index(tree: Pytree, i) -> Pytree:
    """Select index ``i`` along the leading (client) axis of every leaf."""
    if isinstance(tree, Mapping):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]
