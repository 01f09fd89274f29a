"""Parameter arena: ONE canonical flat layout for population-stacked params.

Port of ``repro.runtime.arena`` over (nested) dicts of tensors.  The
population is one ``(n_clients, N_params)`` matrix with a recorded leaf
layout; fingerprint digests, bank extraction and serving all work on rows
of that matrix.

Canonical column order is the sort of the leaves' JAX ``keystr`` paths —
``"['b0']" < "['b1']" < "['b_head']" < "['w0']"``, and ``"['a']['c']"`` for
nested dicts.  The port rebuilds exactly those strings and sorts them, so
an arena row holds the same bits in the same columns as the reference
arena, and digests of port rows equal digests of reference rows.  (A plain
sort of key names agrees for the flat MLP but not for nested dicts.)
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_index

Pytree = Any


def leaves_with_keys(tree: Pytree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """Leaves of a nested dict in JAX's flatten order (sorted keys at every
    level), each with its key path."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_keys(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def keystr(keys: tuple) -> str:
    """The ``jax.tree_util.keystr`` string of a dict key path."""
    return "".join(f"[{k!r}]" for k in keys)


@dataclass(frozen=True)
class ArenaLayout:
    """Recorded flat layout of a stacked dict of tensors (leading client axis).

    ``keys``/``paths``/``shapes``/``dtypes``/``sizes``/``offsets`` describe
    the leaves in canonical (path-sorted) column order; ``order`` maps a
    canonical position to the leaf's position in tree order.
    """

    keys: tuple[tuple, ...]
    paths: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]   # per-client shapes (no client axis)
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    order: tuple[int, ...]                # canonical position -> tree position
    dtype: torch.dtype = torch.float32    # arena storage dtype

    @property
    def n_params(self) -> int:
        return int(sum(self.sizes))

    @classmethod
    def from_stacked(cls, stacked: Pytree, dtype: torch.dtype = torch.float32
                     ) -> "ArenaLayout":
        leaves = leaves_with_keys(stacked)
        strs = [keystr(k) for k, _ in leaves]
        order = tuple(sorted(range(len(leaves)), key=lambda i: strs[i]))
        shapes = [tuple(leaves[i][1].shape[1:]) for i in order]
        sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
        return cls(keys=tuple(leaves[i][0] for i in order),
                   paths=tuple(strs[i] for i in order),
                   shapes=tuple(shapes),
                   dtypes=tuple(leaves[i][1].dtype for i in order),
                   sizes=tuple(sizes),
                   offsets=tuple(int(o) for o in np.cumsum([0] + sizes[:-1])),
                   order=order, dtype=dtype)

    def flatten(self, stacked: Pytree) -> torch.Tensor:
        """Stacked dict -> ``(m, N)`` matrix in canonical column order.

        Only floating dtypes no wider than the arena dtype are accepted, so
        ``unflatten(flatten(x))`` returns ``x`` bit for bit.
        """
        leaves = [leaf for _, leaf in leaves_with_keys(stacked)]
        for pos, i in enumerate(self.order):
            dt = leaves[i].dtype
            if not dt.is_floating_point or dt.itemsize > self.dtype.itemsize:
                raise TypeError(
                    f"arena leaf {self.paths[pos]} has dtype {dt}, not "
                    f"exactly representable in the {self.dtype} arena")
        m = leaves[0].shape[0]
        return torch.cat([leaves[i].to(self.dtype).reshape(m, -1)
                          for i in self.order], dim=1)

    def flatten_u32(self, stacked: Pytree) -> torch.Tensor:
        """Stacked dict -> ``(m, N)`` bit matrix (the fingerprint input), as
        the int32 tensor holding the uint32 bits (the port's convention, see
        :func:`bitcast_u32`).  Leaves that are not 32 bits wide are cast to
        float32 first, as the reference's ``flatten_u32`` does."""
        leaves = [leaf for _, leaf in leaves_with_keys(stacked)]
        m = leaves[0].shape[0]
        cols = []
        for i in self.order:
            leaf = leaves[i]
            if leaf.element_size() != 4:
                leaf = leaf.float()
            cols.append(leaf.contiguous().view(torch.int32).reshape(m, -1))
        return torch.cat(cols, dim=1)

    def unflatten(self, flat: torch.Tensor) -> Pytree:
        """``(m, N)`` matrix -> stacked dict of views (exact inverse of
        :meth:`flatten`)."""
        m = flat.shape[0]
        out: dict = {}
        for pos in sorted(range(len(self.order)), key=self.order.__getitem__):
            col = flat[:, self.offsets[pos]: self.offsets[pos] + self.sizes[pos]]
            *outer, last = self.keys[pos]
            node = out
            for k in outer:
                node = node.setdefault(k, {})
            node[last] = col.reshape((m,) + self.shapes[pos]).to(self.dtypes[pos])
        return out


def bitcast_u32(rows: torch.Tensor) -> torch.Tensor:
    """Arena rows (fp32) -> their exact bit pattern, as an int32 view holding
    the uint32 bits (no copy; the fingerprint input)."""
    return rows.view(torch.int32)


class ParamArena:
    """The population parameter matrix plus its recorded layout."""

    def __init__(self, layout: ArenaLayout, data: torch.Tensor):
        self.layout = layout
        self.data = data

    @classmethod
    def from_stacked(cls, stacked: Pytree, dtype: torch.dtype = torch.float32
                     ) -> "ParamArena":
        layout = ArenaLayout.from_stacked(stacked, dtype=dtype)
        return cls(layout, layout.flatten(stacked))

    @property
    def n_clients(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_params(self) -> int:
        return self.layout.n_params

    # ------------------------------------------------------------------ #

    def _index(self, cohort) -> torch.Tensor:
        """Client ids (a tensor on any device, or a host sequence) as a long
        index on the arena's device."""
        if isinstance(cohort, torch.Tensor):
            return cohort.to(self.data.device, torch.long)
        return torch.as_tensor(np.asarray(cohort), dtype=torch.long,
                               device=self.data.device)

    def gather(self, cohort) -> torch.Tensor:
        """Rows for a cohort of client ids -> ``(k, N)`` (a copy)."""
        return self.data.index_select(0, self._index(cohort))

    def masked_scatter(self, cohort, mask, rows: torch.Tensor) -> torch.Tensor:
        """Write ``rows`` back into the cohort's slots where ``mask`` is set;
        masked-out slots (stragglers, dropouts) keep their existing params.

        The update is IN PLACE (``index_copy_`` into ``data``), where the
        reference donates the arena buffer to a jitted scatter.  Fixed-shape:
        a ``where`` over the full cohort, never a dynamically sized row
        subset.  Returns the cohort's rows as written."""
        idx = self._index(cohort)
        keep = torch.as_tensor(mask, device=self.data.device).bool()[:, None]
        upd = torch.where(keep, rows, self.data.index_select(0, idx))
        self.data.index_copy_(0, idx, upd)
        return upd

    def rebind(self, flat: torch.Tensor) -> None:
        """Install a freshly computed (n, N) population matrix."""
        self.data = flat

    def as_pytree(self, rows: torch.Tensor | None = None) -> Pytree:
        """Dict view of ``rows`` (default: the whole population)."""
        return self.layout.unflatten(self.data if rows is None else rows)

    def row_pytree(self, i: int) -> Pytree:
        """One client's (unstacked) param dict."""
        return tree_index(self.as_pytree(self.data[i][None]), 0)
