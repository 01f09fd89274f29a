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

:class:`ShardedParamArena` spreads the rows over a client mesh
(``repro_torch.launch.mesh``): shard ``j`` is a tensor of its own on
``devices[j]`` and no device holds another shard's rows.  Both arenas
answer the same questions (``gather``, ``masked_scatter``, ``rebind``,
``as_pytree``, ``host_rows``, ``nbytes``, ``per_device_bytes``,
``devices``), which is all the driver, the checkpoint and the serving
snapshot read; only the one-device arena has a ``data`` matrix.
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

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """The devices that hold arena rows."""
        return (self.data.device,)

    @property
    def nbytes(self) -> int:
        """Arena bytes over every device (padding rows included)."""
        return self.data.numel() * self.data.element_size()

    def per_device_bytes(self) -> int:
        """Arena bytes resident on one device."""
        return self.nbytes

    def host_rows(self) -> np.ndarray:
        """A host copy of the ``n_clients`` real rows that later in-place
        updates cannot reach."""
        return self.data.detach().to("cpu", copy=True).numpy()

    # ------------------------------------------------------------------ #

    def _index(self, cohort) -> torch.Tensor:
        """Client ids (a tensor on any device, or a host sequence) as a long
        index on the arena's device."""
        if isinstance(cohort, torch.Tensor):
            return cohort.to(self.data.device, torch.long)
        return torch.as_tensor(np.asarray(cohort), dtype=torch.long,
                               device=self.data.device)

    def gather(self, cohort, device=None) -> torch.Tensor:
        """Rows for a cohort of client ids -> ``(k, N)`` (a copy), on
        ``device`` (default: the arena's)."""
        rows = self.data.index_select(0, self._index(cohort))
        return rows if device is None else rows.to(device)

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
        """Install a freshly computed (n, N) population matrix (on any
        device) on the arena's device, as rows of its own (a broadcast view
        is materialised)."""
        self.data = flat.to(self.data.device).contiguous()

    def as_pytree(self, rows: torch.Tensor | None = None) -> Pytree:
        """Dict view of ``rows`` (default: the whole population)."""
        return self.layout.unflatten(self.data if rows is None else rows)

    def row_pytree(self, i: int) -> Pytree:
        """One client's (unstacked) param dict."""
        return tree_index(self.as_pytree(self.data[i][None]), 0)


def host_ids(cohort) -> np.ndarray:
    """Client ids (a tensor on any device, or a host sequence) as a host
    int64 array."""
    if isinstance(cohort, torch.Tensor):
        cohort = cohort.cpu().numpy()
    return np.asarray(cohort, dtype=np.int64).reshape(-1)


class ShardedParamArena:
    """The population matrix row-sharded over a client mesh.

    Port of ``repro.runtime.arena.ShardedParamArena``.  Rows are zero-padded
    to ``n_padded = ceil(n / S) * S``; shard ``j`` is an ``(n_padded / S,
    N)`` tensor on ``mesh.devices[j]`` holding the rows ``[j * n_padded / S,
    (j + 1) * n_padded / S)``.  Padding rows sit beyond every real client
    id, are never gathered or scattered, and ``n_clients`` / ``as_pytree``
    / ``host_rows`` expose only the logical population.  There is no
    ``data``: nothing concatenates the shards onto one device.  Moves
    between devices are explicit copies in one process; the cohort's
    gather lands each device its own slice, and the masked scatter writes
    each row on the device that owns it.
    """

    def __init__(self, layout: ArenaLayout, shards: list[torch.Tensor],
                 n_clients: int, mesh):
        if len(shards) != mesh.shards:
            raise ValueError(f"{len(shards)} shard tensors for a "
                             f"{mesh.shards}-device client mesh")
        rows = shards[0].shape[0]
        for j, (t, dev) in enumerate(zip(shards, mesh.devices)):
            if t.shape != (rows, layout.n_params) or t.device != dev:
                raise ValueError(f"shard {j} is {tuple(t.shape)} on {t.device}, "
                                 f"expected {(rows, layout.n_params)} on {dev}")
        if not (rows - 1) * mesh.shards < n_clients <= rows * mesh.shards:
            raise ValueError(f"{n_clients} clients do not pad to {mesh.shards} "
                             f"shards of {rows} rows")
        self.layout = layout
        self.mesh = mesh
        self.shards = list(shards)
        self._n_clients = int(n_clients)

    @classmethod
    def from_stacked(cls, stacked: Pytree, mesh,
                     dtype: torch.dtype = torch.float32) -> "ShardedParamArena":
        layout = ArenaLayout.from_stacked(stacked, dtype=dtype)
        flat = layout.flatten(stacked)
        return cls(layout, cls._split(flat, flat.shape[0], mesh),
                   flat.shape[0], mesh)

    @staticmethod
    def _split(flat: torch.Tensor, n_clients: int, mesh) -> list[torch.Tensor]:
        """Shard ``j``'s rows of the (n, N) matrix ``flat`` (any device, a
        broadcast view included), zero-padded, as a new tensor on
        ``devices[j]``."""
        if flat.shape[0] != n_clients:
            raise ValueError(f"rebind needs ({n_clients}, N) rows, got "
                             f"{tuple(flat.shape)}")
        rows = -(-n_clients // mesh.shards)
        out = []
        for j, dev in enumerate(mesh.devices):
            shard = torch.zeros((rows, flat.shape[1]), dtype=flat.dtype,
                                device=dev)
            real = flat[j * rows: min((j + 1) * rows, n_clients)]
            shard[: real.shape[0]].copy_(real)
            out.append(shard)
        return out

    @property
    def n_clients(self) -> int:            # logical population, not padded rows
        return self._n_clients

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.mesh.shards

    @property
    def rows_per_shard(self) -> int:
        return int(self.shards[0].shape[0])

    @property
    def n_params(self) -> int:
        return self.layout.n_params

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return self.mesh.devices

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.shards)

    def per_device_bytes(self) -> int:
        """Arena bytes resident on ONE device (the scaling headline)."""
        t = self.shards[0]
        return t.numel() * t.element_size()

    # ------------------------------------------------------------------ #

    def _owners(self, ids: np.ndarray):
        """``(shard, positions, local rows)`` for every shard that owns at
        least one of ``ids``, positions in ``ids`` order."""
        if ids.size and (ids.min() < 0 or ids.max() >= self._n_clients):
            raise IndexError(f"client ids outside [0, {self._n_clients})")
        owner = ids // self.rows_per_shard
        for j in np.unique(owner):
            pos = np.flatnonzero(owner == j)
            yield int(j), pos, ids[pos] - j * self.rows_per_shard

    def gather(self, cohort, device) -> torch.Tensor:
        """Rows for a cohort of client ids -> ``(k, N)`` on ``device``, in
        ``cohort`` order: an ``index_select`` on each owner, copied over.
        Always a new tensor, never a view of a shard."""
        ids = host_ids(cohort)
        out = torch.empty((ids.size, self.n_params), dtype=self.layout.dtype,
                          device=device)
        for j, pos, local in self._owners(ids):
            shard = self.shards[j]
            rows = shard.index_select(
                0, torch.as_tensor(local, device=shard.device)).to(device)
            out.index_copy_(0, torch.as_tensor(pos, device=device), rows)
        return out

    def masked_scatter(self, cohort, mask, rows: torch.Tensor) -> torch.Tensor:
        """Write ``rows`` (k, N) into the cohort's slots where ``mask`` is
        set, each on the shard that owns it; the other slots keep their
        rows.  Returns the cohort's rows as written, on ``rows``' device."""
        ids = host_ids(cohort)
        keep = torch.as_tensor(mask, device=rows.device).bool()
        written = torch.empty_like(rows)
        for j, pos, local in self._owners(ids):
            shard = self.shards[j]
            at = torch.as_tensor(local, device=shard.device)
            sel = torch.as_tensor(pos, device=rows.device)
            upd = torch.where(keep.index_select(0, sel)[:, None].to(shard.device),
                              rows.index_select(0, sel).to(shard.device),
                              shard.index_select(0, at))
            shard.index_copy_(0, at, upd)
            written.index_copy_(0, sel, upd.to(rows.device))
        return written

    def rebind(self, flat: torch.Tensor) -> None:
        """Install a freshly computed (n, N) population matrix (on any
        device): padded and split, each shard copied to its owner."""
        self.shards = self._split(flat, self._n_clients, self.mesh)

    def host_rows(self) -> np.ndarray:
        """A host copy of the ``n_clients`` real rows, read shard by shard."""
        return np.concatenate([t.detach().cpu().numpy() for t in self.shards]
                              )[: self._n_clients]

    def as_pytree(self, rows: torch.Tensor | None = None) -> Pytree:
        """Dict view of ``rows`` (default: the real rows, read to the
        host)."""
        if rows is None:
            rows = torch.from_numpy(self.host_rows())
        return self.layout.unflatten(rows)
