"""State carried across from the reference package, as plain data.

The port never sees a JAX object: parameters and arena rows arrive as numpy
arrays, a chain as plain records (``dataclasses.asdict`` of each reference
block).  An LM's parameters (lists of stacked layers, bfloat16 leaves) take
:func:`lm_params_from_numpy`, its optimizer's state
:func:`opt_state_from_numpy`.  A bank saved by the reference
(``ModelBank.save``, one ``.npz``) needs nothing here: it loads through
``repro_torch.serve.load_bank``.  An LM tree's expert tables are split
over a device mesh for the expert-parallel MoE by
:func:`place_expert_tables`, and made whole again by
:func:`unplace_expert_tables`.
"""
from __future__ import annotations

import re
from collections.abc import Iterable, Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.blockchain.chain import Block, Blockchain
from repro_torch.blockchain.txpool import Transaction
from repro_torch.device import resolve_device
from repro_torch.models.moe_sharded import map_moe_layers, place_blocks, unplace_blocks
from repro_torch.runtime.arena import ArenaLayout, ParamArena

_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def params_from_numpy(params: Mapping[str, Any], device=None) -> dict:
    """A (nested) dict of numpy arrays -> the same dict of tensors on
    ``device``, bit for bit."""
    device = resolve_device(device)
    return {k: params_from_numpy(v, device) if isinstance(v, Mapping)
            else torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in params.items()}


def _tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """One array -> a tensor on ``device``, bit for bit.  bfloat16 arrives
    as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: it goes
    through its uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def lm_params_from_numpy(tree: Any, device=None) -> Any:
    """An LM parameter tree of numpy arrays — nested dicts and lists (the
    reference's ``layers`` / ``rem_layers``), float32 or bfloat16 leaves —
    -> the same tree of tensors on ``device``, bit for bit."""
    device = resolve_device(device)

    def walk(x):
        if isinstance(x, Mapping):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return _tensor_from_numpy(x, device)
    return walk(tree)


def place_expert_tables(params: Any, mesh, ep_axis: str = "data",
                        tp_axis: str = "model") -> Any:
    """An LM parameter tree with every MoE layer's expert tables
    (``w_gate`` / ``w_up`` (..., E, D, F), ``w_down`` (..., E, F, D), a
    leading axis where the layout stacks periods) placed over ``mesh`` (a
    ``launch.mesh.ModelMesh``): each table becomes a list of the members'
    ``(..., E / ep, D, F / tp)`` blocks in the mesh's device order, each on
    its member's device (the reference's ``P(ep, None, tp)`` / ``P(ep, tp,
    None)``), for ``models/moe_sharded.moe_apply_shard_map``.  A block on
    its table's own device is a view; on another it is a copy, and the
    returned tree keeps no whole table.  Every other leaf is the same
    tensor.  The result is a tree of tensors, so an optimizer trains it.
    Raises for a non-gated MoE and where E does not split over ``ep``."""
    return map_moe_layers(params, lambda moe: place_blocks(mesh, moe, ep_axis, tp_axis))


def unplace_expert_tables(params: Any, mesh, ep_axis: str = "data",
                          tp_axis: str = "model") -> Any:
    """The exact inverse of :func:`place_expert_tables` over the same
    ``mesh``: every placed expert table rebuilt whole from its members'
    blocks (``models/moe_sharded.unplace_blocks``: joined along F, then E,
    in the member order of ``moe_sharded._member`` / ``expert_block``) on
    the router's device, bit for bit; each table is copied once.  Dense
    tables and every other leaf pass through as they are; an optimizer's
    moment trees (which mirror the parameters) unplace the same way.
    Raises where the number of blocks does not fit the mesh."""
    return map_moe_layers(params, lambda moe: unplace_blocks(mesh, moe, ep_axis, tp_axis))


def opt_state_from_numpy(state: Mapping[str, Any], device=None) -> dict:
    """The reference optimizer's state as numpy arrays — ``{"step", "m",
    "v"}`` (adam, adamw), ``{"step", "mu"}`` (momentum) or ``{"step"}``
    (sgd) — -> the port's: the step a plain int, the moment trees (the
    parameters' structure, float32 leaves) tensors on ``device``, bit for
    bit."""
    device = resolve_device(device)
    out: dict = {"step": int(np.asarray(state["step"]))}
    for key in ("m", "v", "mu"):
        if key in state:
            out[key] = lm_params_from_numpy(state[key], device)
    return out


def _keys_of(path: str) -> tuple[str, ...]:
    keys = tuple(_KEY.findall(path))
    if "".join(f"[{k!r}]" for k in keys) != path:
        raise ValueError(f"arena path {path!r} is not a string-keyed dict path")
    return keys


def arena_from_numpy(rows: np.ndarray,
                     layout_paths_shapes: Iterable[tuple[str, tuple[int, ...]]],
                     device=None) -> ParamArena:
    """Reference arena rows ``(n, N)`` plus its layout's ``(path, shape)``
    pairs (``zip(layout.paths, layout.shapes)``) -> a port arena holding the
    same bits.  Raises if the pairs are not in canonical column order."""
    device = resolve_device(device)
    template: dict = {}
    pairs = list(layout_paths_shapes)
    for path, shape in pairs:
        *outer, last = _keys_of(path)
        node = template
        for k in outer:
            node = node.setdefault(k, {})
        node[last] = torch.empty((1,) + tuple(shape), device="meta")
    layout = ArenaLayout.from_stacked(template)
    if list(layout.paths) != [p for p, _ in pairs]:
        raise ValueError("layout paths are not in canonical column order")
    rows = np.asarray(rows, dtype=np.float32)
    if rows.ndim != 2 or rows.shape[1] != layout.n_params:
        raise ValueError(f"rows {rows.shape} do not match the layout's "
                         f"{layout.n_params} params")
    return ParamArena(layout, torch.from_numpy(rows.copy()).to(device))


def chain_from_records(records: Iterable[Mapping[str, Any]]) -> Blockchain:
    """Rebuild a chain from plain block records (``index``, ``round_idx``,
    ``producer``, ``prev_hash``, ``merkle_root`` and ``transactions`` of
    ``kind``/``sender``/``payload``/``round_idx``), genesis included."""
    blocks = [Block(index=int(r["index"]), round_idx=int(r["round_idx"]),
                    producer=int(r["producer"]), prev_hash=str(r["prev_hash"]),
                    merkle_root=str(r["merkle_root"]),
                    transactions=tuple(
                        Transaction(str(t["kind"]), int(t["sender"]),
                                    str(t["payload"]), int(t["round_idx"]))
                        for t in r["transactions"]))
              for r in records]
    return Blockchain(blocks=blocks)
