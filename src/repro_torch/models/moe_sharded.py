"""Explicit expert-parallel MoE over a ``(data, model)`` mesh (the GShard
schedule).

Port of ``repro.models.moe_sharded``.  The reference runs its schedule in a
``shard_map`` over the ambient mesh; the port runs it over the devices of
the ambient :class:`~repro_torch.launch.mesh.ModelMesh`
(``launch.mesh.use_mesh``), one process driving them, every move between
them an explicit ``.to(device)`` (autograd carries each gradient back
through it).  Devices may repeat: S members on one card, or on the host.

    per token shard: local router -> local top-k -> LOCAL capacity buffer
    all_to_all over the expert axis: (E, C_loc, D) -> (E_loc, C_loc * ep, D)
    local expert products (member (d, t) holds experts E_loc of d, F_loc of t)
    psum over tp of the down-projection partials (t = 0..tp-1, in order)
    all_to_all back + local weighted combine

Member ``(d, t)`` of the mesh holds its ``(E / ep, D, F / tp)`` block of
every expert table (the reference's ``P(ep, None, tp)`` / ``P(ep, tp,
None)``).  :func:`place_expert_tables` (``repro_torch.interop``) turns a
parameter tree's tables into those blocks, one a member, so that the
tables' bytes split over the members; :func:`moe_apply_shard_map` copies
no expert weights per call.  It also takes unplaced tables and slices
each member's block as a view (copied to the member's device where that
is another), as the reference's test calls its counterpart.  The router
(replicated in the reference) stays on the lead and each token shard
reads it on its own device; the shared expert runs where its weights lie.

The expert products are ``torch.bmm``: the reference leaves its einsums
to XLA, outside any Pallas kernel.  Requires a gated activation and
``n_experts % ep == 0``, as the reference asserts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import ModelMesh, ambient_mesh
from repro_torch.models.layers import activation, ffn_apply, is_gated
from repro_torch.models.moe import load_balance_loss, router_topk

EXPERT_TABLES = ("w_gate", "w_up", "w_down")


def _local_dispatch(xt: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                    E: int, C_loc: int, top_k: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-sharded local scatter into (E, C_loc, D), no communication:
    ``(buf, slot, keep)``.  A choice past its expert's C_loc slots is
    dropped: its slot is the extra row E * C_loc, which is sliced off (the
    reference writes it out of range with ``mode="drop"``)."""
    T_loc, D = xt.shape
    flat_e = idx.reshape(-1)
    # the exclusive cumsum over the (T_loc * k) choices in token-major order,
    # along the last axis of the transposed one-hot (as models/moe.py)
    onehot = F.one_hot(flat_e, E).T.contiguous()                   # (E, T_loc*k)
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(0, flat_e[None])[0]
    keep = pos < C_loc
    slot = torch.where(keep, flat_e * C_loc + pos, torch.full_like(pos, E * C_loc))
    buf = xt.new_zeros((E * C_loc + 1, D))
    buf[slot] = xt.repeat_interleave(top_k, dim=0)
    return buf[:E * C_loc].reshape(E, C_loc, D), slot, keep


def ambient_mesh_shape() -> dict[str, int]:
    """Axis sizes of the ambient (``use_mesh``) mesh; {} when none is active."""
    mesh = ambient_mesh()
    return dict(mesh.shape) if mesh is not None else {}


def _member(mesh: ModelMesh, ep_axis: str, e: int, t: int) -> int:
    """Flat index (row-major over (data, model)) of the member at expert
    index ``e`` and tensor index ``t``."""
    d, m = (e, t) if ep_axis == "data" else (t, e)
    return d * mesh.model + m


def expert_block(w: torch.Tensor, name: str, e: int, t: int, ep: int, tp: int
                 ) -> torch.Tensor:
    """Member (e, t)'s block of an expert table, a view: experts
    ``e * E / ep ..`` and, along F, ``t * F / tp ..``.  ``w`` is ``(..., E,
    D, F)`` (``w_gate``, ``w_up``) or ``(..., E, F, D)`` (``w_down``); a
    leading axis stacks periods."""
    E = w.shape[-3]
    F_ = w.shape[-2] if name == "w_down" else w.shape[-1]
    if E % ep or F_ % tp:
        raise ValueError(f"{name} {tuple(w.shape)}: {E} experts over ep = {ep} or "
                         f"F = {F_} over tp = {tp} does not divide")
    el, fl = E // ep, F_ // tp
    w = w[..., e * el:(e + 1) * el, :, :]
    return w[..., t * fl:(t + 1) * fl, :] if name == "w_down" else w[..., t * fl:(t + 1) * fl]


def _mesh_sizes(mesh: ModelMesh | None, E: int, ep_axis: str, tp_axis: str
                ) -> tuple[int, int]:
    """(ep, tp) of the mesh; raises where the reference asserts."""
    if mesh is None:
        raise ValueError("the expert-parallel MoE needs an ambient mesh "
                         "(repro_torch.launch.mesh.use_mesh)")
    if ep_axis not in mesh.axis_names or tp_axis == ep_axis:
        raise ValueError(f"expert axis {ep_axis!r} / tensor axis {tp_axis!r} on a mesh "
                         f"of {mesh.axis_names}")
    ep = mesh.shape[ep_axis]
    tp = mesh.shape.get(tp_axis, 1)
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep_axis} = {ep}")
    return ep, tp


def place_blocks(mesh: ModelMesh, moe: dict, ep_axis: str = "data",
                 tp_axis: str = "model") -> dict:
    """One MoE layer's parameters with every expert table a list of member
    blocks in the mesh's device order, each on its member's device: views
    of the table where every member lies on the table's device (S members
    on one card), else copies, so that no member keeps the whole table."""
    if "w_up" not in moe:
        raise ValueError("the expert-parallel MoE takes a gated FFN: this layer "
                         "has no w_up")
    ep, tp = _mesh_sizes(mesh, moe["router"].shape[1], ep_axis, tp_axis)
    return dict(moe, **{name: _blocks(moe[name], name, mesh, ep_axis, ep, tp,
                                      copy=set(mesh.devices) != {moe[name].device})
                        for name in EXPERT_TABLES})


def _blocks(w, name: str, mesh: ModelMesh, ep_axis: str, ep: int, tp: int,
            copy: bool = False) -> list[torch.Tensor]:
    """Every member's block of table ``name``, on its device: placed blocks
    (a list) as they are, or the blocks of a table (views, copied where the
    member's device is another or ``copy``)."""
    if isinstance(w, (list, tuple)):
        if len(w) != len(mesh.devices):
            raise ValueError(f"{name}: {len(w)} placed blocks for a mesh of "
                             f"{len(mesh.devices)} members")
        return list(w)
    blocks = [None] * len(mesh.devices)
    for e in range(ep):
        for t in range(tp):
            i = _member(mesh, ep_axis, e, t)
            blocks[i] = expert_block(w, name, e, t, ep, tp).to(mesh.devices[i], copy=copy)
    return blocks


def moe_apply_shard_map(act: str, p: dict, x: torch.Tensor, *, top_k: int,
                        capacity: int, ep_axis: str = "data", tp_axis: str = "model",
                        batch_axes: tuple = ("data",)
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux) on the ambient mesh.  Tables: ``w_gate`` /
    ``w_up`` (E, D, F) and ``w_down`` (E, F, D), placed
    (:func:`place_blocks`) or not.  The tokens split into ``ep`` contiguous
    shards over ``batch_axes`` (the expert axis; a "pod" axis, which a
    ModelMesh never has, is skipped), each with capacity ``C_loc = max(8,
    capacity // ep)`` an expert.  ``aux`` is the mean over the shards of
    their load-balance losses (the reference's ``pmean``), not the dense
    global loss.  ``y`` comes back on ``x``'s device in token order."""
    if not is_gated(act):
        raise ValueError(f"the expert-parallel MoE takes a gated FFN, got {act!r}")
    mesh = ambient_mesh()
    E = p["router"].shape[1]
    ep, tp = _mesh_sizes(mesh, E, ep_axis, tp_axis)
    tok_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    if tok_axes != (ep_axis,):
        raise ValueError(f"tokens shard over the expert axis {ep_axis!r} only, got "
                         f"batch_axes {batch_axes}")
    orig_shape = x.shape
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    if T % ep:
        raise ValueError(f"{T} tokens do not split into {ep} shards")
    T_loc, E_loc, C_loc = T // ep, E // ep, max(8, capacity // ep)
    w_gate, w_up, w_down = (_blocks(p[name], name, mesh, ep_axis, ep, tp)
                            for name in EXPERT_TABLES)

    # each token shard on its row's first member: router, top-k, dispatch
    bufs, routes, auxes = [], [], []
    for s in range(ep):
        dev = mesh.devices[_member(mesh, ep_axis, s, 0)]
        xs = xt[s * T_loc:(s + 1) * T_loc].to(dev)
        logits = xs.float() @ p["router"].to(dev)                    # (T_loc, E)
        gates, idx = router_topk(logits, top_k)
        auxes.append(load_balance_loss(logits, idx, E))
        buf, slot, keep = _local_dispatch(xs, gates, idx, E, C_loc, top_k)
        bufs.append(buf)
        routes.append((gates, slot, keep))

    # all_to_all: member (d, t) takes block d of every shard's buffer, in
    # shard order, and runs its experts' F_loc columns; psum over tp
    outs = []
    for d in range(ep):
        partial = None
        for t in range(tp):
            i = _member(mesh, ep_axis, d, t)
            dev = mesh.devices[i]
            recv = torch.cat([b[d * E_loc:(d + 1) * E_loc].to(dev) for b in bufs], dim=1)
            h = activation(act, torch.bmm(recv, w_gate[i]), torch.bmm(recv, w_up[i]))
            out = torch.bmm(h, w_down[i])                            # (E_loc, C_loc*ep, D)
            partial = out if partial is None else partial + out.to(partial.device)
        outs.append(partial)

    # all_to_all back: shard s takes its C_loc columns of every expert block
    # in expert order, then combines its choices, weighted
    ys = []
    for s in range(ep):
        dev = mesh.devices[_member(mesh, ep_axis, s, 0)]
        back = torch.cat([o[:, s * C_loc:(s + 1) * C_loc].to(dev) for o in outs], dim=0)
        padded = torch.cat([back.reshape(E * C_loc, D), back.new_zeros((1, D))], dim=0)
        gates, slot, keep = routes[s]
        w = (gates.reshape(-1) * keep.float()).to(x.dtype)
        ys.append((padded[slot] * w[:, None]).reshape(T_loc, top_k, D).sum(dim=1))
    y = torch.cat([part.to(x.device) for part in ys])
    aux = torch.stack([a.to(x.device) for a in auxes]).sum() / ep

    if "shared" in p:
        y = y + ffn_apply(act, p["shared"], xt)
    return y.reshape(orig_shape), aux
