"""Mixture-of-Experts with capacity-based scatter dispatch (GShard / Switch
lineage).

Port of ``repro.models.moe``:

  * router: softmax top-k over E experts, from float32 logits
    ``x.float() @ router`` (a full float32 product: the port never turns
    TF32 on);
  * each (token, choice) gets a slot in its expert's capacity-C buffer from
    an exclusive cumsum over the flattened (T * k) choices in token-major
    order; a choice past its expert's C slots is *dropped* (its
    contribution is zero; the residual path keeps the token);
  * dispatch is a scatter into an (E * C, D) buffer, expert compute three
    batched products (E, C, D) x (E, D, F), and the combine a gather
    weighted by the renormalised gates.

The reference drops a choice by writing it to the out-of-range row E * C
with ``mode="drop"``; here the buffer has E * C + 1 rows, the last one
takes those colliding writes and is sliced off.  The expert products are
plain ``torch.bmm`` calls, as the reference leaves its einsums to XLA: no
Pallas kernel computes them.  The expert-parallel variant (the
reference's ``moe_sharded.py``) is ``repro_torch.models.moe_sharded``,
which ``transformer.py`` takes under ``sharding_mode="ep_tp"`` inside a
``launch.mesh.use_mesh`` block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    Init,
    activation,
    dense_init,
    ffn_apply,
    ffn_init,
    is_gated,
)


def moe_init(init: Init, act: str, d_model: int, d_ff: int, n_experts: int,
             dtype: torch.dtype, shared_expert: bool = False) -> dict:
    """Shapes and initial values of ``repro.models.moe.moe_init``."""
    def experts(a, b):
        return init.normal((n_experts, a, b), (1.0 / a) ** 0.5, dtype)
    p = {"router": dense_init(init, d_model, n_experts, torch.float32),
         "w_gate": experts(d_model, d_ff),
         "w_down": experts(d_ff, d_model)}
    if is_gated(act):
        p["w_up"] = experts(d_model, d_ff)
    if shared_expert:
        p["shared"] = ffn_init(init, act, d_model, d_ff, dtype)
    return p


def router_topk(logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, E) -> gates (T, k) renormalised, idx (T, k), both sorted by
    probability, largest first."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx


def load_balance_loss(logits: torch.Tensor, idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * <fraction routed to e> . <mean router prob e>."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)                                          # (E,)
    ce = F.one_hot(idx[:, 0], n_experts).float().mean(dim=0)
    return n_experts * torch.sum(me * ce)


def moe_apply(act: str, p: dict, x: torch.Tensor, *, top_k: int,
              capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) -> (y (..., D), aux_loss scalar float32)."""
    orig_shape = x.shape
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    E = p["router"].shape[1]
    C = capacity

    logits = xt.float() @ p["router"]                               # (T, E)
    gates, idx = router_topk(logits, top_k)                         # (T, k)
    aux = load_balance_loss(logits, idx, E)

    # position of each (token, choice) within its expert's buffer: the
    # exclusive cumsum over the (T*k) choices, taken along the last axis of
    # the transposed one-hot (the same integers; on the card a scan over the
    # outer axis of a narrow (T*k, E) array took 3 ms at jamba's prefill)
    flat_e = idx.reshape(-1)                                        # (T*k,)
    onehot = F.one_hot(flat_e, E).T.contiguous()                    # (E, T*k)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot                 # exclusive cumsum
    pos = pos_in_e.gather(0, flat_e[None])[0]
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, torch.full_like(pos, E * C))

    # scatter the choices to their slots; row E * C takes the dropped ones
    buf = xt.new_zeros((E * C + 1, D))
    buf[slot] = xt.repeat_interleave(top_k, dim=0)
    buf = buf[:E * C].reshape(E, C, D)

    gate_h = torch.bmm(buf, p["w_gate"])                            # (E, C, F)
    up_h = torch.bmm(buf, p["w_up"]) if is_gated(act) else None
    out = torch.bmm(activation(act, gate_h, up_h), p["w_down"]).reshape(E * C, D)

    # gather back (a zero row for the dropped) and combine, weighted
    padded = torch.cat([out, out.new_zeros((1, D))], dim=0)
    yk = padded[slot]                                               # (T*k, D)
    w = (gates.reshape(-1) * keep.float()).to(x.dtype)
    y = (yk * w[:, None]).reshape(T, top_k, D).sum(dim=1)

    if "shared" in p:
        y = y + ffn_apply(act, p["shared"], xt)
    return y.reshape(orig_shape), aux


def moe_capacity(tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25, multiple: int = 128) -> int:
    """Slots per expert, rounded up to ``multiple``."""
    raw = tokens * top_k * capacity_factor / n_experts
    return max(multiple, int(-(-raw // multiple)) * multiple)
