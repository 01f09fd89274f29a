"""KV-cache / recurrent-state decode path (serve_step).

Port of ``repro.models.decode``.  The cache mirrors the pattern-period
layout of the parameters: one entry per pattern position with leaves
stacked over ``n_periods``, plus ``rem`` for the remainder layers.  Cache
kinds per mixer:

  attn  : k/v ring buffers — full layers allocate ``seq_len`` slots, sliding-
          window layers only ``window`` slots;
  mamba : (conv, ssm) — the last d_conv - 1 inputs of the conv in the model
          dtype and the float32 scan state, O(1) in sequence length; the
          state is carried through ``repro_torch.kernels.ops.selective_scan``
          at S = 1;
  rwkv  : (tm_x, cm_x, wkv) — O(1) in sequence length; the wkv state is
          carried through ``repro_torch.kernels.ops.rwkv6_wkv`` at T = 1;
  cross : the encoder's K/V (kc, vc: n_frames slots), filled once by
          :func:`warm_cache`; every decode step attends over all of them.

MoE FFNs route the step's B tokens at the reference's capacity for
T = B: at least 128 slots an expert, so no choice is dropped while
B * top_k <= 128.

``pos`` is a Python int.  Unlike the reference, whose arrays are immutable,
:func:`decode_step` writes the new k/v rows into the ring buffers and the
new RWKV and Mamba states into their slots in place (a new buffer per token
would copy the whole cache every step), and :func:`warm_cache` the
encoder's K/V likewise: the returned cache holds the same tensors as the
one passed in, which is advanced with it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import rwkv as rk
from repro_torch.models.layers import apply_rope, ffn_apply, matmul, norm, rms_norm
from repro_torch.models.moe import moe_apply, moe_capacity
from repro_torch.models.transformer import (
    ArchConfig,
    LayerSpec,
    embed_tokens,
    encode,
    unembed,
)
from repro_torch.utils.tree import tree_index

Pytree = Any


def _layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, seq_len: int,
                 lead: tuple[int, ...], device) -> dict:
    dt = cfg.dtype
    if spec.mixer == "attn":
        s_c = min(spec.window, seq_len) if spec.window > 0 else seq_len
        shape = lead + (batch, s_c, cfg.n_kv_heads, cfg.head_dim)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
        if spec.cross_attn:
            shape = lead + (batch, cfg.encoder.n_frames, cfg.n_kv_heads, cfg.head_dim)
            c["kc"] = torch.zeros(shape, dtype=dt, device=device)
            c["vc"] = torch.zeros(shape, dtype=dt, device=device)
        return c
    if spec.mixer == "mamba":
        st = mb.mamba_init_state(batch, cfg.mamba_d_inner, cfg.mamba_d_state,
                                 cfg.mamba_d_conv, dt, device=device)
        return {k: v.expand(lead + tuple(v.shape)).clone() for k, v in st.items()}
    if spec.mixer == "rwkv":
        st = rk.rwkv_init_state(batch, cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim,
                                dt, device=device)
        return {k: v.expand(lead + tuple(v.shape)).clone() for k, v in st.items()}
    raise ValueError(spec.mixer)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None) -> Pytree:
    """A zero cache for ``batch`` sequences of up to ``seq_len`` tokens on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    cache: dict = {"pos": 0}
    if cfg.n_periods > 0:
        cache["layers"] = [_layer_cache(cfg, spec, batch, seq_len, (cfg.n_periods,), device)
                           for spec in cfg.pattern]
    cache["rem"] = [_layer_cache(cfg, spec, batch, seq_len, (), device)
                    for spec in cfg.remainder]
    return cache


def warm_cache(cfg: ArchConfig, params: Pytree, cache: Pytree,
               enc_embeds: torch.Tensor | None = None, pos: int = 0) -> Pytree:
    """Set the decode position (e.g. after an external prefill) and, for an
    encoder-decoder configuration given frame embeddings ``enc_embeds``
    (B, n_frames, D), run the encoder once and fill each cross-attention
    layer's kc / vc with its projections of the encoder's output.  They are
    written into the cache's tensors in place (the module note) where those
    have their shape and dtype; otherwise (another frame count, or float32
    frames into a bf16 model) the entry takes new tensors, as the
    reference's entry takes the new arrays."""
    cache = dict(cache, pos=int(pos))
    if cfg.encoder is None or enc_embeds is None:
        return cache
    enc_out = encode(cfg, params, enc_embeds)
    if cfg.n_periods > 0:
        for i, spec in enumerate(cfg.pattern):
            if spec.cross_attn:
                for j in range(cfg.n_periods):
                    _fill_cross(cfg, tree_index(params["layers"][i], j),
                                cache["layers"][i], enc_out, j)
    for i, spec in enumerate(cfg.remainder):
        if spec.cross_attn:
            _fill_cross(cfg, params["rem_layers"][i], cache["rem"][i], enc_out, None)
    return cache


def _fill_cross(cfg: ArchConfig, p: dict, c: dict, enc_out: torch.Tensor,
                j: int | None) -> None:
    """One layer's kc / vc from the encoder's output into cache entry ``c``
    (at period ``j`` of its stack, or unstacked where ``j`` is None)."""
    B, Se = enc_out.shape[:2]
    for name in ("kc", "vc"):
        x = matmul(enc_out, p[name]).reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
        shape = x.shape if j is None else c[name].shape[:1] + x.shape
        if c[name].shape != shape or c[name].dtype != x.dtype:
            c[name] = torch.empty(shape, dtype=x.dtype, device=x.device)
        (c[name] if j is None else c[name][j]).copy_(x)


# --------------------------------------------------------------------------- #
# Single-token layer application
# --------------------------------------------------------------------------- #

def _attn_decode(cfg: ArchConfig, spec: LayerSpec, p: dict, c: dict,
                 h: torch.Tensor, pos: int) -> torch.Tensor:
    B = h.shape[0]
    x = norm(cfg.norm, h, p["norm1"])
    q = (x @ p["q"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    k = (x @ p["k"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["v"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"]["scale"])
        k = rms_norm(k, p["k_norm"]["scale"])
    if spec.rope:
        pid = torch.full((B, 1), pos, device=h.device)
        q = apply_rope(q, pid, cfg.rope_theta)
        k = apply_rope(k, pid, cfg.rope_theta)

    s_c = c["k"].shape[1]
    slot = pos % s_c if spec.window > 0 else pos
    c["k"][:, slot] = k[:, 0]                 # in place: see the module note
    c["v"][:, slot] = v[:, 0]
    out = attn.attend_decode(q, c["k"], c["v"], pos, window=spec.window)
    h = h + out.reshape(B, 1, -1) @ p["o"]

    if spec.cross_attn:
        # every one of the encoder's frames is live: pos = Se - 1
        xc = norm(cfg.norm, h, p["norm_c"])
        qc = (xc @ p["qc"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        co = attn.attend_decode(qc, c["kc"], c["vc"], c["kc"].shape[1] - 1)
        h = h + co.reshape(B, 1, -1) @ p["oc"]
    return h


def _ffn_decode(cfg: ArchConfig, spec: LayerSpec, p: dict, h: torch.Tensor) -> torch.Tensor:
    x = norm(cfg.norm, h, p["norm2"])
    if spec.moe:
        # dense whatever sharding_mode says, as the reference's decode is: its
        # ep_axis hint changes no arithmetic, and a step's B tokens are too
        # few to split over the expert axis.  The tables must be unplaced.
        cap = moe_capacity(x.shape[0] * x.shape[1], cfg.moe_top_k, cfg.n_experts,
                           cfg.capacity_factor)
        y, _ = moe_apply(cfg.activation, p["moe"], x, top_k=cfg.moe_top_k, capacity=cap)
        return h + y
    return h + ffn_apply(cfg.activation, p["ffn"], x)


def _apply_layer_decode(cfg: ArchConfig, spec: LayerSpec, p: dict, c: dict,
                        h: torch.Tensor, pos: int) -> torch.Tensor:
    """One layer at one token; updates its cache entry ``c`` in place."""
    if spec.mixer == "attn":
        h = _attn_decode(cfg, spec, p, c, h, pos)
        return _ffn_decode(cfg, spec, p, h)
    if spec.mixer == "mamba":
        x = norm(cfg.norm, h, p["norm1"])
        y, st = mb.mamba_decode(p["mamba"], x, c, d_state=cfg.mamba_d_state,
                                d_conv=cfg.mamba_d_conv, dt_rank=cfg.mamba_dt_rank)
        for name in ("conv", "ssm"):
            c[name].copy_(st[name])          # in place: see the module note
        return _ffn_decode(cfg, spec, p, h + y)
    if spec.mixer == "rwkv":
        x = norm(cfg.norm, h, p["norm1"])
        y, tm_x, wkv = rk.time_mix_apply(
            p["time_mix"], x, c["tm_x"], c["wkv"],
            n_heads=cfg.rwkv_heads, head_dim=cfg.rwkv_head_dim)
        h = h + y
        x = norm(cfg.norm, h, p["norm2"])
        y, cm_x = rk.channel_mix_apply(p["channel_mix"], x, c["cm_x"])
        for name, new in (("tm_x", tm_x), ("cm_x", cm_x), ("wkv", wkv)):
            c[name].copy_(new)               # in place: see the module note
        return h + y
    raise ValueError(spec.mixer)


def decode_step(cfg: ArchConfig, params: Pytree, cache: Pytree,
                token: torch.Tensor) -> tuple[torch.Tensor, Pytree]:
    """One decode step. token (B, 1) integer -> (logits (B, 1, V), new cache)."""
    pos = int(cache["pos"])
    h = embed_tokens(cfg, params, token)
    if cfg.abs_pos:
        from repro_torch.models.layers import sinusoidal_at
        h = h + sinusoidal_at(torch.tensor([[pos]], device=h.device),
                              cfg.d_model).to(h.dtype)

    for j in range(cfg.n_periods):
        for i, spec in enumerate(cfg.pattern):
            h = _apply_layer_decode(cfg, spec, tree_index(params["layers"][i], j),
                                    tree_index(cache["layers"][i], j), h, pos)
    for i, spec in enumerate(cfg.remainder):
        h = _apply_layer_decode(cfg, spec, params["rem_layers"][i],
                                cache["rem"][i], h, pos)

    h = norm(cfg.norm, h, params["final_norm"])
    return unembed(cfg, params, h), dict(cache, pos=pos + 1)

