"""Analytical FLOP / byte model per (architecture x input shape).

Port of ``repro.launch.flops``, term for term in the reference's order, so
that every value equals the reference's as a Python float.  It is plain
arithmetic over :class:`~repro_torch.models.transformer.ArchConfig`,
:class:`~repro_torch.configs.shapes.InputShape` and
:func:`~repro_torch.models.moe.moe_capacity`.

The reference keeps it because XLA's ``cost_analysis`` counts ``lax.scan``
bodies once.  It counts what the reference's compiled graph executes:
full-S^2 masked chunked attention (``swa_skip=False``), MoE capacity
dispatch and remat recompute.  The port's flash kernels skip masked tiles,
so ``flops_total`` over-counts the port's work on the card.  A share of the
peak that a step reaches is therefore stated on ``model_flops``
(6 N_active tokens for training, 2 N_active tokens otherwise), which does
not depend on the implementation.

All counts are GLOBAL (whole step, all devices); callers divide by devices.
Matmul (m,k)x(k,n) = 2*m*k*n FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.shapes import InputShape
from repro_torch.models.moe import moe_capacity
from repro_torch.models.transformer import ArchConfig, LayerSpec


@dataclass
class CostBreakdown:
    flops_fwd: float            # one forward pass
    flops_total: float          # step total (train: fwd+bwd(+remat); decode: fwd)
    param_bytes: float          # model parameter bytes (all params, once)
    state_bytes: float          # KV cache / recurrent state bytes (decode)
    hbm_bytes: float            # estimated HBM traffic for the step (global)
    model_flops: float          # 6·N_active·D reference (the "useful" FLOPs)
    n_params: float
    n_active_params: float

    def as_dict(self) -> dict:
        return self.__dict__.copy()


# --------------------------------------------------------------------------- #
# Parameter counts
# --------------------------------------------------------------------------- #

def _layer_params(cfg: ArchConfig, spec: LayerSpec) -> tuple[float, float]:
    """(total, active) parameter count for one layer."""
    D = cfg.d_model
    total = active = 0.0
    if spec.mixer == "attn":
        a = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
            + cfg.n_heads * cfg.head_dim * D
        if spec.cross_attn:
            a *= 2
        total += a
        active += a
    elif spec.mixer == "mamba":
        di, N, r = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_dt_rank
        a = D * 2 * di + cfg.mamba_d_conv * di + di * (r + 2 * N) + r * di \
            + di * N + di * D
        total += a
        active += a
    elif spec.mixer == "rwkv":
        hd = cfg.rwkv_head_dim
        H = cfg.rwkv_heads
        a = 4 * D * H * hd + D * cfg.rwkv_lora_rank + cfg.rwkv_lora_rank * H * hd \
            + H * hd * D
        cm = D * cfg.d_ff + cfg.d_ff * D + D * D
        total += a + cm
        active += a + cm
        return total, active

    n_mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    if spec.moe:
        F = cfg.moe_d_ff or cfg.d_ff
        total += cfg.n_experts * n_mats * D * F + D * cfg.n_experts
        active += cfg.moe_top_k * n_mats * D * F + D * cfg.n_experts
        if cfg.moe_shared_expert:
            total += n_mats * D * F
            active += n_mats * D * F
    else:
        total += n_mats * D * cfg.d_ff
        active += n_mats * D * cfg.d_ff
    return total, active


def param_counts(cfg: ArchConfig) -> tuple[float, float]:
    """(total, active) including embeddings and encoder."""
    total = active = 0.0
    specs = list(cfg.pattern) * cfg.n_periods + list(cfg.remainder)
    for spec in specs:
        t, a = _layer_params(cfg, spec)
        total += t
        active += a
    emb = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    total += emb
    active += emb
    if cfg.encoder is not None:
        e = cfg.encoder
        enc_layer = 4 * cfg.d_model * cfg.d_model + 2 * cfg.d_model * e.d_ff
        total += e.n_layers * enc_layer
        active += e.n_layers * enc_layer
    return total, active


# --------------------------------------------------------------------------- #
# Forward FLOPs
# --------------------------------------------------------------------------- #

def _attn_flops(cfg: ArchConfig, spec: LayerSpec, B: int, S: int,
                *, swa_skip: bool = False, chunk: int = 512) -> float:
    D = cfg.d_model
    Hq, hd = cfg.n_heads, cfg.head_dim
    proj = 2 * B * S * D * (Hq + 2 * cfg.n_kv_heads) * hd + 2 * B * S * Hq * hd * D
    if S >= 2048:
        # chunked attention: baseline computes ALL (nq × nk) blocks with
        # masking; swa_skip computes only live blocks (§Perf optimisation)
        nq = nk = S // min(chunk, S)
        if swa_skip and spec.window > 0:
            # static banded unroll: per q block, blocks [lo(i), hi(i)]
            c = min(chunk, S)
            live = 0
            for i in range(nq):
                lo = max(0, (i * c - spec.window + 1) // c)
                hi = min(nk - 1, ((i + 1) * c - 1) // c)
                live += hi - lo + 1
        else:
            live = nq * nk  # masked scan computes every block (global layers)
        kv_pairs = live * min(chunk, S) ** 2
    else:
        kv_pairs = S * S
    score_av = 4 * B * Hq * hd * kv_pairs
    total = proj + score_av
    if spec.cross_attn and cfg.encoder is not None:
        Se = cfg.encoder.n_frames
        total += (2 * B * S * D * Hq * hd + 2 * B * Se * D * 2 * cfg.n_kv_heads * hd
                  + 4 * B * Hq * hd * S * Se + 2 * B * S * Hq * hd * D)
    return total


def _attn_decode_flops(cfg: ArchConfig, spec: LayerSpec, B: int, S: int) -> float:
    D, Hq, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    s_c = min(spec.window, S) if spec.window > 0 else S
    proj = 2 * B * D * (Hq + 2 * cfg.n_kv_heads) * hd + 2 * B * Hq * hd * D
    score_av = 4 * B * Hq * hd * s_c
    total = proj + score_av
    if spec.cross_attn and cfg.encoder is not None:
        total += 2 * B * D * Hq * hd + 4 * B * Hq * hd * cfg.encoder.n_frames \
                 + 2 * B * Hq * hd * D
    return total


def _ffn_flops(cfg: ArchConfig, spec: LayerSpec, tokens: float) -> float:
    D = cfg.d_model
    n_mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    if spec.moe:
        F = cfg.moe_d_ff or cfg.d_ff
        cap = moe_capacity(int(tokens), cfg.moe_top_k, cfg.n_experts,
                           cfg.capacity_factor)
        expert = 2 * cfg.n_experts * cap * n_mats * D * F
        router = 2 * tokens * D * cfg.n_experts
        shared = 2 * tokens * n_mats * D * F if cfg.moe_shared_expert else 0.0
        return expert + router + shared
    return 2 * tokens * n_mats * D * cfg.d_ff


def _mixer_flops(cfg: ArchConfig, spec: LayerSpec, B: int, S: int,
                 *, decode: bool, swa_skip: bool = False) -> float:
    D = cfg.d_model
    tokens = B * (1 if decode else S)
    if spec.mixer == "attn":
        return (_attn_decode_flops(cfg, spec, B, S) if decode
                else _attn_flops(cfg, spec, B, S, swa_skip=swa_skip))
    if spec.mixer == "mamba":
        di, N, r = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_dt_rank
        return tokens * (2 * D * 2 * di + 2 * cfg.mamba_d_conv * di
                         + 2 * di * (r + 2 * N) + 2 * r * di
                         + 6 * di * N + 2 * di * D)
    if spec.mixer == "rwkv":
        hd, H = cfg.rwkv_head_dim, cfg.rwkv_heads
        tm = tokens * (8 * D * H * hd + 2 * D * cfg.rwkv_lora_rank
                       + 2 * cfg.rwkv_lora_rank * H * hd + 5 * H * hd * hd
                       + 2 * H * hd * D)
        cm = tokens * (2 * D * cfg.d_ff + 2 * cfg.d_ff * D + 2 * D * D)
        return tm + cm
    raise ValueError(spec.mixer)


def forward_flops(cfg: ArchConfig, B: int, S: int, *, decode: bool = False,
                  swa_skip: bool = False) -> float:
    tokens = B * (1 if decode else S)
    total = 0.0
    specs = list(cfg.pattern) * cfg.n_periods + list(cfg.remainder)
    for spec in specs:
        total += _mixer_flops(cfg, spec, B, S, decode=decode, swa_skip=swa_skip)
        if spec.mixer != "rwkv":
            total += _ffn_flops(cfg, spec, tokens)
    total += 2 * tokens * cfg.d_model * cfg.padded_vocab        # unembed
    if cfg.encoder is not None and not decode:
        e = cfg.encoder
        Se = e.n_frames
        enc_attn = 2 * B * Se * cfg.d_model * 4 * cfg.d_model + 4 * B * e.n_heads \
            * (cfg.d_model // e.n_heads) * Se * Se
        enc_ffn = 2 * B * Se * 2 * cfg.d_model * e.d_ff
        total += e.n_layers * (enc_attn + enc_ffn)
    return total


# --------------------------------------------------------------------------- #
# HBM traffic estimate
# --------------------------------------------------------------------------- #

def _dtype_bytes(cfg: ArchConfig) -> int:
    return 2 if cfg.param_dtype == "bfloat16" else 4


def state_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    """Decode cache bytes (KV / conv / ssm / wkv)."""
    by = _dtype_bytes(cfg)
    total = 0.0
    specs = list(cfg.pattern) * cfg.n_periods + list(cfg.remainder)
    for spec in specs:
        if spec.mixer == "attn":
            s_c = min(spec.window, S) if spec.window > 0 else S
            total += 2 * B * s_c * cfg.n_kv_heads * cfg.head_dim * by
            if spec.cross_attn and cfg.encoder is not None:
                total += 2 * B * cfg.encoder.n_frames * cfg.n_kv_heads * cfg.head_dim * by
        elif spec.mixer == "mamba":
            total += B * (cfg.mamba_d_conv - 1) * cfg.mamba_d_inner * by \
                     + B * cfg.mamba_d_inner * cfg.mamba_d_state * 4
        elif spec.mixer == "rwkv":
            total += 2 * B * cfg.d_model * by \
                     + B * cfg.rwkv_heads * cfg.rwkv_head_dim ** 2 * 4
    return total


def step_cost(cfg: ArchConfig, shape: InputShape, *, swa_skip: bool = False
              ) -> CostBreakdown:
    B, S = shape.global_batch, shape.seq_len
    by = _dtype_bytes(cfg)
    n_total, n_active = param_counts(cfg)
    pbytes = n_total * by
    decode = shape.kind == "decode"
    fwd = forward_flops(cfg, B, S, decode=decode, swa_skip=swa_skip)

    if shape.kind == "train":
        # bwd = 2×fwd; full remat re-runs fwd once more
        mult = 4.0 if cfg.remat else 3.0
        flops_total = fwd * mult
        tokens = B * S
        act_traffic = 12 * tokens * cfg.d_model * by * cfg.n_layers
        # params: read fwd + read bwd (+ remat read) + grad write; Adam m/v r+w fp32
        hbm = pbytes * (4 if cfg.remat else 3) + n_total * (4 * 4) + act_traffic
        model_flops = 6 * n_active * tokens
        sbytes = 0.0
    elif shape.kind == "prefill":
        flops_total = fwd
        tokens = B * S
        act_traffic = 6 * tokens * cfg.d_model * by * cfg.n_layers
        hbm = pbytes + act_traffic
        model_flops = 2 * n_active * tokens
        sbytes = 0.0
    else:  # decode
        flops_total = fwd
        sbytes = state_bytes(cfg, B, S)
        hbm = pbytes + sbytes + 2 * B * cfg.d_model * cfg.n_layers * by
        model_flops = 2 * n_active * B
    return CostBreakdown(
        flops_fwd=fwd, flops_total=flops_total, param_bytes=pbytes,
        state_bytes=sbytes, hbm_bytes=hbm, model_flops=model_flops,
        n_params=n_total, n_active_params=n_active)
