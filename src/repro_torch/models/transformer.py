"""Unified architecture machinery for the LM zoo.

Port of ``repro.models.transformer``.  Layers are described by a repeating
**pattern** of :class:`LayerSpec` (e.g. gemma3 = 5 x local-SWA + 1 x
global).  Parameters keep the reference's layout key for key, so weights
carry across one to one (``repro_torch.interop.lm_params_from_numpy``):
``params["layers"]`` is a list over pattern positions whose leaves are
stacked over ``n_periods``, and ``params["rem_layers"]`` holds the layers
left over when ``n_layers % len(pattern) != 0``.  The reference's
``lax.scan`` over periods is a Python loop that indexes the stack.

Every configuration of ``configs/`` runs: attention (full, sliding-window,
GQA, QK-norm, RoPE), Mamba and RWKV6 mixers with dense and MoE FFNs —
gemma3-4b, gemma-7b, h2o-danube-3-4b, minitron-8b, internvl2-2b's language
backbone, rwkv6-3b, jamba-1.5-large-398b, llama4-maverick-400b-a17b,
grok-1-314b — and whisper-large-v3's encoder-decoder: :func:`encode` over
the stub frontend's frame embeddings (the caller passes ``enc_embeds``
(B, n_frames, d_model); there is no mel or conv frontend, nor in the
reference) and the decoder's cross-attention over its output.  MoE layers
take the reference's plain ``moe_apply``, except under
``sharding_mode="ep_tp"`` with a gated activation inside
``launch.mesh.use_mesh`` of a mesh whose ``data`` size divides
``n_experts``: then, as in the reference, the expert-parallel
``moe_sharded.moe_apply_shard_map`` over that mesh.

Products follow jnp's type promotion (:func:`~repro_torch.models.layers.
matmul`): float32 frames into a bf16 model run the encoder in float32, as
the reference does, where ``@`` in PyTorch would raise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import rwkv as rk
from repro_torch.models.layers import (
    Init,
    apply_rope,
    dense_init,
    ffn_apply,
    ffn_init,
    init_norm,
    is_gated,
    matmul,
    norm,
    rms_norm,
    sinusoidal_positions,
)
from repro_torch.models.moe import moe_apply, moe_capacity, moe_init
from repro_torch.models.moe_sharded import ambient_mesh_shape, moe_apply_shard_map
from repro_torch.utils.tree import tree_index

Pytree = Any


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # attn | mamba | rwkv
    window: int = 0              # 0 = full attention, >0 = sliding window
    rope: bool = True
    moe: bool = False
    causal: bool = True
    cross_attn: bool = False     # decoder cross-attention (whisper)


# the encoder's layers: non-causal self-attention without rope
ENCODER_LAYER = LayerSpec(mixer="attn", rope=False, causal=False)


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_heads: int
    d_ff: int
    n_frames: int = 1500         # whisper conv-frontend output length (stub)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    qk_norm: bool = False
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # RWKV
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    # encoder-decoder / frontends
    encoder: EncoderConfig | None = None
    frontend: str = "tokens"     # tokens | audio_stub | vision_stub
    abs_pos: bool = False        # add sinusoidal absolute positions (whisper)
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"
    remat: bool = True
    # tp | fsdp_tp | ep_tp.  The port runs tp and fsdp_tp as one process on
    # one device (no GSPMD); ep_tp takes moe_sharded.moe_apply_shard_map
    # for the MoE layers inside launch.mesh.use_mesh (see _ffn_sublayer)
    sharding_mode: str = "tp"
    swa_skip: bool = False       # the reference's GSPMD chunk skipping; unused here
    attn_batch_axes: tuple | None = None   # a mesh hint of the reference; unused here
    vocab_pad_multiple: int = 2048  # Megatron-style padding so vocab shards evenly
    # provenance
    source: str = ""

    # ------------------------------------------------------------------ #
    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> tuple[LayerSpec, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        return max(self.d_model // 16, 8)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """A small same-family variant for CPU smoke tests (<=2 pattern
        periods, d_model <= 512, <=4 experts)."""
        d_model = min(self.d_model, 256)
        head_dim = 32
        n_heads = max(self.n_heads // 8, 2)
        n_kv = max(min(self.n_kv_heads, n_heads), 1)
        changes = dict(
            n_layers=len(self.pattern) * min(self.n_periods, 1) or len(self.pattern),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            rwkv_head_dim=32,
            rwkv_lora_rank=16,
            param_dtype="float32",
            remat=False,
            vocab_pad_multiple=1,
        )
        if self.encoder is not None:
            changes["encoder"] = EncoderConfig(
                n_layers=2, n_heads=n_heads, d_ff=min(self.encoder.d_ff, 512),
                n_frames=16)
        # shrink sliding windows so short smoke sequences exercise the ring buffer
        changes["pattern"] = tuple(
            dataclasses.replace(s, window=min(s.window, 8)) if s.window else s
            for s in self.pattern)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


# --------------------------------------------------------------------------- #
# Parameter construction
# --------------------------------------------------------------------------- #

def _init_layer(cfg: ArchConfig, spec: LayerSpec, init: Init) -> dict:
    dt = cfg.dtype
    D = cfg.d_model
    p: dict = {}
    if spec.mixer == "attn":
        p["norm1"] = init_norm(init, cfg.norm, D, dt)
        p["q"] = dense_init(init, D, cfg.n_heads * cfg.head_dim, dt)
        p["k"] = dense_init(init, D, cfg.n_kv_heads * cfg.head_dim, dt)
        p["v"] = dense_init(init, D, cfg.n_kv_heads * cfg.head_dim, dt)
        p["o"] = dense_init(init, cfg.n_heads * cfg.head_dim, D, dt)
        if cfg.qk_norm:
            p["q_norm"] = {"scale": init.full((cfg.head_dim,), 0.0, dt)}
            p["k_norm"] = {"scale": init.full((cfg.head_dim,), 0.0, dt)}
        if spec.cross_attn:
            p["norm_c"] = init_norm(init, cfg.norm, D, dt)
            p["qc"] = dense_init(init, D, cfg.n_heads * cfg.head_dim, dt)
            p["kc"] = dense_init(init, D, cfg.n_kv_heads * cfg.head_dim, dt)
            p["vc"] = dense_init(init, D, cfg.n_kv_heads * cfg.head_dim, dt)
            p["oc"] = dense_init(init, cfg.n_heads * cfg.head_dim, D, dt)
    elif spec.mixer == "mamba":
        p["norm1"] = init_norm(init, cfg.norm, D, dt)
        p["mamba"] = mb.mamba_init(init, D, cfg.mamba_d_inner, cfg.mamba_d_state,
                                   cfg.mamba_d_conv, cfg.mamba_dt_rank, dt)
    elif spec.mixer == "rwkv":
        p["norm1"] = init_norm(init, cfg.norm, D, dt)
        p["time_mix"] = rk.rwkv_time_mix_init(
            init, D, cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.rwkv_lora_rank, dt)
        p["norm2"] = init_norm(init, cfg.norm, D, dt)
        p["channel_mix"] = rk.rwkv_channel_mix_init(init, D, cfg.d_ff, dt)
        return p
    else:
        raise ValueError(spec.mixer)

    p["norm2"] = init_norm(init, cfg.norm, D, dt)
    if spec.moe:
        p["moe"] = moe_init(init, cfg.activation, D, cfg.moe_d_ff or cfg.d_ff,
                            cfg.n_experts, dt, cfg.moe_shared_expert)
    else:
        p["ffn"] = ffn_init(init, cfg.activation, D, cfg.d_ff, dt)
    return p


def _stack(trees: list) -> Pytree:
    """Stack a list of same-structure trees leaf by leaf (leading axis)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def _init_tree(cfg: ArchConfig, init: Init) -> Pytree:
    dt = cfg.dtype
    params: dict = {
        "embed": init.normal((cfg.padded_vocab, cfg.d_model), 0.02, dt),
        "final_norm": init_norm(init, cfg.norm, cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(init, cfg.d_model, cfg.padded_vocab, dt)
    if cfg.n_periods > 0:
        params["layers"] = _stack([[_init_layer(cfg, spec, init) for spec in cfg.pattern]
                                   for _ in range(cfg.n_periods)])
    params["rem_layers"] = [_init_layer(cfg, spec, init) for spec in cfg.remainder]
    if cfg.encoder is not None:
        ecfg = _encoder_cfg(cfg)
        params["encoder"] = {
            "layers": [_init_layer(ecfg, ENCODER_LAYER, init)
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": init_norm(init, "layernorm", cfg.d_model, dt),
        }
    return params


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    enc = cfg.encoder
    return dataclasses.replace(
        cfg, n_heads=enc.n_heads, n_kv_heads=enc.n_heads, d_ff=enc.d_ff,
        head_dim=cfg.d_model // enc.n_heads, qk_norm=False, activation="gelu",
        norm="layernorm")


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Pytree:
    """Random parameters in the reference's layout, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card unless
    the caller asks for the CPU).  Not the reference's numbers: carry its
    weights across with ``interop.lm_params_from_numpy`` to compare."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _init_tree(cfg, Init(gen, device))


def param_shapes(cfg: ArchConfig) -> Pytree:
    """The parameter tree as ``(shape, dtype)`` leaves, built on the
    ``meta`` device (no allocation) — the counterpart of the reference's
    ``param_specs`` (``eval_shape``)."""
    def leaf(t):
        return tuple(t.shape), t.dtype

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return leaf(x)
    return walk(_init_tree(cfg, Init(None, torch.device("meta"))))


# --------------------------------------------------------------------------- #
# Forward (eval / prefill)
# --------------------------------------------------------------------------- #

def _attn_sublayer(cfg: ArchConfig, spec: LayerSpec, p: dict, h: torch.Tensor,
                   pos_ids: torch.Tensor, enc_out: torch.Tensor | None) -> torch.Tensor:
    B, S, D = h.shape
    x = norm(cfg.norm, h, p["norm1"])
    q = matmul(x, p["q"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = matmul(x, p["k"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = matmul(x, p["v"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"]["scale"])
        k = rms_norm(k, p["k_norm"]["scale"])
    if spec.rope:
        q = apply_rope(q, pos_ids, cfg.rope_theta)
        k = apply_rope(k, pos_ids, cfg.rope_theta)
    # positions are 0..S-1 (forward builds them so), as both forms take them;
    # the reference's choice of form, which on CUDA reaches the kernel either way
    if S >= 2048:
        out = attn.attend_chunked(q, k, v, causal=spec.causal, window=spec.window)
    else:
        out = attn.attend_full(q, k, v, causal=spec.causal, window=spec.window)
    h = h + matmul(out.reshape(B, S, -1), p["o"])

    if spec.cross_attn and enc_out is not None:
        xc = norm(cfg.norm, h, p["norm_c"])
        Se = enc_out.shape[1]
        qc = matmul(xc, p["qc"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
        kc = matmul(enc_out, p["kc"]).reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
        vc = matmul(enc_out, p["vc"]).reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
        h = h + matmul(cross_attend(qc, kc, vc).reshape(B, S, -1), p["oc"])
    return h


def cross_attend(qc: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """The decoder's queries (B, S, Hq, hd) over the encoder's keys and
    values (B, Se, Hkv, hd), non-causal: ``attend_full(qc, kc, vc,
    causal=False)``, in the promoted dtype of the two (the kernels take one
    dtype; float32 frames into a bf16 model give float32 kc, vc) and
    returned in qc's dtype, as the reference's ``attend_full`` returns it."""
    dt = torch.promote_types(qc.dtype, kc.dtype)
    out = attn.attend_full(qc.to(dt), kc.to(dt), vc.to(dt), causal=False)
    return out.to(qc.dtype)


def _ffn_sublayer(cfg: ArchConfig, spec: LayerSpec, p: dict, h: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    x = norm(cfg.norm, h, p["norm2"])
    if spec.moe:
        T = x.shape[0] * x.shape[1]
        cap = moe_capacity(T, cfg.moe_top_k, cfg.n_experts, cfg.capacity_factor)
        if cfg.sharding_mode == "ep_tp":
            ms = ambient_mesh_shape()
            if (is_gated(cfg.activation) and ms.get("data")
                    and cfg.n_experts % ms["data"] == 0):
                baxes = ("pod", "data") if "pod" in ms else ("data",)
                y, aux = moe_apply_shard_map(
                    cfg.activation, p["moe"], x, top_k=cfg.moe_top_k,
                    capacity=cap, batch_axes=baxes)
                return h + y, aux
        y, aux = moe_apply(cfg.activation, p["moe"], x, top_k=cfg.moe_top_k, capacity=cap)
        return h + y, aux
    return (h + ffn_apply(cfg.activation, p["ffn"], x),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _apply_layer(cfg: ArchConfig, spec: LayerSpec, p: dict, h: torch.Tensor,
                 pos_ids: torch.Tensor, enc_out: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    if spec.mixer == "attn":
        h = _attn_sublayer(cfg, spec, p, h, pos_ids, enc_out)
        return _ffn_sublayer(cfg, spec, p, h)
    if spec.mixer == "mamba":
        x = norm(cfg.norm, h, p["norm1"])
        h = h + mb.mamba_apply(p["mamba"], x, d_state=cfg.mamba_d_state,
                               d_conv=cfg.mamba_d_conv, dt_rank=cfg.mamba_dt_rank)
        return _ffn_sublayer(cfg, spec, p, h)
    if spec.mixer == "rwkv":
        B = h.shape[0]
        st = rk.rwkv_init_state(B, cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim,
                                h.dtype, device=h.device)
        x = norm(cfg.norm, h, p["norm1"])
        y, _, _ = rk.time_mix_apply(p["time_mix"], x, st["tm_x"], st["wkv"],
                                    n_heads=cfg.rwkv_heads, head_dim=cfg.rwkv_head_dim)
        h = h + y
        x = norm(cfg.norm, h, p["norm2"])
        y, _ = rk.channel_mix_apply(p["channel_mix"], x, st["cm_x"])
        return h + y, torch.zeros((), dtype=torch.float32, device=h.device)
    raise ValueError(spec.mixer)


def backbone(cfg: ArchConfig, params: Pytree, h: torch.Tensor,
             pos_ids: torch.Tensor, enc_out: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply all layers to hidden states h (B, S, D), with the encoder's
    output ``enc_out`` (B, Se, D) for cross-attention layers (skipped where
    it is None, as in the reference). Returns (h, moe_aux).

    With ``cfg.remat`` and grad enabled each period's layers run under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
    ``period_body`` in ``jax.checkpoint``: the backward runs the period's
    forward again (its kernels launch twice).  The remainder layers are not
    wrapped, nor are they in the reference."""
    def period_body(j, h, aux, enc_out):
        for i, spec in enumerate(cfg.pattern):
            h, a = _apply_layer(cfg, spec, tree_index(params["layers"][i], j), h, pos_ids,
                                enc_out)
            aux = aux + a
        return h, aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(cfg.n_periods):
        if remat:
            h, aux = checkpoint(period_body, j, h, aux, enc_out, use_reentrant=False)
        else:
            h, aux = period_body(j, h, aux, enc_out)
    for i, spec in enumerate(cfg.remainder):
        h, a = _apply_layer(cfg, spec, params["rem_layers"][i], h, pos_ids, enc_out)
        aux = aux + a
    return h, aux


def encode(cfg: ArchConfig, params: Pytree, enc_embeds: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over the stub frontend's frame embeddings
    (B, n_frames, D): sinusoidal positions added in the frames' own dtype,
    then per layer non-causal self-attention without rope and a GELU FFN
    (``_encoder_cfg``), then a final LayerNorm.  Returns (B, n_frames, D)
    in the frames' dtype promoted with the weights'."""
    if cfg.encoder is None:
        raise ValueError(f"{cfg.name} has no encoder")
    B, S = enc_embeds.shape[:2]
    pos = sinusoidal_positions(S, cfg.d_model, device=enc_embeds.device)
    h = enc_embeds + pos.to(enc_embeds.dtype)[None]
    ecfg = _encoder_cfg(cfg)
    pos_ids = torch.arange(S, device=h.device)[None].expand(B, S)
    for lp in params["encoder"]["layers"]:
        h = _attn_sublayer(ecfg, ENCODER_LAYER, lp, h, pos_ids, None)
        h, _ = _ffn_sublayer(ecfg, ENCODER_LAYER, lp, h)
    return norm("layernorm", h, params["encoder"]["final_norm"])


def embed_tokens(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows scaled by sqrt(d_model) — the scalar rounded to the
    embedding's dtype first, as ``jnp.asarray(d_model ** 0.5, h.dtype)``
    rounds it (in bf16, sqrt(2560) = 50.596 becomes 50.5; a Python float
    would multiply by the unrounded value)."""
    h = params["embed"].to(cfg.dtype)[tokens]
    return h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)


def forward(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None, enc_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full forward: returns (logits (B,S,V), final hidden (B,S,D), moe_aux).
    For an encoder-decoder configuration given ``enc_embeds`` (B, n_frames,
    D) the encoder runs first and the decoder's cross-attention reads its
    output; without an encoder they are ignored, as in the reference."""
    if embeds is None:
        if tokens is None:
            raise ValueError("forward needs tokens or embeds")
        h = embed_tokens(cfg, params, tokens)
    else:
        h = embeds.to(cfg.dtype)
    B, S = h.shape[:2]
    pos_ids = torch.arange(S, device=h.device)[None].expand(B, S)
    if cfg.abs_pos:
        h = h + sinusoidal_positions(S, cfg.d_model, device=h.device).to(h.dtype)[None]
    enc_out = None
    if cfg.encoder is not None and enc_embeds is not None:
        enc_out = encode(cfg, params, enc_embeds)
    h, aux = backbone(cfg, params, h, pos_ids, enc_out)
    h = norm(cfg.norm, h, params["final_norm"])
    return unembed(cfg, params, h), h, aux


def unembed(cfg: ArchConfig, params: Pytree, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["lm_head"]
    if cfg.padded_vocab != cfg.vocab_size:
        # mask Megatron-style vocab padding so it never receives probability
        mask = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab_size
        logits = torch.where(mask, logits, logits.new_full((), -1e30))
    return logits
