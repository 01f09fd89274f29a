"""GQA attention: full, chunked online-softmax, and single-token decode
against a KV cache.

Port of ``repro.models.attention``.  Shapes: q (B, Sq, Hq, hd), k/v
(B, Sk, Hkv, hd), Hq = G * Hkv; Sq != Sk in the decoder's cross-attention.

:func:`attend_full` and :func:`attend_chunked` compute the same function.
Both go through ``repro_torch.kernels.ops.attention``, the hand-written
flash-attention kernel on CUDA tensors, differentiable through its backward
kernel (``FlashAttentionFn``); on CPU tensors :func:`attend_full` is that
module's plain version (materialised scores, with the plain backward) and
:func:`attend_chunked` keeps the reference's online-softmax scan over query
and key chunks, which autograd differentiates.  The reference's banded ``skip_masked_chunks`` variant is a
GSPMD workaround with the same result and is not ported.
:func:`attend_decode` is plain PyTorch on both devices, as it is jnp in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(…, Sq, Sk) additive float32 bias. window > 0 = sliding window."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok = ok & (d >= 0)
    if window > 0:
        ok = ok & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, zero + NEG_INF)


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, hd) over k, v (B, Sk, Hkv, hd):
    materialised Sq x Sk scores on the CPU, the flash kernel on CUDA.
    Positions are 0..Sq-1 against 0..Sk-1 (the reference's defaults)."""
    return ops.attention(q, k, v, causal=causal, window=window)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   q_chunk: int = 512, k_chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention, O(chunk^2) live memory (CPU): a loop over
    query chunks, each with a running (max, sum, acc) over every key chunk,
    as the reference's ``lax.scan`` form.  The flash kernel on CUDA."""
    if q.device.type == "cuda":
        return ops.attention(q, k, v, causal=causal, window=window)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    nq, nk = Sq // q_chunk, Sk // k_chunk
    if Sq % q_chunk or Sk % k_chunk:
        raise ValueError(f"attend_chunked: S ({Sq}, {Sk}) is not a multiple of the "
                         f"chunks ({q_chunk}, {k_chunk})")
    qg = q.reshape(B, nq, q_chunk, Hkv, G, hd)
    kg = k.reshape(B, nk, k_chunk, Hkv, hd)
    vg = v.reshape(B, nk, k_chunk, Hkv, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
    blocks = []
    for qi in range(nq):
        qb = qg[:, qi].float() * scale                         # (B, qc, Hkv, G, hd)
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, device=q.device)
        s = torch.zeros((B, Hkv, G, q_chunk), device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, hd), device=q.device)
        for ki in range(nk):
            k_pos = ki * k_chunk + torch.arange(k_chunk, device=q.device)
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qb, kg[:, ki].float())
            sc = sc + _mask_bias(q_pos, k_pos, causal, window)
            new_m = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - new_m[..., None])
            corr = torch.exp(m - new_m)
            s = s * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                       vg[:, ki].float())
            m = new_m
        out = acc / torch.clamp(s, min=1e-30)[..., None]        # (B, Hkv, G, qc, hd)
        blocks.append(out.permute(0, 3, 1, 2, 4))               # (B, qc, Hkv, G, hd)
    out = torch.stack(blocks, dim=1).reshape(B, Sq, Hq, hd)
    return out.to(q.dtype)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos: int, *, window: int = 0) -> torch.Tensor:
    """One-token decode. q (B, 1, Hq, hd); caches (B, S, Hkv, hd); ``pos`` is
    the index of the current token (cache slots > pos are invalid).

    For sliding-window layers the cache is a ring buffer of size ``window``;
    validity is by slot-age rather than absolute position.
    """
    B, _, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    scores = scores / torch.sqrt(torch.tensor(float(hd)))
    slots = torch.arange(S, device=q.device)
    if window > 0:
        valid = slots < min(pos + 1, S)     # ring buffer, all slots live once warm
    else:
        valid = slots <= pos
    scores = torch.where(valid[None, None, None, :], scores,
                         scores.new_full((), NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.float())
    return out.reshape(B, 1, Hq, hd).to(q.dtype)
