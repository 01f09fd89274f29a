"""RWKV6 ("Finch") mixer: linear-attention recurrence with data-dependent
per-channel decay (arXiv:2404.05892).

Port of ``repro.models.rwkv``.

Time-mix:   r,k,v,g from token-shifted projections; decay
            w_t = exp(-exp(w0 + tanh(x~ A_w) B_w)) in (0,1) per channel;
            per-head state S (hd_k x hd_v):
                y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
                S_t = diag(w_t) S_{t-1} + k_t v_t^T
Channel-mix: token-shifted squared-ReLU MLP with sigmoid receptance gate.

The recurrence (the reference's ``lax.scan`` over time) goes through
``repro_torch.kernels.ops.rwkv6_wkv``: the hand-written kernel on CUDA
tensors, the plain step loop on CPU tensors, each differentiable through
its backward (``Rwkv6Fn``; it returns ds0 too, so a carried state
differentiates, though ``forward``'s zero state needs none).  Prefill and
decode (T = 1) take the same call, carrying the state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import Init, dense_init, rms_norm


def rwkv_time_mix_init(init: Init, d_model: int, n_heads: int, head_dim: int,
                       lora_rank: int, dtype: torch.dtype) -> dict:
    D, HD = d_model, n_heads * head_dim
    f32 = torch.float32
    return {
        "mu": init.full((5, D), 0.5, f32),                   # shift mix for r,k,v,g,w
        "w_r": dense_init(init, D, HD, dtype),
        "w_k": dense_init(init, D, HD, dtype),
        "w_v": dense_init(init, D, HD, dtype),
        "w_g": dense_init(init, D, HD, dtype),
        "w0": init.full((HD,), -6.0, f32),
        "w_lora_a": dense_init(init, D, lora_rank, f32),
        "w_lora_b": dense_init(init, lora_rank, HD, f32),
        "u": init.normal((n_heads, head_dim), 0.1, f32),
        "ln_scale": init.full((HD,), 0.0, dtype),
        "w_o": dense_init(init, HD, D, dtype),
    }


def rwkv_channel_mix_init(init: Init, d_model: int, d_ff: int,
                          dtype: torch.dtype) -> dict:
    return {
        "mu": init.full((2, d_model), 0.5, torch.float32),   # shift mix for k, r
        "w_in": dense_init(init, d_model, d_ff, dtype),
        "w_out": dense_init(init, d_ff, d_model, dtype),
        "w_rec": dense_init(init, d_model, d_model, dtype),
    }


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: prepend x_prev (B, D), drop last. x (B, S, D)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0, 1): (B, S, D) -> (B, S, D) fp32."""
    lo = torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    return torch.exp(-torch.exp(p["w0"] + lo))


def time_mix_apply(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                   wkv_state: torch.Tensor, *, n_heads: int, head_dim: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (y, new_x_prev (B,D), new_wkv_state (B,H,hd,hd))."""
    B, S, D = x.shape
    xs = _shift(x, x_prev)

    def mix(i):
        return x + (xs - x) * p["mu"][i][None, None].to(x.dtype)
    xr, xk, xv, xg, xw = (mix(i) for i in range(5))

    H, hd = n_heads, head_dim
    r = (xr @ p["w_r"]).reshape(B, S, H, hd).float()
    k = (xk @ p["w_k"]).reshape(B, S, H, hd).float()
    v = (xv @ p["w_v"]).reshape(B, S, H, hd).float()
    g = xg @ p["w_g"]
    w = _decay(p, xw).reshape(B, S, H, hd)                   # (B,S,H,hd)

    # (B, S, H, hd) views as (B, H, S, hd): the kernel reads them through
    # their strides and writes y where the reshape below wants it
    ys, new_state = ops.rwkv6_wkv(r.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), w.transpose(1, 2),
                                  p["u"], wkv_state)
    y = ys.transpose(1, 2).reshape(B, S, H * hd)              # (B,S,D')
    y = rms_norm(y.to(x.dtype), p["ln_scale"])
    y = y * F.silu(g)
    return y @ p["w_o"], x[:, -1], new_state


def channel_mix_apply(p: dict, x: torch.Tensor, x_prev: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    xs = _shift(x, x_prev)

    def mix(i):
        return x + (xs - x) * p["mu"][i][None, None].to(x.dtype)
    xk, xr = mix(0), mix(1)
    k = F.relu(xk @ p["w_in"])
    kv = (k * k) @ p["w_out"]
    r = torch.sigmoid(xr @ p["w_rec"])
    return r * kv, x[:, -1]


def rwkv_init_state(batch: int, d_model: int, n_heads: int, head_dim: int,
                    dtype: torch.dtype = torch.float32, device=None) -> dict:
    return {
        "tm_x": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "cm_x": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, n_heads, head_dim, head_dim), dtype=torch.float32,
                           device=device),
    }
