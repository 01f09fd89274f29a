"""Shared layer primitives: norms, activations, RoPE, projections.

Port of ``repro.models.layers``: plain functions over tensors, with the
reference's weight layouts (matmul weights are (in_features, out_features);
fused-head projections keep heads flattened into the feature dim).  Norms
and RoPE compute in float32 and cast back to the input's dtype, as the
reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm(kind: str, x: torch.Tensor, p: dict) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


class Init:
    """Draws parameters from one ``torch.Generator`` on its device, or makes
    shape-only tensors on the ``meta`` device (``generator=None``)."""

    def __init__(self, generator: torch.Generator | None, device: torch.device):
        self.generator, self.device = generator, torch.device(device)

    def normal(self, shape: tuple[int, ...], std: float, dtype: torch.dtype) -> torch.Tensor:
        if self.generator is None:
            return torch.empty(shape, dtype=dtype, device="meta")
        x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.generator.device)
        # in place: one float32 copy of the largest leaf at a time (12.9 GB for
        # jamba's (16, 8192, 24576) experts), the same numbers as x * std
        return x.mul_(std).to(self.device, dtype)

    def full(self, shape: tuple[int, ...], value: float, dtype: torch.dtype) -> torch.Tensor:
        device = "meta" if self.generator is None else self.device
        return torch.full(shape, value, dtype=dtype, device=device)


def init_norm(init: Init, kind: str, dim: int, dtype: torch.dtype) -> dict:
    if kind == "rmsnorm":
        return {"scale": init.full((dim,), 0.0, dtype)}
    return {"scale": init.full((dim,), 1.0, dtype), "bias": init.full((dim,), 0.0, dtype)}


def dense_init(init: Init, in_dim: int, out_dim: int, dtype: torch.dtype) -> torch.Tensor:
    return init.normal((in_dim, out_dim), (1.0 / in_dim) ** 0.5, dtype)


# --------------------------------------------------------------------------- #
# Activations / gated FFN
# --------------------------------------------------------------------------- #

def activation(kind: str, gate: torch.Tensor, up: torch.Tensor | None) -> torch.Tensor:
    """Gated activations take (gate, up); plain ones ignore ``up``."""
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    if kind == "relu2":
        r = F.relu(gate)
        return r * r
    raise ValueError(f"unknown activation {kind}")


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's type promotion: operands of two float dtypes are
    both cast to the wider one first (float32 frames into a bf16 model),
    where PyTorch's ``@`` would raise."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def ffn_apply(act: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense FFN. Params: w_gate (D,F) [+ w_up (D,F) if gated], w_down (F,D)."""
    gate = matmul(x, p["w_gate"])
    up = matmul(x, p["w_up"]) if is_gated(act) else None
    return matmul(activation(act, gate, up), p["w_down"])


def ffn_init(init: Init, act: str, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    p = {"w_gate": dense_init(init, d_model, d_ff, dtype),
         "w_down": dense_init(init, d_ff, d_model, dtype)}
    if is_gated(act):
        p["w_up"] = dense_init(init, d_model, d_ff, dtype)
    return p


# --------------------------------------------------------------------------- #
# Rotary position embeddings
# --------------------------------------------------------------------------- #

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)           # (hd/2,)
    ang = positions[..., None].float() * freqs                      # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                              # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (n_pos, dim)."""
    return sinusoidal_at(torch.arange(n_pos, dtype=torch.float32, device=device), dim)


def sinusoidal_at(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding rows for arbitrary positions."""
    pos = positions.float()[..., None]
    inv = torch.exp(-math.log(10000.0)
                    * torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
                    / max(dim // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
