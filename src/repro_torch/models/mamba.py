"""Mamba (selective SSM) mixer for the Jamba hybrid architecture.

Port of ``repro.models.mamba``: in_proj -> (x, z); causal depthwise conv;
selective (input-dependent) dt, B, C; diagonal state-space scan; gated
output.  The scan (the reference's ``lax.scan`` over time, and its decode
step) goes through ``repro_torch.kernels.ops.selective_scan``: the
hand-written kernel on CUDA tensors, the plain step loop on CPU tensors.
Decode is the same call at S = 1 from the carried state.

Rounding follows the reference's order: the conv is the Python sum of the
d_conv shifted products in the model dtype, then ``+ conv_b``, then SiLU;
``proj`` becomes float32 only after the ``x_proj`` product; softplus is
``logaddexp(x, 0)`` as ``jax.nn.softplus`` is (``F.softplus`` returns x
above its threshold of 20).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import Init, dense_init


def mamba_init(init: Init, d_model: int, d_inner: int, d_state: int, d_conv: int,
               dt_rank: int, dtype: torch.dtype) -> dict:
    """Shapes and initial values of ``repro.models.mamba.mamba_init``."""
    f32 = torch.float32
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=f32)).expand(d_inner, d_state)
    return {
        "in_proj": dense_init(init, d_model, 2 * d_inner, dtype),
        "conv_w": init.normal((d_conv, d_inner), (1.0 / d_conv) ** 0.5, dtype),
        "conv_b": init.full((d_inner,), 0.0, dtype),
        "x_proj": dense_init(init, d_inner, dt_rank + 2 * d_state, dtype),
        "dt_proj": dense_init(init, dt_rank, d_inner, dtype),
        "dt_bias": init.full((d_inner,), -4.6, f32),        # softplus^-1(0.01)
        "A_log": a_log.to("meta" if init.generator is None else init.device).clone(),
        "D": init.full((d_inner,), 1.0, f32),
        "out_proj": dense_init(init, d_inner, d_model, dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _selective_terms(p: dict, xc: torch.Tensor, d_state: int, dt_rank: int):
    """xc (B, S, d_inner) -> dt (B, S, d_inner), Bm / Cm (B, S, d_state),
    float32; Bm and Cm are column slices of the ``x_proj`` output."""
    proj = (xc @ p["x_proj"]).float()
    dt_in = proj[..., :dt_rank]
    Bm = proj[..., dt_rank:dt_rank + d_state]
    Cm = proj[..., dt_rank + d_state:]
    dt = _softplus(dt_in @ p["dt_proj"].float() + p["dt_bias"])
    return dt, Bm, Cm


def mamba_apply(p: dict, x: torch.Tensor, *, d_state: int, d_conv: int,
                dt_rank: int) -> torch.Tensor:
    """Train / prefill path. x (B, S, D) -> (B, S, D)."""
    B, S, _ = x.shape
    xr, z = (x @ p["in_proj"]).chunk(2, dim=-1)                 # (B, S, d_inner)
    d_inner = xr.shape[-1]

    # causal depthwise conv over time
    pad = F.pad(xr, (0, 0, d_conv - 1, 0))
    xc = sum(pad[:, i:i + S, :] * p["conv_w"][i] for i in range(d_conv)) + p["conv_b"]
    xc = F.silu(xc)

    dt, Bm, Cm = _selective_terms(p, xc, d_state, dt_rank)
    A = -torch.exp(p["A_log"])                                   # (d_inner, N)
    h0 = torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device)
    y, _ = ops.selective_scan(dt, xc, Bm, Cm, A, p["D"], h0)
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"]


def mamba_init_state(batch: int, d_inner: int, d_state: int, d_conv: int,
                     dtype: torch.dtype, device=None) -> dict:
    return {"conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                               device=device)}


def mamba_decode(p: dict, x: torch.Tensor, state: dict, *, d_state: int,
                 d_conv: int, dt_rank: int) -> tuple[torch.Tensor, dict]:
    """Single-token step. x (B, 1, D) -> (B, 1, D), new state (new tensors;
    ``state`` is not modified)."""
    xr, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)          # (B, d_inner)

    conv_buf = torch.cat([state["conv"], xr[:, None]], dim=1)   # (B, d_conv, di)
    xc = torch.einsum("bcd,cd->bd", conv_buf, p["conv_w"]) + p["conv_b"]
    # contiguous: on CUDA the einsum's product may come back (di, B)-major,
    # and the scan kernel reads x with unit stride over channels
    xc = F.silu(xc).contiguous()

    dt, Bm, Cm = _selective_terms(p, xc[:, None], d_state, dt_rank)
    A = -torch.exp(p["A_log"])
    y, h = ops.selective_scan(dt, xc[:, None], Bm, Cm, A, p["D"], state["ssm"])
    y = y[:, 0].to(x.dtype) * F.silu(z)
    return (y @ p["out_proj"])[:, None], {"conv": conv_buf[:, 1:], "ssm": h}
