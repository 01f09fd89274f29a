"""Pearson correlation matrix of prototype rows: plain PyTorch version +
Hopper kernel.

Port of ``repro.kernels.pearson`` (``pearson_matrix_pallas``) and of the
engine's jnp form ``repro.core.pearson.pearson_matrix``.  For an (m, D)
float32 matrix of client prototypes:

    mu_i     = mean_d x[i, d]                       (over the true D)
    norm_i   = max(sqrt(sum_d (x[i, d] - mu_i)^2), eps)
    corr[i,j] = clip(sum_d (x[i,d]-mu_i)(x[j,d]-mu_j) / (norm_i norm_j), -1, 1)

A constant row has norm ``eps`` and a zero centred row, so its correlations
are 0.  Sums run in another order than either JAX form; the two agree to
float32 rounding (the tests hold them to atol 1e-5, the reference's own
tolerance).

:func:`pearson_rows` picks by where the tensor lies: a CPU tensor takes
:func:`pearson_plain`, a CUDA tensor the hand-written kernel
(``csrc/pearson.cu``: one launch, each block computing the statistics of
its own tile's rows) through :func:`pearson_cuda` — which launches or
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

EPS = 1e-8
TILE = 16                 # the kernel's output tile side (csrc/pearson.cu)

# Launches of pearson_cuda since the last reset (set it to 0): one a call.
launches = 0


def _check(protos: torch.Tensor) -> None:
    if protos.dtype != torch.float32 or protos.dim() != 2:
        raise TypeError(f"pearson takes (m, D) float32 prototypes, got "
                        f"{tuple(protos.shape)} {protos.dtype}")


def pearson_plain(protos: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """(m, D) float32 -> (m, m) float32, in plain PyTorch on the tensor's
    own device (the reference for the kernel, and the CPU path)."""
    _check(protos)
    c = protos - protos.mean(dim=1, keepdim=True)
    norm = torch.clamp(torch.sqrt((c * c).sum(dim=1)), min=eps)
    corr = (c @ c.T) / (norm[:, None] * norm[None, :])
    return torch.clamp(corr, -1.0, 1.0)


def _kernel() -> ctypes.CDLL:
    lib = _build.load("pearson.cu")
    fn = lib.pearson_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def pearson_cuda(protos: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """(m, D) float32 on a CUDA device -> (m, m) float32, by one launch of
    the hand-written kernel on the current stream.  Raises on anything the
    kernel does not take, and if the launch is refused."""
    global launches
    _check(protos)
    if protos.device.type != "cuda":
        raise ValueError(f"pearson_cuda needs a CUDA tensor, got {protos.device}")
    if not protos.is_contiguous():
        raise ValueError("pearson_cuda needs contiguous rows")
    m, d = protos.shape
    if m == 0 or d == 0 or m > 65535 * 16:
        raise ValueError(f"pearson_cuda takes 1 <= m <= {65535 * 16} and "
                         f"D >= 1, got ({m}, {d})")
    out = torch.empty((m, m), dtype=torch.float32, device=protos.device)
    lib = _kernel()
    with torch.cuda.device(protos.device):
        stream = torch.cuda.current_stream(protos.device).cuda_stream
        err = lib.pearson_launch(protos.data_ptr(), out.data_ptr(), m, d, eps,
                                 stream)
    if err:
        raise RuntimeError(f"pearson kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def pearson_rows(protos: torch.Tensor) -> torch.Tensor:
    """(m, D) float32 prototypes -> (m, m) Pearson matrix: the plain version
    for a CPU tensor, the Hopper kernel for a CUDA tensor."""
    if protos.device.type == "cpu":
        return pearson_plain(protos)
    if protos.device.type == "cuda":
        return pearson_cuda(protos)
    raise ValueError(f"pearson_rows: no path for device {protos.device}")
