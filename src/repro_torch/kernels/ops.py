"""Public wrappers for the port's hand-written kernels.

Counterpart of ``repro.kernels.ops``.  A wrapper takes the plain PyTorch
version for a CPU tensor and launches its Hopper kernel for a CUDA tensor;
it never falls back from one to the other.  All five of the reference's
kernels have a wrapper: ``fingerprint``, ``pearson``, ``cluster_aggregate``,
``attention``, ``rwkv6_wkv``; ``selective_scan`` (Mamba's recurrence, a
``lax.scan`` in the reference) has one too.  Those last three are
differentiable: they go through ``FlashAttentionFn`` / ``Rwkv6Fn`` /
``SelectiveScanFn`` on both devices, so a CPU tensor takes the plain
forward and the plain backward, a CUDA tensor the forward kernel and the
backward kernel.  ``batched_matmul`` (the client-stacked products in a
fixed order, which the reference leaves to XLA) is differentiable too,
through ``BatchedMatmulFn`` on a CUDA tensor; on a CPU tensor it is the one
exception to the rule above and keeps ``torch.matmul`` (see
``kernels/batched_matmul.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.batched_matmul import BatchedMatmulFn
from repro_torch.kernels.cluster_agg import cluster_mean_rows
from repro_torch.kernels.fingerprint import fingerprint_rows
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.pearson import pearson_rows
from repro_torch.kernels.rwkv6_scan import Rwkv6Fn
from repro_torch.kernels.selective_scan import SelectiveScanFn


def fingerprint(bits: torch.Tensor) -> torch.Tensor:
    """Per-client polynomial fingerprint residues: (m, N) int32 bit view of
    the rows -> (m, 2) int32 holding the uint32 residues."""
    return fingerprint_rows(bits)


def pearson(protos: torch.Tensor) -> torch.Tensor:
    """Pearson correlation matrix (m, D) float32 -> (m, m)."""
    return pearson_rows(protos)


def cluster_aggregate(rows: torch.Tensor, labels: torch.Tensor,
                      n_clusters: int, weights: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Cluster-masked FedAvg over (m, N) float32 or bf16 client rows, in
    the round engine's fixed tree order."""
    return cluster_mean_rows(rows, labels, n_clusters, weights)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flash attention (causal / sliding-window / full, GQA): q (B, Sq, Hq,
    hd), k and v (B, Sk, Hkv, hd) -> (B, Sq, Hq, hd), positions 0..Sq-1
    against 0..Sk-1; differentiable on both devices, Sq and Sk equal or
    not."""
    return FlashAttentionFn.apply(q, k, v, causal, window)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 wkv recurrence: r, k, v, w (B, H, T, hd), u (H, hd), s0
    (B, H, hd, hd) -> (y (B, H, T, hd), final state), differentiable."""
    return Rwkv6Fn.apply(r, k, v, w, u, s0)


def selective_scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba's selective scan: dt (B, S, di) float32, x (B, S, di), Bm and
    Cm (B, S, N) float32, A (di, N), D (di,), h0 (B, di, N) float32 ->
    (y (B, S, di) float32 with the skip term x D, final state),
    differentiable."""
    return SelectiveScanFn.apply(dt, x, Bm, Cm, A, D, h0)


def batched_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (m, M, K) | (M, K) @ b (m, K, N) -> (m, M, N)`` float32,
    differentiable.  A CUDA tensor takes ``BatchedMatmulFn``: the kernel
    forward and backward, each element summed in one fixed order whatever
    ``m``.  A CPU tensor keeps ``torch.matmul``, whose products are
    batch-invariant on the CPU already (``kernels/batched_matmul.py``)."""
    if b.device.type == "cpu":
        return torch.matmul(a, b)
    if b.device.type == "cuda":
        return BatchedMatmulFn.apply(a, b)
    raise ValueError(f"batched_matmul: no path for device {b.device}")
