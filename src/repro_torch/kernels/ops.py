"""Public wrappers for the port's hand-written kernels.

Counterpart of ``repro.kernels.ops``.  A wrapper takes the plain PyTorch
version for a CPU tensor and launches its Hopper kernel for a CUDA tensor;
it never falls back from one to the other.  All five of the reference's
kernels have a wrapper: ``fingerprint``, ``pearson``, ``cluster_aggregate``,
``attention``, ``rwkv6_wkv``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cluster_agg import cluster_mean_rows
from repro_torch.kernels.fingerprint import fingerprint_rows
from repro_torch.kernels.flash_attention import attention_plain, flash_attention_cuda
from repro_torch.kernels.pearson import pearson_rows
from repro_torch.kernels.rwkv6_scan import rwkv6_cuda, rwkv6_plain


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
    """Flash attention (causal / sliding-window, GQA): q (B, S, Hq, hd),
    k and v (B, S, Hkv, hd) -> (B, S, Hq, hd)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise ValueError(f"attention: no path for device {q.device}")


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 wkv recurrence: r, k, v, w (B, H, T, hd), u (H, hd), s0
    (B, H, hd, hd) -> (y (B, H, T, hd), final state)."""
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0)
    if r.device.type == "cuda":
        return rwkv6_cuda(r, k, v, w, u, s0)
    raise ValueError(f"rwkv6_wkv: no path for device {r.device}")
