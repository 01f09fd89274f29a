"""Public wrappers for the port's hand-written kernels.

Counterpart of ``repro.kernels.ops``.  A wrapper takes the plain PyTorch
version for a CPU tensor and launches its Hopper kernel for a CUDA tensor;
it never falls back from one to the other.  Ported so far:
``fingerprint``, ``pearson``, ``cluster_aggregate``.  Still on the TPU side
only (``repro.kernels.ops``): ``attention``, ``rwkv6_wkv``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cluster_agg import cluster_mean_rows
from repro_torch.kernels.fingerprint import fingerprint_rows
from repro_torch.kernels.pearson import pearson_rows


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
    """Cluster-masked FedAvg over (m, N) float32 client rows, in the
    round engine's fixed tree order."""
    return cluster_mean_rows(rows, labels, n_clusters, weights)
