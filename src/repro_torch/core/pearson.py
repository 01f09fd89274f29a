"""Pearson correlation between client prototype vectors (paper Eq. 2-3).

Port of ``repro.core.pearson``.  The m x m matrix feeds spectral
clustering in PAA; :func:`pearson_matrix` computes it through the port's
Pearson kernel (``repro_torch.kernels.pearson``: the plain version on a
CPU tensor, the Hopper kernel on a CUDA tensor).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pearson import pearson_rows


def pearson_matrix(protos: torch.Tensor) -> torch.Tensor:
    """Xi[i, j] = corr(V_i, V_j) over the feature dim: (m, D) -> (m, m)."""
    return pearson_rows(protos.float().contiguous())


def pearson_affinity(corr: torch.Tensor) -> torch.Tensor:
    """Map correlations [-1, 1] to a non-negative affinity [0, 1] for
    spectral clustering (anti-correlated models are maximally dissimilar)."""
    return (corr + 1.0) * 0.5
