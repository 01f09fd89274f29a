"""Public wrappers for the port's hand-written kernels.

Counterpart of ``repro.kernels.ops``.  A wrapper takes the plain PyTorch
version for a CPU tensor and launches its Hopper kernel for a CUDA tensor;
it never falls back from one to the other.  Ported so far: ``fingerprint``.
Still on the TPU side only (``repro.kernels.ops``): ``pearson``,
``cluster_aggregate``, ``attention``, ``rwkv6_wkv``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fingerprint import fingerprint_rows


def fingerprint(bits: torch.Tensor) -> torch.Tensor:
    """Per-client polynomial fingerprint residues: (m, N) int32 bit view of
    the rows -> (m, 2) int32 holding the uint32 residues."""
    return fingerprint_rows(bits)
