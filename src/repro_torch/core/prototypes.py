"""Prototype extraction (paper Eq. 1).

Port of ``repro.core.prototypes``.  A prototype is the mean representation
a model produces over the probe batch of psi same-category samples; the
aggregation client feeds the SAME probe batch through every client's
model, so prototypes are comparable.  The per-class prototypes of the
FedProto / FedHKD baselines are built instead from each client's own batch.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import batched_matmul

Pytree = Any


def prototype(embed_fn: Callable, params: Pytree,
              probe_x: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 1: the mean of ``embed_fn(params, probe_x) -> (psi, D)``
    over the probe batch, for ONE client's params -> ``(D,)``."""
    return embed_fn(params, probe_x).mean(dim=0)


def client_prototypes(embed_fn: Callable, stacked_params: Pytree,
                      probe_x: torch.Tensor) -> torch.Tensor:
    """Prototypes of every stacked model at once: ``embed_fn(stacked_params,
    probe_x) -> (m, psi, D)`` averaged over the probe axis -> ``(m, D)``."""
    return embed_fn(stacked_params, probe_x).mean(dim=1)


def classwise_prototypes(embed_fn: Callable, stacked_params: Pytree,
                         x: torch.Tensor, y: torch.Tensor, num_classes: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class prototypes of every stacked model on its own batch:
    ``embed_fn(stacked_params, x (m, B, ...)) -> (m, B, R)`` and labels
    ``y (m, B)`` give ``protos (m, K, R)`` and ``counts (m, K)``.  Classes
    absent from a client's batch get a zero prototype and a zero count
    (callers mask on counts).  Differentiable through ``embed_fn``; the sums
    go through the fixed-order batched product, so a model's prototypes do
    not depend on ``m`` (the engine runs this per shard)."""
    reps = embed_fn(stacked_params, x)                          # (m, B, R)
    onehot = F.one_hot(y.long(), num_classes).to(reps.dtype)    # (m, B, K)
    sums = batched_matmul(onehot.transpose(1, 2), reps)         # (m, K, R)
    counts = onehot.sum(dim=1)                                  # (m, K)
    return sums / torch.clamp(counts, min=1.0)[..., None], counts
