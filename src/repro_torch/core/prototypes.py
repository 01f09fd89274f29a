"""Prototype extraction (paper Eq. 1).

Port of ``repro.core.prototypes.client_prototypes``.  A prototype is the
mean representation a model produces over the probe batch of psi
same-category samples; the aggregation client feeds the SAME probe batch
through every client's model, so prototypes are comparable.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

Pytree = Any


def client_prototypes(embed_fn: Callable, stacked_params: Pytree,
                      probe_x: torch.Tensor) -> torch.Tensor:
    """Prototypes of every stacked model at once: ``embed_fn(stacked_params,
    probe_x) -> (m, psi, D)`` averaged over the probe axis -> ``(m, D)``."""
    return embed_fn(stacked_params, probe_x).mean(dim=1)
