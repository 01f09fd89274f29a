"""PAA's cluster-masked FedAvg and the fixed-order tree reductions.

Port of the part of ``repro.core.aggregation`` the BFLN round runs.  Every
cohort-axis float reduction is an adjacent-pair binary tree padded with
+0.0 to the next power of two, and zero-weight slots are where-guarded to
add exactly +0.0, so the bits are a property of the math, not of the
backend — the same as the reference's numpy oracles
(``repro.kernels.ref.tree_sum_ref`` / ``tree_cluster_mean_ref``).

:func:`tree_cluster_mean_params` runs through the port's cluster-aggregation
kernel (``repro_torch.kernels.cluster_agg``): the leaves are laid side by
side as one flat (m, N) matrix and aggregated in ONE call — every column is
independent, so the result is elementwise what a per-leaf pass would give.
It is the reference's pytree form; the round itself already holds the flat
arena rows and calls ``cluster_mean_rows`` on them (``core.baselines``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.cluster_agg import cluster_mean_rows, tree_sum
from repro_torch.runtime.arena import ArenaLayout

Pytree = Any

__all__ = ["tree_sum", "masked_tree_sum", "tree_cluster_mean_params"]


def masked_tree_sum(x: torch.Tensor, w: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Weighted tree sum where zero-weight slots contribute EXACTLY +0.0
    (no ``-0.0`` from a signed zero, no ``0 * inf = NaN`` from garbage)."""
    shape = [1] * x.dim()
    shape[dim] = -1
    wb = w.to(x.dtype).reshape(shape)
    return tree_sum(torch.where(wb > 0, x * wb, x.new_zeros(())), dim=dim)


def tree_cluster_mean_params(stacked_params: Pytree, labels: torch.Tensor,
                             n_clusters: int,
                             weights: torch.Tensor | None = None) -> Pytree:
    """Cluster-masked FedAvg: every slot receives its cluster's weighted
    mean (denominator clamped, so an all-masked cluster gives zeros), in
    the fixed tree order — one kernel call over all leaves at once."""
    layout = ArenaLayout.from_stacked(stacked_params)
    flat = layout.flatten(stacked_params)
    return layout.unflatten(cluster_mean_rows(flat, labels, n_clusters, weights))
