"""PAA — Prototype-based Aggregation Algorithm (paper §IV-B).

Port of ``repro.core.aggregation``.  Pipeline per round:

    stacked local params --embed probe batch--> prototypes (m, D)
    prototypes --Pearson--> Xi (m, m) --spectral--> labels (m,)
    labels + stacked params --cluster-masked FedAvg--> per-client new params

:func:`paa_round` is that pipeline as one function; its Pearson matrix goes
through the port's Pearson kernel (``core.pearson.pearson_matrix``: the
Hopper kernel on a CUDA tensor).  :func:`cluster_mean_params` and
:func:`cluster_mean_rows` are the reference's contraction forms of
cluster-masked FedAvg (``torch.tensordot``, sums in the backend's order).

The round itself runs the fixed-order forms instead.  Every cohort-axis
float reduction there is an adjacent-pair binary tree padded with +0.0 to
the next power of two, and zero-weight slots are where-guarded to add
exactly +0.0, so the bits are a property of the math, not of the backend —
the same as the reference's numpy oracles (``repro.kernels.ref.tree_sum_ref``
/ ``tree_cluster_mean_ref``).  :func:`tree_cluster_mean_params` runs through
the port's cluster-aggregation kernel (``repro_torch.kernels.cluster_agg``,
whose ``cluster_mean_rows`` the engine and FedBuff call on the flat arena
rows): the leaves are laid side by side as one flat (m, N) matrix and
aggregated in ONE call — every column is independent, so the result is
elementwise what a per-leaf pass would give.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.pearson import pearson_affinity, pearson_matrix
from repro_torch.core.prototypes import client_prototypes
from repro_torch.core.spectral import spectral_cluster
from repro_torch.kernels.cluster_agg import cluster_mean_rows as _tree_cluster_mean_rows
from repro_torch.kernels.cluster_agg import tree_sum
from repro_torch.runtime.arena import ArenaLayout
from repro_torch.utils.tree import tree_map

Pytree = Any


class PAAResult(NamedTuple):
    new_stacked_params: Pytree     # per-client aggregated params (personalised)
    labels: torch.Tensor           # (m,) cluster assignment
    corr: torch.Tensor             # (m, m) Pearson matrix Xi
    prototypes: torch.Tensor       # (m, D)
    cluster_sizes: torch.Tensor    # (n_clusters,)


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
    return layout.unflatten(_tree_cluster_mean_rows(flat, labels, n_clusters,
                                                    weights))


def _cluster_weights(labels: torch.Tensor, n_clusters: int,
                     weights: torch.Tensor | None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared membership weights: (onehot (m, C), weighted onehot, denom (C,))."""
    onehot = F.one_hot(labels.long(), n_clusters).float()              # (m, C)
    w = torch.ones(labels.shape[0], device=labels.device) if weights is None \
        else weights.float()
    wo = onehot * w[:, None]                                           # (m, C)
    denom = torch.clamp(wo.sum(dim=0), min=1e-9)                       # (C,)
    return onehot, wo, denom


def cluster_mean_rows(rows: torch.Tensor, labels: torch.Tensor,
                      n_clusters: int,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Cluster-masked FedAvg over flat ``(m, N)`` rows, the reference's
    two-step contraction: reduce to the C cluster means, gather back."""
    onehot, wo, denom = _cluster_weights(labels, n_clusters, weights)
    reduce_w = (wo / denom[None, :]).T                                 # (C, m)
    means = torch.tensordot(reduce_w, rows.float(), dims=([1], [0]))
    return torch.tensordot(onehot, means, dims=([1], [0])).to(rows.dtype)


def cluster_mean_params(stacked_params: Pytree, labels: torch.Tensor,
                        n_clusters: int, weights: torch.Tensor | None = None,
                        method: str = "two_step") -> Pytree:
    """FedAvg within each cluster, broadcast back to the members: for every
    leaf ``x`` (m, ...), ``out[i]`` is the (weighted) mean of ``x[j]`` over
    the ``j`` with ``labels[j] == labels[i]``.

    ``method``: ``"mix"`` — one (m x m) mixing product; ``"two_step"`` —
    the C cluster means first, then gathered back (the same sums);
    ``"two_step_bf16"`` — the two-step products on bf16 operands."""
    onehot, wo, denom = _cluster_weights(labels, n_clusters, weights)
    if method == "mix":
        mix = (onehot / denom[None, :]) @ wo.T                         # (m, m)

        def leaf(x):
            return torch.tensordot(mix, x.float(), dims=([1], [0])).to(x.dtype)
    elif method in ("two_step", "two_step_bf16"):
        reduce_w = (wo / denom[None, :]).T                             # (C, m)
        tdt = torch.bfloat16 if method == "two_step_bf16" else torch.float32

        def leaf(x):
            means = torch.tensordot(reduce_w.to(tdt), x.to(tdt), dims=([1], [0]))
            out = torch.tensordot(onehot.to(tdt), means, dims=([1], [0]))
            return out.to(x.dtype)
    else:
        raise ValueError(method)
    return tree_map(leaf, stacked_params)


def cluster_sizes(labels: torch.Tensor, n_clusters: int) -> torch.Tensor:
    return F.one_hot(labels.long(), n_clusters).sum(dim=0).to(torch.int32)


def paa_round(embed_fn: Callable, stacked_params: Pytree,
              probe_x: torch.Tensor, n_clusters: int,
              weights: torch.Tensor | None = None, kmeans_iters: int = 25,
              agg_method: str = "two_step") -> PAAResult:
    """One full PAA aggregation (paper steps 3-5 of Fig. 1).  ``embed_fn``
    is the stacked embedding of ``core.prototypes.client_prototypes``:
    ``(stacked_params, probe_x) -> (m, psi, D)``."""
    protos = client_prototypes(embed_fn, stacked_params, probe_x)      # (m, D)
    corr = pearson_matrix(protos)                                      # (m, m)
    labels = spectral_cluster(pearson_affinity(corr), n_clusters, kmeans_iters)
    new_params = cluster_mean_params(stacked_params, labels, n_clusters, weights,
                                     method=agg_method)
    return PAAResult(new_params, labels, corr, protos,
                     cluster_sizes(labels, n_clusters))
