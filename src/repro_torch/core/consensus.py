"""CACC — Consensus Algorithm based on Cluster Centroids (paper §IV-C).

Port of ``repro.core.consensus``.  From the spectral partition, the client
whose Pearson row is Euclidean-closest to its cluster's centroid (Eqs. 4-6)
becomes that cluster's representative; representatives take turns producing
blocks (the DPoS packing queue).  Part of the host chain protocol: it runs
in float32 on whatever device its inputs lie on (``chain_round`` hands it
host tensors).
"""
from __future__ import annotations

from collections.abc import Collection
from typing import NamedTuple

import torch


class CentroidResult(NamedTuple):
    representatives: torch.Tensor   # (C,) client index per cluster, -1 if empty
    distances: torch.Tensor         # (m,) distance of each client to its centroid
    centroids: torch.Tensor         # (C, m) mean Pearson row per cluster


def select_centroid_clients(corr: torch.Tensor, labels: torch.Tensor,
                            n_clusters: int) -> CentroidResult:
    """Paper Eqs. 4-6 on the Pearson matrix: each client is its correlation
    profile corr[i, :]; the argmin member of each cluster (first index on a
    tie) is its representative."""
    corr = corr.float()
    clusters = torch.arange(n_clusters, device=labels.device)
    onehot = (labels[:, None] == clusters[None, :]).float()          # (m, C)
    counts = onehot.sum(dim=0)                                       # (C,)
    centroids = (onehot.T @ corr) / torch.clamp(counts, min=1.0)[:, None]
    diff = corr - centroids[labels]                                  # Eq. 5
    dist = torch.sqrt((diff * diff).sum(dim=1))                      # Eq. 6
    big = torch.finfo(torch.float32).max
    masked = torch.where(onehot.T > 0, dist[None, :], torch.full_like(dist, big))
    reps = torch.where(counts > 0, torch.argmin(masked, dim=1),
                       torch.full_like(counts, -1, dtype=torch.long))
    return CentroidResult(reps.to(torch.int32), dist, centroids)


def packing_queue(representatives: torch.Tensor) -> list[int]:
    """Ordered block-producer queue (empty clusters dropped), in cluster
    order, so every validator derives the same queue."""
    return [int(r) for r in representatives.tolist() if r >= 0]


def producer_for_round(queue: list[int], round_idx: int,
                       active: Collection[int] | None = None) -> int:
    """Round-robin slot assignment; a slot whose representative is not
    ``active`` falls through to the next queue member."""
    if not queue:
        raise ValueError("empty packing queue")
    if active is None:
        return queue[round_idx % len(queue)]
    start = round_idx % len(queue)
    for off in range(len(queue)):
        cand = queue[(start + off) % len(queue)]
        if cand in active:
            return cand
    raise ValueError("no active producer in packing queue")
