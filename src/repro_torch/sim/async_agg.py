"""Buffered asynchronous aggregation (FedBuff-style) with staleness weights.

Port of ``repro.sim.async_agg``.  Async mode removes the round barrier:
clients are dispatched a snapshot of the global model, train at their own
speed, and their *deltas* (update - snapshot) accumulate in a
fixed-capacity buffer.  When the buffer fills, the server merges it in one
shot and bumps the model version.  An update that trained against version
``v`` but merges at version ``v'`` has staleness ``s = v' - v`` and is
down-weighted

    w(s) = (1 + s)^(-alpha)            (FedBuff / Nguyen et al., 2022)

so slow clients still contribute but cannot drag the model backwards.

Deltas here are flat arena rows: ``(N,)`` per update, ``(K, N)`` per
buffer.  The merge is one call of the cluster-aggregation kernel with one
cluster (:func:`weighted_delta_mean`).  Chain integration is the caller's
job: the driver gates merge weights with CACC verification, so tampered
updates carry zero weight *and* zero reward.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.cluster_agg import cluster_mean_rows


def staleness_weight(staleness, alpha: float = 0.5) -> np.ndarray:
    """(1 + s)^(-alpha) as float32; alpha = 0 disables the discount.

    The power is taken in float64 on the float32 base and exponent and
    rounded once to float32.  The reference's XLA power is within one ulp
    of that, and equal to it at the default alpha = 0.5 for every
    staleness below 1000."""
    base = 1.0 + np.asarray(staleness, np.float32)
    return (base.astype(np.float64) ** np.float64(np.float32(-alpha))) \
        .astype(np.float32)


def weighted_delta_mean(deltas: torch.Tensor, weights: torch.Tensor
                        ) -> torch.Tensor:
    """Normalised weighted mean of the ``(K, N)`` float32 delta rows over the
    buffer axis -> ``(N,)``: one ``cluster_mean_rows(deltas, zeros(K), 1,
    w)`` call (the kernel on a CUDA tensor, its plain version on a CPU
    tensor), whose every output row is the mean; row 0 is taken.

    This is the reference's ``weighted_delta_mean`` bit for bit.  The
    reference divides the where-guarded tree ``masked_tree_sum(x, w)`` by
    ``max(tree_sum(w), 1e-9)``; with one cluster and every label 0 the
    kernel's weights are ``w * 1 = w`` and it divides the tree of
    ``where(w > 0, w x, +0.0)`` by ``max(tree_sum(w), 1e-9)``.  The
    reference's tree runs over the buffer axis of each leaf, and a leaf's
    elements are columns of the flat rows, so the per-leaf trees are the
    flat tree column by column.  A zero-weight row adds exactly +0.0
    whatever it holds, and a flush whose every weight is 0 (all updates
    unverified) gives an exact zero delta."""
    labels = torch.zeros(deltas.shape[0], dtype=torch.long, device=deltas.device)
    return cluster_mean_rows(deltas, labels, 1, weights.float())[0]


@dataclass(frozen=True)
class BufferedUpdate:
    client: int
    delta: torch.Tensor | None    # (N,) local row - dispatch snapshot
    version: int                  # server model version at dispatch time


@dataclass
class MergeResult:
    delta: torch.Tensor           # (N,) staleness-weighted mean delta
    clients: np.ndarray           # (K,) contributing client ids
    staleness: np.ndarray         # (K,) int staleness per contribution
    weights: np.ndarray           # (K,) effective merge weights


@dataclass
class BufferedAggregator:
    """Fixed-capacity update buffer; :meth:`flush` merges and empties it."""

    capacity: int = 16
    alpha: float = 0.5
    buffer: list[BufferedUpdate] = field(default_factory=list)

    def add(self, update: BufferedUpdate) -> bool:
        """Returns True when the buffer has reached capacity (time to flush)."""
        self.buffer.append(update)
        return len(self.buffer) >= self.capacity

    def __len__(self) -> int:
        return len(self.buffer)

    def flush(self, current_version: int,
              gate: np.ndarray | None = None) -> MergeResult:
        """Merge everything buffered.  ``gate`` (optional, (K,) 0/1) zeroes
        the merge weight of individual contributions — the driver passes the
        chain's verification mask so unverified (tampered) updates are
        excluded from the model as well as from rewards."""
        if not self.buffer:
            raise ValueError("flush of empty buffer")
        clients = np.array([u.client for u in self.buffer], dtype=np.int64)
        staleness = np.array([current_version - u.version for u in self.buffer],
                             dtype=np.int64)
        w = staleness_weight(staleness, self.alpha)
        if gate is not None:
            w = w * np.asarray(gate, np.float32)
        stacked = torch.stack([u.delta for u in self.buffer])
        merged = weighted_delta_mean(stacked,
                                     torch.from_numpy(w).to(stacked.device))
        self.buffer = []
        return MergeResult(merged, clients, staleness, w)
