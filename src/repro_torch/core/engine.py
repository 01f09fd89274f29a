"""The federated round engine over the parameter arena (one device).

Port of ``repro.core.engine.RoundEngine`` for a single device.  The
reference fuses a round into one jitted program that donates the arena;
PyTorch runs eagerly, so here the same steps run in the same order as plain
calls on the arena's device, and the arena is updated IN PLACE:

    arena gather -> strategy.round_extras -> local_train (Adam, client
    axis written out) -> strategy.aggregate_cohort (BFLN: prototypes ->
    Pearson kernel -> spectral -> cluster-aggregation kernel; FedAvg,
    FedProx, FedHKD: the masked mean through the same kernel; FedProto:
    the trained rows) -> fingerprint kernel over the trained rows ->
    where(arrived) scatter-back

Each stage is a span of ``obs`` (``step.gather``, ``step.local_train``,
the strategy's ``step.*`` stages, ``step.fingerprint``, ``step.scatter``)
that ends with ``obs.ready`` on the stage's output when the recorder is
enabled, so a traced stage's wall time covers its kernels; the default
recorder does nothing.  Arrival is a fixed-shape mask, as in
the reference, and each entry counts its calls (``engine.calls.<entry>``,
as the reference's do).  What the host reads
back each round is O(cohort): labels, the Pearson matrix, the fingerprint
residues and the loss (``SyncRoundOut``).

The async flush's step (``async_step``) is the same training without the
aggregation: ``round_extras`` over the buffered base rows ->
``local_train`` -> one fingerprint call over the trained rows; the merge
is the driver's (``repro_torch.sim.async_agg``).  The reference's
compile-cache audit (``cache_sizes`` / ``lower_entry``) has no
counterpart: there is no compilation.  The cohort-sharded mesh path comes
with a later slice (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.core.baselines import Strategy
from repro_torch.core.fl import local_train
from repro_torch.kernels.fingerprint import (
    fingerprint_rows,
    format_digest,
    residues_numpy,
)
from repro_torch.obs import NULL_RECORDER
from repro_torch.optim import Optimizer
from repro_torch.runtime.arena import ArenaLayout, ParamArena, bitcast_u32


class SyncRoundOut(NamedTuple):
    """Outputs of one sync round (all O(cohort) or smaller)."""
    labels: torch.Tensor      # (k,) cluster assignment
    corr: torch.Tensor        # (k, k) Pearson matrix (CACC input)
    residues: torch.Tensor    # (k, 2) int32 holding the uint32 residues
    mean_loss: torch.Tensor   # scalar
    new_rows: torch.Tensor    # (k, N) the cohort's rows after the scatter


class RoundEngine:
    """Arena-backed sync rounds, async flush steps and evaluation entries,
    on the arena's device."""

    def __init__(self, layout: ArenaLayout, *, strategy: Strategy,
                 opt: Optimizer, n_clusters: int, local_epochs: int,
                 stacked_apply_fn: Callable, obs=None):
        if strategy.aggregate_cohort is None:
            raise ValueError(f"strategy {strategy.name!r} has no "
                             "aggregate_cohort stage for the round engine")
        self.layout = layout
        self.strategy = strategy
        self.opt = opt
        self.n_clusters = n_clusters
        self.local_epochs = local_epochs
        self.stacked_apply_fn = stacked_apply_fn
        self.obs = obs if obs is not None else NULL_RECORDER

    def _client_accs(self, rows: torch.Tensor, ex: torch.Tensor,
                     ey: torch.Tensor) -> torch.Tensor:
        """(m,) accuracy of every row's model on the shared eval batch."""
        logits = self.stacked_apply_fn(self.layout.unflatten(rows), ex)
        return (torch.argmax(logits, dim=-1) == ey[None, :]).float().mean(dim=1)

    def sync_step(self, arena: ParamArena, cohort_idx: torch.Tensor,
                  cx: torch.Tensor, cy: torch.Tensor,
                  arrived: torch.Tensor) -> SyncRoundOut:
        """One sync round of the strategy over the cohort; writes the
        arrived slots' aggregated rows into ``arena`` in place."""
        layout, strategy, obs = self.layout, self.strategy, self.obs
        obs.inc("engine.calls.sync_step")
        with obs.span("step.gather"):
            params = layout.unflatten(arena.gather(cohort_idx))
            if obs.enabled:
                obs.ready(params)
        with obs.span("step.local_train"):
            # the server payload over ALL k gathered slots, before training
            extras = strategy.round_extras(params, cx, cy)
            res = local_train(strategy.local_loss, self.opt, params,
                              self.opt.init(params), cx, cy, extras,
                              self.local_epochs,
                              shared_extras=strategy.shared_extras)
            local_rows = layout.flatten(res.params)
            if obs.enabled:
                obs.ready(local_rows)
        # aggregation over ALL cohort slots (stragglers burn local compute
        # too); only the aggregation weights honour the arrival mask
        agg = strategy.aggregate_cohort(res.params, local_rows, cx, cy,
                                        arrived, obs)
        with obs.span("step.fingerprint"):
            residues = fingerprint_rows(bitcast_u32(local_rows))
            if obs.enabled:
                obs.ready(residues)
        with obs.span("step.scatter"):
            upd = arena.masked_scatter(cohort_idx, arrived > 0, agg.rows)
            if obs.enabled:
                obs.ready(upd)
        return SyncRoundOut(agg.labels, agg.corr, residues,
                            res.mean_loss.mean(), upd)

    def async_step(self, base_rows: torch.Tensor, cx: torch.Tensor,
                   cy: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A FedBuff flush batch: local updates of the ``(K, N)`` base rows
        (each client's dispatch snapshot) and their fingerprints, no
        aggregation -> ``(local_rows, residues, mean_loss)``."""
        layout, strategy, obs = self.layout, self.strategy, self.obs
        obs.inc("engine.calls.async_step")
        with obs.span("step.local_train"):
            params = layout.unflatten(base_rows)
            extras = strategy.round_extras(params, cx, cy)
            res = local_train(strategy.local_loss, self.opt, params,
                              self.opt.init(params), cx, cy, extras,
                              self.local_epochs,
                              shared_extras=strategy.shared_extras)
            local_rows = layout.flatten(res.params)
            if obs.enabled:
                obs.ready(local_rows)
        with obs.span("step.fingerprint"):
            residues = fingerprint_rows(bitcast_u32(local_rows))
            if obs.enabled:
                obs.ready(residues)
        return local_rows, residues, res.mean_loss.mean()

    def eval_global(self, global_row: torch.Tensor, ex: torch.Tensor,
                    ey: torch.Tensor) -> torch.Tensor:
        """Accuracy of the one ``(N,)`` global model on the eval batch."""
        self.obs.inc("engine.calls.eval_global")
        return self._client_accs(global_row[None], ex, ey)[0]

    def eval_cohort(self, cohort_rows: torch.Tensor, arrived: torch.Tensor,
                    labels: torch.Tensor, ex: torch.Tensor, ey: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Arrival-masked cohort accuracy and per-cluster accuracy (C,)."""
        self.obs.inc("engine.calls.eval_cohort")
        accs = self._client_accs(cohort_rows, ex, ey)
        w = arrived.float()
        acc = (accs * w).sum() / torch.clamp(w.sum(), min=1.0)
        clusters = torch.arange(self.n_clusters, device=labels.device)
        onehot = (labels[:, None] == clusters[None, :]).float() * w[:, None]
        sizes = onehot.sum(dim=0)
        cacc = (onehot * accs[:, None]).sum(dim=0) / torch.clamp(sizes, min=1.0)
        return acc, cacc

    def eval_population(self, arena_data: torch.Tensor, ids: torch.Tensor,
                        ex: torch.Tensor, ey: torch.Tensor) -> torch.Tensor:
        """Mean accuracy of the sampled clients' rows."""
        self.obs.inc("engine.calls.eval_population")
        return self._client_accs(arena_data.index_select(0, ids), ex, ey).mean()

    def format_digests(self, residues: torch.Tensor) -> list[str]:
        """(k, 2) residues -> per-client digest strings (host side)."""
        return [format_digest(row, self.layout.n_params)
                for row in residues_numpy(residues)]
