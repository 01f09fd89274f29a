"""The federated round engine over the parameter arena.

Port of ``repro.core.engine.RoundEngine``.  The reference fuses a round
into one jitted program that donates the arena; PyTorch runs eagerly, so
here the same steps run in the same order as plain calls, and the arena is
updated IN PLACE:

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
counterpart: there is no compilation.

Mesh mode (``mesh=`` a ``repro_torch.launch.mesh.ClientMesh`` of S > 1
devices, the arena a ``ShardedParamArena``), ``cohort_mode="sharded"``:
the cohort is padded to a multiple of S (padding slots gather row 0, train
on zero data and carry zero arrival weight), and slice ``j`` is gathered
to ``devices[j]``, which trains it, runs the strategy's per-slot partial
(``Strategy.cohort_partial``; BFLN: prototypes) and the fingerprint kernel
over its own trained rows.  The trained rows and the partials are copied
to ``mesh.lead``, where the combine (``Strategy.cohort_combine``: the
Pearson kernel, the spectral embedding, k-means and the cluster-agg kernel
for BFLN) runs on the real ``k`` slots and, for the cluster means, over
the padded block whose padding slots add exactly +0.0.  The server
payload (``round_extras``) is computed on ``lead`` over the real slots
with the one-device op sequence, then padded per client.  The masked
scatter writes only the ``k`` real rows, each on its owner.  Every
reduction across slots runs on ``lead`` in the order the one-device
engine uses, and each client's training is its own (the client axis is
never summed over), so a seeded run at S shards equals the run at one
shard bit for bit, since local training does not depend on how many
clients one call trains: on the CPU ``torch.matmul`` is batch-invariant,
and on the card every client-stacked product goes through the
fixed-order batched-product kernel (``models/classifier.py``;
``tests/test_torch_mesh.py`` and ``chip_smoke.py::mesh_invariance``
measure it).
``cohort_mode="replicated"`` gathers the whole cohort to ``lead``, runs
the one-device step there and scatters to the owners.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.baselines import Strategy
from repro_torch.core.fl import LocalTrainResult, local_train
from repro_torch.kernels.fingerprint import (
    fingerprint_rows,
    format_digest,
    residues_numpy,
)
from repro_torch.obs import NULL_RECORDER
from repro_torch.optim import Optimizer
from repro_torch.runtime.arena import ArenaLayout, bitcast_u32, host_ids
from repro_torch.utils.tree import tree_map

COHORT_MODES = ("sharded", "replicated")


class SyncRoundOut(NamedTuple):
    """Outputs of one sync round (all O(cohort) or smaller)."""
    labels: torch.Tensor      # (k,) cluster assignment
    corr: torch.Tensor        # (k, k) Pearson matrix (CACC input)
    residues: torch.Tensor    # (k, 2) int32 holding the uint32 residues
    mean_loss: torch.Tensor   # scalar
    new_rows: torch.Tensor    # (k, N) the cohort's rows after the scatter


def _pad0(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` zero slots along the leading (cohort) axis."""
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


class RoundEngine:
    """Arena-backed sync rounds, async flush steps and evaluation entries,
    on the arena's device, or over a client mesh."""

    def __init__(self, layout: ArenaLayout, *, strategy: Strategy,
                 opt: Optimizer, n_clusters: int, local_epochs: int,
                 stacked_apply_fn: Callable, mesh=None,
                 cohort_mode: str = "sharded", obs=None):
        if strategy.aggregate_cohort is None:
            raise ValueError(f"strategy {strategy.name!r} has no "
                             "aggregate_cohort stage for the round engine")
        if cohort_mode not in COHORT_MODES:
            raise ValueError(f"cohort_mode must be one of {COHORT_MODES}, "
                             f"got {cohort_mode!r}")
        on_mesh = mesh is not None and mesh.shards > 1
        sharded = on_mesh and cohort_mode == "sharded"
        if sharded and (strategy.cohort_partial is None
                        or strategy.cohort_combine is None):
            raise ValueError(
                f"strategy {strategy.name!r} has no cohort_partial/"
                "cohort_combine stages — sharded cohort mode needs the "
                "two-stage contract (see repro_torch.core.baselines); use "
                "MeshSpec(cohort='replicated') to fall back to the "
                "replicated cohort program")
        self.layout = layout
        self.strategy = strategy
        self.opt = opt
        self.n_clusters = n_clusters
        self.local_epochs = local_epochs
        self.stacked_apply_fn = stacked_apply_fn
        self.mesh = mesh if on_mesh else None
        # resolved mode, read by the driver for its spans and gauges
        self.cohort_mode = "sharded" if sharded else (
            "replicated" if on_mesh else "single")
        self.cohort_shards = mesh.shards if sharded else 1
        self.obs = obs if obs is not None else NULL_RECORDER

    # ------------------------------------------------------------------ #

    def _lead(self, arena) -> torch.device:
        return arena.devices[0]

    def _slices(self, k: int) -> tuple[int, list[slice]]:
        """The cohort's padding and each shard's slice of the padded cohort."""
        s = self.cohort_shards
        per = -(-k // s)
        return per * s - k, [slice(j * per, (j + 1) * per) for j in range(s)]

    def _client_accs(self, rows: torch.Tensor, ex: torch.Tensor,
                     ey: torch.Tensor) -> torch.Tensor:
        """(m,) accuracy of every row's model on the shared eval batch."""
        logits = self.stacked_apply_fn(self.layout.unflatten(rows), ex)
        return (torch.argmax(logits, dim=-1) == ey[None, :]).float().mean(dim=1)

    def _sharded_accs(self, rows: list[torch.Tensor], ex: torch.Tensor,
                      ey: torch.Tensor, k: int) -> torch.Tensor:
        """Per-shard forwards of the slices ``rows`` (one a device), the
        (k,) accuracies of the real slots on ``ex``'s device."""
        accs = [self._client_accs(r, ex.to(r.device), ey.to(r.device))
                for r in rows]
        return torch.cat([a.to(ex.device) for a in accs])[:k]

    def _train(self, params, cx, cy, extras) -> LocalTrainResult:
        return local_train(self.strategy.local_loss, self.opt, params,
                           self.opt.init(params), cx, cy, extras,
                           self.local_epochs,
                           shared_extras=self.strategy.shared_extras)

    def _shard_extras(self, extras, pad: int, sl: slice, dev: torch.device):
        """Shard ``sl``'s part of the server payload, on ``dev``: a shared
        payload ships as it is, a per-client one gets zero padding slots."""
        if self.strategy.shared_extras:
            return tree_map(lambda e: e.to(dev), extras)
        return tree_map(lambda e: _pad0(e, pad)[sl].to(dev), extras)

    def _train_shards(self, slices: list[torch.Tensor], extras, pad: int,
                      cx: torch.Tensor, cy: torch.Tensor):
        """Local training of every shard's slice on its own device (zero
        data in the padding slots) -> ``(results, trained rows, shard
        data)``, one of each a shard."""
        cx_p, cy_p = _pad0(cx, pad), _pad0(cy, pad)
        _, sls = self._slices(cx.shape[0])
        results, rows, data = [], [], []
        for sl, r in zip(sls, slices):
            dev = r.device
            x, y = cx_p[sl].to(dev), cy_p[sl].to(dev)
            res = self._train(self.layout.unflatten(r), x, y,
                              self._shard_extras(extras, pad, sl, dev))
            results.append(res)
            rows.append(self.layout.flatten(res.params))
            data.append((x, y))
        return results, rows, data

    # ------------------------------------------------------------------ #

    def sync_step(self, arena, cohort_idx, cx: torch.Tensor,
                  cy: torch.Tensor, arrived: torch.Tensor) -> SyncRoundOut:
        """One sync round of the strategy over the cohort; writes the
        arrived slots' aggregated rows into ``arena`` in place."""
        self.obs.inc("engine.calls.sync_step")
        if self.cohort_mode == "sharded":
            return self._sharded_sync_step(arena, cohort_idx, cx, cy, arrived)
        layout, strategy, obs = self.layout, self.strategy, self.obs
        with obs.span("step.gather"):
            params = layout.unflatten(arena.gather(cohort_idx, self._lead(arena)))
            if obs.enabled:
                obs.ready(params)
        with obs.span("step.local_train"):
            # the server payload over ALL k gathered slots, before training
            extras = strategy.round_extras(params, cx, cy)
            res = self._train(params, cx, cy, extras)
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

    def _sharded_sync_step(self, arena, cohort_idx, cx, cy, arrived
                           ) -> SyncRoundOut:
        layout, strategy, obs = self.layout, self.strategy, self.obs
        lead = self._lead(arena)
        ids = host_ids(cohort_idx)
        k = ids.size
        pad, sls = self._slices(k)
        # padding slots gather row 0 (any valid row: their outputs are
        # sliced away and their arrival weight is zero)
        ids_p = np.concatenate([ids, np.zeros(pad, np.int64)])
        with obs.span("step.gather"):
            slices = [arena.gather(ids_p[sl], dev)
                      for sl, dev in zip(sls, self.mesh.devices)]
            # the real slots' rows on lead: the server payload's input
            real = torch.cat([r.to(lead) for r in slices])[:k]
            if obs.enabled:
                obs.ready(slices)
        with obs.span("step.local_train"):
            # on the REAL slots with the one-device op sequence: the payload
            # may reduce over the cohort and must never see padding slots
            extras = strategy.round_extras(layout.unflatten(real), cx, cy)
            results, trained, data = self._train_shards(slices, extras, pad,
                                                        cx, cy)
            if obs.enabled:
                obs.ready(trained)
        arrived_p = _pad0(arrived, pad)
        # the per-slot partial on each shard (BFLN: its slots' prototypes)
        partials = [strategy.cohort_partial(res.params, x, y,
                                            arrived_p[sl].to(x.device), obs)
                    for sl, res, (x, y) in zip(sls, results, data)]
        with obs.span("step.fingerprint"):
            residues = [fingerprint_rows(bitcast_u32(r)) for r in trained]
            residues = torch.cat([r.to(lead) for r in residues])[:k]
            if obs.enabled:
                obs.ready(residues)
        # the combine's inputs on lead: the padded trained block and the
        # per-slot partials (BFLN's prototypes)
        local_rows = torch.cat([r.to(lead) for r in trained])
        partial = None if partials[0] is None else \
            torch.cat([p.to(lead) for p in partials])
        agg = strategy.cohort_combine(local_rows, partial, arrived_p, k, obs)
        with obs.span("step.scatter"):
            upd = arena.masked_scatter(ids, arrived > 0, agg.rows)
            if obs.enabled:
                obs.ready(upd)
        mean_loss = torch.cat([r.mean_loss.to(lead) for r in results])[:k].mean()
        return SyncRoundOut(agg.labels, agg.corr, residues, mean_loss, upd)

    def async_step(self, base_rows: torch.Tensor, cx: torch.Tensor,
                   cy: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A FedBuff flush batch: local updates of the ``(K, N)`` base rows
        (each client's dispatch snapshot) and their fingerprints, no
        aggregation -> ``(local_rows, residues, mean_loss)``.  Sharded, the
        batch splits over the mesh like a sync cohort and the rows come
        back to ``base_rows``' device."""
        layout, strategy, obs = self.layout, self.strategy, self.obs
        obs.inc("engine.calls.async_step")
        if self.cohort_mode != "sharded":
            with obs.span("step.local_train"):
                params = layout.unflatten(base_rows)
                extras = strategy.round_extras(params, cx, cy)
                res = self._train(params, cx, cy, extras)
                local_rows = layout.flatten(res.params)
                if obs.enabled:
                    obs.ready(local_rows)
            with obs.span("step.fingerprint"):
                residues = fingerprint_rows(bitcast_u32(local_rows))
                if obs.enabled:
                    obs.ready(residues)
            return local_rows, residues, res.mean_loss.mean()
        lead, k = base_rows.device, base_rows.shape[0]
        pad, sls = self._slices(k)
        with obs.span("step.local_train"):
            extras = strategy.round_extras(layout.unflatten(base_rows), cx, cy)
            rows_p = _pad0(base_rows, pad)
            slices = [rows_p[sl].to(dev)
                      for sl, dev in zip(sls, self.mesh.devices)]
            results, trained, _ = self._train_shards(slices, extras, pad,
                                                     cx, cy)
            if obs.enabled:
                obs.ready(trained)
        with obs.span("step.fingerprint"):
            residues = [fingerprint_rows(bitcast_u32(r)) for r in trained]
            residues = torch.cat([r.to(lead) for r in residues])[:k]
            if obs.enabled:
                obs.ready(residues)
        local_rows = torch.cat([r.to(lead) for r in trained])[:k]
        mean_loss = torch.cat([r.mean_loss.to(lead) for r in results])[:k].mean()
        return local_rows, residues, mean_loss

    def eval_global(self, global_row: torch.Tensor, ex: torch.Tensor,
                    ey: torch.Tensor) -> torch.Tensor:
        """Accuracy of the one ``(N,)`` global model on the eval batch."""
        self.obs.inc("engine.calls.eval_global")
        return self._client_accs(global_row[None], ex, ey)[0]

    def eval_cohort(self, cohort_rows: torch.Tensor, arrived: torch.Tensor,
                    labels: torch.Tensor, ex: torch.Tensor, ey: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Arrival-masked cohort accuracy and per-cluster accuracy (C,).
        Sharded, the forwards split over the mesh and the scalar combine
        runs on the rows' device."""
        self.obs.inc("engine.calls.eval_cohort")
        k = cohort_rows.shape[0]
        if self.cohort_mode == "sharded":
            pad, sls = self._slices(k)
            rows_p = _pad0(cohort_rows, pad)
            accs = self._sharded_accs(
                [rows_p[sl].to(dev) for sl, dev in zip(sls, self.mesh.devices)],
                ex, ey, k)
        else:
            accs = self._client_accs(cohort_rows, ex, ey)
        w = arrived.float()
        acc = (accs * w).sum() / torch.clamp(w.sum(), min=1.0)
        clusters = torch.arange(self.n_clusters, device=labels.device)
        onehot = (labels[:, None] == clusters[None, :]).float() * w[:, None]
        sizes = onehot.sum(dim=0)
        cacc = (onehot * accs[:, None]).sum(dim=0) / torch.clamp(sizes, min=1.0)
        return acc, cacc

    def eval_population(self, source, ids: torch.Tensor, ex: torch.Tensor,
                        ey: torch.Tensor) -> torch.Tensor:
        """Mean accuracy of the sampled clients' rows.  ``source`` is an
        arena or an (n, N) rows tensor on the eval batch's device."""
        self.obs.inc("engine.calls.eval_population")
        if isinstance(source, torch.Tensor):
            return self._client_accs(
                source.index_select(0, ids.to(source.device)), ex, ey).mean()
        if self.cohort_mode != "sharded":
            return self._client_accs(source.gather(ids, ex.device), ex, ey).mean()
        host = host_ids(ids)
        pad, sls = self._slices(host.size)
        # padding slots duplicate id 0; their accuracies are sliced away
        ids_p = np.concatenate([host, np.zeros(pad, np.int64)])
        rows = [source.gather(ids_p[sl], dev)
                for sl, dev in zip(sls, self.mesh.devices)]
        return self._sharded_accs(rows, ex, ey, host.size).mean()

    def format_digests(self, residues: torch.Tensor) -> list[str]:
        """(k, 2) residues -> per-client digest strings (host side)."""
        return [format_digest(row, self.layout.n_params)
                for row in residues_numpy(residues)]

