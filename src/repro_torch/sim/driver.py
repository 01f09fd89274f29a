"""`SimulatedFederation` — event-driven federation over a virtual population.

Port of the engine paths of ``repro.sim.driver``.  Per synchronous round:

    1. availability draw -> online pool -> sampler picks the cohort,
    2. cohort events on the virtual clock (arrival, update-ready after the
       client's latency, dropout); the block slot closes the round,
    3. the round engine (``repro_torch.core.engine``): arena gather ->
       local training -> PAA (arrival mask = aggregation weights) -> cohort
       fingerprints -> masked scatter-back into the arena, in place,
    4. ``FederatedTrainer.chain_round``: hash commits, CACC packing queue,
       block, verification, reward settlement on the population ledger.

Async mode (``mode="async"``) replaces 2-3 with FedBuff buffered
aggregation: clients train against dispatched snapshots of the global row,
finished updates buffer up, and each buffer flush is one ``async_step``
(training and fingerprints), one block and one staleness-weighted merge
(``repro_torch.sim.async_agg``), whose weights are gated by chain
verification, so tampered updates carry zero weight and zero reward.

Steps 1-2, the async dispatch and the event log are the reference's, numpy
RNG call for call (``online_clients``, the sampler, ``latency.draw``,
``rng.random``, ``rng.uniform``), so a seeded run logs the same events in
both packages.  Parameters, data and the arena live on the run's device;
labels, the Pearson matrix, the residues and the loss come to the host
every round.

A ``FaultSpec`` binds a ``FaultInjector`` (``repro_torch.faults``): crashes
at a round's start, before its chain step or after a checkpoint, retries of
dropped cohort slots from the injector's own stream, and the chain faults
of ``chain_round``.  A ``CheckpointSpec`` with ``interval > 0`` snapshots
the complete state (``repro_torch.checkpoint``) every ``interval``
rounds or flushes: the capture on the round's thread, the write on one
background thread, at most one write in flight; ``run(resume_from=...)``
continues from a snapshot with digests equal to the uninterrupted run's.

Byzantine clients train honestly but commit a digest of params they did not
train (the paper's freeriding attack); CACC verification refuses them.
The legacy ``engine=False`` driver and the mesh are not ported.
"""
from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.api.registry import build_strategy
from repro_torch.api.spec import ExperimentSpec
from repro_torch.blockchain import TokenLedger
from repro_torch.core.baselines import ModelBundle
from repro_torch.core.engine import RoundEngine
from repro_torch.core.round import FederatedTrainer, digest_of
from repro_torch.device import resolve_device
from repro_torch.faults import NULL_INJECTOR, FaultInjector
from repro_torch.models import classifier as clf
from repro_torch.obs import NULL_RECORDER
from repro_torch.optim import adam
from repro_torch.runtime.arena import ParamArena
from repro_torch.sim import events as ev
from repro_torch.sim.async_agg import (
    BufferedAggregator,
    BufferedUpdate,
    staleness_weight,
    weighted_delta_mean,
)
from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.events import EventQueue
from repro_torch.sim.population import ClientPopulation
from repro_torch.sim.sampler import SamplerState, get_sampler
from repro_torch.utils.tree import tree_index, tree_map

Pytree = Any


@dataclass
class SimRoundRecord:
    round_idx: int
    t_open: float
    t_close: float
    cohort: np.ndarray
    arrived: np.ndarray               # (k,) bool
    n_stragglers: int
    n_dropouts: int
    n_byzantine: int
    producer: int
    verified_frac: float
    reward_paid: float
    reward_burned: float
    mean_loss: float
    accuracy: Any = float("nan")      # cohort accuracy (sync) / global
                                      # (async); a device scalar until the
                                      # end of the run or a checkpoint
    staleness_mean: float = 0.0       # async only
    cluster_accuracy: Any = None      # (C,) at sync eval rounds


@dataclass
class SimReport:
    config: ExperimentSpec
    history: list[SimRoundRecord]
    event_log: list[tuple]
    final_accuracy: float
    balances: np.ndarray
    chain_valid: bool
    n_blocks: int
    ledger_conserved: bool

    def summary(self) -> str:
        h = self.history
        paid = sum(r.reward_paid for r in h)
        burned = sum(r.reward_burned for r in h)
        return (f"{len(h)} rounds, {len(self.event_log)} events, "
                f"final_acc={self.final_accuracy:.4f}, paid={paid:.1f}, "
                f"burned={burned:.1f}, blocks={self.n_blocks}, "
                f"chain_valid={self.chain_valid}, "
                f"conserved={self.ledger_conserved}")


class SimulatedFederation:
    """Sync rounds or async flushes of the spec's strategy over sampled
    cohorts of a virtual population, on a deterministic virtual clock, with
    the population's parameters in one arena on ``device`` (``None`` means
    the card).

    ``obs`` is a recorder with the surface of ``repro_torch.obs.
    NullRecorder`` (the default): ``span`` / ``inc`` / ``event`` calls mark
    the round's phases for a caller that times them.
    """

    def __init__(self, population: ClientPopulation, spec: ExperimentSpec,
                 device=None, obs=None):
        device = resolve_device(device)
        if population.device != device:
            raise ValueError(f"population lives on {population.device}, the "
                             f"run on {device}")
        self.spec = spec
        self.cfg = spec.train
        self.pop = population
        self.device = device
        self.obs = obs if obs is not None else NULL_RECORDER
        n = population.n_clients
        t, c = spec.train, spec.chain

        mcfg = clf.MLPConfig(in_dim=population.in_dim, hidden=tuple(t.hidden),
                             rep_dim=t.rep_dim,
                             num_classes=population.num_classes)
        self.mcfg = mcfg    # the serving tier rebuilds forwards from this
        self.bundle = ModelBundle(functools.partial(clf.apply_batched, mcfg),
                                  functools.partial(clf.embed_batched, mcfg),
                                  population.num_classes)
        self.opt = adam(t.lr)
        strategy = build_strategy(t.strategy, self.bundle,
                                  probe=population.probe,
                                  n_clusters=t.n_clusters,
                                  **t.strategy_params)
        self.trainer = FederatedTrainer(
            self.bundle, strategy, self.opt, local_epochs=t.local_epochs,
            n_clusters=t.n_clusters, total_reward=c.total_reward, rho=c.rho,
            initial_stake=c.initial_stake)
        # population-wide ledger (the trainer's chain_round settles against it)
        self.trainer.ledger = TokenLedger(n, c.initial_stake)

        params = clf.init_stacked(mcfg, torch.Generator().manual_seed(spec.seed),
                                  n, device=device)
        # shared tamper digest for Byzantine commits (the digest a freerider
        # claims never varies)
        self._fake_digest = digest_of(tree_map(torch.zeros_like,
                                               tree_index(params, 0)))
        self.arena = ParamArena.from_stacked(params)
        self.engine = RoundEngine(
            self.arena.layout, strategy=strategy, opt=self.opt,
            n_clusters=t.n_clusters, local_epochs=t.local_epochs,
            stacked_apply_fn=self.bundle.apply_fn, obs=self.obs)
        self.last_labels = np.full(n, -1, dtype=np.int64)
        self.sampler = get_sampler(t.sampler)

        self.rng = np.random.default_rng(spec.seed)
        self.clock = VirtualClock()
        self.queue = EventQueue()
        self.event_log: list[tuple] = []
        self.history: list[SimRoundRecord] = []

        # checkpoint/resume + fault injection: both default off, and the
        # fault-free run binds the shared no-op injector
        self.ckpt = spec.checkpoint if spec.checkpoint.enabled else None
        self.faults = (FaultInjector(spec.faults, obs=self.obs)
                       if spec.faults.enabled else NULL_INJECTOR)
        self._resume_async: dict | None = None
        self._resumed_from: tuple[str, int] | None = None
        self._ckpt_written = 0
        self._ckpt_bytes = 0
        self._ckpt_executor: ThreadPoolExecutor | None = None
        self._ckpt_future = None       # at most one write in flight
        self.trainer.attach_obs(self.obs)
        self.trainer.attach_faults(self.faults)

    # ------------------------------------------------------------------ #
    # stacked-params view of the arena
    # ------------------------------------------------------------------ #

    @property
    def params(self) -> Pytree:
        return self.arena.as_pytree()

    @params.setter
    def params(self, value: Pytree) -> None:
        self.arena.rebind(self.arena.layout.flatten(value).to(self.device))

    # ------------------------------------------------------------------ #

    def _log(self, event: ev.Event) -> None:
        self.event_log.append(event.log_entry())

    def _sampler_state(self) -> SamplerState:
        return SamplerState(balances=self.trainer.ledger.balances,
                            last_labels=self.last_labels,
                            n_clusters=self.cfg.n_clusters)

    def _tampers(self, cohort: np.ndarray, arrived: np.ndarray) -> dict:
        """Byzantine freeriders commit digests of params they did not train."""
        return {int(gid): self._fake_digest
                for slot, gid in enumerate(cohort)
                if arrived[slot] and self.pop.byzantine[gid]}

    def _schedule_retries(self, r: int, gid: int, t_fail: float,
                          lat: float) -> None:
        """Bounded retry-with-backoff for a dropped cohort slot
        (``FaultSpec.retry``).  Every redraw comes from the injector's own
        seeded generator — the simulator's streams are untouched, so the
        retry knob perturbs nothing else and replays and resumes exactly.
        A recovered client may still miss the deadline."""
        faults, obs = self.faults, self.obs
        t_retry = t_fail
        for attempt in range(1, faults.spec.retry_max + 1):
            with obs.span("round.retry", round=r, client=gid,
                          attempt=attempt) as sp:
                t_retry += faults.retry_latency(lat, attempt)
                ok = faults.retry_succeeds(self.pop.dropout[gid])
                sp.set(t_retry=t_retry, recovered=ok)
            obs.inc("fault.retry")
            if ok:
                self.queue.push(t_retry, ev.UPDATE_READY, gid, r)
                obs.inc("fault.retry_recovered")
                return
            self.queue.push(t_retry, ev.DROPOUT, gid, r)

    def _eval_slices(self) -> tuple[torch.Tensor, torch.Tensor]:
        n = self.spec.eval.examples
        return self.pop.test_x[:n], self.pop.test_y[:n]

    def _evaluate_clients(self, ids: np.ndarray) -> float:
        ex, ey = self._eval_slices()
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return float(self.engine.eval_population(self.arena.data, idx, ex, ey))

    # ------------------------------------------------------------------ #
    # synchronous mode
    # ------------------------------------------------------------------ #

    def _run_sync_round(self, r: int) -> SimRoundRecord:
        with self.obs.span("round.total", round=r) as rt:
            return self._sync_round_body(r, rt)

    def _sync_round_body(self, r: int, rt) -> SimRoundRecord:
        cfg, pop, rng, obs = self.cfg, self.pop, self.rng, self.obs
        self.faults.maybe_crash(r, "round_start")
        t0 = self.clock.now
        k = max(1, int(round(cfg.sample_frac * pop.n_clients)))

        with obs.span("round.sample", round=r) as sp:
            online = pop.online_clients(rng)
            cohort = self.sampler(rng, online, k, self._sampler_state())
            sp.set(online=len(online), k=len(cohort))
        self.queue.push(t0 + cfg.deadline, ev.BLOCK_SLOT, round_idx=r)

        dropouts: set[int] = set()        # classified at schedule time — a
        for gid in cohort:                # dropout past the deadline is still
            gid = int(gid)                # a death, not a straggler
            self.queue.push(t0, ev.CLIENT_ARRIVAL, gid, r)
            lat = pop.latency.draw(gid)
            if rng.random() < pop.dropout[gid]:
                dropouts.add(gid)
                t_fail = t0 + lat * rng.uniform(0.1, 0.9)
                self.queue.push(t_fail, ev.DROPOUT, gid, r)
                if self.faults.retry:
                    self._schedule_retries(r, gid, t_fail, lat)
            else:
                self.queue.push(t0 + lat, ev.UPDATE_READY, gid, r)

        arrived_set: set[int] = set()
        with obs.span("round.wait", round=r) as sp:
            n_events = 0
            while True:
                e = self.queue.pop()
                self.clock.advance_to(e.time)
                self._log(e)
                n_events += 1
                if e.kind == ev.BLOCK_SLOT and e.round_idx == r:
                    break
                if e.round_idx != r:
                    continue                  # late event from an old round
                if e.kind == ev.UPDATE_READY:
                    arrived_set.add(e.client)
            sp.set(n_events=n_events)

        arrived = np.array([int(g) in arrived_set for g in cohort], dtype=bool)
        # with FaultSpec.retry a dropout may recover and still arrive;
        # count only the deaths that stuck (faults off: all of them)
        n_drop = sum(1 for g in dropouts if g not in arrived_set)
        n_strag = int(len(cohort) - arrived.sum() - n_drop)
        rt.set(arrived=int(arrived.sum()))

        record = SimRoundRecord(
            round_idx=r, t_open=t0, t_close=self.clock.now, cohort=cohort,
            arrived=arrived, n_stragglers=n_strag, n_dropouts=n_drop,
            n_byzantine=int(pop.byzantine[cohort][arrived].sum()),
            producer=-1, verified_frac=0.0, reward_paid=0.0,
            reward_burned=0.0, mean_loss=float("nan"))

        if not arrived.any():
            obs.inc("rounds.empty")
            return record                     # empty round: no block minted

        with obs.span("round.gather", round=r):
            cx, cy = pop.cohort_data(cohort)
        arrived_w = torch.as_tensor(arrived, dtype=torch.float32,
                                    device=self.device)
        cohort_idx = torch.as_tensor(cohort, dtype=torch.long,
                                     device=self.device)
        with obs.span("round.step", round=r):
            out = self.engine.sync_step(self.arena, cohort_idx, cx, cy,
                                        arrived_w)
        with obs.span("round.digests", round=r):
            digests = self.engine.format_digests(out.residues)
        self.faults.maybe_crash(r, "pre_chain")
        with obs.span("round.chain", round=r):
            cres = self.trainer.chain_round(
                r, None, out.labels, out.corr, cohort=cohort, arrived=arrived,
                digests=digests, tamper=self._tampers(cohort, arrived))

        labels = out.labels.cpu().numpy()
        self.last_labels[np.asarray(cohort)[arrived]] = labels[arrived]
        record.producer = cres.producer
        record.verified_frac = float(cres.verified[arrived].mean())
        record.reward_paid = float(cres.rewards.sum())
        record.reward_burned = float(self.spec.chain.total_reward
                                     - cres.rewards.sum())
        record.mean_loss = float(out.mean_loss)
        every = self.spec.eval.every
        if every and (r + 1) % every == 0:
            ex, ey = self._eval_slices()
            # the outputs stay on the device until the end of the run:
            # metrics never gate the round
            with obs.span("round.eval", round=r):
                record.accuracy, record.cluster_accuracy = \
                    self.engine.eval_cohort(out.new_rows, arrived_w,
                                            out.labels, ex, ey)
        return record

    # ------------------------------------------------------------------ #
    # asynchronous mode (FedBuff)
    # ------------------------------------------------------------------ #

    def _run_async(self) -> None:
        cfg, acfg, pop, rng = self.cfg, self.spec.async_, self.pop, self.rng
        if acfg.buffer_size + acfg.concurrency > pop.n_clients:
            # buffered clients stay "busy" until their flush: a buffer that
            # cannot fill from the remaining population stalls forever
            raise ValueError(
                f"buffer_size ({acfg.buffer_size}) + concurrency "
                f"({acfg.concurrency}) exceeds the population "
                f"({pop.n_clients}); the buffer could never fill")
        resume = self._resume_async
        self._resume_async = None
        if resume is not None:
            # loop state restored from a flush-boundary snapshot: the
            # post-flush dispatch happened before the snapshot, so the loop
            # re-enters directly
            version = resume["version"]
            global_state = resume["global_state"]
            snapshots: dict[int, torch.Tensor] = resume["snapshots"]
            inflight: dict[int, int] = resume["inflight"]
            agg = resume["agg"]
        else:
            version = 0
            global_state = self.arena.data[0].clone()       # (N,) flat row
            snapshots = {0: global_state}
            inflight = {}                  # client -> dispatch version
            agg = BufferedAggregator(acfg.buffer_size, acfg.staleness_alpha)

        def dispatch() -> None:
            want = acfg.concurrency - len(inflight)
            if want <= 0:
                return
            # a client in flight OR sitting in the buffer must not be
            # re-dispatched: a duplicate in one flush cohort would collapse
            # its two rewards into one ledger slot.  setdiff1d sorts, so
            # the set's iteration order never reaches the event queue
            busy = set(inflight) | {u.client for u in agg.buffer}
            online = pop.online_clients(rng)
            online = np.setdiff1d(online, np.fromiter(busy, np.int64,
                                                      len(busy)))
            picked = self.sampler(rng, online, want, self._sampler_state())
            t = self.clock.now
            for gid in picked:
                gid = int(gid)
                inflight[gid] = version
                self.queue.push(t, ev.CLIENT_ARRIVAL, gid,
                                round_idx=version, tag=version)
                lat = pop.latency.draw(gid)
                if rng.random() < pop.dropout[gid]:
                    self.queue.push(t + lat * rng.uniform(0.1, 0.9),
                                    ev.DROPOUT, gid, version, tag=version)
                else:
                    self.queue.push(t + lat, ev.UPDATE_READY, gid, version,
                                    tag=version)

        if resume is None:
            dispatch()
        while version < cfg.rounds and self.queue:
            e = self.queue.pop()
            self.clock.advance_to(e.time)
            self._log(e)
            if e.kind == ev.DROPOUT:
                inflight.pop(e.client, None)
                dispatch()
                continue
            if e.kind != ev.UPDATE_READY:
                continue
            dispatched_v = inflight.pop(e.client, None)
            if dispatched_v is None:
                continue
            agg.add(BufferedUpdate(e.client, None, dispatched_v))
            flushed = len(agg) >= acfg.buffer_size
            if flushed:
                version, global_state = self._async_flush(
                    agg, version, global_state, snapshots)
                snapshots[version] = global_state
                live = set(inflight.values()) | {version}
                for v in [v for v in snapshots if v not in live]:
                    del snapshots[v]
            dispatch()
            if flushed:
                # flush boundary: snapshot AFTER the post-flush dispatch so
                # a resume re-enters the loop with nothing left to re-issue
                self._maybe_checkpoint(version, async_view={
                    "version": version, "global_state": global_state,
                    "snapshots": snapshots, "inflight": inflight,
                    "agg": agg})
                if self.faults.will_crash(version, "post_checkpoint"):
                    self._ckpt_wait()      # snapshot durable before dying
                self.faults.maybe_crash(version, "post_checkpoint")

        if version < cfg.rounds:
            # event queue drained early (e.g. availability collapse) — the
            # report simply carries fewer flushes than requested
            self.event_log.append((self.clock.now, "queue_drained", -1,
                                   version, 0))
        self.arena.rebind(global_state[None].repeat(self.arena.n_clients, 1))

    def _async_flush(self, agg: BufferedAggregator, version: int,
                     global_state: torch.Tensor, snapshots: dict) -> tuple:
        """One buffer flush = one training batch + one block + one merge."""
        with self.obs.span("flush.total", cat="flush", round=version):
            return self._async_flush_body(agg, version, global_state,
                                          snapshots)

    def _async_flush_body(self, agg: BufferedAggregator, version: int,
                          global_state: torch.Tensor, snapshots: dict
                          ) -> tuple:
        cfg, acfg, pop, obs = self.cfg, self.spec.async_, self.pop, self.obs
        self.faults.maybe_crash(version, "round_start")
        clients = np.array([u.client for u in agg.buffer], dtype=np.int64)
        versions = [u.version for u in agg.buffer]
        k = len(clients)
        with obs.span("flush.gather", cat="flush", round=version):
            cx, cy = pop.cohort_data(clients)

        # chain: single-cluster CACC over the flush group
        labels = torch.zeros(k, dtype=torch.long)
        corr = torch.eye(k, dtype=torch.float32)
        arrived = np.ones(k, dtype=bool)
        tamper = self._tampers(clients, arrived)

        with obs.span("flush.step", cat="flush", round=version):
            base_rows = torch.stack([snapshots[v] for v in versions])  # (k, N)
            local_rows, residues, mean_loss = self.engine.async_step(
                base_rows, cx, cy)
        self.faults.maybe_crash(version, "pre_chain")
        with obs.span("flush.chain", cat="flush", round=version):
            cres = self.trainer.chain_round(
                version, None, labels, corr, cohort=clients, arrived=arrived,
                tamper=tamper, digests=self.engine.format_digests(residues))
        staleness = np.array([version - v for v in versions], np.int64)
        w = staleness_weight(staleness, acfg.staleness_alpha) \
            * cres.verified.astype(np.float32)
        with obs.span("flush.merge", cat="flush", round=version):
            merged = weighted_delta_mean(
                local_rows - base_rows,
                torch.from_numpy(w).to(local_rows.device))
            global_state = global_state + acfg.server_lr * merged
        agg.buffer = []

        new_version = version + 1
        self.last_labels[clients] = 0
        record = SimRoundRecord(
            round_idx=version, t_open=self.clock.now, t_close=self.clock.now,
            cohort=clients, arrived=arrived, n_stragglers=0, n_dropouts=0,
            n_byzantine=int(pop.byzantine[clients].sum()),
            producer=cres.producer,
            verified_frac=float(cres.verified.mean()),
            reward_paid=float(cres.rewards.sum()),
            reward_burned=float(self.spec.chain.total_reward
                                - cres.rewards.sum()),
            mean_loss=float(mean_loss),
            staleness_mean=float(staleness.mean()))
        every = self.spec.eval.every
        if every and new_version % every == 0:
            ex, ey = self._eval_slices()
            # deferred like the sync eval: on the host at the end of the run
            with obs.span("flush.eval", cat="flush", round=version):
                record.accuracy = self.engine.eval_global(global_state, ex, ey)
        self.history.append(record)
        return new_version, global_state

    # ------------------------------------------------------------------ #

    def _finalize_history(self) -> None:
        """Bring the deferred eval metrics to the host."""
        for rec in self.history:
            rec.accuracy = float(rec.accuracy)
            if isinstance(rec.cluster_accuracy, torch.Tensor):
                rec.cluster_accuracy = rec.cluster_accuracy.cpu().numpy()

    def _maybe_checkpoint(self, boundary: int,
                          async_view: dict | None = None) -> None:
        """Snapshot the complete experiment state when ``boundary``
        (completed rounds/flushes) hits the checkpoint interval.

        Only the capture (a consistent host copy of all state) runs on the
        round's thread; encoding, sha256, write and fsync go to one
        background writer so the next round overlaps the disk work.  At
        most one write is in flight: a new boundary first retires the
        previous one.  The writer stages to a temp file and renames
        atomically, so a death mid-write leaves the previous snapshot
        intact; the fault injector corrupts the file (if scheduled) only
        after its write completes."""
        ck = self.ckpt
        if ck is None or boundary == 0 or boundary % ck.interval:
            return
        from repro_torch.checkpoint import save_checkpoint
        from repro_torch.checkpoint.state import capture_experiment_state
        with self.obs.span("ckpt.save", cat="ckpt", round=boundary) as sp:
            tree = capture_experiment_state(self, boundary, async_view)
            self._ckpt_wait()          # retire the previous in-flight write
            if self._ckpt_executor is None:
                self._ckpt_executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-writer")
            faults = self.faults

            def _write() -> int:
                path, n_bytes = save_checkpoint(ck.dir, boundary, tree,
                                                keep_last=ck.keep_last)
                faults.corrupt_checkpoint(path, boundary)
                return n_bytes
            self._ckpt_future = self._ckpt_executor.submit(_write)
            sp.set(boundary=boundary)

    def _ckpt_wait(self) -> None:
        """Block until the in-flight snapshot write (if any) is durable,
        then count it.  Re-raises a failed write's exception here."""
        fut, self._ckpt_future = self._ckpt_future, None
        if fut is None:
            return
        n_bytes = fut.result()
        self.obs.inc("ckpt.saved")
        self.obs.set_gauge("ckpt.bytes", n_bytes)
        self._ckpt_written += 1
        self._ckpt_bytes = n_bytes

    def _restore(self, resume_from: str) -> int:
        """Restore from ``resume_from`` (a snapshot file, or a checkpoint
        directory whose newest *readable* snapshot is used).  Returns the
        next round/flush index to execute."""
        from repro_torch.checkpoint import load_latest, load_pytree
        from repro_torch.checkpoint.state import restore_experiment_state
        with self.obs.span("ckpt.restore", cat="ckpt") as sp:
            if os.path.isdir(resume_from):
                _, tree = load_latest(resume_from)
            else:
                tree = load_pytree(resume_from)
            next_round, async_view = restore_experiment_state(self, tree)
            sp.set(step=next_round)
        self.obs.inc("ckpt.restored")
        self._resume_async = async_view
        self._resumed_from = (resume_from, next_round)
        return next_round

    def run(self, resume_from: str | None = None) -> SimReport:
        """Run every round (sync) or flush (async), from the start or from
        the snapshot ``resume_from``.  The checkpoint writer is shut down
        before this returns or raises, so no write outlives the run."""
        try:
            start = self._restore(resume_from) if resume_from is not None else 0
            if self.cfg.mode == "sync":
                for r in range(start, self.cfg.rounds):
                    self.history.append(self._run_sync_round(r))
                    self._maybe_checkpoint(r + 1)
                    if self.faults.will_crash(r + 1, "post_checkpoint"):
                        self._ckpt_wait()      # snapshot durable before dying
                    self.faults.maybe_crash(r + 1, "post_checkpoint")
            elif self.cfg.mode == "async":
                self._run_async()
            else:
                raise ValueError(f"unknown mode {self.cfg.mode!r}")
            self._ckpt_wait()                  # retire any in-flight snapshot
        finally:
            if self._ckpt_executor is not None:   # an in-flight write ends first
                self._ckpt_executor.shutdown(wait=True)
                self._ckpt_executor = None
        self._finalize_history()

        n_eval = min(self.spec.eval.clients, self.pop.n_clients)
        eval_ids = np.linspace(0, self.pop.n_clients - 1, n_eval).astype(int)
        with self.obs.span("run.final_eval", cat="run") as sp:
            final_acc = self._evaluate_clients(eval_ids)
            sp.set(n_eval=n_eval)
        ledger = self.trainer.ledger
        return SimReport(
            config=self.spec, history=self.history, event_log=self.event_log,
            final_accuracy=final_acc, balances=ledger.balances.copy(),
            chain_valid=self.trainer.chain.validate(),
            n_blocks=len(self.trainer.chain.blocks),
            ledger_conserved=ledger.conserved())
