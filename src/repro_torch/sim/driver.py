"""`SimulatedFederation` — event-driven federation over a virtual population.

Port of the synchronous engine path of ``repro.sim.driver``.  Per round:

    1. availability draw -> online pool -> sampler picks the cohort,
    2. cohort events on the virtual clock (arrival, update-ready after the
       client's latency, dropout); the block slot closes the round,
    3. the round engine (``repro_torch.core.engine``): arena gather ->
       local training -> PAA (arrival mask = aggregation weights) -> cohort
       fingerprints -> masked scatter-back into the arena, in place,
    4. ``FederatedTrainer.chain_round``: hash commits, CACC packing queue,
       block, verification, reward settlement on the population ledger.

Steps 1-2 and the event log are the reference's, numpy RNG call for call
(``online_clients``, the sampler, ``latency.draw``, ``rng.random``,
``rng.uniform``), so a seeded run logs the same events in both packages.
Parameters, data and the arena live on the run's device; labels, the
Pearson matrix, the residues and the loss come to the host every round.

Byzantine clients train honestly but commit a digest of params they did not
train (the paper's freeriding attack); CACC verification refuses them.
Async FedBuff, the legacy ``engine=False`` driver, the mesh, checkpoints
and fault injection come with later slices (ROADMAP queue 1).
"""
from __future__ import annotations

import functools
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
from repro_torch.models import classifier as clf
from repro_torch.obs import NULL_RECORDER
from repro_torch.optim import adam
from repro_torch.runtime.arena import ParamArena
from repro_torch.sim import events as ev
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
    accuracy: Any = float("nan")      # cohort accuracy (a device scalar until
                                      # the end of the run)
    cluster_accuracy: Any = None      # (C,) at eval rounds


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
    """Sync rounds of the spec's strategy over sampled cohorts of a virtual population, on a
    deterministic virtual clock, with the population's parameters in one
    arena on ``device`` (``None`` means the card).

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
        self.trainer.attach_obs(self.obs)

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
                self.queue.push(t0 + lat * rng.uniform(0.1, 0.9), ev.DROPOUT,
                                gid, r)
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
        n_drop = len(dropouts)
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

    def _finalize_history(self) -> None:
        """Bring the deferred eval metrics to the host."""
        for rec in self.history:
            rec.accuracy = float(rec.accuracy)
            if rec.cluster_accuracy is not None:
                rec.cluster_accuracy = rec.cluster_accuracy.cpu().numpy()

    def run(self) -> SimReport:
        for r in range(self.cfg.rounds):
            self.history.append(self._run_sync_round(r))
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
