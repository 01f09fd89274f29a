"""The BFLN federated round driver (paper Fig. 1, steps 1-6).

Port of ``repro.core.round``.  :class:`FederatedTrainer` runs strategy
rounds over stacked clients — every baseline and BFLN, the paper's
full-participation protocol (``init`` / ``run_round``; Table II and Fig 2,
``repro_torch.paper``) — and holds the host-side blockchain protocol
(``chain_round``): hash commitments, the CACC packing queue, the block,
consensus verification and participation-aware reward settlement.  The
simulator drives ``chain_round`` alone; its training half runs in the
round engine (``repro_torch.core.engine``).  A bound fault injector
(:meth:`FederatedTrainer.attach_faults`, ``repro_torch.faults``) makes the
protocol absorb dropped and delayed commits, a failed producer and a bad
block, as the reference's does.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.blockchain import (
    AGG_COMMIT_KIND,
    MODEL_COMMIT_KIND,
    Blockchain,
    RoundCommitments,
    TokenLedger,
    Transaction,
    TxPool,
)
from repro_torch.core import consensus as cacc
from repro_torch.core.baselines import AggOut, ModelBundle, Strategy
from repro_torch.core.fl import global_evaluate, local_train
from repro_torch.core.incentives import allocate_rewards
from repro_torch.faults import NULL_INJECTOR
from repro_torch.kernels.fingerprint import cohort_digests
from repro_torch.obs import NULL_RECORDER
from repro_torch.optim import Optimizer
from repro_torch.utils.tree import tree_leaves, tree_map

Pytree = Any


def digest_of(params: Pytree) -> str:
    """Fingerprint digest of ONE client's (unstacked) param dict — the
    commitment a client would make for these params."""
    return cohort_digests(tree_map(lambda x: x[None], params))[0]


@dataclass
class RoundRecord:
    round_idx: int
    mean_loss: float
    accuracy: float
    labels: np.ndarray | None = None
    cluster_sizes: np.ndarray | None = None
    rewards: np.ndarray | None = None
    balances: np.ndarray | None = None
    producer: int = -1
    verified_frac: float = 1.0


@dataclass
class ChainRoundResult:
    """Outcome of the chain protocol for one round's cohort."""
    producer: int               # global client id of the packing client
    verified: np.ndarray        # (n_cohort,) consensus verification mask
    rewards: np.ndarray         # (n_cohort,) settled rewards (0 if unverified)
    block: Any = None


@dataclass
class FederatedTrainer:
    """Runs strategy rounds over stacked clients; BFLN adds the chain.

    ``strategy`` may be a built :class:`Strategy` or a registry name
    (``repro_torch.api.registry``), resolved at construction against
    ``model`` / ``probe`` / ``n_clusters``.  The token ledger is sized by
    ``init`` to the stacked clients, or installed by the caller (the
    simulator's, sized to the population).
    """
    model: ModelBundle
    strategy: Strategy | str
    opt: Optimizer
    local_epochs: int = 5
    n_clusters: int = 0              # >0 enables CACC/chain (BFLN)
    total_reward: float = 20.0       # paper: "Local training total stake reward"
    rho: float = 2.0                 # paper Table I
    initial_stake: float = 5.0       # paper Table I
    use_chain: bool = True
    probe: Any = None                # PAA probe batch (name-resolved bfln)
    history: list[RoundRecord] = field(default_factory=list)

    def __post_init__(self):
        if isinstance(self.strategy, str):
            from repro_torch.api.registry import build_strategy
            self.strategy = build_strategy(self.strategy, self.model,
                                           probe=self.probe,
                                           n_clusters=self.n_clusters)
        self.chain = Blockchain()
        self.pool = TxPool()
        self.ledger: TokenLedger | None = None
        self._queue: list[int] = []
        self.obs = NULL_RECORDER
        self.faults = NULL_INJECTOR

    def attach_obs(self, obs) -> None:
        """Bind a recorder to the trainer, its chain and its ledger."""
        self.obs = obs
        self.chain.obs = obs
        if self.ledger is not None:
            self.ledger.obs = obs

    def attach_faults(self, faults) -> None:
        """Bind a fault injector (``repro_torch.faults``) so the chain
        protocol absorbs injected producer failures, bad blocks and
        commit-delivery faults.  Default: the shared no-op injector."""
        self.faults = faults

    def init(self, stacked_params: Pytree) -> tuple[Pytree, Pytree]:
        """Size the ledger to the stacked clients (with the chain) and
        start the optimizer: ``(stacked_params, stacked_opt_state)``."""
        n = tree_leaves(stacked_params)[0].shape[0]
        if self.use_chain:
            self.ledger = TokenLedger(n, self.initial_stake)
            self.ledger.obs = self.obs
        return stacked_params, self.opt.init(stacked_params)

    def _train_round(self, stacked_params, stacked_opt, cx, cy):
        strategy = self.strategy
        extras = strategy.round_extras(stacked_params, cx, cy)
        res = local_train(strategy.local_loss, self.opt, stacked_params,
                          stacked_opt, cx, cy, extras, self.local_epochs,
                          shared_extras=strategy.shared_extras)
        agg: AggOut = strategy.aggregate(res.params, cx, cy, self.obs)
        return res.params, agg, res.opt_state, res.mean_loss.mean()

    def run_round(self, round_idx: int, stacked_params: Pytree,
                  stacked_opt: Pytree, cx: torch.Tensor, cy: torch.Tensor,
                  test_x: torch.Tensor, test_y: torch.Tensor,
                  tamper: dict[int, Pytree] | None = None
                  ) -> tuple[Pytree, Pytree, RoundRecord]:
        """One full-participation round: every client trains, the strategy
        aggregates; with ``use_chain`` and cluster labels (BFLN) the chain
        protocol runs on the round's trained params; the record carries the
        mean accuracy on the shared test set.  ``tamper`` (tests only) swaps
        the params a client *claims* (hash-commits)."""
        local_params, agg, stacked_opt, mean_loss = self._train_round(
            stacked_params, stacked_opt, cx, cy)
        record = RoundRecord(round_idx, float(mean_loss), 0.0)
        if self.use_chain and agg.labels is not None:
            cres = self.chain_round(round_idx, local_params, agg.labels,
                                    agg.corr, tamper=tamper)
            record.labels = agg.labels.cpu().numpy()
            record.cluster_sizes = agg.cluster_sizes.cpu().numpy()
            record.rewards = cres.rewards
            record.balances = self.ledger.balances.copy()
            record.producer = cres.producer
            record.verified_frac = float(cres.verified.mean())
        record.accuracy = float(global_evaluate(self.model.apply_fn,
                                                agg.stacked_params, test_x, test_y))
        self.history.append(record)
        return agg.stacked_params, stacked_opt, record

    def fit(self, stacked_params: Pytree, cx, cy, test_x, test_y,
            rounds: int, log_every: int = 0,
            log_fn: Callable[[str], None] = print) -> Pytree:
        """``init`` then ``rounds`` calls of ``run_round``; every
        ``log_every`` rounds (and the last) one line to ``log_fn``, in the
        reference's format.  Returns the final stacked params."""
        stacked_params, stacked_opt = self.init(stacked_params)
        for r in range(rounds):
            stacked_params, stacked_opt, rec = self.run_round(
                r, stacked_params, stacked_opt, cx, cy, test_x, test_y)
            if log_every and (r % log_every == 0 or r == rounds - 1):
                log_fn(f"[{self.strategy.name}] round {r:3d} "
                       f"loss={rec.mean_loss:.4f} acc={rec.accuracy:.4f}"
                       + (f" clusters={rec.cluster_sizes.tolist()}"
                          if rec.cluster_sizes is not None else ""))
        return stacked_params

    def chain_round(self, round_idx: int, local_params: Pytree | None,
                    labels: torch.Tensor, corr: torch.Tensor,
                    cohort: np.ndarray | None = None,
                    arrived: np.ndarray | None = None,
                    tamper: dict[int, str | Pytree] | None = None,
                    digests: list[str] | None = None) -> ChainRoundResult:
        """The chain protocol over one round's cohort.

        ``local_params`` are the slot-stacked trained params; ``cohort``
        maps slot -> global client id (default: identity, the paper's
        always-on clients); ``arrived`` masks the slots whose update reached
        the producer before the block slot (default: all; stragglers and
        dropouts never commit and are never rewarded); ``tamper`` (keyed by
        global client id) substitutes the digest a client *commits* — a
        digest string, or a param dict to digest — the freerider path that
        verification must refuse.  ``digests`` are the per-slot
        fingerprints if the caller has them (the round engine computes them
        in its step, and ``local_params`` may then be ``None``); otherwise
        one fingerprint call over ``local_params`` makes them.
        """
        if self.ledger is None:
            raise ValueError("chain_round needs a ledger sized to the population")
        labels = torch.as_tensor(labels).cpu()
        corr = torch.as_tensor(corr).cpu()
        k = int(labels.shape[0])
        cohort = np.arange(k) if cohort is None else np.asarray(cohort)
        arrived = np.ones(k, bool) if arrived is None else np.asarray(arrived, bool)
        n_total = self.ledger.n_clients
        tamper = tamper or {}

        if not arrived.any():
            # nobody delivered an update: no block, the pool stays unminted
            return ChainRoundResult(-1, np.zeros(k, bool), np.zeros(k))

        obs = self.obs
        if digests is None:
            # one fingerprint call over the slot-stacked trained params
            with obs.span("chain.digests", cat="chain", round=round_idx):
                digests = cohort_digests(local_params)

        # -- Fig.1 step 2: arrived clients commit model digests ------------ #
        faults = self.faults
        with obs.span("chain.commit", cat="chain", round=round_idx) as sp:
            # commits a fault delayed in an earlier round arrive only now —
            # they land in THIS block, where verification ignores them
            # (model_hash txs from another round carry no weight)
            for late in faults.release_commits():
                self.pool.submit(late)
                obs.event("fault.commit_delivered_late", round=round_idx,
                          client=late.sender, from_round=late.round_idx)
            entries: list[tuple[int, str]] = []  # what the producer aggregated
            arrived_slots = [s for s in range(k) if arrived[s]]
            drop_i = faults.commit_drop_slot(round_idx, len(arrived_slots))
            delay_i = faults.commit_delay_slot(round_idx, len(arrived_slots))
            for j, slot in enumerate(arrived_slots):
                gid = int(cohort[slot])
                claimed = tamper.get(gid, digests[slot])
                if not isinstance(claimed, str):
                    claimed = digest_of(claimed)
                tx = Transaction(MODEL_COMMIT_KIND, gid, claimed, round_idx)
                if j == drop_i:
                    # lost in transit: the producer aggregated this client's
                    # update, but its commit never reaches the pool — the
                    # client fails verification and forfeits its reward
                    obs.event("fault.commit_dropped", round=round_idx,
                              client=gid)
                    obs.inc("fault.commit_dropped")
                elif j == delay_i:
                    faults.hold_commit(tx)
                    obs.event("fault.commit_delayed", round=round_idx,
                              client=gid)
                    obs.inc("fault.commit_delayed")
                else:
                    self.pool.submit(tx)
                entries.append((gid, digests[slot]))
            sp.set(n_commits=len(entries))

        # -- CACC: centroid representatives -> packing queue --------------- #
        with obs.span("chain.consensus", cat="chain", round=round_idx):
            sel = cacc.select_centroid_clients(corr, labels, self.n_clusters)
            queue = [int(cohort[slot])
                     for slot in cacc.packing_queue(sel.representatives)]
            self._queue = queue or self._queue or [int(cohort[0])]
            active = {int(g) for g in cohort[arrived]}
            try:
                producer = cacc.producer_for_round(self._queue, round_idx,
                                                   active)
            except ValueError:
                producer = min(active)  # no representative arrived this round
            if faults.producer_fails(round_idx):
                # producer death mid-pack: fail over to the next consensus
                # candidate, exactly as every validator would recompute the
                # slot from the same queue and the reduced active set
                remaining = active - {producer}
                if remaining:
                    failed = producer
                    try:
                        producer = cacc.producer_for_round(
                            self._queue, round_idx, remaining)
                    except ValueError:
                        producer = min(remaining)
                    obs.event("fault.producer_failover", round=round_idx,
                              failed=failed, successor=producer)
                    obs.inc("fault.producer_failover")
                # a sole active client has no successor: it keeps the slot

        # -- Fig.1 step 5: producer records sender-bound commitments ------- #
        commits = RoundCommitments(round_idx, tuple(entries))
        self.pool.submit(Transaction(
            AGG_COMMIT_KIND, producer, commits.to_payload(), round_idx))
        block = self.chain.pack_block(round_idx, producer, self.pool,
                                      faults=faults)

        # -- Fig.1 step 6: consensus verification + incentives ------------- #
        verified_total = self.chain.verify_round(block, n_total)
        with obs.span("chain.rewards", cat="chain", round=round_idx):
            alloc = allocate_rewards(labels, self.n_clusters,
                                     self.total_reward, self.rho,
                                     participating=torch.as_tensor(arrived))
            rewards_total = np.zeros(n_total)
            rewards_total[cohort] = alloc.client_reward.numpy()
            self.ledger.mint_reward_pool(self.total_reward)
            self.ledger.settle_round(rewards_total, float(alloc.fee),
                                     producer, verified_total)

        verified = verified_total[cohort]
        rewards = np.where(verified, rewards_total[cohort], 0.0)
        return ChainRoundResult(producer, verified, rewards, block)
