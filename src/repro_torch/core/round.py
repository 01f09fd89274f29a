"""The host-side blockchain protocol of a BFLN round (paper Fig. 1, steps
2, 5 and 6).

Port of ``repro.core.round``: ``digest_of`` and
``FederatedTrainer.chain_round``, the part the simulator drives — hash
commitments, the CACC packing queue, the block, consensus verification and
participation-aware reward settlement on the population ledger.  The
training half of a round lives in the round engine
(``repro_torch.core.engine``).  The fault-injection hooks come with a later
slice (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

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
from repro_torch.core.incentives import allocate_rewards
from repro_torch.kernels.fingerprint import cohort_digests
from repro_torch.obs import NULL_RECORDER
from repro_torch.utils.tree import tree_map

Pytree = Any


def digest_of(params: Pytree) -> str:
    """Fingerprint digest of ONE client's (unstacked) param dict — the
    commitment a client would make for these params."""
    return cohort_digests(tree_map(lambda x: x[None], params))[0]


@dataclass
class ChainRoundResult:
    """Outcome of the chain protocol for one round's cohort."""
    producer: int               # global client id of the packing client
    verified: np.ndarray        # (n_cohort,) consensus verification mask
    rewards: np.ndarray         # (n_cohort,) settled rewards (0 if unverified)
    block: Any = None


@dataclass
class FederatedTrainer:
    """The chain side of BFLN rounds: chain, transaction pool, packing
    queue and the population's token ledger (``ledger`` is installed by the
    caller, sized to the population)."""
    n_clusters: int
    total_reward: float = 20.0       # paper: "Local training total stake reward"
    rho: float = 2.0                 # paper Table I
    ledger: TokenLedger | None = None
    chain: Blockchain = field(default_factory=Blockchain)
    pool: TxPool = field(default_factory=TxPool)

    def __post_init__(self):
        self._queue: list[int] = []
        self.obs = NULL_RECORDER

    def attach_obs(self, obs) -> None:
        """Bind a recorder to the trainer, its chain and its ledger."""
        self.obs = obs
        self.chain.obs = obs
        if self.ledger is not None:
            self.ledger.obs = obs

    def chain_round(self, round_idx: int, labels: torch.Tensor,
                    corr: torch.Tensor, *, cohort: np.ndarray,
                    arrived: np.ndarray, digests: list[str],
                    tamper: dict[int, str | Pytree] | None = None
                    ) -> ChainRoundResult:
        """The chain protocol over one round's cohort.

        ``cohort`` maps slot -> global client id, ``arrived`` masks the slots
        whose update reached the producer before the block slot (stragglers
        and dropouts never commit and are never rewarded), ``digests`` are
        the per-slot fingerprints of the trained rows, and ``tamper`` (keyed
        by global client id) substitutes the digest a client *commits* — a
        digest string, or a param dict to digest — the freerider path that
        verification must refuse.
        """
        if self.ledger is None:
            raise ValueError("chain_round needs a ledger sized to the population")
        labels = torch.as_tensor(labels).cpu()
        corr = torch.as_tensor(corr).cpu()
        k = int(labels.shape[0])
        cohort = np.asarray(cohort)
        arrived = np.asarray(arrived, bool)
        n_total = self.ledger.n_clients
        tamper = tamper or {}

        if not arrived.any():
            # nobody delivered an update: no block, the pool stays unminted
            return ChainRoundResult(-1, np.zeros(k, bool), np.zeros(k))

        obs = self.obs
        # -- Fig.1 step 2: arrived clients commit model digests ------------ #
        with obs.span("chain.commit", cat="chain", round=round_idx) as sp:
            entries: list[tuple[int, str]] = []  # what the producer aggregated
            for slot in range(k):
                if not arrived[slot]:
                    continue
                gid = int(cohort[slot])
                claimed = tamper.get(gid, digests[slot])
                if not isinstance(claimed, str):
                    claimed = digest_of(claimed)
                self.pool.submit(Transaction(MODEL_COMMIT_KIND, gid, claimed,
                                             round_idx))
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

        # -- Fig.1 step 5: producer records sender-bound commitments ------- #
        commits = RoundCommitments(round_idx, tuple(entries))
        self.pool.submit(Transaction(
            AGG_COMMIT_KIND, producer, commits.to_payload(), round_idx))
        block = self.chain.pack_block(round_idx, producer, self.pool)

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
