"""Token ledger for the BFLN incentive mechanism.

Copy of ``repro.blockchain.ledger.TokenLedger`` (host-side numpy).
Conservation invariant: tokens only enter via minting (initial stake +
round reward pool) and total supply equals the sum of balances at all
times.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import NULL_RECORDER


@dataclass
class TokenLedger:
    n_clients: int
    initial_stake: float = 5.0
    balances: np.ndarray = field(init=False)
    minted: float = field(init=False)

    def __post_init__(self):
        self.balances = np.full((self.n_clients,), float(self.initial_stake))
        self.minted = float(self.initial_stake) * self.n_clients
        self.obs = NULL_RECORDER    # recorder (repro_torch.obs), rebindable

    def mint_reward_pool(self, amount: float) -> float:
        self.minted += float(amount)
        return float(amount)

    def settle_round(self, client_reward: np.ndarray, fee: float,
                     producer: int, verified: np.ndarray) -> None:
        """Verified clients receive their reward and pay the aggregation fee;
        the producer collects the fees only if its OWN commitment verified —
        otherwise the fees are burned alongside the unverified rewards."""
        client_reward = np.asarray(client_reward, dtype=np.float64)
        verified = np.asarray(verified, dtype=bool)
        paid = np.where(verified, client_reward, 0.0)
        fees = np.where(verified, fee, 0.0)
        self.balances = self.balances + paid - fees
        if verified[producer]:
            self.balances[producer] += fees.sum()
        else:
            self.minted -= float(fees.sum())        # forfeited fees leave supply
        # burned tokens leave supply
        burned = float(np.where(~verified, client_reward, 0.0).sum())
        self.minted -= burned
        obs = self.obs
        if obs.enabled:
            obs.observe("ledger.paid", float(paid.sum()))
            obs.observe("ledger.fees", float(fees.sum()))
            obs.observe("ledger.burned", burned)

    def total_supply(self) -> float:
        return float(self.balances.sum())

    def conserved(self, rtol: float = 1e-6) -> bool:
        tol = rtol * max(1.0, abs(self.minted))
        return abs(self.total_supply() - self.minted) <= tol
