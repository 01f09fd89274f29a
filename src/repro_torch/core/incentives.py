"""Incentive mechanism based on cluster membership size (paper §IV-C-1).

Port of ``repro.core.incentives``, in float32 as the reference computes
it:

    Gamma(n_i) = kappa n_i^rho,  kappa = R / sum_i n_i^rho      (Eqs. 7-8)
    per-client reward r = Gamma(n_i) / n_i,  fee g = kappa / N   (Eq. 9)

``participating`` masks partial-participation rounds: sizes count only
participants, non-participants get nothing, the fee divides by the
participant count.  :func:`apply_round_settlement` is the tensor mirror
of the host ledger's settlement (``repro_torch.blockchain.ledger`` is the
authoritative copy).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RewardAllocation(NamedTuple):
    cluster_reward: torch.Tensor   # (C,) Gamma(n_i)
    client_reward: torch.Tensor    # (m,) r_k for every client
    kappa: torch.Tensor            # scalar
    fee: torch.Tensor              # scalar g = kappa / N


def allocate_rewards(labels: torch.Tensor, n_clusters: int,
                     total_reward: float, rho: float = 2.0,
                     participating: torch.Tensor | None = None
                     ) -> RewardAllocation:
    labels = labels.long()
    m = labels.shape[0]
    part = torch.ones((m,), dtype=torch.float32, device=labels.device) \
        if participating is None else participating.float()
    clusters = torch.arange(n_clusters, device=labels.device)
    onehot = (labels[:, None] == clusters[None, :]).float() * part[:, None]
    sizes = onehot.sum(dim=0)
    powered = torch.where(sizes > 0, sizes ** rho, torch.zeros_like(sizes))
    denom = powered.sum()
    # zero participants -> zero pool, never total_reward / eps.  The pool is
    # a float32 tensor: ``float / tensor`` would be reciprocal-then-multiply
    # in PyTorch, two roundings where the reference divides once
    pool = torch.tensor(total_reward, dtype=torch.float32, device=labels.device)
    kappa = torch.where(denom > 0, pool / torch.clamp(denom, min=1e-12),
                        torch.zeros_like(denom))
    cluster_reward = kappa * powered
    per_capita = cluster_reward / torch.clamp(sizes, min=1.0)
    client_reward = per_capita[labels] * part
    fee = kappa / torch.clamp(part.sum(), min=1.0)
    return RewardAllocation(cluster_reward, client_reward, kappa, fee)


def apply_round_settlement(balances: torch.Tensor, alloc: RewardAllocation,
                           producer: int, verified: torch.Tensor
                           ) -> torch.Tensor:
    """Settle one round on a balances tensor: every *verified* client
    receives its reward and pays the fee g; the producer collects the fees
    only if its OWN commitment verified, else they are burned; unverified
    clients receive and pay nothing (their reward is burned)."""
    verified = verified.to(balances.dtype)
    fees = alloc.fee * verified
    credit = alloc.client_reward * verified
    balances = balances + credit - fees
    balances[producer] += fees.sum() * verified[producer]
    return balances
