"""Per-round client sampling strategies.

Copy of ``repro.sim.sampler`` (numpy only): ``uniform``, ``stake_weighted``
and ``cluster_stratified``, each drawing from an explicit
``numpy.random.Generator`` so a seeded run replays exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass
class SamplerState:
    """What the server knows when sampling (all host-side, chain-derived)."""
    balances: np.ndarray | None = None      # (n,) token ledger balances
    last_labels: np.ndarray | None = None   # (n,) last CACC label, -1 unknown
    n_clusters: int = 0


# sampler(rng, online_ids, k, state) -> cohort ids (sorted, unique)
Sampler = Callable[[np.random.Generator, np.ndarray, int, SamplerState],
                   np.ndarray]


def _take(rng: np.random.Generator, ids: np.ndarray, k: int,
          p: np.ndarray | None = None) -> np.ndarray:
    k = min(k, len(ids))
    if k == 0:
        return np.empty(0, dtype=np.int64)
    sel = rng.choice(ids, size=k, replace=False, p=p)
    return np.sort(sel.astype(np.int64))


def uniform(rng: np.random.Generator, online: np.ndarray, k: int,
            state: SamplerState) -> np.ndarray:
    return _take(rng, online, k)


def stake_weighted(rng: np.random.Generator, online: np.ndarray, k: int,
                   state: SamplerState) -> np.ndarray:
    if state.balances is None:
        return _take(rng, online, k)
    w = np.maximum(np.asarray(state.balances, dtype=np.float64)[online], 1e-9)
    return _take(rng, online, k, p=w / w.sum())


def cluster_stratified(rng: np.random.Generator, online: np.ndarray, k: int,
                       state: SamplerState) -> np.ndarray:
    if state.last_labels is None:
        return _take(rng, online, k)
    labels = np.asarray(state.last_labels)[online]
    strata = [online[labels == c] for c in range(-1, state.n_clusters)]
    strata = [s for s in strata if len(s)]
    if not strata:
        return _take(rng, online, k)
    # proportional allocation with largest-remainder rounding
    sizes = np.array([len(s) for s in strata], dtype=np.float64)
    quota = k * sizes / sizes.sum()
    take = np.floor(quota).astype(int)
    rem = k - take.sum()
    if rem > 0:
        order = np.argsort(-(quota - take))
        take[order[:rem]] += 1
    take = np.minimum(take, sizes.astype(int))
    picks = [_take(rng, s, t) for s, t in zip(strata, take) if t > 0]
    cohort = np.concatenate(picks) if picks else np.empty(0, np.int64)
    # top up from the leftover pool if rounding or small strata left a gap
    if len(cohort) < k:
        left = np.setdiff1d(online, cohort, assume_unique=False)
        cohort = np.concatenate([cohort, _take(rng, left, k - len(cohort))])
    return np.sort(cohort)


SAMPLERS: dict[str, Sampler] = {
    "uniform": uniform,
    "stake_weighted": stake_weighted,
    "cluster_stratified": cluster_stratified,
}


def get_sampler(name: str) -> Sampler:
    try:
        return SAMPLERS[name]
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; options: {sorted(SAMPLERS)}")
