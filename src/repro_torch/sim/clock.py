"""Virtual clock and per-client latency model (straggler machinery).

Copy of ``repro.sim.clock`` (numpy only).  Latency of one local-training
round for client *i* is ``base * speed_i * LogNormal(0, sigma^2)``, with a
per-client ``speed_i`` fixed at population build time (a narrow band
around 1x plus a ``straggler_slowdown`` tail).  Everything is driven by
seeded ``numpy.random.Generator`` streams, so latencies — and every arrival
ordering downstream — replay exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class VirtualClock:
    """Monotone virtual time.  The event loop owns advancement — nothing in
    the simulator ever reads a wall clock."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    @property
    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> float:
        if t < self._now:
            raise ValueError(f"virtual time moved backwards: {t} < {self._now}")
        self._now = float(t)
        return self._now


@dataclass
class LatencyModel:
    """Seeded per-client round-latency sampler."""

    speed: np.ndarray                 # (n,) fixed per-client multiplier
    base: float = 10.0                # mean seconds of one local round at 1x
    sigma: float = 0.25               # lognormal jitter
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0))

    def draw(self, client: int) -> float:
        jitter = float(np.exp(self.rng.normal(0.0, self.sigma)))
        return self.base * float(self.speed[client]) * jitter


def make_speed_profile(n_clients: int, straggler_frac: float,
                       straggler_slowdown: float,
                       rng: np.random.Generator) -> np.ndarray:
    """(n,) per-client speed multipliers: a narrow band around 1x plus a
    heavy ``straggler_slowdown`` tail for ``straggler_frac`` of clients."""
    speed = rng.uniform(0.8, 1.25, size=n_clients)
    n_strag = int(round(straggler_frac * n_clients))
    if n_strag:
        stragglers = rng.choice(n_clients, size=n_strag, replace=False)
        speed[stragglers] *= straggler_slowdown
    return speed.astype(np.float64)
