"""Virtual clock (copy of ``repro.sim.clock.VirtualClock``)."""
from __future__ import annotations


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
