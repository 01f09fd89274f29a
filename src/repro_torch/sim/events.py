"""Event types and the deterministic event queue for the federation simulator.

Copy of ``repro.sim.events``: a discrete-event loop over *virtual* time
whose queue pops events in (time, insertion-seq) order, so two runs with
the same seed produce byte-identical event logs.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

CLIENT_ARRIVAL = "client_arrival"
UPDATE_READY = "update_ready"
DROPOUT = "dropout"
BLOCK_SLOT = "block_slot"


@dataclass(frozen=True, order=True)
class Event:
    """One scheduled occurrence.  Ordering is (time, seq): ``seq`` is the
    queue's insertion counter, so simultaneous events resolve in the exact
    order they were scheduled — deterministic under replay."""
    time: float
    seq: int
    kind: str = field(compare=False)
    client: int = field(compare=False, default=-1)
    round_idx: int = field(compare=False, default=-1)
    # free-form small payload (e.g. dispatch model version for async staleness)
    tag: int = field(compare=False, default=0)

    def log_entry(self) -> tuple:
        """Compact hashable form for the replayable event log."""
        return (round(self.time, 9), self.kind, self.client, self.round_idx, self.tag)


class EventQueue:
    """Min-heap of :class:`Event` with a deterministic tiebreak counter."""

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, client: int = -1,
             round_idx: int = -1, tag: int = 0) -> Event:
        ev = Event(float(time), self._seq, kind, client, round_idx, tag)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
