"""`CheckpointSpec` — declarative checkpoint/resume configuration.

Copy of ``repro.checkpoint.spec`` as data: field names, defaults and
validation are the reference's, so an ``ExperimentSpec`` hashes to the
same ``config_digest`` in both packages.  Nothing here acts on it:
the port's driver does not checkpoint yet (ROADMAP queue 1 item 5);
``run`` refuses a non-default ``CheckpointSpec``.

When ``interval > 0`` the reference snapshots the complete experiment
state into ``dir`` at every round/flush boundary divisible by
``interval``, keeping the newest ``keep_last`` snapshots.

Checkpointing is out of band for the *trajectory*: a run with checkpointing
on computes bit-identical results to one with it off, so ``CheckpointSpec``
is excluded from ``ExperimentSpec.config_digest()`` alongside ``obs`` —
resuming from a snapshot reproduces the uninterrupted run's manifest
digests exactly.
"""
from __future__ import annotations

from dataclasses import dataclass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class CheckpointSpec:
    """Checkpoint configuration (``ExperimentSpec.checkpoint``).

    ``interval == 0`` (the default) disables checkpointing entirely; the
    driver then never touches the filesystem.
    """
    interval: int = 0            # snapshot every N rounds/flushes; 0 = off
    dir: str = "checkpoints"     # snapshot directory
    keep_last: int = 3           # keep-last-K pruning window

    def __post_init__(self):
        _check(self.interval >= 0,
               f"interval must be >= 0, got {self.interval}")
        _check(self.keep_last >= 1,
               f"keep_last must be >= 1, got {self.keep_last}")
        _check(isinstance(self.dir, str) and self.dir != "",
               "dir must be a non-empty string")

    @property
    def enabled(self) -> bool:
        return self.interval > 0
