"""`FaultSpec` — declarative, seeded fault-injection schedule.

Copy of ``repro.faults.spec`` as data: field names, defaults and
validation are the reference's, so an ``ExperimentSpec`` hashes to the
same ``config_digest`` in both packages.  The injector that executes it
is ``repro_torch.faults.injector.FaultInjector``.

Every fault is scheduled deterministically from ``seed`` (the injector's
own stream, never the simulator's).

Fault classes (see :class:`repro_torch.faults.FaultInjector` for the handling):

* **process crash** — ``crash_round``/``crash_phase``/``crash_mode``: die at
  a chosen point; ``"sigkill"`` kills the process outright (the
  kill-and-resume tests), ``"exception"`` raises ``InjectedCrash``.
* **checkpoint corruption** — ``corrupt_checkpoint_round`` /
  ``truncate_checkpoint_round``: damage the snapshot just written, so
  resume must fall back to the previous keep-last-K snapshot.
* **producer failure** — ``producer_fail_rounds``: the selected block
  producer dies mid-pack; the driver fails over to the next consensus
  candidate.
* **bad block** — ``bad_block_rounds``: the producer emits a
  digest-mismatched block; the chain quarantines it and re-packs.
* **commit delivery** — ``drop_commit_rounds`` / ``delay_commit_rounds``:
  one arrived client's ``model_hash`` transaction is lost, or delivered
  into a later round's block (where verification ignores it).
* **retry** — bounded retry-with-backoff for dropped cohort slots
  (``retry``/``retry_max``/``retry_backoff``), surfacing as ``round.retry``
  spans.

``FaultSpec`` perturbs the trajectory, so unlike ``obs``/``checkpoint`` it
IS part of ``ExperimentSpec.config_digest()`` — but it is excluded from
``resume_digest()``, so a crashed run can be resumed with its fault
schedule cleared (otherwise a ``round_start`` crash would re-fire on every
resume, forever).
"""
from __future__ import annotations

from dataclasses import dataclass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


#: Where inside a round/flush a crash fires.  ``round_start`` and
#: ``pre_chain`` take the index of the round being executed;
#: ``post_checkpoint`` takes the *boundary* index — the number of completed
#: rounds/flushes — and fires right after that boundary's snapshot lands.
CRASH_PHASES = ("round_start", "pre_chain", "post_checkpoint")

CRASH_MODES = ("exception", "sigkill")


@dataclass(frozen=True)
class FaultSpec:
    """Fault-injection schedule (``ExperimentSpec.faults``); default all-off."""
    seed: int = 0                     # injector RNG stream (independent)
    crash_round: int = -1             # -1 = never crash
    crash_phase: str = "post_checkpoint"
    crash_mode: str = "exception"     # "exception" | "sigkill"
    corrupt_checkpoint_round: int = -1   # bit-flip the snapshot at boundary N
    truncate_checkpoint_round: int = -1  # truncate the snapshot at boundary N
    producer_fail_rounds: tuple[int, ...] = ()
    bad_block_rounds: tuple[int, ...] = ()
    drop_commit_rounds: tuple[int, ...] = ()
    delay_commit_rounds: tuple[int, ...] = ()
    retry: bool = False               # bounded retry for dropped cohort slots
    retry_max: int = 2
    retry_backoff: float = 2.0        # latency multiplier per attempt

    def __post_init__(self):
        _check(self.crash_phase in CRASH_PHASES,
               f"crash_phase must be one of {CRASH_PHASES}, "
               f"got {self.crash_phase!r}")
        _check(self.crash_mode in CRASH_MODES,
               f"crash_mode must be one of {CRASH_MODES}, "
               f"got {self.crash_mode!r}")
        for name in ("producer_fail_rounds", "bad_block_rounds",
                     "drop_commit_rounds", "delay_commit_rounds"):
            v = getattr(self, name)
            _check(isinstance(v, tuple) and all(
                isinstance(r, int) and r >= 0 for r in v),
                f"{name} must be a tuple of round indices >= 0, got {v!r}")
        _check(self.retry_max >= 1,
               f"retry_max must be >= 1, got {self.retry_max}")
        _check(self.retry_backoff >= 1.0,
               f"retry_backoff must be >= 1, got {self.retry_backoff}")

    @property
    def enabled(self) -> bool:
        """True iff any fault (or the retry policy) is configured."""
        return (self.crash_round >= 0
                or self.corrupt_checkpoint_round >= 0
                or self.truncate_checkpoint_round >= 0
                or bool(self.producer_fail_rounds)
                or bool(self.bad_block_rounds)
                or bool(self.drop_commit_rounds)
                or bool(self.delay_commit_rounds)
                or self.retry)
