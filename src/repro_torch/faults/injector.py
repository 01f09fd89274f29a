"""`FaultInjector` — the runtime half of the fault-injection harness.

Port of ``repro.faults.injector``.  One injector rides along one run, as
the recorder does (``repro_torch.obs``): fault-free runs bind the shared
:data:`NULL_INJECTOR` whose methods are no-ops returning "no fault", so the
hot path never branches on whether injection is configured and the
default run is the run without the harness.

Determinism: every random choice (which commit to drop, retry jitter)
draws from the injector's OWN ``numpy`` generator seeded from
``FaultSpec.seed``, never the simulator's — and that generator's state is
part of every checkpoint (:meth:`FaultInjector.state_dict`, plain values
only), so faulted runs replay and resume exactly.  Every injected fault is
a ``fault.*`` event and counter of the bound recorder.

``crash_mode="sigkill"`` kills the calling process outright: run it in a
child process only.
"""
from __future__ import annotations

import os
import signal

import numpy as np

from repro_torch.blockchain.txpool import Transaction
from repro_torch.faults.spec import FaultSpec
from repro_torch.obs import NULL_RECORDER


class InjectedCrash(RuntimeError):
    """Raised by ``crash_mode="exception"`` — a simulated process death that
    in-process callers can catch (``"sigkill"`` kills the interpreter)."""


class NullInjector:
    """Shared no-op injector bound when no faults are configured.  Keeps the
    exact `FaultInjector` surface so instrumented code never branches."""

    __slots__ = ()
    enabled = False
    retry = False
    spec = FaultSpec()

    def maybe_crash(self, boundary: int, phase: str) -> None:
        pass

    def will_crash(self, boundary: int, phase: str) -> bool:
        return False

    def producer_fails(self, round_idx: int) -> bool:
        return False

    def bad_block(self, round_idx: int) -> bool:
        return False

    def commit_drop_slot(self, round_idx: int, n_arrived: int) -> int:
        return -1

    def commit_delay_slot(self, round_idx: int, n_arrived: int) -> int:
        return -1

    def hold_commit(self, tx) -> None:
        raise RuntimeError("NullInjector cannot hold a commit")

    def release_commits(self) -> list:
        return []

    def retry_succeeds(self, dropout_p: float) -> bool:
        return False

    def retry_latency(self, base: float, attempt: int) -> float:
        return base

    def corrupt_checkpoint(self, path: str, boundary: int) -> None:
        pass

    def state_dict(self) -> dict | None:
        return None

    def load_state(self, state: dict | None) -> None:
        pass


NULL_INJECTOR = NullInjector()


class FaultInjector:
    """Live injector: executes one :class:`FaultSpec` schedule."""

    enabled = True

    def __init__(self, spec: FaultSpec, obs=NULL_RECORDER):
        self.spec = spec
        self.obs = obs
        self.rng = np.random.default_rng(spec.seed)
        self.retry = spec.retry
        self._held: list[Transaction] = []   # delayed commits awaiting delivery
        self._crashed = False

    # ------------------------------------------------------------------ #
    # process crash
    # ------------------------------------------------------------------ #

    def maybe_crash(self, boundary: int, phase: str) -> None:
        """Die here if the schedule says so.  ``boundary`` is the round index
        for ``round_start``/``pre_chain`` and the completed-rounds count for
        ``post_checkpoint`` (see ``repro_torch.faults.spec.CRASH_PHASES``)."""
        s = self.spec
        if self._crashed or boundary != s.crash_round or phase != s.crash_phase:
            return
        self._crashed = True
        self.obs.event("fault.crash", round=boundary, phase=phase,
                       mode=s.crash_mode)
        self.obs.inc("fault.crash")
        if s.crash_mode == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedCrash(
            f"injected crash at boundary {boundary} ({phase})")

    def will_crash(self, boundary: int, phase: str) -> bool:
        """True iff :meth:`maybe_crash` would die at this point.  The driver
        makes the in-flight snapshot durable before a scheduled
        ``post_checkpoint`` crash, so "the boundary's snapshot landed, then
        the process died" holds exactly."""
        s = self.spec
        return (not self._crashed and boundary == s.crash_round
                and phase == s.crash_phase)

    # ------------------------------------------------------------------ #
    # chain-level faults
    # ------------------------------------------------------------------ #

    def producer_fails(self, round_idx: int) -> bool:
        if round_idx not in self.spec.producer_fail_rounds:
            return False
        self.obs.event("fault.producer_fail", round=round_idx)
        self.obs.inc("fault.producer_fail")
        return True

    def bad_block(self, round_idx: int) -> bool:
        return round_idx in self.spec.bad_block_rounds

    def commit_drop_slot(self, round_idx: int, n_arrived: int) -> int:
        """Arrived-slot index whose commit tx is lost in transit, or -1."""
        if round_idx not in self.spec.drop_commit_rounds or n_arrived == 0:
            return -1
        return int(self.rng.integers(n_arrived))

    def commit_delay_slot(self, round_idx: int, n_arrived: int) -> int:
        """Arrived-slot index whose commit tx arrives a round late, or -1."""
        if round_idx not in self.spec.delay_commit_rounds or n_arrived == 0:
            return -1
        return int(self.rng.integers(n_arrived))

    def hold_commit(self, tx: Transaction) -> None:
        self._held.append(tx)

    def release_commits(self) -> list[Transaction]:
        """Delayed commits now being delivered (into the current block)."""
        held, self._held = self._held, []
        return held

    # ------------------------------------------------------------------ #
    # retry policy (dropped cohort slots)
    # ------------------------------------------------------------------ #

    def retry_succeeds(self, dropout_p: float) -> bool:
        return float(self.rng.random()) >= float(dropout_p)

    def retry_latency(self, base: float, attempt: int) -> float:
        """Backoff-scaled re-attempt latency with injector-seeded jitter."""
        jitter = float(self.rng.uniform(0.9, 1.1))
        return float(base) * (self.spec.retry_backoff ** attempt) * jitter

    # ------------------------------------------------------------------ #
    # checkpoint corruption
    # ------------------------------------------------------------------ #

    def corrupt_checkpoint(self, path: str, boundary: int) -> None:
        """Damage the snapshot just written at ``boundary`` (bit flip or
        truncation) so the reader's integrity check must catch it and fall
        back to the previous keep-last-K snapshot."""
        s = self.spec
        if boundary == s.corrupt_checkpoint_round:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:       # flip one payload byte
                f.seek(size - max(1, size // 4))
                b = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([b[0] ^ 0xFF]))
            self.obs.event("fault.ckpt_corrupted", round=boundary, path=path)
            self.obs.inc("fault.ckpt_corrupted")
        if boundary == s.truncate_checkpoint_round:
            size = os.path.getsize(path)
            os.truncate(path, size // 2)
            self.obs.event("fault.ckpt_truncated", round=boundary, path=path)
            self.obs.inc("fault.ckpt_truncated")

    # ------------------------------------------------------------------ #
    # checkpoint/resume of the injector itself
    # ------------------------------------------------------------------ #

    def state_dict(self) -> dict:
        """The injector's state as plain values: the generator's state, the
        held commits as ``(kind, sender, payload, round_idx)`` tuples and
        whether the crash fired."""
        return {"rng": self.rng.bit_generator.state,
                "held": [(t.kind, t.sender, t.payload, t.round_idx)
                         for t in self._held],
                "crashed": self._crashed}

    def load_state(self, state: dict | None) -> None:
        if state is None:
            return                     # snapshot came from a fault-free run
        self.rng.bit_generator.state = state["rng"]
        self._held = [Transaction(*t) for t in state["held"]]
        self._crashed = bool(state["crashed"])
