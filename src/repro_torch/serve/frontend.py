"""Deterministic serving frontend: routed queue -> size-bucketed batches.

Port of ``repro.serve.frontend``.  A single FIFO request queue feeds the
mixed-batch engine — cluster routing happens *inside* each batch via the
engine's cluster-id gather, so requests for different personalized models
share one forward.  Batching policy:

  * **size buckets**: a flush pads its requests up to the smallest
    configured bucket that fits.  Padding rows are zero requests routed to
    cluster 0 whose outputs are dropped — the stacked forward is
    padding-neutral for the real rows;
  * **full-bucket flush**: whenever the queue reaches the largest bucket, a
    full batch flushes immediately (inside :meth:`submit`);
  * **max-wait deadline**: :meth:`pump` flushes a partial batch once the
    oldest pending request has waited ``max_wait`` clock units;
  * **graceful rejection**: a request arriving with ``max_pending`` already
    queued completes immediately with ``status="rejected"``.

Time is an injected clock (a ``VirtualClock``, or any ``now`` callable); the
frontend never reads a wall clock, so a request schedule replays exactly:
same arrivals -> same flush boundaries, same batches, same logits.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import NULL_RECORDER
from repro_torch.serve.engine import ServingEngine


@dataclass(frozen=True)
class ServeConfig:
    """Frontend batching policy."""
    buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)  # padded batch shapes
    max_wait: float = 0.005        # clock units a request may wait queued
    max_pending: int = 1024        # queue depth before graceful rejection

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError("buckets must be a sorted tuple of distinct sizes")
        if self.max_wait < 0 or self.max_pending < 1:
            raise ValueError("max_wait must be >= 0 and max_pending >= 1")


@dataclass(frozen=True)
class Completion:
    """One finished request: logits for served ones, None for rejected."""
    req_id: int
    cluster_id: int
    logits: np.ndarray | None
    t_arrival: float
    t_done: float
    status: str          # "ok" | "rejected"


@dataclass
class _Pending:
    req_id: int
    cluster_id: int
    x: np.ndarray
    t_arrival: float


@dataclass
class ServeFrontend:
    """Deterministic request queue in front of a :class:`ServingEngine`."""
    engine: ServingEngine
    config: ServeConfig = field(default_factory=ServeConfig)
    clock: object = None          # callable () -> float, or has a .now
    obs: object = NULL_RECORDER

    def __post_init__(self):
        c = self.clock
        if c is None:
            raise ValueError(
                "ServeFrontend needs a clock (a VirtualClock, or any `now` "
                "callable) — it never reads wall time itself")
        self._now = c if callable(c) else (lambda: c.now)
        self._pending: list[_Pending] = []
        self._completed: list[Completion] = []
        self._next_id = 0
        self.n_requests = 0
        self.n_rejected = 0
        self.n_flushes = 0

    def submit(self, cluster_id: int, x) -> int:
        """Queue one request for ``cluster_id``'s model; returns its id.

        An overloaded queue rejects immediately (a ``rejected`` completion,
        no engine work).  A queue reaching the largest bucket flushes a full
        batch before returning.
        """
        mcfg = self.engine.bank.mcfg
        x = np.asarray(x, dtype=np.float32).reshape(-1)
        if x.shape[0] != mcfg.in_dim:
            raise ValueError(f"request has {x.shape[0]} features, model "
                             f"expects {mcfg.in_dim}")
        if not 0 <= int(cluster_id) < self.engine.bank.n_models:
            raise ValueError(f"cluster_id {cluster_id} out of range "
                             f"[0, {self.engine.bank.n_models})")
        now = self._now()
        req_id = self._next_id
        self._next_id += 1
        self.n_requests += 1
        self.obs.inc("serve.requests")
        if len(self._pending) >= self.config.max_pending:
            self.n_rejected += 1
            self.obs.inc("serve.rejected")
            self._completed.append(Completion(
                req_id, int(cluster_id), None, now, now, "rejected"))
            return req_id
        self._pending.append(_Pending(req_id, int(cluster_id), x, now))
        while len(self._pending) >= self.config.buckets[-1]:
            self._flush(self.config.buckets[-1], "full")
        return req_id

    def pump(self) -> None:
        """Flush every batch whose oldest request hit the max-wait deadline
        (call after advancing the clock)."""
        now = self._now()
        while (self._pending
               and now - self._pending[0].t_arrival >= self.config.max_wait):
            self._flush(min(len(self._pending), self.config.buckets[-1]),
                        "deadline")

    def drain(self) -> None:
        """Flush everything still queued, deadline or not."""
        while self._pending:
            self._flush(min(len(self._pending), self.config.buckets[-1]),
                        "drain")

    def take_completed(self) -> list[Completion]:
        """All completions since the last take, in completion order."""
        out, self._completed = self._completed, []
        return out

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    def _bucket_for(self, n: int) -> int:
        for b in self.config.buckets:
            if b >= n:
                return b
        return self.config.buckets[-1]

    def _flush(self, n: int, reason: str) -> None:
        batch, self._pending = self._pending[:n], self._pending[n:]
        bucket = self._bucket_for(len(batch))
        mcfg = self.engine.bank.mcfg
        with self.obs.span("serve.flush", cat="serve") as sp:
            x = np.zeros((bucket, mcfg.in_dim), dtype=np.float32)
            cids = np.zeros((bucket,), dtype=np.int32)
            for i, r in enumerate(batch):
                x[i] = r.x
                cids[i] = r.cluster_id
            logits = self.engine.forward(x, cids).cpu().numpy()
            sp.set(n=len(batch), bucket=bucket, reason=reason)
        now = self._now()
        for i, r in enumerate(batch):
            self._completed.append(Completion(
                r.req_id, r.cluster_id, logits[i], r.t_arrival, now, "ok"))
            self.obs.observe("serve.latency", now - r.t_arrival)
        self.n_flushes += 1
        self.obs.observe("serve.batch_size", float(len(batch)))
        self.obs.set_gauge("serve.queue_depth", float(len(self._pending)))
