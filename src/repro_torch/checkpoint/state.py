"""Capture/restore of the COMPLETE experiment state at a round boundary.

Port of ``repro.checkpoint.state``.  A snapshot is everything a resumed
process needs to continue a run such that the final manifest digests
(event-log sha256, block hashes, balances, final accuracy) equal the
uninterrupted run's:

* the parameter state — the arena's ``n_clients`` real rows copied to the
  host (shard by shard on a mesh, so the bytes are the same at every
  mesh width),
* the blockchain (blocks + quarantined), the tx pool, the token ledger and
  the CACC packing queue,
* the discrete-event machinery — virtual clock, the event queue's heap
  *as-is* (restoring the raw heap list keeps its pop order) and its
  insertion counter, the event log and the round history,
* every numpy RNG stream: the driver's, the latency model's and the fault
  injector's.  Nothing in a run draws from a torch generator after the
  population's parameters are initialised, so none is captured,
* async mode: the FedBuff view — model version, global row, version
  snapshots, the in-flight dispatch map and the staleness buffer.

Capture runs on the caller's thread and leaves numpy arrays and plain
Python values only (objects become tuples and dicts), so a background
writer never touches a tensor or a live object.  Every snapshot stamps the
spec's ``resume_digest()`` — the experiment identity *excluding* obs,
checkpoint and faults — so a run can be resumed with its fault schedule
cleared or its checkpoint cadence changed, but never resumed into a
different experiment.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.blockchain.chain import Block
from repro_torch.blockchain.txpool import Transaction
from repro_torch.checkpoint.io import CheckpointError
from repro_torch.sim.events import Event

CAPTURE_VERSION = 1


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place updates cannot reach."""
    return t.detach().to("cpu", copy=True).numpy()


def _tx(t: Transaction) -> tuple:
    return (t.kind, t.sender, t.payload, t.round_idx)


def _block(b: Block) -> tuple:
    return (b.index, b.round_idx, b.producer, b.prev_hash, b.merkle_root,
            tuple(_tx(t) for t in b.transactions))


def _unblock(b: tuple) -> Block:
    *head, txs = b
    return Block(*head, tuple(Transaction(*t) for t in txs))


def _event(e: Event) -> tuple:
    return (e.time, e.seq, e.kind, e.client, e.round_idx, e.tag)


def capture_experiment_state(sim, next_round: int,
                             async_view: dict | None = None) -> dict:
    """Snapshot ``sim`` (a ``repro_torch.sim.SimulatedFederation``) at a
    boundary where ``next_round`` rounds/flushes have completed.  Returns
    the tree handed to ``repro_torch.checkpoint.io.save_checkpoint``."""
    # deferred device accuracies come to the host now instead of at the
    # end of the run — the same values, so the trajectory is unperturbed
    sim._finalize_history()
    trainer = sim.trainer
    host: dict[str, Any] = {
        "version": CAPTURE_VERSION,
        "resume_digest": sim.spec.resume_digest(),
        "mode": sim.cfg.mode,
        "next_round": int(next_round),
        "clock": sim.clock.now,
        "queue_heap": [_event(e) for e in sim.queue._heap],
        "queue_seq": sim.queue._seq,
        "event_log": list(sim.event_log),
        "history": [dataclasses.asdict(r) for r in sim.history],
        "last_labels": sim.last_labels.copy(),
        "rng": sim.rng.bit_generator.state,
        "latency_rng": sim.pop.latency.rng.bit_generator.state,
        "chain_blocks": [_block(b) for b in trainer.chain.blocks],
        "chain_quarantined": [_block(b) for b in trainer.chain.quarantined],
        "pool_pending": [_tx(t) for t in trainer.pool.pending],
        "ledger_balances": trainer.ledger.balances.copy(),
        "ledger_minted": trainer.ledger.minted,
        "packing_queue": list(trainer._queue),
        "faults": sim.faults.state_dict(),
    }
    if async_view is not None:
        # at a flush boundary every buffered update is still delta-less
        # (deltas are made inside the flush), so (client, version) pairs
        # rebuild the buffer exactly
        host["async"] = {
            "version": int(async_view["version"]),
            "global_state": _host(async_view["global_state"]),
            "snapshots": {int(v): _host(s)
                          for v, s in async_view["snapshots"].items()},
            "inflight": dict(async_view["inflight"]),
            "buffer": [(int(u.client), int(u.version))
                       for u in async_view["agg"].buffer],
        }
    return {"arrays": {"arena": sim.arena.host_rows()}, "host": host}


def restore_experiment_state(sim, tree: dict) -> tuple[int, dict | None]:
    """Restore a freshly-constructed ``sim`` (same spec, same population)
    from a snapshot tree.  Returns ``(next_round, async_view)`` where
    ``async_view`` (async mode only) re-seeds the async loop's state."""
    from repro_torch.sim.async_agg import BufferedAggregator, BufferedUpdate
    from repro_torch.sim.driver import SimRoundRecord

    host = tree.get("host") if isinstance(tree, dict) else None
    if not isinstance(host, dict) or host.get("version") != CAPTURE_VERSION:
        raise CheckpointError(
            "snapshot capture version "
            f"{host.get('version') if isinstance(host, dict) else None} != "
            f"{CAPTURE_VERSION}")
    want = sim.spec.resume_digest()
    if host["resume_digest"] != want:
        raise CheckpointError(
            "snapshot belongs to a different experiment: resume_digest "
            f"{host['resume_digest'][:12]} != spec's {want[:12]} (obs/"
            "checkpoint/faults sections are free to differ; everything else "
            "must match)")

    dev = sim.device
    sim.arena.rebind(torch.from_numpy(tree["arrays"]["arena"]))
    sim.clock._now = float(host["clock"])
    sim.queue._heap = [Event(*e) for e in host["queue_heap"]]
    sim.queue._seq = int(host["queue_seq"])
    sim.event_log[:] = host["event_log"]
    sim.history[:] = [SimRoundRecord(**r) for r in host["history"]]
    sim.last_labels[:] = host["last_labels"]
    sim.rng.bit_generator.state = host["rng"]
    sim.pop.latency.rng.bit_generator.state = host["latency_rng"]

    trainer = sim.trainer
    trainer.chain.blocks[:] = [_unblock(b) for b in host["chain_blocks"]]
    trainer.chain.quarantined[:] = [_unblock(b)
                                    for b in host["chain_quarantined"]]
    trainer.pool.pending[:] = [Transaction(*t) for t in host["pool_pending"]]
    ledger = trainer.ledger
    ledger.balances = np.asarray(host["ledger_balances"], np.float64)
    ledger.minted = float(host["ledger_minted"])
    trainer._queue[:] = host["packing_queue"]
    sim.faults.load_state(host["faults"])

    av = host.get("async")
    if av is not None:
        agg = BufferedAggregator(sim.spec.async_.buffer_size,
                                 sim.spec.async_.staleness_alpha)
        agg.buffer = [BufferedUpdate(c, None, v) for c, v in av["buffer"]]
        av = {
            "version": av["version"],
            "global_state": torch.from_numpy(av["global_state"]).to(dev),
            "snapshots": {v: torch.from_numpy(s).to(dev)
                          for v, s in av["snapshots"].items()},
            "inflight": dict(av["inflight"]),
            "agg": agg,
        }
    return int(host["next_round"]), av
