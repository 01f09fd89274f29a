"""Canonical observability name registry — the single source of truth for
every span / event / counter / gauge / series name the flight recorder is
allowed to see.

Copy of ``repro.obs.names``, name for name, plus one set of the port's
own: :data:`PORT_SPAN_NAMES`, the stages of the port's eager round engine
(``core/engine.py``, ``core/baselines.py``), which the reference's engine —
one jitted program — has no counterpart of.  No other name is added.

``src/repro_torch/obs/TRACE_SCHEMA.md`` documents these names for humans
(a copy of the reference's ``docs/TRACE_SCHEMA.md`` plus a section for the
port's stages); this module is the machine-checked form.  The reference's
``trace-schema`` rule, run over the port by ``tests/test_torch_rules.py``,
cross-checks three ways:

    1. every literal name passed to a recorder method anywhere in
       ``src/repro_torch`` must be registered here (per method: ``span`` ->
       :data:`SPAN_NAMES`, ``event`` -> :data:`EVENT_NAMES`, ``inc`` ->
       :data:`COUNTER_NAMES`, ``set_gauge`` -> :data:`GAUGE_NAMES`,
       ``observe``/``point`` -> :data:`SERIES_NAMES`);
    2. every name of :data:`ALL_NAMES` must appear in ``TRACE_SCHEMA.md``;
    3. every dotted metric name mentioned in ``TRACE_SCHEMA.md`` must
       resolve against this registry.

The rule's doc cross-check reads only the reference's name families, so
:data:`PORT_SPAN_NAMES` stays out of :data:`ALL_NAMES`; the port's tests
check that each of them is documented.

Dynamic name families (f-strings with a literal prefix, e.g.
``f"engine.calls.{name}"``) are registered as prefixes in
:data:`DYNAMIC_PREFIXES`; the schema doc spells them ``engine.calls.<entry>``.

The static analyzer loads this file on its own — keep it dependency-free.
"""
from __future__ import annotations

# --- spans: timed phases (recorder.span) --------------------------------- #
SPAN_NAMES = frozenset({
    # sync round phases (cat "round")
    "round.total", "round.sample", "round.wait", "round.gather",
    "round.step", "round.digests", "round.chain", "round.scatter",
    "round.eval", "round.retry",
    # async FedBuff flush phases (cat "flush")
    "flush.total", "flush.gather", "flush.step", "flush.chain",
    "flush.merge", "flush.eval",
    # blockchain phases (cat "chain")
    "chain.pack", "chain.validate", "chain.verify", "chain.digests",
    "chain.commit", "chain.consensus", "chain.rewards",
    # checkpoint / run lifecycle
    "ckpt.save", "ckpt.restore", "run.final_eval",
    # serving tier (cat "serve", repro.serve)
    "serve.snapshot", "serve.verify", "serve.batch", "serve.flush",
})

# the port's round-engine stages (cat "round"): spans inside round.step /
# flush.step, one per stage of the eager engine
PORT_SPAN_NAMES = frozenset({
    "step.gather", "step.local_train", "step.prototypes", "step.pearson",
    "step.embedding", "step.kmeans", "step.cluster_mean", "step.fingerprint",
    "step.scatter",
})

# --- events: point-in-time markers (recorder.event) ----------------------- #
FAULT_EVENT_NAMES = frozenset({
    "fault.crash", "fault.producer_fail", "fault.producer_failover",
    "fault.block_quarantined", "fault.commit_dropped", "fault.commit_delayed",
    "fault.commit_delivered_late", "fault.ckpt_corrupted",
    "fault.ckpt_truncated",
})
EVENT_NAMES = frozenset({"compile"}) | FAULT_EVENT_NAMES

# --- counters: monotone totals (recorder.inc) ----------------------------- #
COUNTER_NAMES = frozenset({
    "compiles", "rounds.empty", "chain.blocks", "chain.tx",
    "ckpt.saved", "ckpt.restored", "fault.retry", "fault.retry_recovered",
    "serve.requests", "serve.rejected", "serve.batches", "serve.releases",
    "serve.verifications",
}) | (FAULT_EVENT_NAMES - {"fault.commit_delivered_late"})

# --- gauges: last-written values (recorder.set_gauge) --------------------- #
GAUGE_NAMES = frozenset({
    "arena.bytes", "arena.per_device_bytes", "engine.cohort_bytes",
    "ckpt.bytes", "run.final_accuracy", "run.n_blocks",
    "serve.bank_bytes", "serve.queue_depth",
})

# --- series: per-round observations (recorder.observe / recorder.point) --- #
SERIES_NAMES = frozenset({
    "async.staleness", "async.staleness_weight", "async.staleness_mean",
    "ledger.paid", "ledger.fees", "ledger.burned",
    "serve.latency", "serve.batch_size",
})

# Dynamic families: a recorder call may build its name with an f-string as
# long as the literal prefix is registered here (schema doc: `<...>` suffix).
DYNAMIC_PREFIXES = ("engine.calls.",)

# recorder method -> the name set it is checked against
METHOD_NAME_SETS = {
    "span": SPAN_NAMES | PORT_SPAN_NAMES,
    "event": EVENT_NAMES,
    "inc": COUNTER_NAMES,
    "set_gauge": GAUGE_NAMES,
    "observe": SERIES_NAMES,
    "point": SERIES_NAMES,
}

ALL_NAMES = (SPAN_NAMES | EVENT_NAMES | COUNTER_NAMES | GAUGE_NAMES
             | SERIES_NAMES)


def is_registered(name: str, allowed: frozenset | None = None) -> bool:
    """True if ``name`` (a literal, or an f-string literal prefix ending in
    ``.``) is covered by the registry — exact match or dynamic prefix."""
    pool = ALL_NAMES if allowed is None else allowed
    if name in pool:
        return True
    return any(name.startswith(p) or p.startswith(name)
               for p in DYNAMIC_PREFIXES)
