"""Trace sinks: JSONL file (digest-stamped), console summary, Chrome trace.

Copy of ``repro.obs.sinks``.  The encoding (sorted keys, compact
separators) is the reference's, so the same records, meta and metrics give
the same file bytes and the same sha256 in both packages.

The JSONL sink is the canonical artifact: every record the flight recorder
captured, one JSON object per line (schema: `repro_torch.obs.schema`), written
with sorted keys and compact separators so the file — and therefore its
sha256, which `repro_torch.api.run` stamps into the manifest — is deterministic
given the same records.

The Chrome export rewrites the same spans into the Trace Event Format
(``chrome://tracing`` / https://ui.perfetto.dev): spans become complete
("X") events on one track per category, compile events become instant
markers.  For device-level detail, ``ObsSpec.profile_dir`` additionally
wraps the run in ``torch.profiler.profile`` (CUDA activity on the card) and
writes ``torch_trace.json`` there — the kernels' own timeline, in the same
Perfetto UI.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Mapping

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.schema import SCHEMA_VERSION


def _dumps(obj: Mapping[str, Any]) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def write_jsonl(path: str, meta: Mapping[str, Any], records: list[dict],
                metrics: MetricsRegistry) -> str:
    """Write the trace file and return its sha256 hexdigest.

    Layout: one ``meta`` header, every span/event/point record in emission
    order, then the end-of-run ``summary``/``counter``/``gauge`` records
    from the metrics registry.
    """
    h = hashlib.sha256()
    snap = metrics.snapshot()
    with open(path, "w") as f:
        def emit(obj: Mapping[str, Any]) -> None:
            line = _dumps(obj) + "\n"
            f.write(line)
            h.update(line.encode())

        emit({"kind": "meta", "schema": SCHEMA_VERSION, **meta})
        for rec in records:
            emit(rec)
        for name, body in snap["summaries"].items():
            emit({"kind": "summary", "name": name, **body})
        for name, value in sorted(snap["counters"].items()):
            emit({"kind": "counter", "name": name, "value": value})
        for name, value in sorted(snap["gauges"].items()):
            emit({"kind": "gauge", "name": name, "value": value})
    return h.hexdigest()


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_chrome_trace(path: str, records: list[dict]) -> int:
    """Export spans/events as a Chrome Trace Event Format file; returns the
    number of trace events written.  One ``tid`` per span category keeps
    driver phases, chain internals, and ledger flows on separate tracks."""
    events: list[dict] = []
    tids: dict[str, int] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "span":
            tid = tids.setdefault(rec["cat"], len(tids) + 1)
            args = dict(rec.get("attrs", {}))
            if rec.get("round") is not None:
                args["round"] = rec["round"]
            if rec.get("vt") is not None:
                args["vt"] = rec["vt"]
            events.append({"name": rec["name"], "cat": rec["cat"], "ph": "X",
                           "ts": rec["ts_us"], "dur": rec["dur_us"],
                           "pid": 1, "tid": tid, "args": args})
        elif kind == "event":
            args = dict(rec.get("attrs", {}))
            if rec.get("round") is not None:
                args["round"] = rec["round"]
            events.append({"name": rec["name"], "cat": "event", "ph": "i",
                           "s": "g", "ts": rec["ts_us"], "pid": 1, "tid": 0,
                           "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def console_summary(metrics: MetricsRegistry, *, title: str = "trace") -> str:
    """The ``--trace`` table: per-phase latency breakdown with share of the
    round total, then counters and gauges."""
    snap = metrics.snapshot()
    summaries = snap["summaries"]
    total_key = ("round.total" if "round.total" in summaries
                 else "flush.total" if "flush.total" in summaries else None)
    total_sum = summaries[total_key]["sum"] if total_key else None

    lines = [f"=== {title} ===",
             f"{'phase':<28}{'count':>7}{'mean_ms':>10}{'p50_ms':>10}"
             f"{'p99_ms':>10}{'total_s':>10}{'share':>8}"]
    for name, s in summaries.items():
        # share of round time is only meaningful for phase (span) summaries —
        # ledger.* / async.* series are token amounts and weights, not ms
        is_phase = name.startswith(("round.", "flush.", "chain."))
        share = (f"{100.0 * s['sum'] / total_sum:6.1f}%"
                 if total_sum and is_phase else f"{'':>7}")
        lines.append(f"{name:<28}{s['count']:>7}{s['mean']:>10.3f}"
                     f"{s['p50']:>10.3f}{s['p99']:>10.3f}"
                     f"{s['sum'] / 1e3:>10.3f}{share:>8}")
    if snap["counters"]:
        lines.append("counters: " + "  ".join(
            f"{k}={v:g}" for k, v in sorted(snap["counters"].items())))
    if snap["gauges"]:
        lines.append("gauges:   " + "  ".join(
            f"{k}={v:g}" for k, v in sorted(snap["gauges"].items())))
    return "\n".join(lines)
