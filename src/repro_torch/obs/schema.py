"""The JSONL trace schema — one record per line.

Copy of ``repro.obs.schema``: a port trace and a reference trace are read
by the same validator, and a port trace passes the reference's.

Kinds (the ``kind`` field picks the shape; unknown kinds are rejected):

    meta     first line of every trace; ``schema`` carries the version and
             the rest mirrors the run manifest (config digest, strategy, …)
    span     a timed phase: ``name``, ``cat``, nullable ``round``, wall-time
             ``ts_us``/``dur_us`` (µs since trace start / duration), nullable
             virtual-clock ``vt``, optional ``attrs`` object
    event    a point-in-time marker (e.g. ``compile``): ``name``, nullable
             ``round``, ``ts_us``, optional ``attrs``
    point    one per-round metric observation: ``name``, ``value``,
             nullable ``round``
    summary  end-of-run streaming summary of one series: ``name`` + count /
             sum / mean / min / max / p50 / p90 / p99
    counter  end-of-run counter total: ``name``, ``value``
    gauge    end-of-run gauge value: ``name``, ``value``

``validate_record`` is the single source of truth: ``chip_smoke.py`` and the
obs tests feed every emitted line through it, so the documented schema and
the written trace cannot drift apart.
"""
from __future__ import annotations

from typing import Any, Mapping

SCHEMA_VERSION = 1

_NUM = (int, float)


def _require(rec: Mapping, name: str, types, *, nullable: bool = False) -> Any:
    if name not in rec:
        raise ValueError(f"record missing required field {name!r}: {rec}")
    v = rec[name]
    if v is None:
        if nullable:
            return v
        raise ValueError(f"field {name!r} must not be null: {rec}")
    if not isinstance(v, types) or isinstance(v, bool):
        raise ValueError(
            f"field {name!r} must be {types}, got {type(v).__name__}: {rec}")
    return v


def _check_attrs(rec: Mapping) -> None:
    if "attrs" in rec and not isinstance(rec["attrs"], dict):
        raise ValueError(f"attrs must be an object: {rec}")


def validate_record(rec: Mapping) -> str:
    """Validate one parsed JSONL record; returns its kind, raises ValueError
    with the offending record on any schema violation."""
    if not isinstance(rec, Mapping):
        raise ValueError(f"record must be a JSON object, got {rec!r}")
    kind = _require(rec, "kind", str)
    if kind == "meta":
        version = _require(rec, "schema", int)
        if version != SCHEMA_VERSION:
            raise ValueError(f"unsupported trace schema version {version} "
                             f"(this build reads {SCHEMA_VERSION})")
    elif kind == "span":
        _require(rec, "name", str)
        _require(rec, "cat", str)
        _require(rec, "round", int, nullable=True)
        if _require(rec, "ts_us", _NUM) < 0:
            raise ValueError(f"ts_us must be >= 0: {rec}")
        if _require(rec, "dur_us", _NUM) < 0:
            raise ValueError(f"dur_us must be >= 0: {rec}")
        _require(rec, "vt", _NUM, nullable=True)
        _check_attrs(rec)
    elif kind == "event":
        _require(rec, "name", str)
        _require(rec, "round", int, nullable=True)
        if _require(rec, "ts_us", _NUM) < 0:
            raise ValueError(f"ts_us must be >= 0: {rec}")
        _check_attrs(rec)
    elif kind == "point":
        _require(rec, "name", str)
        _require(rec, "round", int, nullable=True)
        _require(rec, "value", _NUM)
    elif kind == "summary":
        _require(rec, "name", str)
        if _require(rec, "count", int) < 0:
            raise ValueError(f"count must be >= 0: {rec}")
        for f in ("sum", "mean", "min", "max", "p50", "p90", "p99"):
            _require(rec, f, _NUM)
    elif kind in ("counter", "gauge"):
        _require(rec, "name", str)
        _require(rec, "value", _NUM)
    else:
        raise ValueError(f"unknown record kind {kind!r}: {rec}")
    return kind


def validate_trace_lines(lines) -> dict[str, int]:
    """Validate an iterable of JSONL lines; returns per-kind counts.  The
    first record must be the ``meta`` header."""
    import json
    counts: dict[str, int] = {}
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            raise ValueError(f"blank line {i} in trace")
        kind = validate_record(json.loads(line))
        if i == 0 and kind != "meta":
            raise ValueError(f"first trace record must be meta, got {kind!r}")
        counts[kind] = counts.get(kind, 0) + 1
    if counts.get("meta", 0) != 1:
        raise ValueError(f"trace must contain exactly one meta record, "
                         f"got {counts.get('meta', 0)}")
    return counts
