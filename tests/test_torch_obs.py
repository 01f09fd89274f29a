"""`repro_torch.obs` — the port's flight recorder — case for case against
`tests/test_obs.py`, and against the reference package itself.

The reference's cases run on the port's modules: streaming metrics (the
RNG-free reservoir thinning), the span tracer (wall and virtual clocks,
compile-delta events), the JSONL schema validator and the sinks.  Across
the packages: the same observations give the same `Summary.snapshot()`,
the same records, meta and metrics give the same trace bytes and sha256,
a port trace passes the reference's validator, and the port's name
registry is the reference's plus the engine stages.  `ready` returns its
argument as the same object and waits for nothing on the CPU; on the card
it waits once for the card (a `cuda` test)."""
import json
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as ref_obs  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    ALL_NAMES,
    NULL_RECORDER,
    PORT_SPAN_NAMES,
    FlightRecorder,
    MetricsRegistry,
    NullRecorder,
    ObsSpec,
    Summary,
    console_summary,
    file_sha256,
    names,
    validate_record,
    validate_trace_lines,
    write_chrome_trace,
    write_jsonl,
)


# --------------------------------------------------------------------------- #
# ObsSpec
# --------------------------------------------------------------------------- #

def test_obs_spec_defaults_off():
    spec = ObsSpec()
    assert not spec.enabled
    assert spec.trace_path


@pytest.mark.parametrize("bad", [
    dict(trace_path=""),
    dict(sample_cap=4),
    dict(chrome_path=""),
    dict(profile_dir=""),
])
def test_obs_spec_validates(bad):
    with pytest.raises(ValueError):
        ObsSpec(enabled=True, **bad)


# --------------------------------------------------------------------------- #
# Summary / MetricsRegistry
# --------------------------------------------------------------------------- #

def test_summary_exact_aggregates():
    s = Summary(cap=64)
    for v in [3.0, 1.0, 2.0]:
        s.observe(v)
    snap = s.snapshot()
    assert snap["count"] == 3
    assert snap["sum"] == 6.0
    assert snap["mean"] == 2.0
    assert snap["min"] == 1.0 and snap["max"] == 3.0
    assert snap["p50"] == 2.0


def test_summary_thinning_is_bounded_and_deterministic():
    a, b = Summary(cap=32), Summary(cap=32)
    for i in range(10_000):
        a.observe(float(i))
        b.observe(float(i))
    assert len(a._samples) < 32
    assert a.snapshot() == b.snapshot()        # no RNG anywhere
    assert a.count == 10_000
    assert a.min == 0.0 and a.max == 9999.0
    assert a.quantile(0.5) == pytest.approx(5000, rel=0.1)


def test_registry_counters_gauges_summaries():
    m = MetricsRegistry(sample_cap=64)
    m.inc("blocks")
    m.inc("blocks", 2.0)
    m.set_gauge("bytes", 7.0)
    m.set_gauge("bytes", 9.0)
    m.observe("lat", 5.0)
    snap = m.snapshot()
    assert snap["counters"]["blocks"] == 3.0
    assert snap["gauges"]["bytes"] == 9.0
    assert snap["summaries"]["lat"]["count"] == 1


@pytest.mark.parametrize("cap,n,seed", [(8, 1000, 0), (64, 5000, 1),
                                        (2048, 3000, 2), (32, 17, 3)])
def test_summary_snapshot_equals_reference(cap, n, seed):
    values = np.random.default_rng(seed).standard_normal(n) * 10
    port, ref = Summary(cap), ref_metrics.Summary(cap)
    for v in values:
        port.observe(float(v))
        ref.observe(float(v))
    assert port.snapshot() == ref.snapshot()
    assert port._samples == ref._samples


# --------------------------------------------------------------------------- #
# FlightRecorder / NullRecorder
# --------------------------------------------------------------------------- #

def test_span_records_wall_and_virtual_time():
    vt = [10.0]
    rec = FlightRecorder(ObsSpec(enabled=True), clock=lambda: vt[0])
    with rec.span("round.total", round=3) as sp:
        vt[0] = 12.5
        sp.set(arrived=8)
    (r,) = rec.records
    assert r["kind"] == "span" and r["name"] == "round.total"
    assert r["round"] == 3
    assert r["dur_us"] >= 0
    assert r["vt"] == 12.5
    assert r["attrs"]["vt_dur"] == 2.5
    assert r["attrs"]["arrived"] == 8
    assert rec.metrics.summaries["round.total"].count == 1


def test_compile_delta_emits_events_once_per_growth():
    rec = FlightRecorder(ObsSpec(enabled=True))
    rec.compile_delta({"fingerprint.cu": 1, "pearson.cu": 0}, round_idx=0)
    rec.compile_delta({"fingerprint.cu": 1, "pearson.cu": 1}, round_idx=1)
    rec.compile_delta({"fingerprint.cu": 1, "pearson.cu": 1}, round_idx=2)
    events = [r for r in rec.records if r["kind"] == "event"]
    assert [(e["attrs"]["entry"], e["round"]) for e in events] == \
        [("fingerprint.cu", 0), ("pearson.cu", 1)]
    assert rec.metrics.counters["compiles"] == 2


def test_ready_returns_value_unchanged():
    rec = FlightRecorder(ObsSpec(enabled=True, block_until_ready=True))
    assert rec.ready(41) == 41
    assert NULL_RECORDER.ready("x") == "x"


class _Out(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


@pytest.mark.parametrize("make", [
    lambda: torch.arange(4.0),
    lambda: (torch.ones(2), torch.zeros(3)),
    lambda: _Out(torch.ones(2), torch.zeros(2, 2)),
    lambda: {"w": torch.ones(3), "nested": [torch.zeros(1), 7]},
    lambda: [torch.ones(1), "label", None],
    lambda: 3.5,
])
@pytest.mark.parametrize("block", [True, False])
def test_ready_is_the_same_object_and_waits_for_nothing_on_the_cpu(
        monkeypatch, make, block):
    def no_sync(*a, **k):
        raise AssertionError("ready synchronized on CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    x = make()
    rec = FlightRecorder(ObsSpec(enabled=True, block_until_ready=block))
    assert rec.ready(x) is x
    assert NULL_RECORDER.ready(x) is x


def test_ready_reads_no_value(monkeypatch):
    x = torch.arange(6.0)
    for name in ("item", "cpu", "numpy", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, **k: pytest.fail(name))
    assert FlightRecorder(ObsSpec(enabled=True)).ready((x, {"k": x})) is not None


@pytest.mark.cuda
def test_ready_waits_once_for_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: ready waits for CUDA tensors only")
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device) or real(device))
    x = (torch.ones(3, device="cuda"), {"k": torch.zeros(2, device="cuda")},
         torch.ones(2))
    rec = FlightRecorder(ObsSpec(enabled=True))
    assert rec.ready(x) is x and calls == [x[0].device]
    assert FlightRecorder(ObsSpec(enabled=True, block_until_ready=False)).ready(x) is x
    assert len(calls) == 1


def test_null_recorder_is_inert():
    with NULL_RECORDER.span("anything", round=1) as sp:
        sp.set(a=1)
    NULL_RECORDER.event("e")
    NULL_RECORDER.point("p", 1.0)
    NULL_RECORDER.inc("c")
    NULL_RECORDER.set_gauge("g", 2.0)
    NULL_RECORDER.observe("o", 3.0)
    NULL_RECORDER.compile_delta({"x": 5})
    assert not NULL_RECORDER.enabled
    assert NULL_RECORDER.spec == ObsSpec()


def _public_methods(cls) -> set[str]:
    return {n for n in dir(cls) if not n.startswith("_") and callable(getattr(cls, n))}


def test_null_recorder_has_every_public_method_of_the_flight_recorder():
    assert _public_methods(FlightRecorder) <= _public_methods(NullRecorder)
    # and the port's recorder has the reference's whole surface
    assert _public_methods(ref_obs.FlightRecorder) <= _public_methods(FlightRecorder)


def test_timing_summary_reads_round_metrics():
    rec = FlightRecorder(ObsSpec(enabled=True))
    for ms in (10.0, 12.0, 11.0):
        rec.metrics.observe("round.total", ms)
        rec.metrics.observe("round.chain", ms / 10)
    rec.inc("compiles", 4)
    t = rec.timing_summary()
    assert t["rounds"] == 3
    assert t["compiles"] == 4
    assert t["round_ms_p50"] == 11.0
    assert t["chain_overhead_pct"] == 10.0


# --------------------------------------------------------------------------- #
# schema
# --------------------------------------------------------------------------- #

def test_validate_record_accepts_each_kind():
    for rec in [
        {"kind": "meta", "schema": 1},
        {"kind": "span", "name": "a", "cat": "round", "round": 1,
         "ts_us": 0.0, "dur_us": 1.0, "vt": None},
        {"kind": "event", "name": "compile", "round": None, "ts_us": 2.0},
        {"kind": "point", "name": "p", "round": 0, "value": 1.5},
        {"kind": "summary", "name": "s", "count": 1, "sum": 1.0, "mean": 1.0,
         "min": 1.0, "max": 1.0, "p50": 1.0, "p90": 1.0, "p99": 1.0},
        {"kind": "counter", "name": "c", "value": 2.0},
        {"kind": "gauge", "name": "g", "value": 3.0},
    ]:
        assert validate_record(rec) == ref_obs.validate_record(rec)


@pytest.mark.parametrize("bad", [
    {"name": "missing-kind"},
    {"kind": "nope"},
    {"kind": "span", "name": "a"},                       # missing fields
    {"kind": "counter", "name": "c", "value": "high"},   # non-numeric
    {"kind": "counter", "name": "c", "value": True},     # bool is not a number
    {"kind": "point", "name": 7, "round": 0, "value": 1.0},
    {"kind": "meta", "schema": 2},                       # unknown version
])
def test_validate_record_rejects(bad):
    with pytest.raises(ValueError):
        validate_record(bad)


def test_validate_trace_lines_requires_meta_header():
    meta = json.dumps({"kind": "meta", "schema": 1})
    span = json.dumps({"kind": "span", "name": "a", "cat": "c", "round": None,
                       "ts_us": 0.0, "dur_us": 1.0, "vt": None})
    counts = validate_trace_lines([meta, span])
    assert counts == {"meta": 1, "span": 1}
    with pytest.raises(ValueError):
        validate_trace_lines([span, meta])               # meta must come first
    with pytest.raises(ValueError):
        validate_trace_lines([meta, meta])               # exactly one meta


# --------------------------------------------------------------------------- #
# sinks
# --------------------------------------------------------------------------- #

def _recorder_with_traffic() -> FlightRecorder:
    rec = FlightRecorder(ObsSpec(enabled=True))
    with rec.span("round.total", round=0):
        with rec.span("chain.pack", cat="chain", round=0) as sp:
            sp.set(n_tx=3)
    rec.event("compile", round=0, entry="fingerprint.cu", n=1)
    rec.point("async.staleness_mean", 0.5, round=0)
    rec.inc("chain.blocks")
    rec.set_gauge("arena.bytes", 1024.0)
    return rec


def test_write_jsonl_digest_matches_file_and_schema(tmp_path):
    rec = _recorder_with_traffic()
    path = str(tmp_path / "t.jsonl")
    digest = write_jsonl(path, {"seed": 0}, rec.records, rec.metrics)
    assert digest == file_sha256(path)
    lines = open(path).read().splitlines()
    counts = validate_trace_lines(lines)
    assert counts["span"] == 2 and counts["meta"] == 1
    assert ref_obs.validate_trace_lines(lines) == counts
    path2 = str(tmp_path / "t2.jsonl")
    assert write_jsonl(path2, {"seed": 0}, rec.records, rec.metrics) == digest


def test_write_jsonl_bytes_equal_reference(tmp_path):
    rec = _recorder_with_traffic()
    ref_metrics_reg = ref_metrics.MetricsRegistry(sample_cap=rec.metrics.sample_cap)
    ref_metrics_reg.counters = dict(rec.metrics.counters)
    ref_metrics_reg.gauges = dict(rec.metrics.gauges)
    for name, s in rec.metrics.summaries.items():
        r = ref_metrics_reg.summaries[name] = ref_metrics.Summary(s.cap)
        for slot in r.__slots__:
            setattr(r, slot, getattr(s, slot))
    meta = {"config_digest": "ab" * 32, "seed": 0, "strategy": "bfln"}
    port_path, ref_path = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    d_port = write_jsonl(port_path, meta, rec.records, rec.metrics)
    d_ref = ref_obs.write_jsonl(ref_path, meta, rec.records, ref_metrics_reg)
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    assert d_port == d_ref == ref_obs.file_sha256(port_path)


def test_chrome_trace_export(tmp_path):
    rec = _recorder_with_traffic()
    path = str(tmp_path / "chrome.json")
    n = write_chrome_trace(path, rec.records)
    doc = json.load(open(path))
    events = doc["traceEvents"]
    assert n == len(events) == 3                         # 2 spans + 1 instant
    spans = [e for e in events if e["ph"] == "X"]
    assert {e["cat"] for e in spans} == {"round", "chain"}
    assert len({e["tid"] for e in spans}) == 2
    (instant,) = [e for e in events if e["ph"] == "i"]
    assert instant["name"] == "compile"


def test_console_summary_mentions_phases_and_counters():
    rec = _recorder_with_traffic()
    text = console_summary(rec.metrics, title="t")
    assert "round.total" in text and "chain.pack" in text
    assert "chain.blocks=1" in text
    assert "arena.bytes=1024" in text
    assert "100.0%" in text                              # round.total share
    assert text == ref_obs.console_summary(rec.metrics, title="t")


# --------------------------------------------------------------------------- #
# the name registry
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("attr", ["SPAN_NAMES", "FAULT_EVENT_NAMES", "EVENT_NAMES",
                                  "COUNTER_NAMES", "GAUGE_NAMES", "SERIES_NAMES",
                                  "DYNAMIC_PREFIXES", "ALL_NAMES"])
def test_registry_is_the_references(attr):
    from repro.obs import names as ref_names
    assert getattr(names, attr) == getattr(ref_names, attr)


def test_registry_adds_only_the_engine_stages():
    from repro.obs import names as ref_names
    assert PORT_SPAN_NAMES and not PORT_SPAN_NAMES & ALL_NAMES
    assert all(n.startswith("step.") for n in PORT_SPAN_NAMES)
    for method, pool in names.METHOD_NAME_SETS.items():
        extra = PORT_SPAN_NAMES if method == "span" else frozenset()
        assert pool == ref_names.METHOD_NAME_SETS[method] | extra


# --------------------------------------------------------------------------- #
# spec integration
# --------------------------------------------------------------------------- #

def test_experiment_spec_obs_roundtrip_and_digest_exclusion():
    import repro_torch.api as api
    on = api.ExperimentSpec(obs=api.ObsSpec(enabled=True, trace_path="x.jsonl"))
    off = api.ExperimentSpec()
    assert on.config_digest() == off.config_digest()
    back = api.ExperimentSpec.from_json(on.to_json())
    assert back.obs == on.obs
    assert back == on
