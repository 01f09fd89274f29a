"""Tracing on the port is out of band: a seeded `repro_torch.api.run` with
the flight recorder on ends on the same manifest digests (event log, block
hashes, balances, final accuracy) as the same run with it off — in sync
rounds, async FedBuff flushes, under a fault schedule, and across a crash
and `resume_from`.  Every traced run's trace file passes the port's and
the reference's schema validators, its sha256 is the manifest's
`trace_digest`, and the manifest carries the timing readout.

Against the reference: the traced port run and the traced reference run
at the same spec (n = 40, on the CPU) record the same names by kind and
the same number of each `round.*` / `flush.*` span.  The exceptions, each
with its reason:

  * the port's `step.*` spans (`PORT_SPAN_NAMES`) and their summaries —
    the stages of the port's eager engine, which the reference runs as
    one jitted program;
  * `compile` events and the `compiles` counter — the reference counts its
    jit compiles; the port counts kernel-library loads, and a CPU run
    loads none.

Serving on a traced run writes a valid trace too, and a `profile_dir` run
on the CPU writes a non-empty `torch_trace.json`."""
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
from repro.obs import validate_trace_lines as ref_validate  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch.api.runner import check_supported  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    ALL_NAMES,
    PORT_SPAN_NAMES,
    FlightRecorder,
    file_sha256,
    validate_trace_lines,
    write_jsonl,
)
from repro_torch.obs.names import is_registered  # noqa: E402
from repro_torch.serve import serve  # noqa: E402

REPLAY_KEYS = ("event_log_digest", "block_hashes_digest", "balances_digest",
               "final_accuracy")
# names only one package records, and why (module docstring)
PORT_ONLY = {"span": PORT_SPAN_NAMES, "summary": PORT_SPAN_NAMES}
REFERENCE_ONLY = {"event": {"compile"}, "counter": {"compiles"}}
FAULTS = dict(seed=19, producer_fail_rounds=(1,), bad_block_rounds=(2,),
              drop_commit_rounds=(0,), delay_commit_rounds=(1,), retry=True)


def _spec(pkg, *, mode="sync", obs=None, faults=None, checkpoint=None):
    kw = {}
    if faults is not None:
        kw["faults"] = faults
    if checkpoint is not None:
        kw["checkpoint"] = checkpoint
    return pkg.ExperimentSpec(
        data=pkg.DataSpec(n_clients=40, dataset="synth10", beta=0.3,
                          n_batches=1, batch_size=16, straggler_frac=0.2,
                          straggler_slowdown=8.0, dropout_rate=0.05,
                          byzantine_frac=0.1),
        train=pkg.TrainSpec(rounds=4, sample_frac=0.25, n_clusters=3,
                            local_epochs=1, mode=mode),
        async_=pkg.AsyncSpec(buffer_size=6, concurrency=12),
        eval=pkg.EvalSpec(every=2, clients=16, examples=64),
        obs=obs if obs is not None else pkg.ObsSpec(), seed=3, **kw)


def _lines(path) -> list[str]:
    return open(path).read().splitlines()


def _check_trace(res, trace, rounds_timed=None):
    """The traced artifact is complete, digest-stamped and valid in both
    packages' schemas; every name it records is registered; the timing
    readout counts the rounds this run ran (all, unless it resumed)."""
    m = res.manifest
    assert m["trace_path"] == trace and m["trace_digest"] == file_sha256(trace)
    lines = _lines(trace)
    counts = validate_trace_lines(lines)
    assert ref_validate(lines) == counts
    assert counts["span"] > 0 and counts["summary"] > 0
    recorded = {json.loads(x)["name"] for x in lines[1:]}
    assert all(is_registered(n, ALL_NAMES | PORT_SPAN_NAMES) for n in recorded)
    timing = m["timing"]
    assert timing["rounds"] == (rounds_timed if rounds_timed is not None
                                else len(res.report.history))
    assert "round_ms_p50" in timing and timing["compiles"] == 0
    assert "timing:" in res.summary() and "compiles=" in res.summary()


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("faulted", [False, True])
def test_traced_replay_identical(tmp_path, mode, faulted):
    faults = api.FaultSpec(**FAULTS) if faulted else None
    trace = str(tmp_path / "t.jsonl")
    on = api.run(_spec(api, mode=mode, faults=faults,
                       obs=api.ObsSpec(enabled=True, trace_path=trace,
                                       chrome_path=str(tmp_path / "c.json"))),
                 device="cpu")
    off = api.run(_spec(api, mode=mode, faults=faults), device="cpu")
    for key in REPLAY_KEYS:
        assert on.manifest[key] == off.manifest[key], key
    assert on.spec.config_digest() == off.spec.config_digest()
    _check_trace(on, trace)
    assert json.load(open(on.manifest["chrome_trace_path"]))["traceEvents"]
    if faulted:
        events = {json.loads(x)["name"] for x in _lines(trace)
                  if json.loads(x)["kind"] == "event"}
        assert {"fault.producer_fail", "fault.block_quarantined",
                "fault.commit_dropped"} <= events


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_traced_crash_and_resume_identical(tmp_path, mode):
    plain = api.run(_spec(api, mode=mode), device="cpu")
    ck = api.CheckpointSpec(interval=1, dir=str(tmp_path / "ck"))
    crash = api.FaultSpec(crash_round=2, crash_phase="post_checkpoint")
    first = str(tmp_path / "crashed.jsonl")
    with pytest.raises(api.InjectedCrash):
        api.run(_spec(api, mode=mode, checkpoint=ck, faults=crash,
                      obs=api.ObsSpec(enabled=True, trace_path=first)),
                device="cpu")
    trace = str(tmp_path / "resumed.jsonl")
    res = api.run(_spec(api, mode=mode, checkpoint=ck,
                        obs=api.ObsSpec(enabled=True, trace_path=trace)),
                  device="cpu", resume_from=ck.dir)
    assert res.manifest["resume_step"] == 2
    for key in REPLAY_KEYS:
        assert res.manifest[key] == plain.manifest[key], key
    _check_trace(res, trace, rounds_timed=len(res.report.history) - 2)
    names = {json.loads(x)["name"] for x in _lines(trace)[1:]}
    assert {"ckpt.restore", "ckpt.restored", "ckpt.save", "ckpt.saved"} <= names
    assert not [t for t in threading.enumerate() if t.name.startswith("ckpt-writer")]


def _names_by_kind(path) -> tuple[dict[str, set], dict[str, int]]:
    kinds: dict[str, set] = {}
    spans: dict[str, int] = {}
    for line in _lines(path)[1:]:
        rec = json.loads(line)
        kinds.setdefault(rec["kind"], set()).add(rec["name"])
        if rec["kind"] == "span":
            spans[rec["name"]] = spans.get(rec["name"], 0) + 1
    return kinds, spans


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_trace_names_match_the_reference(tmp_path, mode):
    port_path, ref_path = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    port = api.run(_spec(api, mode=mode,
                         obs=api.ObsSpec(enabled=True, trace_path=port_path)),
                   device="cpu")
    ref = ref_api.run(_spec(ref_api, mode=mode,
                            obs=ref_api.ObsSpec(enabled=True, trace_path=ref_path)))
    assert port.manifest["event_log_digest"] == ref.manifest["event_log_digest"]
    pk, ps = _names_by_kind(port_path)
    rk, rs = _names_by_kind(ref_path)
    for kind in set(pk) | set(rk):
        assert pk.get(kind, set()) - PORT_ONLY.get(kind, set()) == \
            rk.get(kind, set()) - REFERENCE_ONLY.get(kind, set()), kind
    assert PORT_SPAN_NAMES & pk["span"]
    phases = {n for n in rs if n.startswith(("round.", "flush."))}
    assert phases and {n: ps.get(n) for n in phases} == {n: rs[n] for n in phases}


def test_serving_a_traced_run_writes_a_valid_trace(tmp_path):
    res = api.run(_spec(api, obs=api.ObsSpec(enabled=True,
                                             trace_path=str(tmp_path / "run.jsonl"))),
                  device="cpu")
    rec = FlightRecorder(api.ObsSpec(enabled=True))
    fe = serve(res, obs=rec)
    rng = np.random.default_rng(0)
    for i in range(10):
        fe.submit(i % 3, rng.standard_normal(res.sim.mcfg.in_dim).astype(np.float32))
    fe.drain()
    assert len(fe.take_completed()) == 10
    path = str(tmp_path / "serve.jsonl")
    digest = write_jsonl(path, {"what": "serve"}, rec.records, rec.metrics)
    assert digest == file_sha256(path)
    lines = _lines(path)
    assert ref_validate(lines) == validate_trace_lines(lines)
    names = {json.loads(x)["name"] for x in lines[1:]}
    assert {"serve.snapshot", "serve.verify", "serve.batch", "serve.flush",
            "serve.latency", "serve.requests"} <= names <= ALL_NAMES


def test_profile_dir_writes_a_torch_trace_on_the_cpu(tmp_path):
    prof = tmp_path / "prof"
    spec = dataclasses.replace(
        _spec(api), train=dataclasses.replace(_spec(api).train, rounds=1),
        obs=api.ObsSpec(enabled=True, trace_path=str(tmp_path / "t.jsonl"),
                        profile_dir=str(prof)))
    api.run(spec, device="cpu")
    doc = json.load(open(prof / "torch_trace.json"))
    assert doc["traceEvents"]


def test_check_supported_accepts_an_enabled_obs_spec():
    check_supported(api.ExperimentSpec(obs=api.ObsSpec(enabled=True, console=True)))


def test_an_explicit_recorder_and_an_enabled_spec_refuse_together(tmp_path):
    spec = _spec(api, obs=api.ObsSpec(enabled=True, trace_path=str(tmp_path / "t")))
    with pytest.raises(ValueError, match="not both"):
        api.run(spec, device="cpu", obs=FlightRecorder())


def test_an_explicit_recorder_still_times_an_untraced_run():
    rec = FlightRecorder()
    res = api.run(_spec(api), device="cpu", obs=rec)
    assert res.sim.obs is rec and "trace_digest" not in res.manifest
    names = {r["name"] for r in rec.records}
    assert {"round.total", "round.step", "step.local_train"} <= names
