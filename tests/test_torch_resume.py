"""Crash-consistent checkpoint/resume on the port, on the CPU.

Kill a run at a checkpoint boundary — `crash_mode="exception"` in process,
at each crash phase and in both modes; a real SIGKILL only in a child
process, with a timeout — resume from the snapshot directory with the fault
schedule cleared, and the final manifest digests (event-log sha256,
block-hashes digest, balances digest, final accuracy) must equal the
uninterrupted run's exactly.  Checkpointing is a pure observer; a corrupt
or truncated newest snapshot falls back to the one before; a different
experiment is refused; no writer thread outlives a run, crashed or not.
Every snapshot directory lies under `tmp_path`.

The snapshot files (`repro_torch.checkpoint.io`): the `BFLNCKPT`
container round-trips numpy arrays and plain values, refuses to write a
tensor and to read a bad magic, a newer format, a truncated or
bit-flipped payload and a payload that pickles anything but plain
values, and prunes to `keep_last`.
The `cuda`-marked test crashes and resumes on the card (skipped here)."""
import io
import os
import pickle
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (  # noqa: E402
    AsyncSpec,
    CheckpointError,
    CheckpointSpec,
    DataSpec,
    ExperimentSpec,
    FaultSpec,
    InjectedCrash,
    TrainSpec,
    run,
)
from repro_torch.checkpoint import io as ckio  # noqa: E402
from repro_torch.checkpoint.state import capture_experiment_state  # noqa: E402
from repro_torch.sim.driver import SimulatedFederation  # noqa: E402
from repro_torch.sim.population import ClientPopulation  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DIGEST_KEYS = ("event_log_digest", "block_hashes_digest", "balances_digest",
               "final_accuracy")


def _digests(m):
    return {k: m[k] for k in DIGEST_KEYS}


def _spec(mode="sync", rounds=6, seed=3, **kw):
    return ExperimentSpec(
        data=DataSpec(n_clients=40, n_batches=1, batch_size=16),
        train=TrainSpec(strategy="bfln", rounds=rounds, sample_frac=0.3,
                        n_clusters=2, local_epochs=1, mode=mode),
        async_=AsyncSpec(buffer_size=4, concurrency=8), seed=seed, **kw)


@pytest.fixture(scope="module")
def plain():
    return {mode: run(_spec(mode), device="cpu").manifest
            for mode in ("sync", "async")}


def _writers() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith("ckpt-writer")]


def _crash_then_resume(tmp_path, mode, phase, boundary=4, **faults):
    ck = CheckpointSpec(interval=2, dir=str(tmp_path / "ck"))
    crash = _spec(mode, checkpoint=ck,
                  faults=FaultSpec(crash_round=boundary, crash_phase=phase,
                                   crash_mode="exception", **faults))
    with pytest.raises(InjectedCrash):
        run(crash, device="cpu")
    assert _writers() == []
    return run(_spec(mode, checkpoint=ck), device="cpu", resume_from=ck.dir)


@pytest.mark.parametrize("phase", ["round_start", "pre_chain", "post_checkpoint"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_crash_and_resume_is_bit_identical(tmp_path, plain, mode, phase):
    resumed = _crash_then_resume(tmp_path, mode, phase)
    assert resumed.manifest["resume_step"] == 4
    assert resumed.manifest["resumed_from"] == str(tmp_path / "ck")
    assert _digests(resumed.manifest) == _digests(plain[mode])
    assert resumed.manifest["rounds_run"] == plain[mode]["rounds_run"]
    assert resumed.manifest["chain_valid"] and resumed.manifest["ledger_conserved"]
    assert _writers() == []


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_checkpointing_is_a_pure_observer(tmp_path, plain, mode):
    ck = CheckpointSpec(interval=2, dir=str(tmp_path / "ck"), keep_last=2)
    m = run(_spec(mode, checkpoint=ck), device="cpu").manifest
    assert _digests(m) == _digests(plain[mode])
    assert m["checkpoints_written"] == 3 and m["checkpoint_bytes"] > 0
    assert [s for s, _ in ckio.list_checkpoints(ck.dir)] == [4, 6]
    assert _spec(mode, checkpoint=ck).config_digest() == _spec(mode).config_digest()
    assert _writers() == []


def test_resume_from_explicit_snapshot_file(tmp_path, plain):
    ck = CheckpointSpec(interval=2, dir=str(tmp_path / "ck"))
    run(_spec(checkpoint=ck), device="cpu")
    resumed = run(_spec(checkpoint=ck), device="cpu",
                  resume_from=os.path.join(ck.dir, "ckpt_00000004.npz"))
    assert resumed.manifest["resume_step"] == 4
    assert _digests(resumed.manifest) == _digests(plain["sync"])


@pytest.mark.parametrize("damage", ["corrupt", "truncate"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resume_falls_back_over_a_damaged_snapshot(tmp_path, plain, mode, damage):
    resumed = _crash_then_resume(tmp_path, mode, "post_checkpoint",
                                 **{f"{damage}_checkpoint_round": 4})
    assert resumed.manifest["resume_step"] == 2          # 4 was damaged
    assert _digests(resumed.manifest) == _digests(plain[mode])


def test_resume_refuses_a_different_experiment(tmp_path):
    ck = CheckpointSpec(interval=2, dir=str(tmp_path / "ck"))
    run(_spec(rounds=2, checkpoint=ck), device="cpu")
    with pytest.raises(CheckpointError, match="different experiment"):
        run(_spec(rounds=2, seed=7, checkpoint=ck), device="cpu",
            resume_from=ck.dir)
    (tmp_path / "empty").mkdir()
    with pytest.raises(CheckpointError, match="no checkpoints"):
        run(_spec(rounds=2), device="cpu", resume_from=str(tmp_path / "empty"))
    with pytest.raises(CheckpointError, match="cannot read"):
        run(_spec(rounds=2), device="cpu", resume_from=str(tmp_path / "absent.npz"))


def test_capture_holds_numpy_arrays_and_plain_values_only(tmp_path):
    spec = _spec(rounds=2)
    sim = SimulatedFederation(
        ClientPopulation.from_spec(spec.population_spec(), "cpu"), spec,
        device="cpu")
    sim.run()
    tree = capture_experiment_state(sim, 2)

    def plain_only(x):
        if isinstance(x, dict):
            return all(plain_only(k) and plain_only(v) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return all(plain_only(v) for v in x)
        return isinstance(x, (np.ndarray, np.generic, int, float, str, bool,
                              bytes, type(None)))
    assert plain_only(tree)
    arena = tree["arrays"]["arena"]
    sim.arena.data.add_(1.0)              # later in-place updates stay out
    assert not np.shares_memory(arena, sim.arena.data.numpy())
    assert not np.array_equal(arena, sim.arena.data.numpy())


def test_checkpoint_file_round_trips_arrays_and_plain_values(tmp_path):
    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
            "host": {"s": "x", 3: (1, 2.5, None, True), "l": [np.float32(2.0)],
                     "rng": np.random.default_rng(4).bit_generator.state,
                     "b": np.array([True, False])}}
    path = str(tmp_path / "one.npz")
    n = ckio.save_pytree(path, tree)
    assert n == os.path.getsize(path)
    got = ckio.load_pytree(path)
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["host"].pop("b"), [True, False])
    assert got["host"] == {"s": "x", 3: (1, 2.5, None, True), "l": [2.0],
                           "rng": tree["host"]["rng"]}
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    with pytest.raises(TypeError, match="plain values"):
        ckio.save_pytree(str(tmp_path / "two.npz"), {"t": torch.zeros(2)})
    assert not os.path.exists(tmp_path / "two.npz")


def _payload_with_meta(meta: bytes) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(meta, np.uint8))
    return buf.getvalue()


@pytest.mark.parametrize("damage", ["magic", "format", "truncate", "flip",
                                    "not-plain", "missing"])
def test_checkpoint_file_refuses_damage(tmp_path, monkeypatch, damage):
    path = str(tmp_path / "one.npz")
    if damage == "not-plain":             # a valid container around a pickled Path
        monkeypatch.setattr(ckio, "_encode_payload", lambda tree: _payload_with_meta(
            pickle.dumps({"x": Path("p")})))
    ckio.save_pytree(path, {"x": np.ones(64, np.float32)})
    raw = bytearray(open(path, "rb").read())
    if damage == "magic":
        raw[:8] = b"NOTACKPT"
    elif damage == "format":
        raw[8:12] = (ckio.FORMAT_VERSION + 1).to_bytes(4, "little")
    elif damage == "truncate":
        raw = raw[: len(raw) // 2]
    elif damage == "flip":
        raw[-len(raw) // 4] ^= 0xFF
    elif damage == "missing":
        path = str(tmp_path / "nope.npz")
    open(str(tmp_path / "one.npz"), "wb").write(bytes(raw))
    with pytest.raises(CheckpointError):
        ckio.load_pytree(path)


def test_checkpoint_directory_keeps_last_and_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    for step in (1, 2, 3, 4):
        path, _ = ckio.save_checkpoint(d, step, {"step": np.asarray(step)},
                                       keep_last=3)
        assert path == ckio.checkpoint_path(d, step)
    assert [s for s, _ in ckio.list_checkpoints(d)] == [2, 3, 4]
    step, tree = ckio.load_latest(d)
    assert step == 4 and int(tree["step"]) == 4
    with open(ckio.checkpoint_path(d, 4), "r+b") as f:
        f.truncate(10)
    step, tree = ckio.load_latest(d)
    assert step == 3 and int(tree["step"]) == 3
    for s in (2, 3):
        open(ckio.checkpoint_path(d, s), "wb").write(b"junk")
    with pytest.raises(CheckpointError, match="every checkpoint"):
        ckio.load_latest(d)
    assert ckio.list_checkpoints(str(tmp_path / "absent")) == []


_KILL_SCRIPT = textwrap.dedent("""
    from repro_torch.api import (AsyncSpec, CheckpointSpec, DataSpec,
                                 ExperimentSpec, FaultSpec, TrainSpec, run)
    spec = ExperimentSpec(
        data=DataSpec(n_clients=40, n_batches=1, batch_size=16),
        train=TrainSpec(strategy="bfln", rounds=6, sample_frac=0.3,
                        n_clusters=2, local_epochs=1, mode={mode!r}),
        async_=AsyncSpec(buffer_size=4, concurrency=8),
        checkpoint=CheckpointSpec(interval=2, dir={ckdir!r}),
        faults=FaultSpec(crash_round=4, crash_phase="post_checkpoint",
                         crash_mode="sigkill"),
        seed=3)
    run(spec, device="cpu")
    raise SystemExit("survived an injected SIGKILL")
""")


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sigkill_in_a_child_process_and_resume_bit_identical(tmp_path, plain, mode):
    ckdir = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_SCRIPT.format(mode=mode, ckdir=ckdir)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-2000:])
    assert [s for s, _ in ckio.list_checkpoints(ckdir)] == [2, 4]
    resumed = run(_spec(mode, checkpoint=CheckpointSpec(interval=2, dir=ckdir)),
                  device="cpu", resume_from=ckdir)
    assert resumed.manifest["resume_step"] == 4
    assert _digests(resumed.manifest) == _digests(plain[mode])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_cuda_crash_and_resume_is_bit_identical(tmp_path, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    want = run(_spec(mode), device="cuda").manifest
    ck = CheckpointSpec(interval=2, dir=str(tmp_path / "ck"))
    with pytest.raises(InjectedCrash):
        run(_spec(mode, checkpoint=ck,
                  faults=FaultSpec(crash_round=4, crash_phase="post_checkpoint")),
            device="cuda")
    resumed = run(_spec(mode, checkpoint=ck), device="cuda", resume_from=ck.dir)
    assert resumed.manifest["resume_step"] == 4
    assert _digests(resumed.manifest) == _digests(want)
    assert resumed.sim.arena.data.device.type == "cuda"
    assert _writers() == []
