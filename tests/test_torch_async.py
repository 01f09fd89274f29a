"""Async FedBuff on the port against `repro.sim.async_agg` and the
reference's async driver, on the CPU.

Bit for bit: the merge (`weighted_delta_mean` over flat (K, N) rows, one
`cluster_mean_rows` call at C = 1) against the reference's per-leaf
`weighted_delta_mean` on the same numpy inputs — random weights, all-zero
weights (an exact zero delta), NaN in zero-weight rows, -0.0 rows, K off a
power of two; `BufferedAggregator.flush` (staleness, weights, delta) the
same.  The staleness weight: equal at alpha = 0.5 for every staleness
below 1000, within one ulp of the reference's XLA power at other alphas.

`run(async spec)` at n = 60 (buffer 6, concurrency 12, 4 flushes, the port
starting from the reference's initial population): the event log and
balances equal (single-cluster CACC with the identity affinity makes
producers and rewards independent of the trained bits), chain valid and
ledger conserved on both, final and per-flush accuracy within ACC_TOL =
0.02, the staleness means equal.  The `cuda`-marked tests run the merge and
a run on the card (skipped here)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.api as ref_api  # noqa: E402
from repro.sim import ClientPopulation as JPopulation  # noqa: E402
from repro.sim import SimulatedFederation as JSimulation  # noqa: E402
from repro.sim import async_agg as ref_agg  # noqa: E402
from repro_torch.api import (  # noqa: E402
    AsyncSpec,
    DataSpec,
    EvalSpec,
    ExperimentSpec,
    TrainSpec,
    build_manifest,
    run,
)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import cluster_agg as ka  # noqa: E402
from repro_torch.kernels import fingerprint as kf  # noqa: E402
from repro_torch.sim import async_agg as tagg  # noqa: E402
from repro_torch.sim.driver import SimulatedFederation  # noqa: E402
from repro_torch.sim.population import ClientPopulation  # noqa: E402

ACC_TOL = 0.02
# a flat row is the leaves' columns in sorted-key order
LEAVES = {"a_w": (3, 4), "b": (5,), "c_head": (2, 3)}
N = sum(int(np.prod(s)) for s in LEAVES.values())


def _ref_merge(rows: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The reference's merge on the rows split into LEAVES, flattened back."""
    k, cols, tree = rows.shape[0], 0, {}
    for name in sorted(LEAVES):
        size = int(np.prod(LEAVES[name]))
        tree[name] = jnp.asarray(rows[:, cols:cols + size].reshape((k,) + LEAVES[name]))
        cols += size
    out = ref_agg.weighted_delta_mean(tree, jnp.asarray(w))
    return np.concatenate([np.asarray(out[name]).reshape(-1) for name in sorted(LEAVES)])


def _merge_case(kind: str, k: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((k, N)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, k).astype(np.float32)
    if kind == "all-zero-weights":
        w[:] = 0.0
    elif kind == "nan-at-zero-weight":
        w[1::3] = 0.0
        rows[w == 0] = np.nan
    elif kind == "negative-zero-rows":
        w[::2] = 0.0
        rows[1] = -0.0
    elif kind == "staleness-weights":
        w = ref_agg.staleness_weight(np.arange(k) % 5, 0.5)
        w = np.asarray(w, np.float32) * (rng.random(k) < 0.8)
    return rows, np.asarray(w, np.float32)


MERGE_CASES = {"random": 16, "all-zero-weights": 16, "nan-at-zero-weight": 16,
               "negative-zero-rows": 16, "staleness-weights": 16, "k-off-pow2": 11,
               "one-update": 1}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_is_the_references_bit_for_bit(case):
    kind = case if case in ("all-zero-weights", "nan-at-zero-weight",
                            "negative-zero-rows", "staleness-weights") else "random"
    rows, w = _merge_case(kind, k=MERGE_CASES[case], seed=len(case))
    got = tagg.weighted_delta_mean(torch.from_numpy(rows), torch.from_numpy(w)).numpy()
    want = _ref_merge(rows, w)
    assert got.shape == (N,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isfinite(got).all()
    if case == "all-zero-weights":
        assert not got.view(np.uint32).any()          # exact +0.0 everywhere


def test_staleness_weight_matches_reference():
    s = np.arange(1000)
    np.testing.assert_array_equal(tagg.staleness_weight(s, 0.5),
                                  np.asarray(ref_agg.staleness_weight(s, 0.5)))
    for alpha in (0.0, 0.25, 0.7, 1.0, 1.5, 2.0):
        got = tagg.staleness_weight(s, alpha).view(np.int32)
        want = np.asarray(ref_agg.staleness_weight(s, alpha)).view(np.int32)
        assert np.abs(got - want).max() <= 1, alpha
    w = tagg.staleness_weight(np.arange(6))
    assert w.dtype == np.float32 and w[0] == 1.0 and np.all(np.diff(w) < 0)


def test_buffered_aggregator_matches_reference():
    rows, _ = _merge_case("random", k=5, seed=9)
    versions, gate = [0, 1, 1, 3, 2], np.array([1, 1, 0, 1, 1], np.float32)
    mine = tagg.BufferedAggregator(capacity=5, alpha=0.5)
    ref = ref_agg.BufferedAggregator(capacity=5, alpha=0.5)
    for i, v in enumerate(versions):
        full = mine.add(tagg.BufferedUpdate(i, torch.from_numpy(rows[i]), v))
        assert full == ref.add(ref_agg.BufferedUpdate(i, {"x": jnp.asarray(rows[i])}, v))
    got, want = mine.flush(4, gate=gate), ref.flush(4, gate=gate)
    np.testing.assert_array_equal(got.clients, want.clients)
    np.testing.assert_array_equal(got.staleness, want.staleness)
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.delta.numpy().view(np.uint32),
                                  np.asarray(want.delta["x"]).view(np.uint32))
    assert len(mine) == 0
    with pytest.raises(ValueError, match="empty buffer"):
        mine.flush(5)


SMALL = dict(data=dict(n_clients=60),
             train=dict(sample_frac=0.25, rounds=4, hidden=(16,), rep_dim=8,
                        mode="async"),
             eval=dict(every=2, clients=16, examples=256),
             async_=dict(buffer_size=6, concurrency=12))


def _specs():
    ref = ref_api.ExperimentSpec(data=ref_api.DataSpec(**SMALL["data"]),
                                 train=ref_api.TrainSpec(**SMALL["train"]),
                                 eval=ref_api.EvalSpec(**SMALL["eval"]),
                                 async_=ref_api.AsyncSpec(**SMALL["async_"]))
    port = ExperimentSpec(data=DataSpec(**SMALL["data"]),
                          train=TrainSpec(**SMALL["train"]),
                          eval=EvalSpec(**SMALL["eval"]),
                          async_=AsyncSpec(**SMALL["async_"]))
    return ref, port


@pytest.fixture(scope="module")
def runs():
    rspec, tspec = _specs()
    jsim = JSimulation(JPopulation.from_spec(rspec.population_spec()), rspec)
    init = {k: np.array(v) for k, v in jsim.params.items()}
    jrep = jsim.run()
    tsim = SimulatedFederation(
        ClientPopulation.from_spec(tspec.population_spec(), "cpu"), tspec,
        device="cpu")
    tsim.params = params_from_numpy(init, device="cpu")
    trep = tsim.run()
    return dict(jsim=jsim, jrep=jrep, jm=ref_api.build_manifest(rspec, jsim, jrep),
                tsim=tsim, trep=trep, tm=build_manifest(tspec, tsim, trep))


def test_async_event_log_and_balances_equal_reference(runs):
    assert runs["trep"].event_log == runs["jrep"].event_log
    assert runs["tm"]["event_log_digest"] == runs["jm"]["event_log_digest"]
    np.testing.assert_array_equal(runs["trep"].balances, runs["jrep"].balances)
    assert runs["tm"]["rounds_run"] == runs["jm"]["rounds_run"] == 4
    for m in (runs["tm"], runs["jm"]):
        assert m["chain_valid"] and m["ledger_conserved"] and m["n_blocks"] == 5


def test_async_history_and_accuracy_match_reference(runs):
    for a, b in zip(runs["jrep"].history, runs["trep"].history, strict=True):
        np.testing.assert_array_equal(a.cohort, b.cohort)
        assert (a.staleness_mean, a.producer, a.verified_frac, a.reward_paid) == \
            (b.staleness_mean, b.producer, b.verified_frac, b.reward_paid)
        assert isinstance(b.accuracy, float)
        assert np.isnan(a.accuracy) == np.isnan(b.accuracy)
        if not np.isnan(a.accuracy):
            assert abs(a.accuracy - b.accuracy) <= ACC_TOL
        assert abs(a.mean_loss - b.mean_loss) < 0.05
    assert any(r.staleness_mean > 0 for r in runs["trep"].history)
    t, j = runs["tm"]["final_accuracy"], runs["jm"]["final_accuracy"]
    assert 0.0 < t <= 1.0 and abs(t - j) <= ACC_TOL


def test_async_run_ends_with_every_row_the_global_model(runs):
    data = runs["tsim"].arena.data
    assert torch.equal(data, data[:1].expand_as(data))
    ref_row = np.asarray(runs["jsim"].arena.data[0])
    assert np.abs(data[0].numpy() - ref_row).max() < 1e-4


def test_async_step_trains_without_touching_its_base_rows(runs):
    tsim = runs["tsim"]
    eng, pop = tsim.engine, tsim.pop
    clients = np.array([3, 7, 11, 19])
    base = tsim.arena.data[clients].clone() + 0.01 * torch.arange(4.0)[:, None]
    keep = base.clone()
    cx, cy = pop.cohort_data(clients)
    local, residues, loss = eng.async_step(base, cx, cy)
    assert torch.equal(base, keep) and local.shape == base.shape
    assert not torch.equal(local, base) and torch.isfinite(local).all()
    assert torch.equal(residues, kf.fingerprint_rows(local.view(torch.int32)))
    assert loss.shape == () and torch.isfinite(loss)
    acc = eng.eval_global(local[0], pop.test_x[:64], pop.test_y[:64])
    assert acc == eng.eval_population(local, torch.tensor([0]), pop.test_x[:64],
                                      pop.test_y[:64])


def test_async_refuses_a_buffer_that_could_never_fill():
    _, tspec = _specs()
    spec = dataclasses.replace(tspec, async_=AsyncSpec(buffer_size=30, concurrency=40))
    with pytest.raises(ValueError, match="could never fill"):
        run(spec, device="cpu")


def test_async_baseline_strategy_runs():
    _, tspec = _specs()
    spec = dataclasses.replace(
        tspec, train=dataclasses.replace(tspec.train, strategy="fedavg", rounds=2))
    m = run(spec, device="cpu").manifest
    assert m["mode"] == "async" and m["rounds_run"] == 2
    assert m["chain_valid"] and m["ledger_conserved"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "nan-at-zero-weight", "all-zero-weights"])
def test_cuda_merge_is_the_references_bit_for_bit(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rows, w = _merge_case(case, k=16, seed=3)
    before = ka.launches
    got = tagg.weighted_delta_mean(torch.from_numpy(rows).cuda(),
                                   torch.from_numpy(w).cuda())
    assert ka.launches == before + 1
    want = _ref_merge(rows, w)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.cuda
def test_cuda_async_run_matches_the_cpu_run():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, tspec = _specs()
    before = (kf.launches, ka.launches)
    card = run(tspec, device="cuda")
    assert (kf.launches - before[0], ka.launches - before[1]) == (4 + 1, 4)
    cpu = run(tspec, device="cpu")
    assert card.manifest["event_log_digest"] == cpu.manifest["event_log_digest"]
    np.testing.assert_array_equal(card.report.balances, cpu.report.balances)
    assert card.manifest["chain_valid"] and card.manifest["ledger_conserved"]
    assert abs(card.manifest["final_accuracy"] - cpu.manifest["final_accuracy"]) <= ACC_TOL
