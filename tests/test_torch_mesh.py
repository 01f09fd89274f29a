"""The client-sharded mesh on the port, on the CPU.

The contract under test is the reference's (`tests/test_sharded_engine.py`):
with `MeshSpec(shards=S)` the arena is row-sharded over S devices — each
holds `n_padded / S` rows and no device holds the whole matrix — while a
seeded run (event log, block hashes, balances, final accuracy, arena
bytes) equals the run at `shards=1` bit for bit, in sync and async mode,
with the cohort sharded or replicated.  The port's mesh is one process over
a tuple of S devices (`repro_torch.launch.mesh`); here they are S times the
host, which no environment variable and no process group is needed for.
The port at S = 4 against the reference's engine is in
`tests/test_torch_mesh_reference.py`; this file imports no JAX, so its
`cuda`-marked tests run on the card as they are.

Bit identity rests on local training giving each client the same bits
however many clients one call trains; `test_local_train_is_batch_invariant`
measures that at the default model's widths.  The `cuda`-marked tests run
the same checks on the card (skipped here): there every client-stacked
product goes through the fixed-order batched-product kernel
(`kernels/batched_matmul.py`), which makes local training batch-invariant
(cuBLAS picks its kernel by the batch count and did not), and the small
spec's runs on two shards of one card must equal one shard."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.api import (  # noqa: E402
    AsyncSpec,
    CheckpointSpec,
    DataSpec,
    EvalSpec,
    ExperimentSpec,
    FaultSpec,
    InjectedCrash,
    MeshSpec,
    ObsSpec,
    TrainSpec,
    run,
)
from repro_torch.api.registry import build_strategy  # noqa: E402
from repro_torch.core.baselines import ModelBundle  # noqa: E402
from repro_torch.core.engine import RoundEngine  # noqa: E402
from repro_torch.core.fl import local_train  # noqa: E402
from repro_torch.launch.mesh import ClientMesh, make_client_mesh  # noqa: E402
from repro_torch.models import classifier as clf  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.runtime.arena import ParamArena, ShardedParamArena  # noqa: E402
from repro_torch.serve import serve  # noqa: E402
from repro_torch.sim.driver import SimulatedFederation, cohort_bytes  # noqa: E402
from repro_torch.sim.population import ClientPopulation  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

STRATEGIES = ("bfln", "fedavg", "fedprox", "fedproto", "fedhkd")
SMALL = dict(data=dict(n_clients=60),
             train=dict(sample_frac=0.25, rounds=3, hidden=(16,), rep_dim=8),
             eval=dict(every=2, clients=16, examples=256))
DIGESTS = ("event_log_digest", "block_hashes_digest", "balances_digest",
           "final_accuracy")


def _spec(strategy="bfln", mode="sync", shards=1, cohort="sharded", **kw):
    spec = ExperimentSpec(data=DataSpec(**SMALL["data"]),
                          train=TrainSpec(strategy=strategy, mode=mode,
                                          **SMALL["train"]),
                          eval=EvalSpec(**SMALL["eval"]),
                          async_=AsyncSpec(buffer_size=5, concurrency=12),
                          mesh=MeshSpec(shards=shards, cohort=cohort))
    return dataclasses.replace(spec, **kw)


def _outcome(res) -> dict:
    """Everything a replay must reproduce, the arena as its bytes."""
    out = {k: res.manifest[k] for k in DIGESTS}
    out["event_log"] = res.report.event_log
    out["arena"] = res.sim.arena.host_rows().tobytes()
    out["accuracy"] = np.array([r.accuracy for r in res.report.history],
                               np.float64).tobytes()
    return out


@functools.lru_cache(maxsize=None)
def _one_shard(strategy: str, mode: str) -> dict:
    return _outcome(run(_spec(strategy, mode), device="cpu"))


def _check_shards(arena: ShardedParamArena, shards: int) -> None:
    """No shard tensor holds more than n_padded / S rows; shard j lives on
    devices[j]."""
    assert arena.n_padded == -(-arena.n_clients // shards) * shards
    assert len(arena.shards) == shards
    for t, dev in zip(arena.shards, arena.devices):
        assert t.shape == (arena.n_padded // shards, arena.n_params)
        assert t.device == dev


# --------------------------------------------------------------------------- #
# the mesh and the sharded arena
# --------------------------------------------------------------------------- #

def test_make_client_mesh_rules(monkeypatch):
    mesh = make_client_mesh(3, "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.shards == 3 and mesh.lead == torch.device("cpu")
    # a sequence is taken as given, repeats included
    assert make_client_mesh(2, ["cpu", torch.device("cpu")]).shards == 2
    with pytest.raises(ValueError, match="got 3 devices"):
        make_client_mesh(2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="shards >= 1"):
        make_client_mesh(0, "cpu")
    if not torch.cuda.is_available():
        # None means the cards, never the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_client_mesh(2)
    # too few cards: the reference's refusal
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        make_client_mesh(2)
    with pytest.raises(ValueError, match="single device"):
        make_client_mesh(2, "cuda:0")
    with pytest.raises(ValueError):
        ClientMesh(())


def _population(n: int, n_params: int = 13, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((n, n_params - 3))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))}


@pytest.mark.parametrize("shards", [2, 3, 4, 7])
def test_sharded_arena_pads_splits_and_round_trips(shards):
    n = 60
    params = _population(n)
    one = ParamArena.from_stacked(params)
    arena = ShardedParamArena.from_stacked(params, make_client_mesh(shards, "cpu"))
    _check_shards(arena, shards)
    assert arena.n_clients == n and arena.n_padded == -(-n // shards) * shards
    # the padding rows are zeros, beyond every real id
    pad = arena.shards[-1][arena.n_clients - (shards - 1) * arena.rows_per_shard:]
    assert not pad.any()
    for key, leaf in arena.as_pytree().items():
        assert torch.equal(leaf.view(torch.int32), one.as_pytree()[key].view(torch.int32))
    np.testing.assert_array_equal(arena.host_rows(), one.data.numpy())
    assert arena.per_device_bytes() == arena.rows_per_shard * one.n_params * 4
    assert arena.nbytes == arena.n_padded * one.n_params * 4
    # rebind pads and splits, from a broadcast view too
    arena.rebind(one.data * 2)
    _check_shards(arena, shards)
    np.testing.assert_array_equal(arena.host_rows(), one.data.numpy() * 2)
    arena.rebind(one.data[:1].expand(n, -1))
    _check_shards(arena, shards)
    assert torch.equal(torch.from_numpy(arena.host_rows()),
                       one.data[:1].expand(n, -1))
    with pytest.raises(ValueError):
        arena.rebind(one.data[:-1])


@settings(database=None, derandomize=True, max_examples=40, deadline=None)
@given(shards=st.integers(2, 7), n=st.integers(1, 40), seed=st.integers(0, 2**16))
def test_sharded_gather_and_scatter_match_one_arena(shards, n, seed):
    rng = np.random.default_rng(seed)
    params = _population(n, seed=seed)
    one = ParamArena.from_stacked({k: v.clone() for k, v in params.items()})
    arena = ShardedParamArena.from_stacked(params, make_client_mesh(shards, "cpu"))
    ids = rng.permutation(n)[: rng.integers(1, n + 1)]
    got = arena.gather(ids, "cpu")
    assert torch.equal(got, one.gather(ids))
    # a copy, never a view of a shard
    got += 1.0
    np.testing.assert_array_equal(arena.host_rows(), one.data.numpy())
    rows = torch.from_numpy(rng.standard_normal((ids.size, one.n_params))
                            .astype(np.float32))
    mask = rng.random(ids.size) < 0.6
    written = arena.masked_scatter(ids, mask, rows)
    want = one.masked_scatter(ids, mask, rows)
    assert torch.equal(written, want)
    np.testing.assert_array_equal(arena.host_rows(), one.data.numpy())
    _check_shards(arena, shards)
    with pytest.raises(IndexError):
        arena.gather([n], "cpu")


@pytest.mark.parametrize("shards,per_device,cohort", [
    (4, 6_570_000, 3_942_000), (3, 8_777_520, 4_467_600)])
def test_gauges_at_the_defaults_follow_the_reference_formula(tmp_path, shards,
                                                             per_device, cohort):
    spec = ExperimentSpec(mesh=MeshSpec(shards=shards),
                          obs=ObsSpec(enabled=True, trace_path=str(tmp_path / "t.jsonl")))
    pop = ClientPopulation.from_spec(spec.population_spec(), "cpu")
    sim = SimulatedFederation(pop, spec, device="cpu")
    n_params = sim.arena.n_params
    rows = -(-1000 // shards)
    assert n_params == 6570
    _check_shards(sim.arena, shards)
    gauges = sim.obs.metrics.gauges
    assert gauges["arena.per_device_bytes"] == per_device == rows * n_params * 4
    assert gauges["arena.bytes"] == rows * shards * n_params * 4
    k_pad = -(-100 // shards) * shards
    assert gauges["engine.cohort_bytes"] == cohort == \
        2 * (k_pad // shards) * n_params * 4 + k_pad * n_params * 4
    rep = SimulatedFederation(pop, dataclasses.replace(
        spec, mesh=MeshSpec(shards=shards, cohort="replicated")), device="cpu")
    assert rep.engine.cohort_mode == "replicated"
    assert rep.obs.metrics.gauges["engine.cohort_bytes"] == \
        cohort_bytes(rep.engine, 100, n_params) == 2 * 100 * n_params * 4


# --------------------------------------------------------------------------- #
# local training does not depend on how many clients one call trains
# --------------------------------------------------------------------------- #

def _default_model(pop):
    t = TrainSpec()
    mcfg = clf.MLPConfig(in_dim=pop.in_dim, hidden=t.hidden, rep_dim=t.rep_dim,
                         num_classes=pop.num_classes)
    bundle = ModelBundle(functools.partial(clf.apply_batched, mcfg),
                         functools.partial(clf.embed_batched, mcfg), pop.num_classes)
    return mcfg, bundle, adam(t.lr)


def _pad0(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]) if pad else t


def _batch_invariance(device) -> dict[str, bool]:
    """At the default widths (64 -> 64 -> 32 -> 10), each strategy's local
    training of 100 clients in one call against 4 calls of 25 and against
    3 calls of 34 (the last padded with 2 zero-data slots on row 0, as the
    engine pads), and the eval forward of 100 clients against 4 calls of
    25, bit for bit."""
    pop = ClientPopulation.from_spec(
        ExperimentSpec(data=DataSpec(n_clients=200)).population_spec(), device)
    mcfg, bundle, opt = _default_model(pop)
    params = clf.init_stacked(mcfg, torch.Generator().manual_seed(0), 100,
                              same_init=False, device=device)
    cx, cy = pop.cohort_data(np.arange(100) * 2)
    equal = {}
    for name in STRATEGIES:
        strat = build_strategy(name, bundle, probe=pop.probe, n_clusters=5)
        extras = strat.round_extras(params, cx, cy)

        def train(a, m, pad=0):
            sl = slice(a, a + m)
            p = {k: torch.cat([v[sl], v[:1].expand(pad, *v.shape[1:])])
                 for k, v in params.items()}
            e = extras if strat.shared_extras else tree_map(
                lambda t: _pad0(t[sl], pad), extras)
            res = local_train(strat.local_loss, opt, p, opt.init(p),
                              _pad0(cx[sl], pad), _pad0(cy[sl], pad), e, 1,
                              shared_extras=strat.shared_extras)
            return {k: v[:m] for k, v in res.params.items()}, res.mean_loss[:m]

        whole = train(0, 100)
        for split in ((25, 25, 25, 25), (34, 34, 32)):
            starts = np.cumsum((0,) + split[:-1])
            parts = [train(a, m, pad=max(split) - m) for a, m in zip(starts, split)]
            same = all(torch.equal(torch.cat([q[0][k] for q in parts]), whole[0][k])
                       for k in whole[0])
            equal[f"{name} {split}"] = same and torch.equal(
                torch.cat([q[1] for q in parts]), whole[1])
    ex = pop.test_x[:1024]
    logits = bundle.apply_fn(params, ex)
    equal["eval forward (25, 25, 25, 25)"] = torch.equal(torch.cat(
        [bundle.apply_fn({k: v[a:a + 25] for k, v in params.items()}, ex)
         for a in range(0, 100, 25)]), logits)
    return equal


def test_local_train_is_batch_invariant():
    equal = _batch_invariance("cpu")
    assert all(equal.values()), {k: v for k, v in equal.items() if not v}


# --------------------------------------------------------------------------- #
# runs at S shards equal the run at one shard, bit for bit
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cohort", ["sharded", "replicated"])
@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sync_run_on_the_mesh_equals_one_shard(strategy, shards, cohort):
    res = run(_spec(strategy, shards=shards, cohort=cohort), device="cpu")
    assert res.sim.engine.cohort_mode == cohort
    assert res.sim.engine.cohort_shards == (shards if cohort == "sharded" else 1)
    _check_shards(res.sim.arena, shards)
    assert _outcome(res) == _one_shard(strategy, "sync")
    assert res.manifest["chain_valid"] and res.manifest["ledger_conserved"]


@pytest.mark.parametrize("cohort", ["sharded", "replicated"])
@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("strategy", ["bfln", "fedavg"])
def test_async_run_on_the_mesh_equals_one_shard(strategy, shards, cohort):
    res = run(_spec(strategy, "async", shards=shards, cohort=cohort), device="cpu")
    _check_shards(res.sim.arena, shards)
    assert _outcome(res) == _one_shard(strategy, "async")
    assert res.report.n_blocks > 1


def test_round_spans_carry_the_shards_and_the_cohort_mode(tmp_path):
    spec = _spec(shards=4, obs=ObsSpec(enabled=True, trace_path=str(tmp_path / "t.jsonl")))
    res = run(spec, device="cpu")
    steps = [r for r in res.sim.obs.records if r.get("name") == "round.step"]
    assert len(steps) == 3
    assert all(r["attrs"] == {"shards": 4, "cohort_mode": "sharded"} for r in steps)
    assert {k: res.manifest[k] for k in DIGESTS} == \
        {k: v for k, v in _one_shard("bfln", "sync").items() if k in DIGESTS}


def test_sharded_mode_needs_the_two_stage_strategy():
    pop = ClientPopulation.from_spec(_spec().population_spec(), "cpu")
    sim = SimulatedFederation(pop, _spec(), device="cpu")
    bare = sim.engine.strategy._replace(cohort_partial=None)
    with pytest.raises(ValueError, match="replicated"):
        RoundEngine(sim.arena.layout, strategy=bare, opt=sim.opt, n_clusters=5,
                    local_epochs=1, stacked_apply_fn=sim.bundle.apply_fn,
                    mesh=make_client_mesh(2, "cpu"))
    eng = RoundEngine(sim.arena.layout, strategy=bare, opt=sim.opt, n_clusters=5,
                      local_epochs=1, stacked_apply_fn=sim.bundle.apply_fn,
                      mesh=make_client_mesh(2, "cpu"), cohort_mode="replicated")
    assert eng.cohort_mode == "replicated" and eng.cohort_shards == 1


def test_empty_rounds_on_the_mesh_are_blockless_and_identical():
    def make(shards):
        spec = _spec(shards=shards,
                     data=DataSpec(n_clients=32, straggler_frac=0.0, dropout_rate=0.0),
                     eval=EvalSpec(every=0, clients=16, examples=256))
        spec = dataclasses.replace(spec, train=dataclasses.replace(spec.train, rounds=2))
        pop = ClientPopulation.from_spec(spec.population_spec(), "cpu")
        pop.latency.speed[:] = 1e9        # everyone misses every deadline
        return run(spec, population=pop, device="cpu")
    a, b = make(4), make(1)
    assert a.report.event_log == b.report.event_log
    assert all(not r.arrived.any() for r in a.report.history)
    assert a.report.n_blocks == 1                         # genesis only
    assert a.manifest["block_hashes_digest"] == b.manifest["block_hashes_digest"]
    np.testing.assert_array_equal(a.report.balances, b.report.balances)
    assert a.sim.arena.host_rows().tobytes() == b.sim.arena.host_rows().tobytes()


def test_zero_arrival_cluster_on_the_mesh_matches_one_shard():
    """A cluster whose members all miss the deadline aggregates identically
    on the mesh: weight-zero mean, its members keep their old rows."""
    data = DataSpec(n_clients=40, straggler_frac=0.0, dropout_rate=0.0)
    spec = _spec(data=data)
    pop = ClientPopulation.from_spec(spec.population_spec(), "cpu")
    k = 13                                  # pads to 16 on 4 shards
    cohort = np.arange(0, 39, 3)[:k]
    cx, cy = pop.cohort_data(cohort)

    def sim(shards):
        return SimulatedFederation(pop, dataclasses.replace(
            spec, mesh=MeshSpec(shards=shards)), device="cpu")
    probe = sim(4)
    labels = probe.engine.sync_step(probe.arena, cohort, cx, cy,
                                    torch.ones(k)).labels.numpy()
    mask = labels != labels[0]
    assert mask.any() and not mask.all()
    a, b = sim(4), sim(1)
    w = torch.as_tensor(mask, dtype=torch.float32)
    oa = a.engine.sync_step(a.arena, cohort, cx, cy, w)
    ob = b.engine.sync_step(b.arena, torch.as_tensor(cohort), cx, cy, w)
    assert torch.equal(oa.labels, ob.labels) and torch.equal(oa.corr, ob.corr)
    assert torch.equal(oa.new_rows.view(torch.int32), ob.new_rows.view(torch.int32))
    assert torch.equal(oa.residues, ob.residues)
    assert torch.equal(oa.mean_loss, ob.mean_loss)
    np.testing.assert_array_equal(a.arena.host_rows().view(np.int32),
                                  b.arena.host_rows().view(np.int32))
    # the members of the empty cluster kept their rows
    before = ParamArena.from_stacked(sim(1).params).gather(cohort[~mask])
    assert torch.equal(oa.new_rows[torch.as_tensor(~mask)], before)
    _check_shards(a.arena, 4)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_checkpoint_on_the_mesh_resumes_to_the_uninterrupted_run(tmp_path, mode):
    ck = CheckpointSpec(interval=1, dir=str(tmp_path / "ck"))
    crash = _spec(mode=mode, shards=4, checkpoint=ck,
                  faults=FaultSpec(crash_round=2, crash_phase="pre_chain",
                                   crash_mode="exception"))
    with pytest.raises(InjectedCrash):
        run(crash, device="cpu")
    resumed = run(_spec(mode=mode, shards=4, checkpoint=ck), device="cpu",
                  resume_from=ck.dir)
    assert resumed.manifest["resume_step"] == 2
    _check_shards(resumed.sim.arena, 4)
    want = _one_shard("bfln", mode)
    got = _outcome(resumed)
    assert {k: got[k] for k in DIGESTS + ("arena", "event_log")} == \
        {k: want[k] for k in DIGESTS + ("arena", "event_log")}


def test_serve_from_a_mesh_run_equals_one_shard():
    banks = []
    for shards in (4, 1):
        fe = serve(run(_spec(shards=shards), device="cpu"))
        banks.append(fe.engine.bank)
    a, b = banks
    assert a.data.numpy().tobytes() == b.data.numpy().tobytes()
    assert [r.digest for r in a.releases] == [r.digest for r in b.releases]
    assert (a.root, a.round_idx, a.block_hash) == (b.root, b.round_idx, b.block_hash)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

def _cuda_outcome(device) -> dict:
    return _outcome(run(_spec(shards=1 if isinstance(device, str) else len(device)),
                        device=device))


@pytest.mark.cuda
def test_cuda_local_train_is_batch_invariant():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    equal = _batch_invariance("cuda")
    assert all(equal.values()), {k: v for k, v in equal.items() if not v}


@pytest.mark.cuda
def test_cuda_two_shards_on_one_card_equal_one_shard():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    assert _cuda_outcome(["cuda:0", "cuda:0"]) == _cuda_outcome("cuda")


@pytest.mark.cuda
def test_cuda_shards_on_two_cards_equal_one_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    assert _cuda_outcome(["cuda:0", "cuda:1"]) == _cuda_outcome("cuda")
