"""`repro_torch.api.run` end to end against `repro.api.run` at a small size
(n = 60, cohort 25%, 3 rounds, MLP hidden=(16,), rep_dim=8), both on the
CPU, the port starting from the reference's initial population (carried
across with the `params` setter: JAX's PRNG cannot be reproduced in torch).

Equal exactly: the population data, the event log (numpy-driven: the
`uniform` sampler and the latency draws never read labels), the number of
blocks; `chain_valid` and `ledger_conserved` hold on both.  Not compared:
block hashes and balances — the trained params differ in the low bits, and
a near-tie in spectral clustering can flip a label, which moves the CACC
producer and the rewards.  Final accuracy agrees within ACC_TOL = 0.01
(measured: equal to the last bit at this size; a flipped label moves a
few clients' models)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
from repro.sim import ClientPopulation as JPopulation  # noqa: E402
from repro.sim import SimulatedFederation as JSimulation  # noqa: E402
from repro_torch.api import (  # noqa: E402
    DataSpec,
    EvalSpec,
    ExperimentSpec,
    MeshSpec,
    TrainSpec,
    build_manifest,
    run,
)
from repro_torch.api.runner import check_supported  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serve import serve, verify_bank  # noqa: E402
from repro_torch.sim.driver import SimulatedFederation  # noqa: E402
from repro_torch.sim.population import ClientPopulation  # noqa: E402

ACC_TOL = 0.01
SMALL = dict(data=dict(n_clients=60),
             train=dict(sample_frac=0.25, rounds=3, hidden=(16,), rep_dim=8),
             eval=dict(every=2, clients=16, examples=256))


def _specs():
    ref = ref_api.ExperimentSpec(data=ref_api.DataSpec(**SMALL["data"]),
                                 train=ref_api.TrainSpec(**SMALL["train"]),
                                 eval=ref_api.EvalSpec(**SMALL["eval"]))
    port = ExperimentSpec(data=DataSpec(**SMALL["data"]),
                          train=TrainSpec(**SMALL["train"]),
                          eval=EvalSpec(**SMALL["eval"]))
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
                tsim=tsim, trep=trep, tm=build_manifest(tspec, tsim, trep),
                init=init)


def test_event_log_equals_reference(runs):
    assert runs["trep"].event_log == runs["jrep"].event_log
    assert runs["tm"]["event_log_digest"] == runs["jm"]["event_log_digest"]
    assert len(runs["trep"].event_log) > 3 * 15


def test_chain_and_ledger_hold_on_both(runs):
    for m in (runs["jm"], runs["tm"]):
        assert m["chain_valid"] and m["ledger_conserved"]
    assert runs["tm"]["n_blocks"] == runs["jm"]["n_blocks"] == 1 + sum(
        bool(r.arrived.any()) for r in runs["trep"].history)
    assert runs["tm"]["rounds_run"] == 3


def test_final_accuracy_within_tolerance(runs):
    t, j = runs["tm"]["final_accuracy"], runs["jm"]["final_accuracy"]
    assert 0.0 < t <= 1.0 and abs(t - j) <= ACC_TOL


def test_history_matches_reference_where_numpy_drives_it(runs):
    for a, b in zip(runs["jrep"].history, runs["trep"].history):
        np.testing.assert_array_equal(a.cohort, b.cohort)
        np.testing.assert_array_equal(a.arrived, b.arrived)
        assert (a.n_stragglers, a.n_dropouts, a.t_close) == \
            (b.n_stragglers, b.n_dropouts, b.t_close)
        assert abs(a.mean_loss - b.mean_loss) < 0.05
        assert isinstance(b.accuracy, float)
    rec = runs["trep"].history[1]         # eval every 2 rounds
    assert 0.0 <= rec.accuracy <= 1.0 and rec.cluster_accuracy.shape == (5,)


def test_manifest_keys_are_the_reference_minus_compile_counts(runs):
    assert set(runs["tm"]) == set(runs["jm"]) - {"engine_compile_counts"}
    for key in ("strategy", "mode", "sampler", "engine", "mesh_shards", "seed",
                "n_clients", "rounds_run"):
        assert runs["tm"][key] == runs["jm"][key]


def test_population_equals_reference():
    rspec, tspec = _specs()
    jp = JPopulation.from_spec(rspec.population_spec())
    tp = ClientPopulation.from_spec(tspec.population_spec(), "cpu")
    for name in ("cx", "cy", "test_x", "test_y", "probe"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    for name in ("tx", "ty", "availability", "dropout", "byzantine"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    np.testing.assert_array_equal(tp.latency.speed, jp.latency.speed)
    assert tp.latency.draw(3) == jp.latency.draw(3)


def test_params_setter_round_trips(runs):
    tsim = runs["tsim"]
    before = tsim.arena.data.clone()
    tsim.params = tsim.params
    assert torch.equal(tsim.arena.data, before)
    fresh = SimulatedFederation(runs["tsim"].pop, runs["tsim"].spec, device="cpu")
    fresh.params = params_from_numpy(runs["init"], device="cpu")
    for k, v in runs["init"].items():
        np.testing.assert_array_equal(fresh.params[k].numpy(), v)


def test_serve_plugs_into_the_trained_run(runs):
    sim = runs["tsim"]
    fe = serve(sim)
    verify_bank(fe.engine.bank, sim.trainer.chain)
    rng = np.random.default_rng(0)
    for c in range(5):
        fe.submit(c, rng.standard_normal(sim.mcfg.in_dim).astype(np.float32))
    fe.drain()
    done = fe.take_completed()
    assert [d.status for d in done] == ["ok"] * 5
    assert all(np.isfinite(d.logits).all() and d.logits.shape == (10,) for d in done)


def test_run_returns_a_result_on_the_cpu():
    _, tspec = _specs()
    spec = dataclasses.replace(tspec, train=dataclasses.replace(tspec.train, rounds=2))
    res = run(spec, device="cpu")
    assert res.manifest["rounds_run"] == 2 and res.manifest["chain_valid"]
    assert res.sim.arena.data.device.type == "cpu"
    assert "config_digest=" in res.summary()


@pytest.mark.parametrize("change,match", [
    # async runs now, for BFLN and the baselines alike: accepted (match None)
    (dict(train=TrainSpec(mode="async")), None),
    (dict(engine=False), "Deliberately not ported"),
    # the client-sharded mesh runs now: accepted (match None), under the
    # case id it had while refused
    pytest.param(dict(mesh=MeshSpec(shards=2)), None, id="change2-item 6"),
    (dict(train=TrainSpec(strategy="fedavg", mode="async")), None),
])
def test_run_refuses_what_the_slice_does_not_do(change, match):
    spec = dataclasses.replace(ExperimentSpec(), **change)
    if match is None:
        check_supported(spec)
        return
    with pytest.raises(NotImplementedError, match=match):
        run(spec, device="cpu")


def test_spec_defaults_equal_the_reference_and_round_trip():
    ref, port = ref_api.ExperimentSpec(), ExperimentSpec()
    for section in ("data", "train", "async_", "eval", "chain", "mesh", "obs",
                    "checkpoint", "faults"):
        assert dataclasses.asdict(getattr(port, section)) == \
            dataclasses.asdict(getattr(ref, section))
    assert port.seed == ref.seed and port.engine == ref.engine
    assert ExperimentSpec.from_json(port.to_json()) == port
    assert ExperimentSpec.from_json(port.to_json()).config_digest() == port.config_digest()
    with pytest.raises(ValueError, match="unknown spec section"):
        ExperimentSpec.from_dict({"fault": {}})
    with pytest.raises(ValueError, match="unknown strategy"):
        TrainSpec(strategy="nope")
