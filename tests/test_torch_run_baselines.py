"""`repro_torch.api.run` for each of the four Table II baselines against
`repro.api.run`, at `tests/test_torch_run.py`'s small size (n = 60, cohort
25%, 3 rounds, MLP hidden=(16,), rep_dim=8), both on the CPU, the port
starting from the reference's initial population (carried across with the
`params` setter).

Equal exactly: the event log, the number of blocks, `chain_valid` and
`ledger_conserved` (which hold on both).  The flat strategies report one
cluster and the identity affinity, so the rewards do not depend on the
trained bits: each round pays the same within 1e-6.  The producer (who
collects the round's fees) is not compared: with the identity affinity
every client is at the same distance from the centroid, and which float32
distance comes out least depends on each framework's summation order
(`ROADMAP.md` §3).  So the balances agree within 1e-6 for every client that
produced no block in either run, and the total supply agrees.  Final
accuracy within ACC_TOL = 0.01, as for BFLN.

Also one full-participation round per strategy through both of the port's
paths — the engine's `sync_step` with every slot arrived and the trainer's
`run_round` half (`round_extras` -> `local_train` -> `aggregate`) — which
run the same functions in the same order: equal params, loss and accuracy."""
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
    TrainSpec,
    build_manifest,
    build_strategy,
    load_packed_clients,
    make_mlp_bundle,
)
from repro_torch.core.engine import RoundEngine  # noqa: E402
from repro_torch.core.fl import global_evaluate  # noqa: E402
from repro_torch.core.round import FederatedTrainer  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.runtime.arena import ParamArena  # noqa: E402
from repro_torch.sim.driver import SimulatedFederation  # noqa: E402
from repro_torch.sim.population import ClientPopulation  # noqa: E402

ACC_TOL = 0.01
BALANCE_TOL = 1e-6
BASELINES = ["fedavg", "fedprox", "fedproto", "fedhkd"]
SMALL = dict(data=dict(n_clients=60),
             train=dict(sample_frac=0.25, rounds=3, hidden=(16,), rep_dim=8),
             eval=dict(every=2, clients=16, examples=256))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are small: one intra-op thread each.  Under the suite's
    parallel workers the default (one thread per core in every worker)
    oversubscribes the cores; the Table II smoke run took 1050 s instead of
    37 s with six such processes side by side on 8 cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=BASELINES)
def runs(request):
    name = request.param
    train = dict(SMALL["train"], strategy=name)
    rspec = ref_api.ExperimentSpec(data=ref_api.DataSpec(**SMALL["data"]),
                                   train=ref_api.TrainSpec(**train),
                                   eval=ref_api.EvalSpec(**SMALL["eval"]))
    tspec = ExperimentSpec(data=DataSpec(**SMALL["data"]),
                           train=TrainSpec(**train), eval=EvalSpec(**SMALL["eval"]))
    jsim = JSimulation(JPopulation.from_spec(rspec.population_spec()), rspec)
    init = {k: np.array(v) for k, v in jsim.params.items()}
    jrep = jsim.run()
    tsim = SimulatedFederation(
        ClientPopulation.from_spec(tspec.population_spec(), "cpu"), tspec,
        device="cpu")
    tsim.params = params_from_numpy(init, device="cpu")
    trep = tsim.run()
    return dict(name=name, jrep=jrep, jm=ref_api.build_manifest(rspec, jsim, jrep),
                trep=trep, tm=build_manifest(tspec, tsim, trep))


def test_baseline_run_matches_reference(runs):
    jm, tm = runs["jm"], runs["tm"]
    assert tm["strategy"] == jm["strategy"] == runs["name"]
    assert runs["trep"].event_log == runs["jrep"].event_log
    assert tm["event_log_digest"] == jm["event_log_digest"]
    assert tm["n_blocks"] == jm["n_blocks"] == 1 + sum(
        bool(r.arrived.any()) for r in runs["trep"].history)
    for m in (jm, tm):
        assert m["chain_valid"] and m["ledger_conserved"]
    tb, jb = runs["trep"].balances, runs["jrep"].balances
    producers = [r.producer for rep in (runs["trep"], runs["jrep"])
                 for r in rep.history if r.producer >= 0]
    others = np.setdiff1d(np.arange(tb.shape[0]), producers)
    np.testing.assert_allclose(tb[others], jb[others], rtol=0, atol=BALANCE_TOL)
    assert abs(tb.sum() - jb.sum()) <= BALANCE_TOL * tb.sum()
    t, j = tm["final_accuracy"], jm["final_accuracy"]
    assert 0.0 < t <= 1.0 and abs(t - j) <= ACC_TOL
    for a, b in zip(runs["jrep"].history, runs["trep"].history):
        assert abs(a.reward_paid - b.reward_paid) <= BALANCE_TOL
        assert a.verified_frac == b.verified_frac == 1.0
        assert abs(a.mean_loss - b.mean_loss) < 1e-3


@pytest.mark.parametrize("name", ["bfln"] + BASELINES)
def test_engine_round_equals_trainer_round(name):
    """One full-participation round from identical init, through the
    engine and through the trainer: the same functions in the same order,
    so the same params, loss and accuracy."""
    n = 6
    data = load_packed_clients("synth10", n, 0.3, n_batches=2, batch_size=8,
                               psi=8, device="cpu")
    cfg, bundle = make_mlp_bundle(data.in_dim, data.num_classes, hidden=(16,),
                                  rep_dim=8)
    strat = build_strategy(name, bundle, probe=data.probe, n_clusters=2)
    opt = adam(1e-3)
    sp = tclf.init_stacked(cfg, torch.Generator().manual_seed(0), n, device="cpu")

    tr = FederatedTrainer(bundle, strat, opt, local_epochs=2, n_clusters=2,
                          use_chain=False)
    p0, o0 = tr.init(sp)
    _, agg, _, tr_loss = tr._train_round(p0, o0, data.cx, data.cy)

    arena = ParamArena.from_stacked(sp)
    eng = RoundEngine(arena.layout, strategy=strat, opt=opt, n_clusters=2,
                      local_epochs=2, stacked_apply_fn=bundle.apply_fn)
    out = eng.sync_step(arena, torch.arange(n), data.cx, data.cy, torch.ones(n))
    engine_params = arena.layout.unflatten(out.new_rows)
    for k, v in agg.stacked_params.items():
        assert torch.equal(v, engine_params[k]), k
    assert float(out.mean_loss) == float(tr_loss)
    assert float(global_evaluate(bundle.apply_fn, agg.stacked_params, data.test_x,
                                 data.test_y)) == \
        float(global_evaluate(bundle.apply_fn, engine_params, data.test_x,
                              data.test_y))
    if name == "bfln":
        assert torch.equal(agg.labels, out.labels)
        assert int(agg.cluster_sizes.sum()) == n
    else:
        assert agg.labels is None
        assert torch.equal(out.labels, torch.zeros(n, dtype=torch.long))


def test_run_takes_strategy_params():
    base = ExperimentSpec(data=DataSpec(**SMALL["data"]),
                          train=TrainSpec(**dict(SMALL["train"], rounds=2,
                                                 strategy="fedprox")),
                          eval=EvalSpec(**SMALL["eval"]))
    spec = dataclasses.replace(base, train=dataclasses.replace(
        base.train, strategy_params={"mu": 5.0}))
    sims = [SimulatedFederation(
        ClientPopulation.from_spec(s.population_spec(), "cpu"), s, device="cpu")
        for s in (base, spec)]
    reps = [sim.run() for sim in sims]
    assert reps[0].event_log == reps[1].event_log
    # every client starts from one init, so round 0's anchor is each
    # client's own params and the prox term vanishes; round 1 mixes clients
    # that were averaged with clients that were not, and mu moves the loss
    assert reps[0].history[0].mean_loss == reps[1].history[0].mean_loss
    assert reps[0].history[1].mean_loss != reps[1].history[1].mean_loss
