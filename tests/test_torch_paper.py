"""The paper's full-participation protocol on the port against the
reference: `load_packed_clients`, `FederatedTrainer.init` / `run_round` for
BFLN and the four baselines, and the Table II / Fig 2 drivers
(`repro_torch.paper`), on the CPU.

`run_round`: 2 rounds at 8 clients (MLP hidden=(16,), rep_dim=8), both
packages from the reference's initial params (carried across with
`interop.params_from_numpy`: JAX's PRNG cannot be reproduced in torch).
Tolerances: params at atol 1e-5 (float32 training noise, measured 1.8e-7),
each round's loss at atol 1e-5 (measured 2.4e-7), accuracy on the shared
test set within ACC_TOL = 0.01 (measured equal).  BFLN's rewards must be
equal in every round whose labels agree; its producer is not compared,
since CACC's centroid distances come from each package's Pearson matrix,
which differ in the last bits, and a near-tie may pick another
representative (measured: round 1 at this size).  The port's `aggregate`
sums in the engine's tree order where the reference takes `jnp.mean` /
`tensordot`: the same means within float tolerance, not in every bit."""
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.models import classifier as jclf  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.core.fl import evaluate  # noqa: E402
from repro_torch.core.round import FederatedTrainer  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.paper import common, fig2_rewards, table2_accuracy  # noqa: E402

N_CLIENTS, ROUNDS = 8, 2
PARAMS_ATOL = 1e-5
LOSS_ATOL = 1e-5
ACC_TOL = 0.01
STRATEGIES = ["bfln", "fedavg", "fedprox", "fedproto", "fedhkd"]


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


def _load(**kw):
    args = dict(n_batches=2, batch_size=16, psi=8)
    args.update(kw)
    return (japi.load_packed_clients("synth10", N_CLIENTS, 0.3, **args),
            tapi.load_packed_clients("synth10", N_CLIENTS, 0.3, device="cpu", **args))


@pytest.mark.parametrize("kw", [{}, dict(seed=3, probe_category=2, n_batches=1)])
def test_load_packed_clients_equals_reference(kw):
    jd, td = _load(**kw)
    for name in ("cx", "cy", "test_x", "test_y", "probe"):
        got = getattr(td, name)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jd, name)))
    assert td.cy.dtype == td.test_y.dtype == torch.int64
    for name in ("tx", "ty"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    assert (td.num_classes, td.in_dim) == (jd.num_classes, jd.in_dim)


@pytest.mark.parametrize("name", STRATEGIES)
def test_run_round_matches_reference(name):
    jd, td = _load()
    jcfg, jbundle = japi.make_mlp_bundle(jd.in_dim, jd.num_classes, hidden=(16,),
                                         rep_dim=8)
    _, tbundle = tapi.make_mlp_bundle(td.in_dim, td.num_classes, hidden=(16,),
                                      rep_dim=8)
    sp = jclf.init_stacked(jcfg, jax.random.PRNGKey(0), N_CLIENTS)
    n_clusters = 3 if name == "bfln" else 0
    kw = dict(local_epochs=2, n_clusters=n_clusters, use_chain=name == "bfln")
    jt = JTrainer(jbundle, name, jax_adam(1e-3), probe=jd.probe, **kw)
    tt = FederatedTrainer(tbundle, name, adam(1e-3), probe=td.probe, **kw)
    jp, jo = jt.init(sp)
    tp, to = tt.init(params_from_numpy({k: np.array(v) for k, v in sp.items()},
                                       device="cpu"))
    agreed = 0
    for r in range(ROUNDS):
        jp, jo, jr = jt.run_round(r, jp, jo, jd.cx, jd.cy, jd.test_x, jd.test_y)
        tp, to, tr = tt.run_round(r, tp, to, td.cx, td.cy, td.test_x, td.test_y)
        for k, v in tp.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=PARAMS_ATOL)
        assert abs(tr.mean_loss - jr.mean_loss) <= LOSS_ATOL
        assert abs(tr.accuracy - jr.accuracy) <= ACC_TOL
        if name != "bfln":
            assert tr.labels is None and tr.rewards is None and tr.producer == -1
            continue
        assert tr.cluster_sizes.sum() == N_CLIENTS and tr.verified_frac == 1.0
        np.testing.assert_array_equal(tr.cluster_sizes,
                                      np.bincount(tr.labels, minlength=n_clusters))
        if np.array_equal(tr.labels, jr.labels):
            agreed += 1
            np.testing.assert_array_equal(tr.rewards, jr.rewards)
    assert len(tt.history) == ROUNDS
    if name == "bfln":
        assert agreed >= 1, "labels differ in every round"
        assert tt.chain.validate() and tt.ledger.conserved()
        assert len(tt.chain.blocks) == 1 + ROUNDS
    else:
        assert tt.ledger is None and len(tt.chain.blocks) == 1


def test_run_round_chain_refuses_a_tampered_commit():
    _, td = _load()
    cfg, bundle = tapi.make_mlp_bundle(td.in_dim, td.num_classes, hidden=(16,),
                                       rep_dim=8)
    sp = tclf.init_stacked(cfg, torch.Generator().manual_seed(1), N_CLIENTS,
                           device="cpu")
    tt = FederatedTrainer(bundle, "bfln", adam(1e-3), local_epochs=1,
                          n_clusters=2, probe=td.probe)
    p, o = tt.init(sp)
    fake = {k: torch.zeros_like(v[0]) for k, v in sp.items()}
    p, o, rec = tt.run_round(0, p, o, td.cx, td.cy, td.test_x, td.test_y,
                             tamper={3: fake})
    assert rec.rewards[3] == 0.0 and rec.verified_frac == (N_CLIENTS - 1) / N_CLIENTS
    assert rec.balances[3] == tt.initial_stake
    assert tt.chain.validate() and tt.ledger.conserved()


def test_run_fl_returns_trainer_and_personalised_accuracy():
    tr, pacc = common.run_fl("synth10", 0.3, "fedavg", n_clients=4, rounds=1,
                             n_batches=1, batch_size=8, device="cpu")
    assert 0.0 <= pacc <= 1.0 and len(tr.history) == 1
    tr, _ = common.run_fl("synth10", 0.3, "bfln", n_clients=4, rounds=2,
                          n_batches=1, batch_size=8, n_clusters=2, device="cpu")
    assert tr.chain.validate() and len(tr.chain.blocks) == 3
    # the metric is each client's model on its own local split
    data = tapi.load_packed_clients("synth10", 3, 0.3, n_batches=1,
                                    batch_size=8, device="cpu")
    cfg, bundle = tapi.make_mlp_bundle(data.in_dim, data.num_classes)
    sp = tclf.init_stacked(cfg, torch.Generator().manual_seed(0), 3, device="cpu")
    accs = evaluate(bundle.apply_fn, sp, torch.from_numpy(data.tx),
                    torch.from_numpy(data.ty))
    logits = bundle.apply_fn(sp, torch.from_numpy(data.tx))
    want = (logits.argmax(-1) == torch.from_numpy(data.ty)).float().mean(1)
    assert torch.equal(accs, want) and accs.shape == (3,)


def test_table2_and_fig2_drivers_smoke_run(tmp_path):
    t2 = table2_accuracy.main(rounds=1, out_path=str(tmp_path / "t2.json"),
                              device="cpu")
    assert len(t2) == 2 * 3 * len(table2_accuracy.STRATEGIES)
    assert all(0.0 <= a <= 1.0 for a in t2.values())
    assert (tmp_path / "t2.json").exists()
    f2 = fig2_rewards.main(rounds=1, out_path=str(tmp_path / "f2.json"),
                           device="cpu")
    assert set(f2) == {"clusters-2", "clusters-7"}
    for run in f2.values():
        assert run["chain_valid"] and run["ledger_conserved"]
        assert len(run["cumulative_rewards"]) == 20
    assert (tmp_path / "f2.json").exists()
    # the default output is the git-ignored chiprun_out/, never experiments/
    assert common.OUT_DIR == Path(__file__).resolve().parents[1] / "chiprun_out"


def test_paper_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.load_packed_clients("synth10", 4, 0.3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.run_fl("synth10", 0.3, "fedavg", rounds=1)
