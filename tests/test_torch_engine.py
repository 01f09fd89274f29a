"""The port's round engine and the chain side of a round against the
reference, on the same numpy inputs.

* `RoundEngine.sync_step` vs the JAX engine's, one BFLN round over a cohort
  whose models form well-separated clusters: labels equal, the Pearson
  matrix at atol 1e-5 (the reference's Pearson tolerance), the new rows at
  atol 1e-5 (float32 training noise, ~1e-7 measured, carried through the
  cluster means), the loss at rtol 1e-5; the arena is updated in place and
  only where a cohort slot arrived.
* The evaluation entries at atol 1e-6.
* `ParamArena` gather / masked scatter / rebind / views, bit for bit.
* CACC, rewards and `chain_round`: given the same labels, Pearson matrix
  and digests, the same representatives, producer, verification, rewards,
  ledger balances and block hashes as the reference — exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api.setup import make_mlp_bundle  # noqa: E402
from repro.blockchain import TokenLedger as JLedger  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.core.baselines import make_bfln  # noqa: E402
from repro.core.consensus import select_centroid_clients as jax_select  # noqa: E402
from repro.core.engine import RoundEngine as JEngine  # noqa: E402
from repro.core.incentives import allocate_rewards as jax_allocate  # noqa: E402
from repro.models import classifier as jclf  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro.runtime.arena import ParamArena as JArena  # noqa: E402
from repro_torch.api.setup import make_mlp_bundle as t_make_mlp_bundle  # noqa: E402
from repro_torch.blockchain import TokenLedger  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core.baselines import ModelBundle, make_bfln as t_make_bfln  # noqa: E402
from repro_torch.core.engine import RoundEngine  # noqa: E402
from repro_torch.core.incentives import allocate_rewards  # noqa: E402
from repro_torch.core.round import FederatedTrainer  # noqa: E402
from repro_torch.kernels import fingerprint as tfp  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.runtime.arena import ParamArena  # noqa: E402

CFG = dict(in_dim=12, hidden=(10,), rep_dim=6, num_classes=4)
N, K, C = 24, 16, 4


def _population(seed=0):
    """N clients whose params are C distinct models plus small noise, so
    the clusters stay well separated after one local step."""
    rng = np.random.default_rng(seed)
    shapes = tclf.param_shapes(tclf.MLPConfig(**CFG))
    which = np.arange(N) % C
    out = {}
    for k, s in shapes.items():
        centers = rng.standard_normal((C,) + s) * 0.6
        out[k] = (centers[which] + 0.01 * rng.standard_normal((N,) + s)
                  ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def round_pair():
    rng = np.random.default_rng(1)
    params = _population()
    cohort = np.sort(rng.choice(N, size=K, replace=False))
    cx = rng.standard_normal((K, 1, 8, CFG["in_dim"])).astype(np.float32)
    cy = rng.integers(0, CFG["num_classes"], size=(K, 1, 8)).astype(np.int32)
    arrived = (rng.random(K) < 0.75).astype(np.float32)
    probe = rng.standard_normal((5, CFG["in_dim"])).astype(np.float32)

    jcfg, jbundle = make_mlp_bundle(CFG["in_dim"], CFG["num_classes"],
                                    hidden=CFG["hidden"], rep_dim=CFG["rep_dim"])
    jarena = JArena.from_stacked({k: jnp.asarray(v) for k, v in params.items()})
    jeng = JEngine(jarena.layout, apply_fn=jbundle.apply_fn,
                   strategy=make_bfln(jbundle, jnp.asarray(probe), C),
                   opt=jax_adam(1e-3), n_clusters=C, local_epochs=1,
                   stacked_apply_fn=functools.partial(jclf.apply_stacked, jcfg))
    jdata, jout = jeng.sync_step(jarena.data, jnp.asarray(cohort), jnp.asarray(cx),
                                 jnp.asarray(cy), jnp.asarray(arrived))

    tcfg = tclf.MLPConfig(**CFG)
    tbundle = ModelBundle(functools.partial(tclf.apply_batched, tcfg),
                          functools.partial(tclf.embed_batched, tcfg),
                          CFG["num_classes"])
    tarena = ParamArena.from_stacked({k: torch.from_numpy(v) for k, v in params.items()})
    before = tarena.data.clone()
    teng = RoundEngine(tarena.layout,
                       strategy=t_make_bfln(tbundle, torch.from_numpy(probe), C),
                       opt=adam(1e-3), n_clusters=C, local_epochs=1,
                       stacked_apply_fn=tbundle.apply_fn)
    tout = teng.sync_step(tarena, torch.from_numpy(cohort), torch.from_numpy(cx),
                          torch.from_numpy(cy), torch.from_numpy(arrived))
    return dict(cohort=cohort, arrived=arrived, jeng=jeng, jdata=jdata, jout=jout,
                teng=teng, tarena=tarena, tout=tout, before=before)


def test_sync_step_matches_reference(round_pair):
    j, t = round_pair["jout"], round_pair["tout"]
    labels = t.labels.numpy()
    np.testing.assert_array_equal(labels, np.asarray(j.labels))
    assert len(set(labels.tolist())) == C
    np.testing.assert_allclose(t.corr.numpy(), np.asarray(j.corr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.new_rows.numpy(), np.asarray(j.new_rows), rtol=0,
                               atol=1e-5)
    assert abs(float(t.mean_loss) - float(j.mean_loss)) <= 1e-5 * abs(float(j.mean_loss))
    np.testing.assert_allclose(round_pair["tarena"].data.numpy(),
                               np.asarray(round_pair["jdata"]), rtol=0, atol=1e-5)


def test_sync_step_scatters_in_place_where_arrived(round_pair):
    cohort, arrived = round_pair["cohort"], round_pair["arrived"]
    data, before = round_pair["tarena"].data, round_pair["before"]
    untouched = np.setdiff1d(np.arange(N), cohort[arrived > 0])
    assert torch.equal(data[untouched], before[untouched])
    assert torch.equal(data[cohort], round_pair["tout"].new_rows)
    assert not torch.equal(data[cohort[arrived > 0]], before[cohort[arrived > 0]])


def test_residues_are_the_trained_rows_fingerprints(round_pair):
    t = round_pair["tout"]
    assert t.residues.shape == (K, 2) and t.residues.dtype == torch.int32
    digests = round_pair["teng"].format_digests(t.residues)
    assert len(digests) == K and all(len(d) == 24 for d in digests)
    assert digests == [tfp.format_digest(r, round_pair["tarena"].n_params)
                       for r in tfp.residues_numpy(t.residues)]


def test_eval_entries_match_reference(round_pair):
    rng = np.random.default_rng(2)
    ex = rng.standard_normal((50, CFG["in_dim"])).astype(np.float32)
    ey = rng.integers(0, CFG["num_classes"], size=50)
    rows = np.array(round_pair["jout"].new_rows)
    labels = np.array(round_pair["jout"].labels)
    arrived = round_pair["arrived"]
    jacc, jcacc = round_pair["jeng"].eval_cohort(
        jnp.asarray(rows), jnp.asarray(arrived), jnp.asarray(labels),
        jnp.asarray(ex), jnp.asarray(ey))
    tacc, tcacc = round_pair["teng"].eval_cohort(
        torch.from_numpy(rows), torch.from_numpy(arrived), torch.from_numpy(labels),
        torch.from_numpy(ex), torch.from_numpy(ey))
    assert abs(float(tacc) - float(jacc)) < 1e-6
    np.testing.assert_allclose(tcacc.numpy(), np.asarray(jcacc), atol=1e-6)
    data = np.array(round_pair["jdata"])
    ids = np.array([0, 5, 9, 23])
    jpop = round_pair["jeng"].eval_population(jnp.asarray(data), jnp.asarray(ids),
                                              jnp.asarray(ex), jnp.asarray(ey))
    tpop = round_pair["teng"].eval_population(torch.from_numpy(data),
                                              torch.from_numpy(ids),
                                              torch.from_numpy(ex),
                                              torch.from_numpy(ey))
    assert abs(float(tpop) - float(jpop)) < 1e-6


def test_arena_methods_match_reference():
    params = _population(3)
    jarena = JArena.from_stacked({k: jnp.asarray(v) for k, v in params.items()})
    tarena = ParamArena.from_stacked({k: torch.from_numpy(v) for k, v in params.items()})
    cohort = np.array([3, 7, 11, 20])
    np.testing.assert_array_equal(tarena.gather(cohort).numpy(),
                                  np.asarray(jarena.gather(cohort)))
    rows = np.random.default_rng(4).standard_normal(
        (4, tarena.n_params)).astype(np.float32)
    mask = np.array([True, False, True, False])
    ptr = tarena.data.data_ptr()
    written = tarena.masked_scatter(cohort, mask, torch.from_numpy(rows))
    jarena.masked_scatter(cohort, mask, jnp.asarray(rows))
    assert tarena.data.data_ptr() == ptr               # updated in place
    np.testing.assert_array_equal(tarena.data.numpy(), np.asarray(jarena.data))
    assert torch.equal(written, tarena.data[cohort])
    for k, v in tarena.row_pytree(7).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jarena.row_pytree(7)[k]))
    doubled = tarena.data * 2
    tarena.rebind(doubled)
    jarena.rebind(jnp.asarray(doubled.numpy()))
    for k, v in tarena.as_pytree().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jarena.as_pytree()[k]))


def test_consensus_and_rewards_match_reference():
    rng = np.random.default_rng(5)
    for m, c in [(16, 4), (9, 5), (1, 3)]:
        corr = np.clip(rng.standard_normal((m, m)), -1, 1).astype(np.float32)
        labels = rng.integers(0, c, size=m)
        part = rng.random(m) < 0.7
        js = jax_select(jnp.asarray(corr), jnp.asarray(labels), c)
        ts = tcons.select_centroid_clients(torch.from_numpy(corr),
                                           torch.from_numpy(labels), c)
        np.testing.assert_array_equal(ts.representatives.numpy(),
                                      np.asarray(js.representatives))
        np.testing.assert_allclose(ts.distances.numpy(), np.asarray(js.distances),
                                   rtol=1e-6, atol=1e-6)
        ja = jax_allocate(jnp.asarray(labels), c, 20.0, 2.0,
                          participating=jnp.asarray(part))
        ta = allocate_rewards(torch.from_numpy(labels), c, 20.0, 2.0,
                              participating=torch.from_numpy(part))
        np.testing.assert_array_equal(ta.client_reward.numpy(),
                                      np.asarray(ja.client_reward))
        assert float(ta.fee) == float(ja.fee)
    assert tcons.packing_queue(torch.tensor([2, -1, 0])) == [2, 0]
    assert tcons.producer_for_round([4, 9, 1], 3, active={1, 4}) == 4
    assert tcons.producer_for_round([4, 9, 1], 4, active={1, 4}) == 1


def test_chain_round_matches_reference_given_the_same_inputs():
    rng = np.random.default_rng(6)
    n, k, c = 30, 10, 3
    jbundle = make_mlp_bundle(4, 2, hidden=(3,), rep_dim=2)[1]
    jt = JTrainer(jbundle, "fedavg", jax_adam(1e-3), n_clusters=c)
    jt.ledger = JLedger(n, 5.0)
    tbundle = t_make_mlp_bundle(4, 2, hidden=(3,), rep_dim=2)[1]
    tt = FederatedTrainer(tbundle, "fedavg", adam(1e-3), n_clusters=c)
    tt.ledger = TokenLedger(n, 5.0)
    for r in range(4):
        cohort = np.sort(rng.choice(n, size=k, replace=False))
        arrived = rng.random(k) < 0.8
        labels = rng.integers(0, c, size=k)
        corr = np.clip(rng.standard_normal((k, k)), -1, 1).astype(np.float32)
        digests = [f"{rng.integers(0, 2**32):08x}" * 2 + "00000010"
                   for _ in range(k)]
        tamper = {int(cohort[0]): "0" * 24} if arrived[0] else {}
        jr = jt.chain_round(r, None, jnp.asarray(labels), jnp.asarray(corr),
                            cohort=cohort, arrived=arrived, tamper=tamper,
                            digests=digests)
        tr = tt.chain_round(r, None, torch.from_numpy(labels), torch.from_numpy(corr),
                            cohort=cohort, arrived=arrived, digests=digests,
                            tamper=tamper)
        assert tr.producer == jr.producer
        np.testing.assert_array_equal(tr.verified, jr.verified)
        np.testing.assert_array_equal(tr.rewards, jr.rewards)
        np.testing.assert_array_equal(tt.ledger.balances, jt.ledger.balances)
    assert [b.block_hash() for b in tt.chain.blocks] == \
        [b.block_hash() for b in jt.chain.blocks]
    assert tt.chain.validate() and tt.ledger.conserved()
