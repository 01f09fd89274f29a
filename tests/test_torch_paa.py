"""The public functions of the port's otherwise ported core modules against
the reference, on the same numpy inputs, on the CPU:

  * `core/aggregation.py`: `cluster_sizes` exactly; `cluster_mean_rows` and
    `cluster_mean_params` (`mix`, `two_step`) within 1e-6, `two_step_bf16`
    within bf16 tolerance (three roundings to bf16 of values below 4:
    2^-8 relative each, so 4e-2 absolute); `paa_round` on well-separated
    clients: labels and cluster sizes equal, Pearson matrix within 1e-5,
    prototypes and new params within 1e-6;
  * `core/prototypes.py::prototype` within 1e-6;
  * `core/incentives.py::apply_round_settlement` within 1e-6, the total
    supply conserved up to the fees an unverified producer burns;
  * `core/round.py::FederatedTrainer.fit`: a 2-round fit at 8 clients gives
    the params of 2 `run_round` calls, and its log lines have the
    reference's format;
  * `api/spec.py::ExperimentSpec.from_flat` equal to the reference's for a
    change in every section, `config_digest` included;
    `api/runner.py::format_manifest` the same text for equal manifests;
  * `runtime/arena.py::ArenaLayout.flatten_u32` and
    `kernels/fingerprint.py::stack_flatten_u32` bit for bit (as uint32
    patterns), with equal fingerprint digests.

The engine and FedBuff keep the fixed-tree-order kernel path
(`kernels.cluster_agg.cluster_mean_rows`): their rows are unchanged bit for
bit by the reference-semantics `core.aggregation.cluster_mean_rows`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import incentives as jinc  # noqa: E402
from repro.core import prototypes as jproto  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.kernels import fingerprint as jfp  # noqa: E402
from repro.models import classifier as jclf  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro.runtime.arena import ArenaLayout as JLayout  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import incentives as tinc  # noqa: E402
from repro_torch.core import prototypes as tproto  # noqa: E402
from repro_torch.core.round import FederatedTrainer  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import cluster_agg as kca  # noqa: E402
from repro_torch.kernels import fingerprint as tfp  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402
from repro_torch.obs import NULL_RECORDER  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.runtime.arena import ArenaLayout as TLayout  # noqa: E402
from repro_torch.sim import async_agg as tasync  # noqa: E402

ATOL = 1e-6
CORR_ATOL = 1e-5
BF16_ATOL = 4e-2


def _params(m, seed, shapes=(("b0", (5,)), ("w0", (3, 5)), ("w_head", (5, 2)))):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((m,) + s).astype(np.float32) for k, s in shapes}


def _labels_weights(m, c, seed, weighted):
    rng = np.random.default_rng(seed + 100)
    labels = rng.integers(0, c, m).astype(np.int32)
    w = (rng.random(m) * (rng.random(m) < 0.7)).astype(np.float32) if weighted else None
    return labels, w


def _t(x, dtype=None):
    return None if x is None else torch.from_numpy(np.asarray(x, dtype=dtype))


@pytest.mark.parametrize("m,c", [(1, 1), (7, 3), (12, 5), (20, 4)])
def test_cluster_sizes_exact(m, c):
    labels, _ = _labels_weights(m, c, m, False)
    got = tagg.cluster_sizes(_t(labels), c)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jagg.cluster_sizes(labels, c)))


@pytest.mark.parametrize("method", ["mix", "two_step", "two_step_bf16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m,c", [(9, 3), (16, 5)])
def test_cluster_mean_params_matches_reference(method, weighted, m, c):
    p = _params(m, seed=m + c)
    labels, w = _labels_weights(m, c, m, weighted)
    want = jagg.cluster_mean_params({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(labels), c,
                                    None if w is None else jnp.asarray(w), method=method)
    got = tagg.cluster_mean_params(params_from_numpy(p, device="cpu"), _t(labels), c,
                                   _t(w), method=method)
    tol = BF16_ATOL if method == "two_step_bf16" else ATOL
    assert sorted(got) == sorted(want)
    for k in p:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=tol)


def test_cluster_mean_params_refuses_an_unknown_method():
    with pytest.raises(ValueError):
        tagg.cluster_mean_params(params_from_numpy(_params(3, 0), device="cpu"),
                                 torch.zeros(3, dtype=torch.long), 1, method="median")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m,n,c", [(12, 40, 3), (30, 131, 5)])
def test_cluster_mean_rows_matches_reference(weighted, m, n, c):
    rows = np.random.default_rng(n).standard_normal((m, n)).astype(np.float32)
    labels, w = _labels_weights(m, c, n, weighted)
    want = jagg.cluster_mean_rows(jnp.asarray(rows), jnp.asarray(labels), c,
                                  None if w is None else jnp.asarray(w))
    got = tagg.cluster_mean_rows(_t(rows), _t(labels), c, _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_the_engine_and_fedbuff_keep_the_kernel_path():
    assert tbase.cluster_mean_rows is kca.cluster_mean_rows
    assert tasync.cluster_mean_rows is kca.cluster_mean_rows
    assert tagg.cluster_mean_rows is not kca.cluster_mean_rows
    rng = np.random.default_rng(5)
    m, n, c = 20, 131, 4
    rows = _t(rng.standard_normal((m, n)), np.float32)
    protos = _t(rng.standard_normal((m, 8)), np.float32)
    arrived = _t(rng.random(m) < 0.8, np.float32)
    bfln = tbase.make_bfln(None, None, n_clusters=c)
    out = bfln.cohort_combine(rows, protos, arrived, m, NULL_RECORDER)
    assert torch.equal(out.rows, kca.cluster_mean_rows(rows, out.labels, c, arrived))
    w = _t(rng.random(m), np.float32)
    assert torch.equal(tasync.weighted_delta_mean(rows, w),
                       kca.cluster_mean_rows(rows, torch.zeros(m, dtype=torch.long),
                                             1, w)[0])


def _separated(m, c, seed):
    """m MLP clients around c distinct models (hidden=(16,), rep_dim=8)."""
    cfg = jclf.MLPConfig(in_dim=6, hidden=(16,), rep_dim=8, num_classes=3)
    centers = jclf.init_stacked(cfg, jax.random.PRNGKey(seed), c, same_init=False)
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v)[np.arange(m) % c]
                  + 0.002 * rng.standard_normal((m,) + v.shape[1:])).astype(np.float32)
              for k, v in centers.items()}
    probe = rng.standard_normal((16, 6)).astype(np.float32)
    tcfg = tclf.MLPConfig(in_dim=6, hidden=(16,), rep_dim=8, num_classes=3)
    return cfg, tcfg, params, probe


@pytest.mark.parametrize("m,c,method,weighted", [(12, 3, "two_step", False),
                                                 (15, 5, "two_step", True),
                                                 (10, 2, "mix", True)])
def test_paa_round_matches_reference(m, c, method, weighted):
    cfg, tcfg, params, probe = _separated(m, c, seed=m)
    _, w = _labels_weights(m, c, m, weighted)
    want = jagg.paa_round(functools.partial(jclf.embed, cfg),
                          {k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(probe), c,
                          None if w is None else jnp.asarray(w), agg_method=method)
    got = tagg.paa_round(functools.partial(tclf.embed_stacked, tcfg),
                         params_from_numpy(params, device="cpu"), _t(probe), c, _t(w),
                         agg_method=method)
    assert isinstance(got, tagg.PAAResult)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert len(set(got.labels.tolist())) == c
    np.testing.assert_array_equal(got.cluster_sizes.numpy(), np.asarray(want.cluster_sizes))
    np.testing.assert_allclose(got.corr.numpy(), np.asarray(want.corr), rtol=0,
                               atol=CORR_ATOL)
    np.testing.assert_allclose(got.prototypes.numpy(), np.asarray(want.prototypes),
                               rtol=0, atol=ATOL)
    for k in params:
        np.testing.assert_allclose(got.new_stacked_params[k].numpy(),
                                   np.asarray(want.new_stacked_params[k]), rtol=0,
                                   atol=ATOL)


def test_paa_round_runs_the_pearson_kernels_wrapper(monkeypatch):
    from repro_torch.kernels import pearson as kpe
    calls = []
    real = kpe.pearson_rows
    monkeypatch.setattr("repro_torch.core.pearson.pearson_rows",
                        lambda x: calls.append(x.shape) or real(x))
    _, tcfg, params, probe = _separated(6, 2, seed=1)
    tagg.paa_round(functools.partial(tclf.embed_stacked, tcfg),
                   params_from_numpy(params, device="cpu"), _t(probe), 2)
    assert calls == [(6, 8)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prototype_matches_reference(seed):
    cfg, tcfg, params, probe = _separated(3, 3, seed)
    one = {k: v[seed] for k, v in params.items()}
    want = jproto.prototype(functools.partial(jclf.embed, cfg),
                            {k: jnp.asarray(v) for k, v in one.items()}, jnp.asarray(probe))
    got = tproto.prototype(functools.partial(tclf.embed, tcfg),
                           params_from_numpy(one, device="cpu"), _t(probe))
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    stacked = tproto.client_prototypes(functools.partial(tclf.embed_stacked, tcfg),
                                       params_from_numpy(params, device="cpu"), _t(probe))
    np.testing.assert_allclose(stacked[seed].numpy(), got.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("producer_verified", [True, False])
@pytest.mark.parametrize("m,c,seed", [(8, 3, 0), (20, 5, 1)])
def test_apply_round_settlement_matches_reference(producer_verified, m, c, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, m).astype(np.int32)
    verified = rng.random(m) < 0.75
    producer = int(rng.integers(m))
    verified[producer] = producer_verified
    balances = (5.0 + rng.random(m)).astype(np.float32)
    jalloc = jinc.allocate_rewards(jnp.asarray(labels), c, 20.0, 2.0)
    talloc = tinc.allocate_rewards(_t(labels), c, 20.0, 2.0)
    want = jinc.apply_round_settlement(jnp.asarray(balances), jalloc, producer,
                                       jnp.asarray(verified))
    before = _t(balances)
    got = tinc.apply_round_settlement(before, talloc, producer, _t(verified))
    assert torch.equal(before, _t(balances))              # the input is not touched
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    credit = float((talloc.client_reward * _t(verified, np.float32)).sum())
    fees = float(talloc.fee) * int(verified.sum())
    burned = 0.0 if producer_verified else fees
    assert float(got.sum()) == pytest.approx(balances.sum() + credit - burned, abs=1e-4)


def _trainer_pair(name, n_clients=8):
    jd = japi.load_packed_clients("synth10", n_clients, 0.3, n_batches=2, batch_size=16,
                                  psi=8)
    td = tapi.load_packed_clients("synth10", n_clients, 0.3, n_batches=2, batch_size=16,
                                  psi=8, device="cpu")
    jcfg, jbundle = japi.make_mlp_bundle(jd.in_dim, jd.num_classes, hidden=(16,),
                                         rep_dim=8)
    _, tbundle = tapi.make_mlp_bundle(td.in_dim, td.num_classes, hidden=(16,), rep_dim=8)
    sp = jclf.init_stacked(jcfg, jax.random.PRNGKey(0), n_clients)
    kw = dict(local_epochs=2, n_clusters=3 if name == "bfln" else 0,
              use_chain=name == "bfln")
    return (jd, JTrainer(jbundle, name, jax_adam(1e-3), probe=jd.probe, **kw), sp,
            td, lambda: FederatedTrainer(tbundle, name, adam(1e-3), probe=td.probe, **kw))


@pytest.mark.parametrize("name", ["bfln", "fedavg"])
def test_fit_equals_run_round_and_logs_like_the_reference(name):
    jd, jt, sp, td, make = _trainer_pair(name)
    init = {k: np.array(v) for k, v in sp.items()}
    lines, jlines = [], []
    fitted = make().fit(params_from_numpy(init, device="cpu"), td.cx, td.cy,
                        td.test_x, td.test_y, rounds=2, log_every=1, log_fn=lines.append)
    tt = make()
    p, o = tt.init(params_from_numpy(init, device="cpu"))
    for r in range(2):
        p, o, _ = tt.run_round(r, p, o, td.cx, td.cy, td.test_x, td.test_y)
    assert sorted(fitted) == sorted(p)
    for k in p:
        assert torch.equal(fitted[k], p[k])
    jt.fit(sp, jd.cx, jd.cy, jd.test_x, jd.test_y, rounds=2, log_every=1,
           log_fn=jlines.append)
    assert len(lines) == len(jlines) == 2
    for got, want in zip(lines, jlines):
        g, w = got.split(), want.split()
        assert [x.split("=")[0] for x in g] == [x.split("=")[0] for x in w]
        assert g[:3] == w[:3]                             # "[name] round   r"
        assert abs(float(g[3][5:]) - float(w[3][5:])) <= 1e-4          # loss=
        assert abs(float(g[4][4:]) - float(w[4][4:])) <= 0.01          # acc=


FLAT_CHANGES = [
    {},
    dict(rounds=3, sample_frac=0.2, n_clusters=4, local_epochs=2, lr=1e-2,
         deadline=10.0, sampler="stake_weighted", mode="async", hidden=[8, 8], rep_dim=4,
         strategy="fedprox", strategy_params={"mu": 0.1}),
    dict(buffer_size=4, staleness_alpha=1.0, server_lr=0.5, concurrency=9),
    dict(eval_every=0, eval_clients=7, eval_examples=11),
    dict(total_reward=3.0, rho=1.5, initial_stake=2.0),
    dict(mesh_shards=2, mesh_cohort="replicated"),
    dict(engine=False, seed=9),
]


@pytest.mark.parametrize("flat", FLAT_CHANGES)
@pytest.mark.parametrize("with_data", [False, True])
def test_from_flat_equals_reference(flat, with_data):
    jdata = japi.DataSpec(n_clients=60) if with_data else None
    tdata = tapi.DataSpec(n_clients=60) if with_data else None
    want = japi.ExperimentSpec.from_flat(jdata, **flat)
    got = tapi.ExperimentSpec.from_flat(tdata, **flat)
    assert got.to_json() == want.to_json()
    assert got.config_digest() == want.config_digest()


def test_from_flat_refuses_an_unknown_knob():
    with pytest.raises(TypeError):
        tapi.ExperimentSpec.from_flat(roundz=3)


def test_format_manifest_equals_reference():
    from repro.api.runner import format_manifest as jformat
    res = tapi.run(tapi.ExperimentSpec(data=tapi.DataSpec(n_clients=40),
                                       train=tapi.TrainSpec(rounds=1, hidden=(8,),
                                                            rep_dim=4)),
                   device="cpu")
    assert tapi.format_manifest(res.manifest) == jformat(dict(res.manifest))
    assert tapi.format_manifest(res.manifest).splitlines()[0].startswith(
        "  config_digest: ")


@pytest.mark.parametrize("shapes", [
    (("b0", (5,)), ("w0", (3, 5)), ("w_head", (5, 2))),
    (("a", (7,)), ("z", (2, 2, 2))),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_flatten_u32_bit_for_bit(shapes, dtype):
    p = _params(4, seed=len(shapes), shapes=shapes)
    if dtype == "int32":
        p = {k: (v * 1000).astype(np.int32) for k, v in p.items()}
    jp = {k: jnp.asarray(v, dtype=dtype) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.asarray(v, dtype=np.float32 if dtype == "bfloat16"
                                         else v.dtype)) for k, v in p.items()}
    if dtype == "bfloat16":
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    want = np.asarray(JLayout.from_stacked(jp).flatten_u32(jp))
    got = TLayout.from_stacked(tp).flatten_u32(tp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tfp.stack_flatten_u32(tp).numpy().view(np.uint32),
                                  np.asarray(jfp.stack_flatten_u32(jp)))


def test_stack_flatten_u32_digests_equal_reference():
    p = _params(6, seed=11)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = params_from_numpy(p, device="cpu")
    bits = tfp.stack_flatten_u32(tp)
    n = bits.shape[1]
    got = [tfp.format_digest(r, n) for r in tfp.residues_numpy(tfp.fingerprint_rows(bits))]
    assert got == jfp.cohort_digests(jp, use_pallas=False)
    assert got == tfp.cohort_digests(tp)
