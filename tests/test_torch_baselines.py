"""The port's four Table II baselines (`repro_torch.core.baselines`) and the
strategy registry against the reference, on the same numpy inputs.

Tolerances, with their reasons:
  * `round_extras`: atol 1e-6 — class prototypes and soft predictions,
    values in [-1, 1], weighted by counts summed over the cohort in a plain
    sum (another order in each package);
  * `local_loss` and its gradients (`jax.value_and_grad` per client):
    atol 1e-5, float32 products summed in another order (MKL vs XLA);
  * one `local_train` with extras: atol 1e-5 on the params, as
    `tests/test_torch_fl.py` holds BFLN's (a hundredth of lr = 1e-3);
  * the flat strategies' combine: bit for bit against the numpy oracles
    `masked_tree_sum_ref` / `tree_sum_ref`, NaN in zero-weight rows
    included; within 1e-6 of the reference's `_tree_masked_mean`, whose
    jitted tree can be 1 ULP off its own oracle;
  * FedProto's combine: the trained rows exactly.

The CUDA test (`cuda` marker, skipped without a card) holds the
cluster-aggregation kernel at C = 1 with an arrival mask bit for bit
against its plain version at the engine's and the Table II shapes."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import registry as jreg  # noqa: E402
from repro.api.setup import make_mlp_bundle  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.core.fl import local_train as jax_local_train  # noqa: E402
from repro.kernels.ref import masked_tree_sum_ref, tree_sum_ref  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro_torch.api import registry as treg  # noqa: E402
from repro_torch.api.spec import TrainSpec  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import fl as tfl  # noqa: E402
from repro_torch.kernels import cluster_agg as ka  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402
from repro_torch.obs import NULL_RECORDER  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

CFG = dict(in_dim=12, hidden=(10,), rep_dim=6, num_classes=4)
M, NB, B = 6, 2, 8
BASELINES = ["fedavg", "fedprox", "fedproto", "fedhkd"]
MEAN_STRATEGIES = ["fedavg", "fedprox", "fedhkd"]
EXTRAS_ATOL = 1e-6
LOSS_ATOL = 1e-5
TRAIN_ATOL = 1e-5
# non-default hyper-parameters, so each one is seen to reach the loss
PARAMS = {"fedavg": {}, "fedprox": {"mu": 0.5}, "fedproto": {"lam": 0.7},
          "fedhkd": {"lam_rep": 0.3, "lam_soft": 0.4, "temp": 1.5}}


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


def _params(seed=0, m=M):
    rng = np.random.default_rng(seed)
    shapes = tclf.param_shapes(tclf.MLPConfig(**CFG))
    return {k: (rng.standard_normal((m,) + s) * 0.4).astype(np.float32)
            for k, s in shapes.items()}


def _data(seed=1):
    """Batches in which some clients miss some classes (counts of 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, NB, B, CFG["in_dim"])).astype(np.float32)
    y = rng.integers(0, CFG["num_classes"], size=(M, NB, B)).astype(np.int32)
    y[0] %= 2                       # client 0 sees classes 0 and 1 only
    return x, y


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: np.asarray(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [np.asarray(v) for v in tree]
    return np.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [torch.from_numpy(np.array(v)) for v in tree]
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree) if isinstance(tree, (tuple, list)) else [tree]


def _bundle():
    tcfg = tclf.MLPConfig(**CFG)
    return tb.ModelBundle(functools.partial(tclf.apply_batched, tcfg),
                          functools.partial(tclf.embed_batched, tcfg),
                          CFG["num_classes"])


def _strategies(name):
    _, jbundle = make_mlp_bundle(CFG["in_dim"], CFG["num_classes"],
                                 hidden=CFG["hidden"], rep_dim=CFG["rep_dim"])
    return (jb.STRATEGY_FACTORIES[name](jbundle, **PARAMS[name]),
            treg.build_strategy(name, _bundle(), **PARAMS[name]))


@pytest.mark.parametrize("name", BASELINES)
def test_round_extras_match_reference(name):
    js, ts = _strategies(name)
    p = _params(2)
    x, y = _data(3)
    want = _to_np(js.round_extras(_j(p), jnp.asarray(x), jnp.asarray(y)))
    got = ts.round_extras(_t(p), torch.from_numpy(x), torch.from_numpy(y).long())
    assert ts.shared_extras == js.shared_extras == (name == "fedprox")
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert not g.requires_grad and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=EXTRAS_ATOL)


@pytest.mark.parametrize("name", BASELINES)
def test_local_loss_and_gradients_match_reference(name):
    js, ts = _strategies(name)
    p = _params(4)
    x, y = _data(5)
    # one payload for both packages: the reference's, carried across
    extras = js.round_extras(_j(p), jnp.asarray(x), jnp.asarray(y))
    grad = jax.vmap(jax.value_and_grad(js.local_loss),
                    in_axes=(0, 0, 0, None if js.shared_extras else 0))
    jloss, jgrads = grad(_j(p), jnp.asarray(x[:, 0]), jnp.asarray(y[:, 0]), extras)
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tloss = ts.local_loss(tp, torch.from_numpy(x[:, 0]),
                          torch.from_numpy(y[:, 0]).long(), _to_torch(_to_np(extras)))
    tloss.sum().backward()
    assert tloss.shape == (M,)
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss),
                               rtol=0, atol=LOSS_ATOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrads[k]),
                                   rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("name", BASELINES)
def test_local_train_with_extras_matches_reference(name):
    js, ts = _strategies(name)
    p = _params(6)
    x, y = _data(7)
    jopt, topt = jax_adam(1e-3), adam(1e-3)

    @jax.jit
    def jtrain(pp, xx, yy):
        extras = js.round_extras(pp, xx, yy)
        return jax_local_train(js.local_loss, jopt, pp, jax.vmap(jopt.init)(pp),
                               xx, yy, extras, 1, shared_extras=js.shared_extras)
    jres = jtrain(_j(p), jnp.asarray(x), jnp.asarray(y))
    tp, tx, ty = _t(p), torch.from_numpy(x), torch.from_numpy(y).long()
    tres = tfl.local_train(ts.local_loss, topt, tp, topt.init(tp), tx, ty,
                           ts.round_extras(tp, tx, ty), 1,
                           shared_extras=ts.shared_extras)
    np.testing.assert_allclose(tres.mean_loss.numpy(), np.asarray(jres.mean_loss),
                               rtol=1e-5)
    for k in p:
        got = tres.params[k].numpy()
        np.testing.assert_allclose(got, np.asarray(jres.params[k]), rtol=0,
                                   atol=TRAIN_ATOL)
        assert not np.array_equal(got, p[k]) and not tres.params[k].requires_grad


def test_local_train_refuses_per_client_extras_without_the_client_axis():
    _, ts = _strategies("fedproto")
    p = _t(_params())
    x, y = _data()
    with pytest.raises(ValueError, match="client axis"):
        tfl.local_train(ts.local_loss, adam(1e-3), p, adam(1e-3).init(p),
                        torch.from_numpy(x), torch.from_numpy(y).long(),
                        torch.zeros(CFG["num_classes"], CFG["rep_dim"]), 1)


def _rows_and_mask(m, n, seed):
    """Rows with NaN (and -0.0) in the zero-weight slots, as a cohort's
    stragglers may hold."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((m, n)).astype(np.float32)
    w = (rng.random(m) < 0.7).astype(np.float32)
    w[0] = 1.0
    rows[w == 0] = np.nan
    if m > 2 and w[1] == 0:
        rows[1, ::2] = -0.0
    return rows, w


@pytest.mark.parametrize("name", MEAN_STRATEGIES)
@pytest.mark.parametrize("m,n", [(6, 33), (8, 17), (1, 5), (100, 65)])
def test_flat_combine_bit_exact_to_numpy_oracle(name, m, n):
    _, ts = _strategies(name)
    rows, w = _rows_and_mask(m, n, seed=m * n)
    out = ts.cohort_combine(torch.from_numpy(rows), None, torch.from_numpy(w), m,
                            NULL_RECORDER)
    want = masked_tree_sum_ref(rows, w) / np.maximum(tree_sum_ref(w), 1.0)
    assert out.rows.shape == (m, n) and np.isfinite(out.rows.numpy()).all()
    np.testing.assert_array_equal(out.rows.numpy().view(np.int32),
                                  np.broadcast_to(want, (m, n)).view(np.int32))
    # the single-cluster view
    assert torch.equal(out.labels, torch.zeros(m, dtype=torch.long))
    assert torch.equal(out.corr, torch.eye(m))
    # within 1e-6 of the reference's own jitted masked mean
    ref = jax.jit(jb._tree_masked_mean, static_argnums=2)(
        {"w": jnp.asarray(rows)}, jnp.asarray(w), m)["w"]
    np.testing.assert_allclose(out.rows.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_fedproto_combine_keeps_the_trained_rows():
    _, ts = _strategies("fedproto")
    rows, w = _rows_and_mask(6, 33, seed=1)
    t = torch.from_numpy(rows)
    out = ts.cohort_combine(t, None, torch.from_numpy(w), 6, NULL_RECORDER)
    assert out.rows is t
    assert torch.equal(out.labels, torch.zeros(6, dtype=torch.long))
    assert torch.equal(out.corr, torch.eye(6))


@pytest.mark.parametrize("name", BASELINES)
def test_aggregate_is_the_cohort_stage_with_every_slot_arrived(name):
    _, ts = _strategies(name)
    p = _t(_params(8))
    x, y = _data(9)
    agg = ts.aggregate(p, torch.from_numpy(x), torch.from_numpy(y).long())
    assert agg.labels is None and agg.cluster_sizes is None and agg.corr is None
    for k, v in p.items():
        want = v if name == "fedproto" else \
            torch.from_numpy(masked_tree_sum_ref(v.numpy(), np.ones(M, np.float32))
                             / np.float32(M)).expand_as(v)
        assert torch.equal(agg.stacked_params[k], want)


def test_registry_builds_every_reference_name():
    assert treg.strategy_names() == jreg.strategy_names()
    bundle = _bundle()
    probe = torch.zeros(3, CFG["in_dim"])
    for name in jreg.strategy_names():
        s = treg.build_strategy(name, bundle, probe=probe, n_clusters=2)
        assert s.name == name and s.aggregate_cohort is not None
        TrainSpec(strategy=name)
    with pytest.raises(ValueError, match="unknown strategy"):
        treg.build_strategy("fedsgd", bundle)


def test_mu_reaches_fedprox():
    p = _t(_params(10))
    x, y = _data(11)
    tx, ty = torch.from_numpy(x[:, 0]), torch.from_numpy(y[:, 0]).long()
    losses = {}
    for mu in (0.0, 0.5):
        s = treg.build_strategy("fedprox", _bundle(), mu=mu)
        anchor = {k: torch.zeros_like(v[0]) for k, v in p.items()}
        losses[mu] = s.local_loss(p, tx, ty, anchor)
    sq = sum(v.square().reshape(M, -1).sum(dim=1) for v in p.values())
    torch.testing.assert_close(losses[0.5] - losses[0.0], 0.25 * sq,
                               rtol=1e-5, atol=1e-5)


def test_spec_accepts_a_strategy_registered_by_a_user():
    with pytest.raises(ValueError, match="unknown strategy"):
        TrainSpec(strategy="mine")
    treg.register_strategy("mine", lambda bundle, **kw: tb.make_fedavg(bundle))
    try:
        assert TrainSpec(strategy="mine").strategy == "mine"
        assert treg.build_strategy("mine", _bundle()).name == "fedavg"
        with pytest.raises(ValueError, match="already registered"):
            treg.register_strategy("mine", lambda bundle, **kw: None)
    finally:
        treg._REGISTRY.pop("mine")


CUDA_SHAPES = [(100, 6570), (20, 17226), (20, 23076)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", CUDA_SHAPES)
def test_cuda_masked_mean_bit_exact_to_plain(m, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rows, w = _rows_and_mask(m, n, seed=m + n)
    rows, w = torch.from_numpy(rows).cuda(), torch.from_numpy(w).cuda()
    before = ka.launches
    got = tb.masked_mean_rows(rows, w)
    assert ka.launches == before + 1
    labels = torch.zeros(m, dtype=torch.long, device="cuda")
    wo, denom = ka.cluster_weights(labels, 1, w)
    want = ka.cluster_agg_plain(rows, labels, wo, denom)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isfinite(got).all()
