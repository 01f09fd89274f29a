"""The port's training substrate against the reference, on the same numpy
inputs: Adam (`repro_torch.optim`), the batched MLP forward and its
cross-entropy, `local_train`, the evaluations and client prototypes.

Tolerances, with their reasons:
  * forward, loss, prototypes, Adam from given gradients: rtol 1e-5 /
    atol 1e-6 — float32 products summed in another order (MKL vs XLA);
  * `local_train`: atol 1e-5 on the trained params, a hundredth of
    lr = 1e-3 (measured: at most 9e-8 over five seeds).  Not float32
    rounding: Adam's first step is lr * g / (|g| + eps) with eps = 1e-8,
    so where a gradient entry is itself ~1e-8, float noise of that size in
    g moves the update by a sizeable fraction of lr; these inputs keep
    gradients well above that.  The losses agree to rtol 1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api.setup import make_mlp_bundle  # noqa: E402
from repro.core.baselines import _xent as jax_xent, make_bfln  # noqa: E402
from repro.core.fl import global_evaluate, local_train, masked_global_evaluate  # noqa: E402
from repro.core.prototypes import client_prototypes  # noqa: E402
from repro.models import classifier as jclf  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro_torch.core import fl as tfl  # noqa: E402
from repro_torch.core.baselines import ModelBundle, _xent, make_bfln as t_make_bfln  # noqa: E402
from repro_torch.core.prototypes import client_prototypes as t_client_prototypes  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

CFG = dict(in_dim=12, hidden=(10,), rep_dim=6, num_classes=4)
M, NB, B = 6, 2, 8
TRAIN_ATOL = 1e-5


def _params(seed=0, m=M):
    rng = np.random.default_rng(seed)
    shapes = tclf.param_shapes(tclf.MLPConfig(**CFG))
    return {k: (rng.standard_normal((m,) + s) * 0.4).astype(np.float32)
            for k, s in shapes.items()}


def _data(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, NB, B, CFG["in_dim"])).astype(np.float32)
    y = rng.integers(0, CFG["num_classes"], size=(M, NB, B)).astype(np.int32)
    return x, y


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _bundles():
    jcfg, jbundle = make_mlp_bundle(CFG["in_dim"], CFG["num_classes"],
                                    hidden=CFG["hidden"], rep_dim=CFG["rep_dim"])
    tcfg = tclf.MLPConfig(**CFG)
    tbundle = ModelBundle(functools.partial(tclf.apply_batched, tcfg),
                          functools.partial(tclf.embed_batched, tcfg),
                          CFG["num_classes"])
    return jcfg, jbundle, tcfg, tbundle


def test_batched_forward_and_loss_match_reference():
    jcfg, jbundle, tcfg, tbundle = _bundles()
    p = _params()
    x, y = _data()
    want = np.asarray(jax.vmap(jbundle.apply_fn)(_j(p), jnp.asarray(x[:, 0])))
    got = tclf.apply_batched(tcfg, _t(p), torch.from_numpy(x[:, 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # one batch shared by all models, as eval and prototypes use it
    shared = np.asarray(jclf.apply_stacked(jcfg, _j(p), jnp.asarray(x[0, 0])))
    np.testing.assert_allclose(
        tclf.apply_batched(tcfg, _t(p), torch.from_numpy(x[0, 0])).numpy(),
        shared, rtol=1e-5, atol=1e-6)
    losses = _xent(torch.from_numpy(got), torch.from_numpy(y[:, 0])).numpy()
    jl = np.array([float(jax_xent(jnp.asarray(want[i]), jnp.asarray(y[i, 0])))
                   for i in range(M)])
    np.testing.assert_allclose(losses, jl, rtol=1e-5)


def test_adam_updates_match_reference():
    rng = np.random.default_rng(2)
    p = _params(3)
    jopt, topt = jax_adam(1e-3), adam(1e-3)
    jp, tp = _j(p), _t(p)
    js, ts = jax.vmap(jopt.init)(jp), topt.init(tp)
    for _ in range(4):
        g = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
             for k, v in p.items()}
        jp, js = jax.vmap(jopt.update)(jp, _j(g), js)
        tp, ts = topt.update(tp, _t(g), ts)
    assert ts["step"] == 4 and ts["m"]["w0"].dtype == torch.float32
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]),
                                   rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("epochs", [1, 2])
def test_local_train_matches_reference(epochs):
    jcfg, jbundle, tcfg, tbundle = _bundles()
    p = _params(4)
    x, y = _data(5)
    probe = np.zeros((3, CFG["in_dim"]), np.float32)
    jstrat = make_bfln(jbundle, jnp.asarray(probe), 2)
    tstrat = t_make_bfln(tbundle, torch.from_numpy(probe), 2)
    jopt, topt = jax_adam(1e-3), adam(1e-3)
    jp = _j(p)
    jres = jax.jit(lambda pp: local_train(
        jstrat.local_loss, jopt, pp, jax.vmap(jopt.init)(pp), jnp.asarray(x),
        jnp.asarray(y), jnp.zeros((M,)), epochs))(jp)
    tp = _t(p)
    tres = tfl.local_train(tstrat.local_loss, topt, tp, topt.init(tp),
                           torch.from_numpy(x), torch.from_numpy(y),
                           torch.zeros(M), epochs)
    np.testing.assert_allclose(tres.mean_loss.numpy(), np.asarray(jres.mean_loss),
                               rtol=1e-5)
    assert tres.opt_state["step"] == epochs * NB
    for k in p:
        got, want = tres.params[k].numpy(), np.asarray(jres.params[k])
        np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_ATOL)
        assert not np.array_equal(got, p[k])          # it trained
        assert not tres.params[k].requires_grad


def test_evaluations_and_prototypes_match_reference():
    jcfg, jbundle, tcfg, tbundle = _bundles()
    p = _params(6)
    rng = np.random.default_rng(7)
    ex = rng.standard_normal((40, CFG["in_dim"])).astype(np.float32)
    ey = rng.integers(0, CFG["num_classes"], size=40)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    jacc, jaccs = masked_global_evaluate(jbundle.apply_fn, _j(p), jnp.asarray(ex),
                                         jnp.asarray(ey), jnp.asarray(mask))
    tacc, taccs = tfl.masked_global_evaluate(tbundle.apply_fn, _t(p),
                                             torch.from_numpy(ex),
                                             torch.from_numpy(ey),
                                             torch.from_numpy(mask))
    np.testing.assert_allclose(taccs.numpy(), np.asarray(jaccs), atol=1e-6)
    assert abs(float(tacc) - float(jacc)) < 1e-6
    g = tfl.global_evaluate(tbundle.apply_fn, _t(p), torch.from_numpy(ex),
                            torch.from_numpy(ey))
    assert abs(float(g) - float(global_evaluate(jbundle.apply_fn, _j(p),
                                                jnp.asarray(ex), jnp.asarray(ey)))) < 1e-6
    probe = ex[:5]
    np.testing.assert_allclose(
        t_client_prototypes(tbundle.embed_fn, _t(p), torch.from_numpy(probe)).numpy(),
        np.asarray(client_prototypes(jbundle.embed_fn, _j(p), jnp.asarray(probe))),
        rtol=1e-5, atol=1e-6)
