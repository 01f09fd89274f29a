"""The port's classifier (`repro_torch.models.classifier`) against the
reference, on parameters carried across as numpy arrays.

Tolerance: atol = rtol = 1e-5 on every forward — float32 throughout, with
the products summed in another order than XLA's (a fixed pairwise tree)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import classifier as jclf  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CFGS = [dict(in_dim=64, hidden=(64,), rep_dim=32, num_classes=10),
        dict(in_dim=12, hidden=(8, 6), rep_dim=5, num_classes=3)]


def _pair(cfg, n=None, seed=0):
    jcfg, tcfg = jclf.MLPConfig(**cfg), tclf.MLPConfig(**cfg)
    key = jax.random.PRNGKey(seed)
    jp = jclf.init_mlp(jcfg, key) if n is None else \
        jclf.init_stacked(jcfg, key, n, same_init=False)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _x(b, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)


@pytest.mark.parametrize("cfg", CFGS)
def test_param_shapes_match_reference_init(cfg):
    jp = jclf.init_mlp(jclf.MLPConfig(**cfg), jax.random.PRNGKey(0))
    assert tclf.param_shapes(tclf.MLPConfig(**cfg)) == \
        {k: tuple(v.shape) for k, v in jp.items()}
    tp = tclf.init_mlp(tclf.MLPConfig(**cfg), torch.Generator().manual_seed(0),
                       device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tp.items()} == \
        {k: (tuple(v.shape), torch.float32) for k, v in jp.items()}
    assert not any(tp[k].any() for k in tp if k.startswith("b"))


@pytest.mark.parametrize("cfg", CFGS)
def test_apply_and_embed_match_reference(cfg):
    jcfg, tcfg, jp, tp = _pair(cfg)
    x = _x(9, cfg["in_dim"])
    np.testing.assert_allclose(
        tclf.embed(tcfg, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jclf.embed(jcfg, jp, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        tclf.apply(tcfg, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jclf.apply(jcfg, jp, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("cfg", CFGS)
def test_stacked_forward_matches_reference(cfg):
    jcfg, tcfg, jp, tp = _pair(cfg, n=4)
    x = _x(7, cfg["in_dim"])
    np.testing.assert_allclose(
        tclf.embed_stacked(tcfg, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jclf.embed_stacked(jcfg, jp, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        tclf.apply_stacked(tcfg, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jclf.apply_stacked(jcfg, jp, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("batch", [1, 3, 8, 32])
def test_stacked_rows_bitwise_equal_single_model_rows(batch):
    _, tcfg, _, tp = _pair(CFGS[0], n=5)
    x = torch.from_numpy(_x(batch, 64, seed=batch))
    stacked = tclf.apply_stacked(tcfg, tp, x)
    for k in range(5):
        model = {n: v[k] for n, v in tp.items()}
        for i in range(batch):
            alone = tclf.apply(tcfg, model, x[i:i + 1])[0]
            assert torch.equal(alone.view(torch.int32),
                               stacked[k, i].view(torch.int32))


@pytest.mark.parametrize("i,j", [(64, 64), (33, 7), (1, 5), (6, 1)])
def test_matmul_fixed_order_matches_matmul(i, j):
    rng = np.random.default_rng(i * 100 + j)
    h = rng.standard_normal((3, 4, i)).astype(np.float32)
    w = rng.standard_normal((3, i, j)).astype(np.float32)
    got = tclf.matmul_fixed_order(torch.from_numpy(h), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), h @ w, **TOL)


def test_init_stacked_seeded_and_same_init():
    cfg = tclf.MLPConfig(**CFGS[1])
    a = tclf.init_stacked(cfg, torch.Generator().manual_seed(3), 4, device="cpu")
    b = tclf.init_stacked(cfg, torch.Generator().manual_seed(3), 4, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a[k][0], a[k][3]) for k in a)
    c = tclf.init_stacked(cfg, torch.Generator().manual_seed(3), 4,
                          same_init=False, device="cpu")
    assert not torch.equal(c["w0"][0], c["w0"][1])
