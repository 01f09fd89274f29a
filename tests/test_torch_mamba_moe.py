"""The port's MoE FFN (`repro_torch.models.moe`) and Mamba mixer
(`repro_torch.models.mamba`) against the reference's (`repro.models.moe`,
`repro.models.mamba`) on the same numpy inputs and weights, on the CPU in
float32.

MoE: `moe_capacity` equal over a grid of token counts, top-k, expert
counts and capacity factors; `router_topk` gates within 1e-6 and routes
equal wherever the top-k margin exceeds 1e-5 (float32 softmax sums in
another order); `load_balance_loss` within 1e-6 relative; `moe_apply`
with a gated and a plain activation, with and without a shared expert, at
the automatic capacity and at `capacity=4`, where most choices are
dropped: y and aux within 1e-5 of max |y|.  Mamba: `mamba_apply` and 8
chained `mamba_decode` steps from a non-zero state, each step's output
and the final conv and ssm states within 1e-5 of max |y| and max |h|;
the gradients of `mamba_apply` (every parameter and the input; on the CPU
autograd takes the scan's plain backward through `SelectiveScanFn`)
against `jax.grad` of the reference's within 1e-5 of max(1, max |g|).
The scan itself is held against a float64 oracle and on the card in
`tests/test_torch_selective_scan.py`; the three configurations that use
these modules run end to end in `tests/test_torch_lm.py` and
`tests/test_torch_lm_train.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import mamba as jmb  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from repro_torch.models import mamba as tmb  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

RTOL = 1e-5            # of max |y| (and max |h| for the Mamba state)
GATE_ATOL = 1e-6
ROUTE_MARGIN = 1e-5
D_MODEL, D_FF, N_EXPERTS = 32, 48, 4
D_INNER, D_STATE, D_CONV, DT_RANK = 64, 16, 4, 8


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, scale, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} * {scale}"


@pytest.mark.parametrize("top_k,n_experts", [(1, 128), (2, 16), (2, 8), (2, 4), (1, 4)])
def test_moe_capacity_matches_reference(top_k, n_experts):
    for tokens in (1, 2, 31, 32, 40, 64, 1000, 8192, 100_000):
        for cf in (1.0, 1.25, 2.0):
            for multiple in (1, 8, 128):
                want = jmoe.moe_capacity(tokens, top_k, n_experts, cf, multiple)
                assert tmoe.moe_capacity(tokens, top_k, n_experts, cf, multiple) == want


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_router_topk_and_load_balance_match_reference(top_k):
    logits = np.random.default_rng(top_k).standard_normal((200, 8)).astype(np.float32) * 3
    jg, ji = jmoe.router_topk(jnp.asarray(logits), top_k)
    tg, ti = tmoe.router_topk(_t(logits), top_k)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=GATE_ATOL)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    kth = np.sort(probs, axis=-1)[:, ::-1]
    clear = (kth[:, :top_k] - kth[:, 1:top_k + 1]).min(axis=-1) > ROUTE_MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    want = float(jmoe.load_balance_loss(jnp.asarray(logits), ji, 8))
    got = float(tmoe.load_balance_loss(_t(logits), torch.from_numpy(np.array(ji)).long(), 8))
    assert abs(got - want) <= 1e-6 * abs(want)


def _moe_params(act, shared, seed):
    """A parameter tree in the reference's `moe_init` layout, from numpy."""
    g = np.random.default_rng(seed)

    def w(*shape):
        return (g.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    p = {"router": w(D_MODEL, N_EXPERTS), "w_gate": w(N_EXPERTS, D_MODEL, D_FF),
         "w_down": w(N_EXPERTS, D_FF, D_MODEL)}
    if act in ("swiglu", "geglu"):
        p["w_up"] = w(N_EXPERTS, D_MODEL, D_FF)
    if shared:
        p["shared"] = {"w_gate": w(D_MODEL, D_FF), "w_down": w(D_FF, D_MODEL)}
        if act in ("swiglu", "geglu"):
            p["shared"]["w_up"] = w(D_MODEL, D_FF)
    return p


@pytest.mark.parametrize("capacity", ["auto", 4])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_apply_matches_reference(act, shared, capacity):
    p = _moe_params(act, shared, seed=len(act) + shared)
    x = np.random.default_rng(3).standard_normal((2, 24, D_MODEL)).astype(np.float32)
    top_k = 2
    cap = (jmoe.moe_capacity(48, top_k, N_EXPERTS) if capacity == "auto" else capacity)
    jy, jaux = jmoe.moe_apply(act, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              top_k=top_k, capacity=cap)
    with torch.no_grad():
        ty, taux = tmoe.moe_apply(act, lm_params_from_numpy(p, "cpu"), _t(x),
                                  top_k=top_k, capacity=cap)
    scale = float(np.abs(np.asarray(jy)).max())
    _close(ty.numpy(), jy, scale, "y")
    _close(float(taux), float(jaux), scale, "aux")
    if capacity == 4:       # 96 choices for 16 slots: most are dropped
        routed = np.asarray(jmoe.router_topk(jnp.asarray(x.reshape(-1, D_MODEL)) @ p["router"],
                                             top_k)[1])
        assert np.bincount(routed.ravel(), minlength=N_EXPERTS).max() > 2 * cap


@pytest.fixture(scope="module")
def mamba_pair():
    """(reference params, carried params) of one Mamba block."""
    jp = jmb.mamba_init(jax.random.PRNGKey(4), D_MODEL, D_INNER, D_STATE, D_CONV,
                        DT_RANK, jnp.float32)
    # a non-zero conv bias and dt spread around its init, as training leaves them
    g = np.random.default_rng(4)
    jp = dict(jp, conv_b=jnp.asarray(0.1 * g.standard_normal(D_INNER), jnp.float32),
              dt_bias=jnp.asarray(-4.6 + g.standard_normal(D_INNER), jnp.float32))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_mamba_apply_matches_reference(mamba_pair):
    jp, tp = mamba_pair
    x = np.random.default_rng(5).standard_normal((2, 40, D_MODEL)).astype(np.float32)
    kw = dict(d_state=D_STATE, d_conv=D_CONV, dt_rank=DT_RANK)
    want = np.asarray(jax.jit(lambda p, x: jmb.mamba_apply(p, x, **kw))(jp, jnp.asarray(x)))
    before = tss.launches
    with torch.no_grad():
        got = tmb.mamba_apply(tp, _t(x), **kw).numpy()
    assert tss.launches == before            # CPU tensors: the plain scan
    _close(got, want, float(np.abs(want).max()), "mamba_apply")


def test_mamba_apply_gradients_match_reference(mamba_pair):
    """d/d(params, x) of sum(mamba_apply(p, x) * w) for a random w: the
    port's autograd (the scan's plain backward, no launch) against
    ``jax.grad`` of the reference's ``lax.scan``."""
    jp, tp = mamba_pair
    g = np.random.default_rng(7)
    x = g.standard_normal((2, 40, D_MODEL)).astype(np.float32)
    w = g.standard_normal((2, 40, D_MODEL)).astype(np.float32)
    kw = dict(d_state=D_STATE, d_conv=D_CONV, dt_rank=DT_RANK)

    def jloss(p, x):
        return jnp.sum(jmb.mamba_apply(p, x, **kw) * jnp.asarray(w))
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    tx = _t(x).requires_grad_(True)
    before = (tss.launches, tss.launches_bwd)
    (tmb.mamba_apply(leaves, tx, **kw) * _t(w)).sum().backward()
    assert (tss.launches, tss.launches_bwd) == before
    assert sorted(leaves) == sorted(jgp)
    for name, got, want in [(k, leaves[k].grad, jgp[k]) for k in sorted(leaves)] + \
            [("x", tx.grad, jgx)]:
        want = np.asarray(want, np.float64)
        _close(got.numpy(), want, max(1.0, float(np.abs(want).max())), f"d{name}")


def test_mamba_decode_steps_match_reference(mamba_pair):
    """8 chained single-token steps from a non-zero (conv, ssm) state."""
    jp, tp = mamba_pair
    g = np.random.default_rng(6)
    conv = g.standard_normal((2, D_CONV - 1, D_INNER)).astype(np.float32)
    ssm = g.standard_normal((2, D_INNER, D_STATE)).astype(np.float32)
    xs = g.standard_normal((8, 2, 1, D_MODEL)).astype(np.float32)
    kw = dict(d_state=D_STATE, d_conv=D_CONV, dt_rank=DT_RANK)
    jstep = jax.jit(lambda p, x, s: jmb.mamba_decode(p, x, s, **kw))
    jstate = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    tstate = {"conv": _t(conv), "ssm": _t(ssm)}
    for x in xs:
        jy, jstate = jstep(jp, jnp.asarray(x), jstate)
        with torch.no_grad():
            ty, tstate = tmb.mamba_decode(tp, _t(x), tstate, **kw)
        _close(ty.numpy(), jy, float(np.abs(np.asarray(jy)).max()), "decode y")
    for name in ("conv", "ssm"):
        want = np.asarray(jstate[name])
        _close(tstate[name].numpy(), want, float(np.abs(want).max()), f"state {name}")
    fresh = tmb.mamba_init_state(2, D_INNER, D_STATE, D_CONV, torch.float32, "cpu")
    want = jmb.mamba_init_state(2, D_INNER, D_STATE, D_CONV, jnp.float32)
    for name in ("conv", "ssm"):
        assert tuple(fresh[name].shape) == want[name].shape
        assert str(fresh[name].dtype) == f"torch.{want[name].dtype}"
