"""The port's optimizers and schedules (`repro_torch.optim`) against the
reference's (`repro.optim`), on the same numpy inputs.

Tolerances, with their reasons:
  * `sgd`, `momentum` (with and without Nesterov), `adam`, `adamw`, with a
    float lr or a schedule, 5 steps over a nested dict of float32 and bf16
    leaves: equal, bit for bit (the same float32 ops in the same order);
  * the schedules: within 1 ulp, since `torch.cos` and `jnp.cos` may differ
    by one (equal on these steps);
  * `clip_by_global_norm`: within 4 float32 ulps (float32 leaves) and one
    bf16 ulp (bf16 leaves).  Not a transcendental: each leaf's sum of
    squares is a reduction that XLA and PyTorch take in other orders (2 ulps
    seen on these leaves), and the scale carries that into every leaf; the
    leaves are summed in the reference's order;
  * the FL `adam(lr)` over client-stacked leaves: equal, bit for bit."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as jopt  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
from repro_torch.interop import lm_params_from_numpy, opt_state_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

STEPS = 5
CLIP_ULPS_F32 = 4
CLIP_ULPS_BF16 = 1
SCHEDULE_ULPS = 1

OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd-cosine": lambda m: m.sgd(m.cosine_decay_schedule(0.1, 4)),
    "momentum": lambda m: m.momentum(0.05),
    "momentum-nesterov": lambda m: m.momentum(0.05, beta=0.8, nesterov=True),
    "adam": lambda m: m.adam(0.01),
    "adamw": lambda m: m.adamw(0.01, weight_decay=0.1),
    "adamw-warmup-cosine": lambda m: m.adamw(m.warmup_cosine_schedule(3e-3, 2, 5)),
}


def _tree(seed):
    """A nested dict (and list) of float32 and bf16 leaves."""
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                  "z": rng.standard_normal((4,)).astype(ml_dtypes.bfloat16)},
            "a": [rng.standard_normal((2, 3)).astype(np.float32),
                  rng.standard_normal((6,)).astype(ml_dtypes.bfloat16)]}


def _ulps(got: torch.Tensor, want) -> int:
    """The largest distance in units in the last place, in got's dtype."""
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        x = got.view(torch.int16).numpy().astype(np.int64)
        y = want.view(np.int16).astype(np.int64)
    else:
        x = got.numpy().view(np.int32).astype(np.int64)
        y = want.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(x - y).max())


def _max_ulps(tgot, jwant) -> int:
    got, want = tree_leaves(tgot), jax.tree.leaves(jwant)
    assert [tuple(t.shape) for t in got] == [tuple(np.shape(w)) for w in want]
    return max(_ulps(t, w) for t, w in zip(got, want))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_bit_for_bit(name):
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = lm_params_from_numpy(_tree(0), "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for s in range(STEPS):
        g = _tree(10 + s)
        jp, js = jo.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = to.update(tp, lm_params_from_numpy(g, "cpu"), ts)
        assert _max_ulps(tp, jp) == 0, f"step {s}"
    assert ts["step"] == int(js["step"]) == STEPS
    for key in ("m", "v", "mu"):
        if key in js:
            assert _max_ulps(ts[key], js[key]) == 0


def test_optimizer_state_carries_across_mid_training():
    """`opt_state_from_numpy` takes the reference's mid-training AdamW state:
    both packages continue from it to the same parameters."""
    jo, to = jopt.adamw(0.01), topt.adamw(0.01)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    js = jo.init(jp)
    for s in range(3):
        jp, js = jo.update(jp, jax.tree.map(jnp.asarray, _tree(10 + s)), js)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts["step"] == 3 and set(ts) == {"step", "m", "v"}
    g = _tree(20)
    jp, js = jo.update(jp, jax.tree.map(jnp.asarray, g), js)
    tp, ts = to.update(tp, lm_params_from_numpy(g, "cpu"), ts)
    assert _max_ulps(tp, jp) == 0 and _max_ulps(ts["v"], js["v"]) == 0


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3)
    want = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    got = topt.clip_by_global_norm(lm_params_from_numpy(g, "cpu"), max_norm)
    for t, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        limit = CLIP_ULPS_BF16 if t.dtype == torch.bfloat16 else CLIP_ULPS_F32
        assert _ulps(t, w) <= limit
    if max_norm > 1e2:      # the norm is below max_norm: every leaf as it was
        for t, x in zip(tree_leaves(got), jax.tree.leaves(g)):
            assert _ulps(t, x) == 0


SCHEDULES = {
    "constant": (lambda m: m.constant_schedule(3e-3), 8),
    "cosine": (lambda m: m.cosine_decay_schedule(3e-3, 7, alpha=0.1), 7),
    "warmup-cosine": (lambda m: m.warmup_cosine_schedule(3e-3, 3, 17), 17),
    "warmup-cosine-launcher": (lambda m: m.warmup_cosine_schedule(3e-3, 20 // 10 + 1, 20), 20),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    make, decay = SCHEDULES[name]
    js, ts = make(jopt), make(topt)
    for step in range(2 * decay + 1):
        got = ts(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert _ulps(got.reshape(1), np.asarray(js(jnp.asarray(step, jnp.int32))).reshape(1)) \
            <= SCHEDULE_ULPS, step


def test_fl_adam_over_client_stacked_leaves_bit_for_bit():
    """The FL layer's `adam(lr)` (a float lr, leaves with a leading client
    axis, the step shared by the cohort) is the reference's, bit for bit."""
    rng = np.random.default_rng(7)
    params = {"w1": rng.standard_normal((6, 12, 10)).astype(np.float32),
              "b1": rng.standard_normal((6, 10)).astype(np.float32)}
    jo, to = jopt.adam(1e-3), topt.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js = jax.vmap(jo.init)(jp)
    ts = to.init(tp)
    for s in range(STEPS):
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** -s).astype(np.float32)
             for k, v in params.items()}
        jp, js = jax.vmap(jo.update)(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = to.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in params:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
            np.testing.assert_array_equal(ts["m"][k].numpy(), np.asarray(js["m"][k]))
