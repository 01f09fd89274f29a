"""The port's arena (`repro_torch.runtime.arena`) against the reference:
layout paths, shapes, offsets, tree order and column order, and the bits
of `flatten`, equal JAX's exactly on the MLP params and on nested dicts
whose keystr order differs from a plain sort of key names."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import classifier as jclf  # noqa: E402
from repro.runtime.arena import ArenaLayout as JaxLayout  # noqa: E402
from repro.runtime.arena import ParamArena as JaxArena  # noqa: E402
from repro.runtime.arena import bitcast_u32 as jax_bitcast_u32  # noqa: E402
from repro_torch.interop import arena_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.runtime.arena import (  # noqa: E402
    ArenaLayout,
    ParamArena,
    bitcast_u32,
    keystr,
)


def _mlp_params():
    cfg = jclf.MLPConfig(in_dim=12, hidden=(8, 6), rep_dim=5, num_classes=3)
    p = jclf.init_stacked(cfg, jax.random.PRNGKey(0), 3, same_init=False)
    return jax.tree.map(np.asarray, p)


def _nested_params():
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal((3,) + s).astype(np.float32)  # noqa: E731
    # "['a b']" < "['a']['c']" although "a" < "a b": keystr order is not the
    # nested sort of key names
    return {"a": {"c": f(2, 2), "b": f(4)}, "a b": f(3), "B": f(1, 2),
            "z": {"y": {"x": f(5)}}, "a_b": f(2)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("make", [_mlp_params, _nested_params])
def test_layout_equals_reference(make):
    p = make()
    jl = JaxLayout.from_stacked(_jax(p))
    tl = ArenaLayout.from_stacked(params_from_numpy(p, device="cpu"))
    assert tl.paths == jl.paths
    assert tl.shapes == jl.shapes
    assert tl.sizes == jl.sizes
    assert tl.offsets == jl.offsets
    assert tl.order == jl.order
    assert tl.n_params == jl.n_params
    paths_with_keys = [p for p, _ in
                       jax.tree_util.tree_flatten_with_path(_jax(p))[0]]
    assert sorted(keystr(k) for k in tl.keys) == \
        sorted(jax.tree_util.keystr(k) for k in paths_with_keys)


@pytest.mark.parametrize("make", [_mlp_params, _nested_params])
def test_flatten_bits_equal_reference(make):
    p = make()
    jl = JaxLayout.from_stacked(_jax(p))
    want = np.asarray(jax_bitcast_u32(jl.flatten(_jax(p))))
    tp = params_from_numpy(p, device="cpu")
    tl = ArenaLayout.from_stacked(tp)
    flat = tl.flatten(tp)
    np.testing.assert_array_equal(bitcast_u32(flat).numpy().view(np.uint32), want)
    # unflatten is the exact inverse, and keeps the dict structure
    back = tl.unflatten(flat)
    for k, leaf in _leaves(tp):
        assert torch.equal(_get(back, k), leaf)
    assert list(back) == sorted(tp)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_bitcast_is_a_view():
    rows = torch.randn(3, 10)
    bits = bitcast_u32(rows)
    assert bits.dtype == torch.int32 and bits.data_ptr() == rows.data_ptr()
    np.testing.assert_array_equal(bits.numpy(), rows.numpy().view(np.int32))


def test_flatten_refuses_inexact_dtypes():
    lay = ArenaLayout.from_stacked({"w": torch.zeros(2, 3)})
    with pytest.raises(TypeError, match="float64"):
        lay.flatten({"w": torch.zeros(2, 3, dtype=torch.float64)})
    with pytest.raises(TypeError, match="int32"):
        lay.flatten({"w": torch.zeros(2, 3, dtype=torch.int32)})
    half = torch.randn(2, 3).to(torch.bfloat16)
    assert torch.equal(lay.flatten({"w": half}), half.float())


def test_param_arena_and_carried_rows_equal_reference():
    p = _mlp_params()
    ja = JaxArena.from_stacked(_jax(p))
    ta = ParamArena.from_stacked(params_from_numpy(p, device="cpu"))
    assert (ta.n_clients, ta.n_params) == (ja.n_clients, ja.n_params)
    rows = np.asarray(ja.data)
    np.testing.assert_array_equal(ta.data.numpy(), rows)
    carried = arena_from_numpy(rows, zip(ja.layout.paths, ja.layout.shapes),
                               device="cpu")
    assert carried.layout.paths == ja.layout.paths
    assert torch.equal(carried.data, ta.data)
    tree = carried.layout.unflatten(carried.data)
    np.testing.assert_array_equal(tree["w1"].numpy(), p["w1"])
    with pytest.raises(ValueError, match="canonical"):
        arena_from_numpy(rows, reversed(list(zip(ja.layout.paths,
                                                 ja.layout.shapes))),
                         device="cpu")
