"""`repro_torch.utils.tree` against `repro.utils.tree` on the same numpy
trees: exact where the reference is elementwise (add, scale, cast, stack,
unstack, zeros_like, flatten_vector, the vmapped map, the NaN flag, size
and bytes), within 1e-6 where it reduces (`tree_dot`,
`tree_weighted_mean`).  Every walk visits dict keys in sorted order, as
`jax.tree` does, so leaf order — and the order of a reduction over the
leaves — is the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.utils import tree as jt  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.utils import tree as tt  # noqa: E402

ATOL = 1e-6
# keys deliberately out of sorted order, and a nested dict
SHAPES = {"w_head": (4, 3), "b0": (5,), "w0": (3, 5), "inner": {"z": (2,), "a": (2, 2)}}


def _tree(seed, lead=(), shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: _tree(seed + 1, lead, v) if isinstance(v, dict)
            else rng.standard_normal(lead + v).astype(np.float32)
            for k, v in shapes.items()}


def _j(t):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in t.items()}


def _p(t):
    return params_from_numpy(t, device="cpu")


def _leaves_np(tree_j) -> list[np.ndarray]:
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(tree_j)]


def _same(got, want, atol=0.0):
    g = [x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
         for x in tt.tree_leaves(got)]
    w = [np.asarray(x, dtype=np.float32) if x.dtype == jnp.bfloat16 else x
         for x in _leaves_np(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        if atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(a, b)


ELEMENTWISE = {
    "add": (lambda a, b: tt.tree_add(a, b), lambda a, b: jt.tree_add(a, b)),
    "sub": (lambda a, b: tt.tree_sub(a, b), lambda a, b: jt.tree_sub(a, b)),
    "scale": (lambda a, b: tt.tree_scale(a, 0.37), lambda a, b: jt.tree_scale(a, 0.37)),
    "zeros_like": (lambda a, b: tt.tree_zeros_like(a), lambda a, b: jt.tree_zeros_like(a)),
    "cast_bf16": (lambda a, b: tt.tree_cast(a, torch.bfloat16),
                  lambda a, b: jt.tree_cast(a, jnp.bfloat16)),
    "index": (lambda a, b: tt.tree_index(a, 2), lambda a, b: jt.tree_index(a, 2)),
    "map_stacked": (lambda a, b: tt.tree_map_stacked(lambda t: tt.tree_scale(t, 2.0), a),
                    lambda a, b: jt.tree_map_stacked(lambda t: jt.tree_scale(t, 2.0), a)),
}


@pytest.mark.parametrize("op", sorted(ELEMENTWISE))
@pytest.mark.parametrize("seed", [0, 1])
def test_elementwise_ops_exact(op, seed):
    port, ref = ELEMENTWISE[op]
    a, b = _tree(seed, (4,)), _tree(seed + 10, (4,))
    _same(port(_p(a), _p(b)), ref(_j(a), _j(b)))


@pytest.mark.parametrize("n", [1, 3])
def test_stack_and_unstack_exact(n):
    trees = [_tree(s) for s in range(n)]
    stacked = tt.tree_stack([_p(t) for t in trees])
    _same(stacked, jt.tree_stack([_j(t) for t in trees]))
    back = tt.tree_unstack(stacked, n)
    for got, want in zip(back, jt.tree_unstack(jt.tree_stack([_j(t) for t in trees]), n)):
        _same(got, want)


@pytest.mark.parametrize("reduce", ["size", "bytes", "flatten_vector", "any_nan",
                                    "any_nan_with_nan"])
def test_whole_tree_readouts_exact(reduce):
    a = _tree(3, (2,))
    if reduce == "any_nan_with_nan":
        a["inner"]["a"][1, 0, 1] = np.nan
        reduce = "any_nan"
    got = getattr(tt, f"tree_{reduce}")(_p(a))
    want = getattr(jt, f"tree_{reduce}")(_j(a))
    if isinstance(want, int):
        assert got == want
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flatten_vector_casts_like_the_reference(dtype):
    a = _tree(4)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = tt.tree_flatten_vector(_p(a), dtype=dtype)
    want = jt.tree_flatten_vector(_j(a), dtype=jdt)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_dot_within_tolerance(seed):
    a, b = _tree(seed, (3,)), _tree(seed + 5, (3,))
    got = tt.tree_dot(_p(a), _p(b))
    want = jt.tree_dot(_j(a), _j(b))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ATOL * 10)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0, 1.0], [0.5, 0.0, 2.0, 1.5],
                                     [3.0, 1.0, 0.0, 0.0]])
def test_tree_weighted_mean_within_tolerance(weights):
    a = _tree(7, (4,))
    w = np.asarray(weights, np.float32)
    got = tt.tree_weighted_mean(_p(a), torch.from_numpy(w))
    want = jt.tree_weighted_mean(_j(a), jnp.asarray(w))
    _same(got, want, atol=ATOL)


def test_leaves_walk_in_the_references_order():
    a = _tree(9, (2,))
    got = [x.numpy() for x in tt.tree_leaves(_p(a))]
    want = _leaves_np(_j(a))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
