"""The port's cluster-masked FedAvg (`repro_torch.kernels.cluster_agg`,
`repro_torch.core.aggregation`) against the reference.

Bit for bit: the plain PyTorch version equals the numpy oracle
`repro.kernels.ref.tree_cluster_mean_ref` (the fixed-order tree the round
engine sums in), including NaN rows at zero weight, rows of -0.0, empty
clusters, all-zero weights and cohorts that are not a power of two; so do
the tree primitives against `tree_sum_ref` / `masked_tree_sum_ref`.

Allclose: against the Pallas kernel `cluster_agg_pallas(rows,
mixing_matrix(labels, C, w), interpret=True)` at atol 1e-5 — the same
function as a mixing-matrix product, summed in another order.

The CUDA kernel is held bit for bit against the plain version on the card
(`cuda` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.aggregation import (  # noqa: E402
    tree_cluster_mean_params as jax_tree_cluster_mean_params,
)
from repro.kernels.cluster_agg import cluster_agg_pallas, mixing_matrix  # noqa: E402
from repro.kernels.ref import (  # noqa: E402
    masked_tree_sum_ref,
    tree_cluster_mean_ref,
    tree_sum_ref,
)
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.kernels import cluster_agg as ka  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ATOL = 1e-5


def _case(m, n, c, seed=0, p_arrive=0.8):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((m, n)).astype(np.float32)
    labels = rng.integers(0, c, size=m)
    w = (rng.random(m) < p_arrive).astype(np.float32)
    return rows, labels, w


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _plain(rows, labels, c, w):
    t = [torch.from_numpy(np.asarray(a)) for a in (rows, labels, w)]
    return ka.cluster_mean_rows(t[0], t[1], c, t[2]).numpy()


CASES = {
    "main-path": (100, 6570, 5),
    "one-row": (1, 10, 3),
    "three-rows": (3, 7, 2),
    "ragged": (37, 131, 4),
    "power-of-two": (64, 33, 5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_bit_exact_to_tree_oracle(case):
    m, n, c = CASES[case]
    rows, labels, w = _case(m, n, c, seed=m + n)
    want = tree_cluster_mean_ref(rows, labels, c, weights=w)
    np.testing.assert_array_equal(_bits(_plain(rows, labels, c, w)), _bits(want))


def _edge(kind):
    rows, labels, w = _case(12, 40, 4, seed=7)
    if kind == "nan-at-zero-weight":
        w[[2, 5]] = 0.0
        rows[2] = np.nan
        rows[5, ::3] = np.inf
    elif kind == "negative-zero-row":
        labels[:] = np.arange(12) % 4
        w[:] = 1.0
        rows[0] = -0.0                  # alone at weight 1 in cluster 0
        w[[4, 8]] = 0.0
    elif kind == "empty-cluster":
        labels = np.where(labels == 3, 0, labels)
    elif kind == "all-zero-weights":
        w[:] = 0.0
    return rows, labels, w


@pytest.mark.parametrize("kind", ["nan-at-zero-weight", "negative-zero-row",
                                  "empty-cluster", "all-zero-weights"])
def test_plain_edge_cases_bit_exact(kind):
    rows, labels, w = _edge(kind)
    got = _plain(rows, labels, 4, w)
    with np.errstate(invalid="ignore"):          # the oracle's 0 * inf, discarded
        want = tree_cluster_mean_ref(rows, labels, 4, w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isfinite(got).all()
    if kind == "negative-zero-row":
        # -0.0 + the padded +0.0 adds give +0.0, as in the oracle
        assert not np.signbit(got[0]).any()
    if kind == "all-zero-weights":
        assert not got.any()


@pytest.mark.parametrize("m,n,c", [(100, 300, 5), (3, 7, 2), (37, 131, 4)])
def test_plain_matches_pallas_mixing_product(m, n, c):
    rows, labels, w = _case(m, n, c, seed=1)
    mix = mixing_matrix(jnp.asarray(labels), c, jnp.asarray(w))
    pal = np.asarray(cluster_agg_pallas(jnp.asarray(rows), mix, interpret=True))
    np.testing.assert_allclose(_plain(rows, labels, c, w), pal, rtol=0, atol=ATOL)


@pytest.mark.parametrize("m", [1, 2, 5, 8, 13])
def test_tree_primitives_bit_exact(m):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 9)).astype(np.float32)
    w = (rng.random(m) < 0.6).astype(np.float32)
    x[w == 0] = np.nan
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        _bits(ka.tree_sum(torch.nan_to_num(t), dim=0).numpy()),
        _bits(tree_sum_ref(np.nan_to_num(x), axis=0)))
    np.testing.assert_array_equal(
        _bits(tagg.masked_tree_sum(t, torch.from_numpy(w)).numpy()),
        _bits(masked_tree_sum_ref(x, w)))


def test_tree_cluster_mean_params_on_a_dict():
    rng = np.random.default_rng(4)
    m = 11
    params = {"w0": rng.standard_normal((m, 4, 3)).astype(np.float32),
              "b0": rng.standard_normal((m, 3)).astype(np.float32),
              "w_head": rng.standard_normal((m, 3, 2)).astype(np.float32)}
    labels = rng.integers(0, 3, size=m)
    w = (rng.random(m) < 0.7).astype(np.float32)
    before = ka.launches
    got = tagg.tree_cluster_mean_params(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(labels), 3, weights=torch.from_numpy(w))
    assert ka.launches == before          # no kernel on a CPU tensor
    ref = jax_tree_cluster_mean_params({k: jnp.asarray(v) for k, v in params.items()},
                                       jnp.asarray(labels), 3, jnp.asarray(w))
    for k, v in params.items():
        want = tree_cluster_mean_ref(v.reshape(m, -1), labels, 3, w).reshape(v.shape)
        assert got[k].shape == v.shape
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(want))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=ATOL)


def test_ops_wrapper_and_out_of_range_labels():
    rows, labels, w = _case(6, 5, 3)
    t = torch.from_numpy(rows)
    want = ka.cluster_mean_rows(t, torch.from_numpy(labels), 3, torch.from_numpy(w))
    got = tops.cluster_aggregate(t, torch.from_numpy(labels), 3, torch.from_numpy(w))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    bad = labels.copy()
    bad[1] = 3
    out = ka.cluster_mean_rows(t, torch.from_numpy(bad), 3).numpy()
    assert np.isnan(out[1]).all() and np.isfinite(np.delete(out, 1, axis=0)).all()


def test_wrappers_refuse_what_they_do_not_take():
    rows = torch.zeros((4, 3))
    labels = torch.zeros((4,), dtype=torch.long)
    wo, denom = ka.cluster_weights(labels, 2)
    with pytest.raises(TypeError):
        ka.cluster_agg_plain(rows.double(), labels, wo, denom)
    with pytest.raises(ValueError):
        ka.cluster_agg_plain(rows, labels[:3], wo, denom)
    with pytest.raises(ValueError, match="no path"):
        ka.cluster_mean_rows(rows.to("meta"), labels.to("meta"), 2)
    with pytest.raises(ValueError, match="CUDA"):
        ka.cluster_agg_cuda(rows, labels, wo, denom)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_bit_exact_to_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    m, n, c = CASES[case]
    rows, labels, w = (torch.from_numpy(np.asarray(a)).cuda()
                       for a in _case(m, n, c, seed=m + n))
    wo, denom = ka.cluster_weights(labels, c, w)
    before = ka.launches
    got = ka.cluster_mean_rows(rows, labels, c, w)
    assert ka.launches == before + 1
    want = ka.cluster_agg_plain(rows, labels, wo, denom)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
