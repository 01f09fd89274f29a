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

bfloat16 rows: the plain version is the oracle on the rows' float32
values, rounded once to bf16, bit for bit; and within the reference's own
bf16 tolerance (3e-2, `tests/test_kernels_cluster_agg.py`) of the Pallas
kernel on the same bf16 rows.

The CUDA kernel is held bit for bit against the plain version on the card
(`cuda` marker), in float32 and bf16 rows, up to m = MAX_ROWS = 65536 and at
the edge cases.  What it does not take, its wrapper refuses before it looks
at the device, so those refusals are tested here on the CPU."""
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


def _bf16(rows):
    """(bf16 tensor, its float32 values as numpy) of float32 rows."""
    b = torch.from_numpy(rows).to(torch.bfloat16)
    return b, b.float().numpy()


def _bf16_bits(t):
    return t.view(torch.int16).numpy()


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


BF16_CASES = {
    "main-path": (100, 6570, 5),
    "odd-n": (100, 6571, 5),
    "one-row": (1, 10, 3),
    "ragged": (37, 131, 4),
    "whole-population": (1000, 65, 5),
    "past-a-chunk": (300, 33, 3),
}
EDGE_KINDS = ["nan-at-zero-weight", "negative-zero-row", "empty-cluster",
              "all-zero-weights"]


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_plain_bf16_bit_exact_to_tree_oracle_rounded_once(case):
    m, n, c = BF16_CASES[case]
    rows, labels, w = _case(m, n, c, seed=m + n + 1)
    b, values = _bf16(rows)
    got = ka.cluster_mean_rows(b, torch.from_numpy(labels), c, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(tree_cluster_mean_ref(values, labels, c, weights=w)) \
        .to(torch.bfloat16)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


@pytest.mark.parametrize("kind", EDGE_KINDS + ["bad-label"])
def test_plain_bf16_edge_cases_bit_exact(kind):
    """The edge cases in bf16, bit for bit the oracle rounded once.  A bad
    label (-1) weighs in no cluster and its row is NaN (0x7fc0, PyTorch's
    bits); the oracle, which has no bad labels, sees that row at weight 0."""
    rows, labels, w = _edge("nan-at-zero-weight" if kind == "bad-label" else kind)
    b, values = _bf16(rows)
    got_labels, want_w = labels.copy(), w.copy()
    if kind == "bad-label":
        got_labels[3], want_w[3] = -1, 0.0
    got = ka.cluster_mean_rows(b, torch.from_numpy(got_labels), 4, torch.from_numpy(w))
    with np.errstate(invalid="ignore"):          # the oracle's 0 * inf, discarded
        want = torch.from_numpy(tree_cluster_mean_ref(values, labels, 4, want_w)) \
            .to(torch.bfloat16)
    if kind == "bad-label":
        assert (_bf16_bits(got)[3] == 0x7fc0).all()
        want[3] = got[3]
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))
    assert torch.isfinite(got[torch.from_numpy(got_labels) >= 0].float()).all()


PALLAS_BF16_CASES = {
    "main-path": (100, 6570, 5),
    "odd-n": (100, 6571, 5),
    "one-row": (1, 10, 3),
    "n-past-a-tile": (64, 5001, 4),
    "empty-cluster": "empty-cluster",
    "all-zero-weights": "all-zero-weights",
    "bad-label": "bad-label",
}


@pytest.mark.parametrize("case", sorted(PALLAS_BF16_CASES))
def test_plain_bf16_matches_pallas_mixing_product(case):
    """Within the reference's bf16 tolerance of the Pallas kernel on the
    same bf16 rows.  A bad label: the Pallas product gives its row 0 (its
    one-hot row is empty), the port NaN; every other row is compared."""
    spec = PALLAS_BF16_CASES[case]
    if isinstance(spec, str):
        rows, labels, w = _edge("empty-cluster" if spec == "bad-label" else spec)
        c = 4
        if spec == "bad-label":
            labels[3] = -1
    else:
        m, n, c = spec
        rows, labels, w = _case(m, n, c, seed=2)
    b, values = _bf16(rows)
    mix = mixing_matrix(jnp.asarray(labels), c, jnp.asarray(w))
    pal = cluster_agg_pallas(jnp.asarray(values).astype(jnp.bfloat16), mix, interpret=True)
    assert pal.dtype == jnp.bfloat16
    got = ka.cluster_mean_rows(b, torch.from_numpy(labels), c,
                               torch.from_numpy(w)).float().numpy()
    good = labels >= 0
    assert np.isnan(got[~good]).all()
    np.testing.assert_allclose(got[good], np.asarray(pal, np.float32)[good],
                               rtol=0, atol=3e-2)


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
    with pytest.raises(TypeError):
        ka.cluster_agg_plain(rows.half(), labels, wo, denom)
    with pytest.raises(ValueError):
        ka.cluster_agg_plain(rows, labels[:3], wo, denom)
    with pytest.raises(ValueError, match="no path"):
        ka.cluster_mean_rows(rows.to("meta"), labels.to("meta"), 2)
    with pytest.raises(ValueError, match="CUDA"):
        ka.cluster_agg_cuda(rows, labels, wo, denom)


def _refused(kind):
    """Inputs that cluster_agg_cuda refuses whatever their device."""
    m = ka.MAX_ROWS + 1 if kind == "too-many-rows" else 4
    rows = torch.zeros((m, 3))
    labels = torch.zeros((m,), dtype=torch.long)
    wo, denom = ka.cluster_weights(labels, 2)
    if kind == "float16-rows":
        rows = rows.half()
    elif kind == "non-contiguous-rows":
        rows = torch.zeros((3, m)).t()
    elif kind == "float64-weights":
        wo = wo.double()
    return rows, labels, wo, denom


@pytest.mark.parametrize("kind,error", [
    ("float16-rows", TypeError), ("non-contiguous-rows", ValueError),
    ("float64-weights", TypeError), ("too-many-rows", ValueError)])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(kind, error):
    """Refused before any device is looked at, so on the CPU as on the card:
    nothing falls back to the plain version."""
    before = ka.launches
    with pytest.raises(error) as info:
        ka.cluster_agg_cuda(*_refused(kind))
    assert "CUDA tensors" not in str(info.value) and ka.launches == before


CUDA_CASES = dict(CASES, **{"whole-population": (1000, 6570, 5),
                            "past-a-chunk": (3000, 131, 5),
                            "odd-n": (100, 6571, 5),
                            "most-rows": (ka.MAX_ROWS, 40, 5),
                            "most-rows-ragged": (ka.MAX_ROWS - 77, 33, 3)})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_bit_exact_to_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    m, n, c = CUDA_CASES[case]
    rows, labels, w = (torch.from_numpy(np.asarray(a)).cuda()
                       for a in _case(m, n, c, seed=m + n))
    rows = rows.to(dtype)
    wo, denom = ka.cluster_weights(labels, c, w)
    before = ka.launches
    got = ka.cluster_mean_rows(rows, labels, c, w)
    assert ka.launches == before + 1 and got.dtype == dtype
    want = ka.cluster_agg_plain(rows, labels, wo, denom)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", EDGE_KINDS + ["bad-label"])
def test_cuda_kernel_edge_cases_bit_exact_to_plain(kind, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rows, labels, w = _edge("nan-at-zero-weight" if kind == "bad-label" else kind)
    if kind == "bad-label":
        labels[3] = -1
    rows, labels, w = (torch.from_numpy(a).cuda() for a in (rows, labels, w))
    rows = rows.to(dtype)
    wo, denom = ka.cluster_weights(labels, 4, w)
    got = ka.cluster_agg_cuda(rows, labels, wo, denom)
    want = ka.cluster_agg_plain(rows, labels, wo, denom)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
