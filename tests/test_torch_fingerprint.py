"""The port's fingerprint (`repro_torch.kernels.fingerprint`) against the
reference: the plain PyTorch version is bit-exact to `fingerprint_ref` and
to the Pallas kernel in interpret mode, digest strings equal
`cohort_digests`, zero padding is neutral and the digest binds N.  The
CUDA kernel is held against the plain version on the card (`cuda` marker).

Tolerance: none — integer arithmetic mod 2^32 is exact, so every
comparison here is bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.fingerprint import (  # noqa: E402
    cohort_digests as jax_cohort_digests,
    fingerprint_pallas,
    format_digest as jax_format_digest,
    poly_weights as jax_poly_weights,
)
from repro.kernels.ref import fingerprint_ref  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import fingerprint as tfp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SHAPES = [(4, 256), (8, 1024), (5, 131), (3, 2049), (17, 6500), (1, 128)]


def _bits(m, n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, size=(m, n),
                                                dtype=np.uint32)


def _port(x_u32):
    return torch.from_numpy(x_u32.view(np.int32).copy())


@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_matches_ref_and_pallas_interpret(m, n):
    x = _bits(m, n, seed=m * 10007 + n)
    ref = np.asarray(fingerprint_ref(jnp.asarray(x),
                                     jnp.asarray(jax_poly_weights(n))))
    pal = np.asarray(fingerprint_pallas(jnp.asarray(x), interpret=True))
    port = tfp.residues_numpy(tfp.fingerprint_plain(_port(x)))
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, pal)


@pytest.mark.parametrize("n", [1, 7, 128, 6570])
def test_poly_weights_match_reference(n):
    np.testing.assert_array_equal(tfp.poly_weights(n), jax_poly_weights(n))


def test_cpu_wrappers_take_the_plain_version():
    x = _port(_bits(6, 300))
    before = tfp.launches
    want = tfp.fingerprint_plain(x)
    assert torch.equal(tfp.fingerprint_rows(x), want)
    assert torch.equal(tops.fingerprint(x), want)
    assert tfp.launches == before          # no kernel on a CPU tensor


def test_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(TypeError):
        tfp.fingerprint_rows(torch.zeros((2, 3), dtype=torch.float32))
    with pytest.raises(TypeError):
        tfp.fingerprint_rows(torch.zeros((6,), dtype=torch.int32))
    with pytest.raises(ValueError, match="no path"):
        tfp.fingerprint_rows(torch.zeros((2, 3), dtype=torch.int32,
                                         device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfp.fingerprint_cuda(torch.zeros((2, 3), dtype=torch.int32))


@pytest.mark.parametrize("tree", ["mlp", "nested"])
def test_digest_strings_equal_cohort_digests(tree):
    rng = np.random.default_rng(3)
    if tree == "mlp":
        p = {"w0": rng.standard_normal((6, 33, 7)), "b0": rng.standard_normal((6, 7)),
             "w_head": rng.standard_normal((6, 7, 3)), "b_head": np.zeros((6, 3))}
    else:
        p = {"a": {"c": rng.standard_normal((4, 3, 2)), "b": rng.standard_normal((4, 5))},
             "a b": rng.standard_normal((4, 2)), "z": {"y": {"x": rng.standard_normal((4, 1))}}}
    p = _as_f32(p)
    want = jax_cohort_digests(_as_jnp(p))
    assert tfp.cohort_digests(params_from_numpy(p, device="cpu")) == want


def _as_f32(t):
    return {k: _as_f32(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in t.items()}


def _as_jnp(t):
    return {k: _as_jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in t.items()}


def test_zero_padding_is_neutral_and_zero_rows_vanish():
    x = _bits(4, 300)
    padded = np.pad(x, ((0, 0), (0, 212)))
    a = tfp.fingerprint_plain(_port(x))
    assert torch.equal(a, tfp.fingerprint_plain(_port(padded)))
    x[2] = 0
    assert not tfp.fingerprint_plain(_port(x))[2].any()


def test_digest_sensitivity_and_length_binding():
    p = {"a": torch.arange(12.0).reshape(3, 2, 2), "b": {"c": torch.ones((3, 5))}}
    d = tfp.cohort_digests(p)
    assert len(set(d)) == 3 and d == tfp.cohort_digests(p)
    p2 = {"a": p["a"].clone(), "b": p["b"]}
    p2["a"][1, 0, 0] += 1e-5
    d2 = tfp.cohort_digests(p2)
    assert d2[1] != d[1] and d2[0] == d[0] and d2[2] == d[2]
    # same values, zero-extended: the digest binds N, so no collision
    assert tfp.cohort_digests({"a": torch.zeros((2, 4))}) != \
        tfp.cohort_digests({"a": torch.zeros((2, 8))})


def test_format_digest_matches_reference():
    for res, n in [((1, 2), 9), ((0xFFFFFFFF, 0x80000000), 6570)]:
        r = np.array(res, np.uint32)
        assert tfp.format_digest(r, n) == jax_format_digest(r, n)
    # int32 residues carrying the same bits format the same way
    assert tfp.format_digest(np.array([-1, -2**31], np.int32), 6570) == \
        jax_format_digest(np.array([0xFFFFFFFF, 0x80000000], np.uint32), 6570)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(5, 6570), (100, 6570), (17, 131), (1, 1),
                                 (3, 70001)])
def test_cuda_kernel_bit_exact_to_plain(m, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x = _port(_bits(m, n)).cuda()
    before = tfp.launches
    got = tfp.fingerprint_rows(x)
    assert tfp.launches == before + 1
    assert torch.equal(got, tfp.fingerprint_plain(x))
    # rows that start off the 16-byte grid
    buf = _port(_bits(1, m * n + 1)).cuda()[0]
    off = buf[1:].view(m, n)
    assert torch.equal(tfp.fingerprint_cuda(off), tfp.fingerprint_plain(off))


def _kernel_split(offset: int, n: int, c: int):
    """The kernel's split of one row whose first element lies ``offset``
    bytes past a 16-byte boundary (csrc/fingerprint.cu): a scalar head up to
    the boundary, C contiguous spans of 16-byte vectors, a scalar tail.
    Returns (head, [(first element, elements) per block], tail start)."""
    head = min(n, ((16 - offset % 16) % 16) // 4)
    nvec = (n - head) // 4
    span = -(-nvec // c)
    spans = []
    for b in range(c):
        q0, q1 = min(b * span, nvec), min((b + 1) * span, nvec)
        spans.append((head + 4 * q0, 4 * (q1 - q0)))
    return head, spans, head + 4 * nvec


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 131, 1023, 2051, 6570, 70001])
@pytest.mark.parametrize("m", [1, 2, 5, 33, 65, 100, 263, 264, 1000, 70000,
                               2**31 - 1])
def test_cluster_size_chooser(m, n):
    c = tfp.cluster_size(m, n)
    assert c in tfp.CLUSTER_SIZES
    assert m * c <= 2**31 - 1                      # grid.x = m * C
    if c > 1:                                      # more blocks only while
        assert m * (c // 2) < tfp.BLOCKS_WANTED    # the card wants them, and
        assert c * tfp.THREADS <= (n - 3) // 4     # each thread has a load
    for offset in (0, 4, 8, 12):
        head, spans, tail0 = _kernel_split(offset, n, c)
        assert head < 4 and n - tail0 < 4
        covered = list(range(head))
        for first, count in spans:
            # every vector load aligned (an empty span loads nothing)
            assert count == 0 or (offset + 4 * first) % 16 == 0
            covered += range(first, first + count)
        covered += range(tail0, n)
        assert covered == list(range(n))           # each element exactly once


def test_cluster_size_at_the_path_shapes():
    # start-up digest, serving bank, cohort: four blocks a row; a population
    # of 1000 rows fills the card with one block a row
    assert [tfp.cluster_size(m, 6570) for m in (1, 5, 100, 1000)] == [4, 4, 4, 1]


def test_cuda_wrapper_refuses_a_bad_cluster_before_the_device():
    with pytest.raises(ValueError, match="cluster"):
        tfp.fingerprint_cuda(torch.zeros((2, 3), dtype=torch.int32), cluster=3)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _exact_once(x, **kw):
    before = tfp.launches
    got = tfp.fingerprint_cuda(x, **kw)
    assert tfp.launches == before + 1
    assert torch.equal(got, tfp.fingerprint_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("m,n", [(100, 6570), (5, 6570), (1, 6570), (17, 131),
                                 (3, 70001)])
def test_cuda_kernel_bit_exact_at_every_cluster_size(m, n, cluster):
    _cuda_or_skip()
    buf = _port(_bits(1, m * n + 3, seed=cluster)).cuda()[0]
    for off in (0, 1, 2, 3):                 # rows on and off the 16-byte grid
        _exact_once(buf[off:off + m * n].view(m, n), cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(70000, 3), (7, 1), (7, 2), (7, 3), (7, 4),
                                 (7, 5)])
def test_cuda_kernel_head_and_tail_only(m, n):
    # more rows than grid.y could take, and rows of scalar head and tail only
    _cuda_or_skip()
    _exact_once(_port(_bits(m, n, seed=n)).cuda())
    buf = _port(_bits(1, m * n + 1, seed=n)).cuda()[0]
    _exact_once(buf[1:].view(m, n))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 8])
def test_cuda_kernel_several_load_groups_a_thread(cluster):
    _cuda_or_skip()
    _exact_once(_port(_bits(3, 70001, seed=5)).cuda(), cluster=cluster)


@pytest.mark.cuda
def test_cuda_kernel_repeated_is_stable():
    # a distributed-shared-memory race would show only sometimes
    _cuda_or_skip()
    x = _port(_bits(100, 6570, seed=9)).cuda()
    want = tfp.fingerprint_plain(x)
    before = tfp.launches
    for _ in range(50):
        assert torch.equal(tfp.fingerprint_cuda(x), want)
    assert tfp.launches == before + 50
