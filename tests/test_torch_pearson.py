"""The port's Pearson matrix (`repro_torch.kernels.pearson`,
`repro_torch.core.pearson`) against the reference: the plain PyTorch
version matches both JAX forms — the engine's jnp `pearson_matrix` and the
Pallas kernel `pearson_matrix_pallas` in interpret mode — and a constant
row takes the eps path.  The CUDA kernel is held against the plain version
on the card (`cuda` marker).

Tolerance: atol 1e-5, the reference's own for its Pallas Pearson kernel
(`tests/test_kernels_pearson.py`).  The three forms sum in different
orders (gram of normalised rows vs centred gram divided by the norms), so
they agree to float32 rounding, not bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pearson import (  # noqa: E402
    pearson_affinity as jax_affinity,
    pearson_matrix as jax_pearson,
)
from repro.kernels.pearson import pearson_matrix_pallas  # noqa: E402
from repro_torch.core import pearson as tpearson  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pearson as kp  # noqa: E402

ATOL = 1e-5
SHAPES = [(100, 32), (7, 5), (1, 3), (20, 130), (33, 600)]


def _protos(m, d, seed=0):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)


@pytest.mark.parametrize("m,d", SHAPES)
def test_plain_matches_jnp_and_pallas_interpret(m, d):
    x = _protos(m, d, seed=m * 1000 + d)
    port = kp.pearson_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, np.asarray(jax_pearson(jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    pal = np.asarray(pearson_matrix_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(port, pal, rtol=0, atol=ATOL)
    assert port.shape == (m, m) and np.abs(port).max() <= 1.0


def test_constant_row_takes_the_eps_path():
    x = _protos(6, 5)
    x[2] = 0.5                  # exact mean: the centred row is exactly zero
    x[4] = -2.0
    port = kp.pearson_plain(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_pearson(jnp.asarray(x)))
    np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL)
    for i in (2, 4):
        assert not port[i].any() and not port[:, i].any()


def test_core_forms_route_through_the_kernel_module():
    x = _protos(9, 12, seed=3)
    t = torch.from_numpy(x)
    before = kp.launches
    corr = tpearson.pearson_matrix(t)
    assert torch.equal(corr, kp.pearson_plain(t))
    assert torch.equal(tops.pearson(t), corr)
    assert kp.launches == before          # no kernel on a CPU tensor
    np.testing.assert_allclose(
        tpearson.pearson_affinity(corr).numpy(),
        np.asarray(jax_affinity(jax_pearson(jnp.asarray(x)))), rtol=0, atol=ATOL)


def test_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(TypeError):
        kp.pearson_rows(torch.zeros((3, 4), dtype=torch.float64))
    with pytest.raises(TypeError):
        kp.pearson_rows(torch.zeros((4,), dtype=torch.float32))
    with pytest.raises(ValueError, match="no path"):
        kp.pearson_rows(torch.zeros((2, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kp.pearson_cuda(torch.zeros((2, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", SHAPES + [(300, 600)])
def test_cuda_kernel_matches_plain(m, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x = torch.from_numpy(_protos(m, d)).cuda()
    x[m // 2] = 0.5
    before = kp.launches
    got = kp.pearson_rows(x)
    assert kp.launches == before + 1
    torch.testing.assert_close(got, kp.pearson_plain(x), rtol=0, atol=ATOL)



@pytest.mark.cuda
@pytest.mark.parametrize("m,d,shift", [(129, 33, 0.0), (1, 1, 0.0), (2000, 32, 0.0),
                                       (300, 600, 1e3), (100, 32, 0.0), (16, 64, 0.0),
                                       (17, 65, 0.0), (3, 130, 0.0)])
def test_cuda_kernel_edges_exactly_symmetric(m, d, shift):
    # m off the tile, D off 4, one row, many tiles, a large mean (the
    # two-pass statistics), D at, just past and past twice the kernel's
    # 64-column chunk; each call one launch, the output exactly symmetric
    # (a tile and its mirror are written from one block)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x = torch.from_numpy(_protos(m, d, seed=m + d)).cuda() + shift
    before = kp.launches
    got = kp.pearson_cuda(x)
    assert kp.launches == before + 1
    torch.testing.assert_close(got, kp.pearson_plain(x), rtol=0, atol=ATOL)
    assert torch.equal(got, got.T)
