"""The port's spectral clustering (`repro_torch.core.spectral`) against the
reference `repro.core.spectral`: the Laplacian and the k-means centres to
float32 rounding (atol 1e-5), and the cluster LABELS exactly, on inputs
whose clusters are well separated.

Labels are compared exactly because eigenvector signs and the basis of the
bottom eigenspace differ between `jnp.linalg.eigh` and `torch.linalg.eigh`
without moving a label: row normalisation and k-means distances are
unchanged by any orthogonal change of basis of the embedding, and both
k-means runs start from the same farthest-first points.  On a degenerate
input (no gap after the n_clusters-th eigenvalue) the two may differ;
that is not tested."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import spectral as jspec  # noqa: E402
from repro.core.pearson import pearson_affinity, pearson_matrix  # noqa: E402
from repro_torch.core import pearson as tpearson  # noqa: E402
from repro_torch.core import spectral as tspec  # noqa: E402

ATOL = 1e-5


def _blobs(n_clusters, per, d, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d))
    pts = np.repeat(centers, per, axis=0) + noise * rng.standard_normal(
        (n_clusters * per, d))
    return pts[rng.permutation(len(pts))].astype(np.float32)


@pytest.mark.parametrize("n_clusters,per,d,seed", [(5, 20, 32, 0), (3, 7, 8, 1),
                                                   (5, 8, 32, 2), (2, 30, 16, 3)])
def test_labels_equal_reference_on_separated_clusters(n_clusters, per, d, seed):
    protos = _blobs(n_clusters, per, d, seed)
    jl = np.asarray(jspec.spectral_cluster(
        pearson_affinity(pearson_matrix(jnp.asarray(protos))), n_clusters))
    aff = tpearson.pearson_affinity(tpearson.pearson_matrix(torch.from_numpy(protos)))
    tl = tspec.spectral_cluster(aff, n_clusters).numpy()
    np.testing.assert_array_equal(tl, jl)
    assert len(set(tl.tolist())) == n_clusters


def test_normalized_laplacian_matches_reference():
    a = np.random.default_rng(0).random((9, 9)).astype(np.float32)
    a = (a + a.T) / 2
    np.testing.assert_allclose(
        tspec.normalized_laplacian(torch.from_numpy(a)).numpy(),
        np.asarray(jspec.normalized_laplacian(jnp.asarray(a))), rtol=0, atol=ATOL)


def test_kmeans_matches_reference():
    pts = _blobs(4, 10, 3, seed=5, noise=0.2)
    jl, jc = jspec.kmeans(jnp.asarray(pts), 4, 25)
    tl, tc = tspec.kmeans(torch.from_numpy(pts), 4, 25)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ATOL)


def test_farthest_first_init_matches_reference():
    pts = np.random.default_rng(3).standard_normal((15, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tspec._farthest_first_init(torch.from_numpy(pts), 5).numpy(),
        np.asarray(jspec._farthest_first_init(jnp.asarray(pts), 5)))


def test_embedding_is_rotation_of_reference():
    protos = _blobs(3, 10, 16, seed=4)
    aff_j = pearson_affinity(pearson_matrix(jnp.asarray(protos)))
    aff_t = tpearson.pearson_affinity(tpearson.pearson_matrix(torch.from_numpy(protos)))
    ej = np.asarray(jspec.spectral_embedding(aff_j, 3)).astype(np.float64)
    et = tspec.spectral_embedding(aff_t, 3).numpy().astype(np.float64)
    # same rows up to an orthogonal change of basis: equal Gram matrices
    np.testing.assert_allclose(et @ et.T, ej @ ej.T, rtol=0, atol=1e-4)
