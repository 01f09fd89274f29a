"""Spectral clustering of client prototype vectors (paper §IV-B).

Port of ``repro.core.spectral``: normalized graph Laplacian ->
``torch.linalg.eigh`` on the tensor's device (ascending eigenvalues, as
``jnp.linalg.eigh``) -> k-means on the row-normalised spectral embedding
with a deterministic farthest-first start and a fixed 25 iterations.

Eigenvector signs, and the basis inside a repeated eigenvalue's space,
differ between eigen-solvers.  The labels do not: k-means distances and the
row normalisation are unchanged by any orthogonal change of basis of the
embedding, so two solvers agree whenever the n_clusters-th eigenvalue is
separated from the next.  Ties in ``argmin``/``argmax`` go to the first
index, as in JAX.
"""
from __future__ import annotations

import torch


def normalized_laplacian(affinity: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L_sym = I - D^{-1/2} A D^{-1/2} with zeroed self-loops."""
    m = affinity.shape[0]
    eye = torch.eye(m, dtype=affinity.dtype, device=affinity.device)
    a = affinity * (1.0 - eye)
    deg = a.sum(dim=1)
    d_isqrt = 1.0 / torch.sqrt(torch.clamp(deg, min=eps))
    return eye - a * d_isqrt[:, None] * d_isqrt[None, :]


def spectral_embedding(affinity: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Rows of the n_clusters smallest-eigenvalue eigenvectors of L_sym,
    row-normalised (Ng-Jordan-Weiss)."""
    lap = normalized_laplacian(affinity.float())
    _, vecs = torch.linalg.eigh(lap)          # ascending eigenvalues
    emb = vecs[:, :n_clusters]
    norms = torch.linalg.norm(emb, dim=1, keepdim=True)
    return emb / torch.clamp(norms, min=1e-8)


def _farthest_first_init(points: torch.Tensor, k: int) -> torch.Tensor:
    """Deterministic k-means start: point 0, then greedily the point
    farthest from the chosen set (replayable, so every validator derives
    the same clustering from the same prototypes)."""
    centers = torch.zeros((k, points.shape[1]), dtype=points.dtype,
                          device=points.device)
    centers[0] = points[0]
    mind = torch.full((points.shape[0],), float("inf"), dtype=points.dtype,
                      device=points.device)
    for i in range(1, k):
        d = ((points - centers[i - 1][None, :]) ** 2).sum(dim=1)
        mind = torch.minimum(mind, d)
        centers[i] = points[torch.argmax(mind)]
    return centers


def _sq_dists(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return ((points[:, None, :] - centers[None, :, :]) ** 2).sum(dim=-1)


def kmeans(points: torch.Tensor, n_clusters: int, n_iters: int = 25
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm with fixed iterations: (labels (m,), centers (k, D)).
    An empty cluster keeps its previous center."""
    centers = _farthest_first_init(points, n_clusters)
    clusters = torch.arange(n_clusters, device=points.device)
    for _ in range(n_iters):
        labels = torch.argmin(_sq_dists(points, centers), dim=1)
        onehot = (labels[:, None] == clusters[None, :]).to(points.dtype)
        counts = onehot.sum(dim=0)
        new = (onehot.T @ points) / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new, centers)
    return torch.argmin(_sq_dists(points, centers), dim=1), centers


def spectral_cluster(affinity: torch.Tensor, n_clusters: int,
                     n_iters: int = 25) -> torch.Tensor:
    """Full pipeline: affinity (m, m) -> labels (m,)."""
    labels, _ = kmeans(spectral_embedding(affinity, n_clusters), n_clusters,
                       n_iters)
    return labels
