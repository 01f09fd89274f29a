"""Cluster-masked FedAvg over flat client rows: plain PyTorch version +
Hopper kernel.

Port of ``repro.kernels.cluster_agg`` (``cluster_agg_pallas``, which
computes ``mixing_matrix(labels, C, w) @ rows``) in the fixed summation
order the round engine needs, ``repro.core.aggregation.
tree_cluster_mean_params`` — bit for bit the numpy oracle
``repro.kernels.ref.tree_cluster_mean_ref``:

    wo[i, c]  = w_i [labels_i == c]                     (m, C)
    denom[c]  = max(tree_i wo[i, c], 1e-9)              (C,)
    mean[c]   = tree_i where(wo[i, c] > 0, wo[i, c] * rows[i], +0.0) / denom[c]
    out[j]    = mean[labels_j]

``tree_i`` is the adjacent-pair binary tree over i, the axis padded with
+0.0 to the next power of two and every padded add done (``-0.0 + +0.0``
is ``+0.0``).  Zero-weight rows add exactly +0.0 whatever they hold, NaN
included.  A label outside [0, C) matches no cluster and its output row is
NaN (``jnp.take``'s fill for an index out of range).  Rows are float32 or
bfloat16; bf16 rows are summed as their float32 values and the means
rounded once to bf16, as the Pallas kernel casts its tile to float32 and
its product back to the rows' dtype.

``wo`` and ``denom`` are O(m·C) and are built by plain tensor ops in
:func:`cluster_weights` for both paths, as the reference builds
``mixing_matrix`` outside its kernel.  :func:`cluster_mean_rows` picks by
where the rows lie: a CPU tensor takes :func:`cluster_agg_plain`, a CUDA
tensor the hand-written kernel (``csrc/cluster_agg.cu``) through
:func:`cluster_agg_cuda` — which launches or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_ROWS = 1 << 16        # the kernel's stack holds 9 levels of 256-row chunks

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of cluster_agg_cuda since the last reset (set it to 0).
launches = 0


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def tree_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Fixed-order adjacent-pair binary-tree sum along ``dim``, padded with
    +0.0 to the next power of two (``repro.core.aggregation.tree_sum``)."""
    x = torch.movedim(x, dim, 0)
    m = x.shape[0]
    p = _next_pow2(m)
    if p != m:
        x = torch.cat([x, x.new_zeros((p - m,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def cluster_weights(labels: torch.Tensor, n_clusters: int,
                    weights: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m,) labels (+ optional (m,) weights) -> ``wo`` (m, C) float32 and
    the clamped ``denom`` (C,) float32, on the labels' device."""
    clusters = torch.arange(n_clusters, device=labels.device)
    onehot = (labels[:, None] == clusters[None, :]).float()
    w = torch.ones(labels.shape, dtype=torch.float32, device=labels.device) \
        if weights is None else weights.float()
    wo = onehot * w[:, None]
    return wo, torch.clamp(tree_sum(wo, dim=0), min=1e-9)


def _check(rows, labels, wo, denom) -> None:
    if rows.dtype not in _DTYPES or rows.dim() != 2:
        raise TypeError(f"cluster_agg takes (m, N) float32 or bfloat16 rows, got "
                        f"{tuple(rows.shape)} {rows.dtype}")
    m = rows.shape[0]
    if labels.shape != (m,) or wo.dim() != 2 or wo.shape[0] != m \
            or denom.shape != (wo.shape[1],):
        raise ValueError(f"cluster_agg: labels {tuple(labels.shape)}, wo "
                         f"{tuple(wo.shape)}, denom {tuple(denom.shape)} do "
                         f"not fit {m} rows")


def cluster_agg_plain(rows: torch.Tensor, labels: torch.Tensor,
                      wo: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """(m, N) float32 or bf16 rows -> (m, N) cluster means in the rows'
    dtype, in plain PyTorch on the tensor's own device (the reference for
    the kernel, and the CPU path)."""
    _check(rows, labels, wo, denom)
    n_clusters = wo.shape[1]
    x = rows.float()
    means = torch.stack([
        tree_sum(torch.where(wo[:, c, None] > 0, wo[:, c, None] * x,
                             x.new_zeros(())), dim=0) / denom[c]
        for c in range(n_clusters)]).to(rows.dtype)         # (C, N)
    valid = (labels >= 0) & (labels < n_clusters)
    out = means[torch.where(valid, labels, 0)]
    return torch.where(valid[:, None], out, out.new_full((), float("nan")))


def _kernel() -> ctypes.CDLL:
    lib = _build.load("cluster_agg.cu")
    fn = lib.cluster_agg_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def cluster_agg_cuda(rows: torch.Tensor, labels: torch.Tensor,
                     wo: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """(m, N) float32 or bf16 rows on a CUDA device -> (m, N) cluster means
    in the rows' dtype, by the hand-written kernel on the current stream.
    Raises on anything the kernel does not take (whatever the device), on
    tensors not on one CUDA device, and if the launch is refused."""
    global launches
    _check(rows, labels, wo, denom)
    tensors = (rows, labels, wo, denom)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cluster_agg_cuda needs contiguous inputs")
    if wo.dtype != torch.float32 or denom.dtype != torch.float32:
        raise TypeError("cluster_agg_cuda needs float32 wo and denom")
    m, n = rows.shape
    n_clusters = wo.shape[1]
    if not 1 <= m <= MAX_ROWS or n_clusters < 1:
        raise ValueError(f"cluster_agg_cuda takes 1 <= m <= {MAX_ROWS} rows "
                         f"and C >= 1, got m={m}, C={n_clusters}")
    if any(t.device != rows.device for t in tensors) or rows.device.type != "cuda":
        raise ValueError("cluster_agg_cuda needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    labels = labels.to(torch.int64)        # no copy for int64 labels
    out = torch.empty_like(rows)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.cluster_agg_launch(rows.data_ptr(), labels.data_ptr(),
                                     wo.data_ptr(), denom.data_ptr(),
                                     out.data_ptr(), _DTYPES[rows.dtype], m, n,
                                     n_clusters, stream)
    if err:
        raise RuntimeError(f"cluster_agg kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def cluster_mean_rows(rows: torch.Tensor, labels: torch.Tensor,
                      n_clusters: int, weights: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Cluster-masked FedAvg of (m, N) float32 or bf16 rows: every row
    receives its cluster's weighted mean.  The plain version for CPU rows,
    the Hopper kernel for CUDA rows."""
    wo, denom = cluster_weights(labels, n_clusters, weights)
    if rows.device.type == "cpu":
        return cluster_agg_plain(rows, labels, wo, denom)
    if rows.device.type == "cuda":
        return cluster_agg_cuda(rows, labels, wo, denom)
    raise ValueError(f"cluster_mean_rows: no path for device {rows.device}")
