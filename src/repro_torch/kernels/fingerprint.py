"""Batched per-client model fingerprints: plain PyTorch version + Hopper kernel.

Port of ``repro.kernels.fingerprint`` (and its oracle
``repro.kernels.ref.fingerprint_ref``).  Per row of an (m, N) matrix of
uint32 bit patterns, two mod-2^32 polynomial residues

    A_i = sum_j mix(V[i, j]) * r^(j+1)
    B_i = sum_j mix(V[i, j]) * r^(2(j+1))

with ``mix(v) = v ^ (v >> 16)`` and ``r = 0x85EBCA77``; the digest string is
``(A, B)`` plus N (:func:`format_digest`).  Zero columns are neutral, since
``mix(0) = 0``.

The port carries the uint32 bits in int32 tensors (``bitcast_u32`` is a
view, no copy) and returns residues the same way: int32 tensors holding the
uint32 bits (``.numpy().view(np.uint32)`` reads them).  Torch's CPU kernels
lack uint32 shifts and sums, so the plain version computes in int64 with
every intermediate below 2^63.

:func:`fingerprint_rows` picks by where the tensor lies: a CPU tensor takes
:func:`fingerprint_plain`, a CUDA tensor the hand-written kernel
(``csrc/fingerprint.cu``: one launch, each row split over a thread-block
cluster of :func:`cluster_size` blocks) through :func:`fingerprint_cuda` —
which launches or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.runtime.arena import ArenaLayout, bitcast_u32

# Odd base (MurmurHash3's c1), as in the reference.
FINGERPRINT_BASE = np.uint32(0x85EBCA77)
_MASK = 0xFFFFFFFF
THREADS = 256             # threads per block, fixed in the kernel
CLUSTER_SIZES = (1, 2, 4, 8)   # blocks per row (8: the portable cluster limit)
# blocks the card should get: two on each of the H100's 132 SMs
BLOCKS_WANTED = 2 * 132

# Kernel launches of fingerprint_cuda since the last reset (set it to 0).
launches = 0


@functools.lru_cache(maxsize=8)
def poly_weights(n: int, base: int = int(FINGERPRINT_BASE)) -> np.ndarray:
    """(2, n) uint32: rows ``r^(j+1)`` and ``r^(2(j+1))`` mod 2^32."""
    with np.errstate(over="ignore"):
        w1 = np.cumprod(np.full((n,), np.uint32(base), dtype=np.uint32))
        w2 = w1 * w1
    return np.stack([w1, w2])


def format_digest(residues, n_params: int) -> str:
    """(2,) uint32 residues + length -> canonical digest string."""
    a, b = (int(v) & _MASK for v in residues)
    return f"{a:08x}{b:08x}{n_params:08x}"


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _mulmod32(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``v * w mod 2^32`` for int64 values in [0, 2^32), split on w's 16-bit
    halves so no product reaches 2^63."""
    return (v * (w & 0xFFFF) + (((v * (w >> 16)) & 0xFFFF) << 16)) & _MASK


def _check_bits(bits: torch.Tensor) -> None:
    if bits.dtype != torch.int32 or bits.dim() != 2:
        raise TypeError(f"fingerprint takes the (m, N) int32 bit view of the "
                        f"rows, got {tuple(bits.shape)} {bits.dtype}")


def fingerprint_plain(bits: torch.Tensor) -> torch.Tensor:
    """(m, N) int32 bits -> (m, 2) int32 residues, in plain PyTorch on the
    tensor's own device (the reference for the kernel, and the CPU path)."""
    _check_bits(bits)
    n = bits.shape[1]
    w = torch.from_numpy(poly_weights(n).astype(np.int64)).to(bits.device)
    v = bits.to(torch.int64) & _MASK
    v = v ^ (v >> 16)
    a = _mulmod32(v, w[0]).sum(dim=1) & _MASK
    b = _mulmod32(v, w[1]).sum(dim=1) & _MASK
    return _to_int32_bits(torch.stack([a, b], dim=1))


def cluster_size(m: int, n: int) -> int:
    """Blocks per row (the kernel's thread-block cluster) for an (m, n)
    matrix: the least of 1, 2, 4, 8 that gives the card BLOCKS_WANTED
    blocks, but no more than lets every thread take one 16-byte load of the
    row (the row's unaligned head may take up to 3 elements)."""
    nvec = max(0, (n - 3) // 4)
    c = 1
    while c < CLUSTER_SIZES[-1] and m * c < BLOCKS_WANTED \
            and 2 * c * THREADS <= nvec:
        c *= 2
    return c


def _kernel() -> ctypes.CDLL:
    lib = _build.load("fingerprint.cu")
    fn = lib.fingerprint_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fingerprint_cuda(bits: torch.Tensor, *, cluster: int | None = None
                     ) -> torch.Tensor:
    """(m, N) int32 bits on a CUDA device -> (m, 2) int32 residues, by one
    launch of the hand-written kernel on the current stream.  ``cluster``
    forces the blocks per row (1, 2, 4 or 8; default
    :func:`cluster_size`), for tests and measurements.  Raises on anything
    the kernel does not take, and if the launch is refused."""
    global launches
    _check_bits(bits)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"fingerprint_cuda: cluster must be one of "
                         f"{CLUSTER_SIZES}, got {cluster}")
    if bits.device.type != "cuda":
        raise ValueError(f"fingerprint_cuda needs a CUDA tensor, got "
                         f"{bits.device}")
    if not bits.is_contiguous():
        raise ValueError("fingerprint_cuda needs contiguous rows")
    m, n = bits.shape
    c = cluster_size(m, n) if cluster is None else cluster
    if m * c > 2**31 - 1:
        raise ValueError(f"fingerprint_cuda: {m} rows x {c} blocks exceed "
                         f"the grid's 2^31 - 1")
    out = torch.empty((m, 2), dtype=torch.int32, device=bits.device)
    if m == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        err = lib.fingerprint_launch(bits.data_ptr(), out.data_ptr(), m, n,
                                     c, stream)
    if err:
        raise RuntimeError(f"fingerprint kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def fingerprint_rows(bits: torch.Tensor) -> torch.Tensor:
    """(m, N) int32 bit matrix -> (m, 2) int32 residues: the plain version
    for a CPU tensor, the Hopper kernel for a CUDA tensor."""
    if bits.device.type == "cpu":
        return fingerprint_plain(bits)
    if bits.device.type == "cuda":
        return fingerprint_cuda(bits)
    raise ValueError(f"fingerprint_rows: no path for device {bits.device}")


def residues_numpy(residues: torch.Tensor) -> np.ndarray:
    """(m, 2) int32 residues -> host uint32 array."""
    return residues.cpu().numpy().view(np.uint32)


def row_digests(rows: torch.Tensor) -> list[str]:
    """Digest strings of fp32 rows (m, N) — one device program, an O(m)
    host transfer."""
    res = residues_numpy(fingerprint_rows(bitcast_u32(rows.contiguous())))
    return [format_digest(r, rows.shape[1]) for r in res]


def stack_flatten_u32(stacked_params) -> torch.Tensor:
    """Stacked dict (leading client axis) -> (m, N) bit matrix in the
    arena's canonical column order, as int32 holding the uint32 bits — the
    fingerprint's input (``ArenaLayout.flatten_u32``)."""
    return ArenaLayout.from_stacked(stacked_params).flatten_u32(stacked_params)


def cohort_digests(stacked_params) -> list[str]:
    """Per-client digest strings for a cohort-stacked dict of tensors."""
    layout = ArenaLayout.from_stacked(stacked_params)
    return row_digests(layout.flatten(stacked_params))
