"""A batched float32 product summed in one fixed order: plain PyTorch
version + Hopper kernel.

No Pallas counterpart.  The reference leaves the client-stacked products of
local training, prototypes and evaluation to XLA.  The port's client mesh
needs each client's bits not to depend on how many clients one call holds:
a cohort sharded over S devices must replay the one-device run bit for bit.
cuBLAS picks its kernel by the batch count, so on the card it does not give
that; this product does:

    c[b, i, j] = (...((0 + a[b, i, 0] b[b, 0, j]) + a[b, i, 1] b[b, 1, j]) + ...)

every product and every sum rounded once to float32, k in order.  An
element's bits depend on its own row of ``a`` and column of ``b`` alone.
``a`` is ``(m, M, K)`` or one ``(M, K)`` matrix shared by all ``m`` (the
shared eval or probe batch), ``b`` is ``(m, K, N)``; either may be a
transposed view (the backward's ``dY @ B^T`` and ``A^T @ dY``).

:func:`batched_matmul_cuda` launches the hand-written kernel
(``csrc/batched_matmul.cu``) or raises; :func:`batched_matmul_plain` adds
the same products in the same order and equals it bit for bit (the tests
and ``chip_smoke.py`` hold the kernel against it).  :class:`BatchedMatmulFn`
is the product with its gradient in the same order: the kernel for CUDA
tensors, the plain version for CPU ones.

The routing in ``kernels.ops.batched_matmul`` has one exception to the
port's rule that a CPU tensor takes the plain version: on the CPU it keeps
``torch.matmul``.  The CPU's products are batch-invariant already
(``tests/test_torch_mesh.py`` measures it), the K-step loop of the plain
version would slow every training run of the CPU tests, and keeping
``torch.matmul`` leaves every CPU bit as it was.  The plain version runs in
the tests and in ``chip_smoke.py`` only, on no path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# the sizes the wrapper takes (the first design's grid limits: a batch entry
# and 16 output rows a block along y), kept as the wrapper's contract
MAX_BATCH = 65535
MAX_ROWS = 65535 * 16

# Launches of batched_matmul_cuda since the last reset (set it to 0).
launches = 0


def _check(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int, int]:
    """(m, M, K, N) of a product the kernel takes; raises on anything else,
    whatever the device."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"batched_matmul takes float32, got {a.dtype} @ {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() != 3:
        raise ValueError(f"batched_matmul takes (m, M, K) or (M, K) @ (m, K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    m, K, N = b.shape
    M = a.shape[-2]
    if a.shape[-1] != K or (a.dim() == 3 and a.shape[0] != m):
        raise ValueError(f"batched_matmul: {tuple(a.shape)} @ {tuple(b.shape)} do not fit")
    return m, M, K, N


def batched_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (m, M, K) | (M, K) @ b (m, K, N) -> (m, M, N)`` float32, each
    element summed over k = 0..K-1 in order from +0.0, in plain PyTorch on
    the tensors' own device: the kernel's arithmetic, bit for bit."""
    m, M, K, N = _check(a, b)
    acc = b.new_zeros((m, M, N))
    for k in range(K):
        acc = acc + a[..., k:k + 1] * b[:, k:k + 1, :]
    return acc


def _kernel() -> ctypes.CDLL:
    lib = _build.load("batched_matmul.cu")
    fn = lib.batched_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def batched_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as :func:`batched_matmul_plain` computes it, by the
    hand-written kernel on the current stream; operands read in place
    through their strides.  Raises on anything the kernel does not take
    (whatever the device), on tensors not on one CUDA device, and if the
    launch is refused."""
    global launches
    m, M, K, N = _check(a, b)
    if not (m <= MAX_BATCH and M <= MAX_ROWS):
        raise ValueError(f"batched_matmul_cuda takes m <= {MAX_BATCH} and M <= "
                         f"{MAX_ROWS}, got m={m}, M={M}")
    if a.device != b.device or b.device.type != "cuda":
        raise ValueError("batched_matmul_cuda needs CUDA tensors on one device, got "
                         f"{a.device} and {b.device}")
    if any(s < 0 for s in a.stride() + b.stride()):
        raise ValueError("batched_matmul_cuda needs non-negative strides")
    out = torch.empty((m, M, N), dtype=torch.float32, device=b.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    sab, (sam, sak) = (0, a.stride()) if a.dim() == 2 else (a.stride(0), a.stride()[1:])
    lib = _kernel()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.batched_matmul_launch(a.data_ptr(), sab, sam, sak, b.data_ptr(),
                                        *b.stride(), out.data_ptr(), m, M, K, N, stream)
    if err:
        raise RuntimeError(f"batched_matmul kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if b.device.type == "cpu":
        return batched_matmul_plain(a, b)
    if b.device.type == "cuda":
        return batched_matmul_cuda(a, b)
    raise ValueError(f"batched_matmul: no path for device {b.device}")


class BatchedMatmulFn(torch.autograd.Function):
    """``a @ b`` in the fixed order, with its gradient in the same order:
    ``dA = dY @ B^T`` (summed over the models where ``a`` is one shared
    matrix; no path differentiates a shared ``a``) and ``dB = A^T @ dY``,
    so every gradient is batch-invariant too.  CUDA tensors take the kernel
    forward and backward, CPU tensors the plain version."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _product(a, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product(dy, b.transpose(1, 2))
            if a.dim() == 2:
                da = da.sum(dim=0)
        if ctx.needs_input_grad[1]:
            db = _product(a.transpose(-1, -2), dy)
        return da, db
