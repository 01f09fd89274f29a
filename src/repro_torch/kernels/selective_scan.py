"""Mamba's selective scan: plain PyTorch version + Hopper kernel.

No Pallas kernel computes this function: the reference's Mamba recurrence
is a ``lax.scan`` over time (``repro.models.mamba.mamba_apply``, and the
single step of ``mamba_decode``).  Eager PyTorch would run that scan as a
loop of several launches a step, or materialise exp(dt A) and (dt x) B at
(B, S, d_inner, d_state) (8.6 GB each in float32 at jamba's prefill), so
it gets a kernel of its own.  Per (batch, channel d), with state h
(d_state,) starting at h0:

    h_t = h_{t-1} * exp(dt_t A_d) + (dt_t x_t) B_t
    y_t = sum_n h_t C_t + x_t D_d

for dt (B, S, di) float32, x (B, S, di) in the model's dtype (float32 or
bf16), B_t and C_t (B, S, N) float32, A (di, N) = -exp(A_log), D (di,) and
h0 (B, di, N) float32; it returns (y (B, S, di) float32, h_T (B, di, N)
float32).  Calls compose: two halves with the state carried give the
whole.  The SiLU gate and the cast to the model dtype stay in the model.

:func:`selective_scan_plain` is the step loop (each step's exp(dt A)
computed as it goes, nothing of (B, S, di, N) kept; the CPU path, autograd
included); :func:`selective_scan_cuda` launches the hand-written kernel
(``csrc/selective_scan.cu``).  ``repro_torch.kernels.ops.selective_scan``
picks by where the tensors lie: the plain version for CPU tensors, the
kernel for CUDA tensors, which launches or raises.  The kernel has no
backward yet: on CUDA tensors the call goes through
:class:`SelectiveScanFn`, whose backward raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

D_STATES = (16,)          # csrc/selective_scan.cu's instances (every config uses 16)
# csrc/selective_scan.cu's kChunk (steps staged at a time) and kDecodeMaxS:
# a call with S <= DECODE_MAX_S takes the kernel's decode form, longer ones
# the chunked form (one launch either way)
CHUNK, DECODE_MAX_S = 16, 4
NO_BACKWARD = ("the selective-scan backward kernel is not written yet: Mamba "
               "training on the card is ROADMAP queue 1 item 7e")

# Launches of selective_scan_cuda since the last reset (set it to 0).
launches = 0


def _check(dt, x, Bm, Cm, A, D, h0) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"selective_scan takes dt and x of one shape (B, S, di), got "
                         f"{tuple(dt.shape)} and {tuple(x.shape)}")
    B, S, di = dt.shape
    N = A.shape[-1] if A.dim() == 2 else -1
    if A.shape != (di, N) or Bm.shape != (B, S, N) or Cm.shape != (B, S, N) \
            or D.shape != (di,) or h0.shape != (B, di, N):
        raise ValueError(f"selective_scan: A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
                         f"Cm {tuple(Cm.shape)}, D {tuple(D.shape)}, h0 "
                         f"{tuple(h0.shape)} do not fit dt {tuple(dt.shape)}")


def selective_scan_plain(dt, x, Bm, Cm, A, D, h0) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence step by step in plain PyTorch on the tensors' own
    device, in float32 (the reference's ``lax.scan`` and the skip term, in
    its order of operations; the reference for the kernel, and the CPU
    path).  Returns (y (B, S, di) float32, h_T (B, di, N) float32)."""
    _check(dt, x, Bm, Cm, A, D, h0)
    xf, h = x.float(), h0.float()
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t]
        dA = torch.exp(dt_t[..., None] * A[None])                    # (B, di, N)
        h = h * dA + (dt_t * xf[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y + xf * D, h


def _kernel():
    fn = _build.load("selective_scan.cu").selective_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def selective_scan_cuda(dt, x, Bm, Cm, A, D, h0) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence on a CUDA device by the hand-written kernel, on the
    current stream; one call is one launch.  dt, x, Bm and Cm are read
    through their strides (unit stride over the last axis required; Bm and
    Cm may be column slices of the ``x_proj`` output); A, D and h0
    contiguous, A and h0 starting on 16 bytes (the kernel reads their rows
    by 16-byte loads).  y comes back (B, S, di) float32 contiguous, h_T (B, di,
    N) float32.  Raises on a d_state the kernel was not built for (any not
    in D_STATES), on wrong dtypes or layouts (all before it looks at the
    device), on tensors not on one CUDA device, and if the launch is
    refused.  It computes no gradient: :class:`SelectiveScanFn` refuses
    one."""
    global launches
    _check(dt, x, Bm, Cm, A, D, h0)
    B, S, di = dt.shape
    N = A.shape[1]
    if N not in D_STATES:
        raise ValueError(f"selective_scan_cuda takes d_state in {D_STATES}, got {N}")
    f32 = (dt, Bm, Cm, A, D, h0)
    if any(t.dtype != torch.float32 for t in f32) \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("selective_scan_cuda takes x in float32 or bfloat16 and the "
                        f"rest in float32, got dt, x, Bm, Cm, A, D, h0 in "
                        f"{[t.dtype for t in (dt, x, Bm, Cm, A, D, h0)]}")
    if any(t.stride(2) != 1 for t in (dt, x, Bm, Cm)) \
            or not all(t.is_contiguous() for t in (A, D, h0)) \
            or A.data_ptr() % 16 or h0.data_ptr() % 16:
        raise ValueError("selective_scan_cuda needs unit stride over the last axis "
                         "of dt, x, Bm, Cm, contiguous A, D, h0, and A and h0 on "
                         "16 bytes")
    tensors = (dt, x, Bm, Cm, A, D, h0)
    if dt.device.type != "cuda" or any(t.device != dt.device for t in tensors):
        raise ValueError("selective_scan_cuda needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    hT = torch.empty((B, di, N), dtype=torch.float32, device=dt.device)
    if B == 0 or di == 0:
        return y, hT
    fn = _kernel()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (dt, x, Bm, Cm, A, D, h0, y, hT)),
                 B, S, di, N, int(x.dtype == torch.bfloat16),
                 *(st for t in (dt, x, Bm, Cm, y) for st in t.stride()[:2]), stream)
    if err:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, hT


class SelectiveScanFn(torch.autograd.Function):
    """The kernel's call on CUDA tensors: its forward launches the kernel;
    its backward raises (no backward kernel yet, ROADMAP item 7e).  CPU
    tensors never come here: autograd runs through the plain version."""

    @staticmethod
    def forward(ctx, dt, x, Bm, Cm, A, D, h0):
        return selective_scan_cuda(dt, x, Bm, Cm, A, D, h0)

    @staticmethod
    def backward(ctx, dy, dhT):
        raise NotImplementedError(NO_BACKWARD)
