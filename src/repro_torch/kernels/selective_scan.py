"""Mamba's selective scan: plain PyTorch version + Hopper kernel, and its
gradient.

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
computed as it goes, nothing of (B, S, di, N) kept); :func:`selective_scan_cuda`
launches the hand-written kernel (``csrc/selective_scan.cu``).

The gradient (the reference differentiates its ``lax.scan``; there is no
Pallas backward) carries g_t, the gradient reaching h_t, backward in time
from g = dh_T, with a_t = exp(dt_t A):

    g_t   = g_{t+1} a_{t+1} + dy_t C_t       dC_t = sum_d dy_t h_t
    u_t   = sum_n g_t B_t                    dB_t = sum_d g_t dt_t x_t
    dx_t  = u_t dt_t + dy_t D                ddt_t = u_t x_t + sum_n g_t h_{t-1} a_t A
    dA    = sum_{b,t} g_t h_{t-1} a_t dt_t   dD = sum_{b,t} dy_t x_t

ending with dh0 = g_0 a_0 (steps counted from 0).  For CPU tensors
:func:`selective_scan_backward_plain` (every state of a forward pass kept),
for CUDA tensors :func:`selective_scan_backward_cuda`
(``csrc/selective_scan_bwd.cu``: each span of STATES_EVERY steps
recomputed from the state the forward kernel stores there, then walked
backward; no atomics).  :class:`SelectiveScanFn` picks by where the
tensors lie, forward and backward, and ``repro_torch.kernels.ops.selective_scan`` routes every
call through it; a CUDA tensor launches the kernels or raises, there is no
fallback.
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
# the interval at which the forward stores states for the backward, and the
# span the backward walks from each (kStatesEvery of both sources)
STATES_EVERY = 8

# Launches since the last reset (set them to 0): of selective_scan_cuda, and
# of selective_scan_backward_cuda (one call, its two launches, counts one).
launches = 0
launches_bwd = 0


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions compute in float32, or in float64 on float64
    inputs (the gradient tests)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


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
    path), or in float64 for float64 inputs.  Returns (y (B, S, di), h_T
    (B, di, N)), float32 (float64)."""
    _check(dt, x, Bm, Cm, A, D, h0)
    xf, h = _wide(x), _wide(h0)
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t]
        dA = torch.exp(dt_t[..., None] * A[None])                    # (B, di, N)
        h = h * dA + (dt_t * xf[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) if ys else _wide(dt).new_zeros(dt.shape)
    return y + xf * D, h


def selective_scan_backward_plain(dt, x, Bm, Cm, A, D, h0, dy, dhT):
    """Gradients (ddt, dx, dBm, dCm, dA, dD, dh0) of
    :func:`selective_scan_plain` for the upstream dy (B, S, di) and dh_T
    (B, di, N): the reverse loop in plain PyTorch from every state of one
    forward pass kept (the reference for the kernel, and the CPU path).
    Each gradient in its input's dtype (dx in bf16 for bf16 x, rounded as
    autograd rounds it: through x's float32 copy)."""
    _check(dt, x, Bm, Cm, A, D, h0)
    dtf, xf, Bf, Cf, Af, Df, dyf = (_wide(t) for t in (dt, x, Bm, Cm, A, D, dy))
    h = _wide(h0)
    states = [h]                          # states[t] is the state before step t
    for t in range(dt.shape[1]):
        h = h * torch.exp(dtf[:, t, :, None] * Af[None]) \
            + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        states.append(h)
    g = _wide(dhT).to(h.dtype)
    ddt, dx = torch.empty_like(dtf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    for t in reversed(range(dt.shape[1])):
        dt_t, x_t, dy_t = dtf[:, t], xf[:, t], dyf[:, t]
        a = torch.exp(dt_t[..., None] * Af[None])                    # (B, di, N)
        g = g + dy_t[..., None] * Cf[:, t, None, :]                  # g_t
        gha = g * states[t] * a                                      # g_t h_{t-1} a_t
        u = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        dC[:, t] = torch.einsum("bd,bdn->bn", dy_t, states[t + 1])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dt_t * x_t)
        dx[:, t] = u * dt_t + dy_t * Df
        ddt[:, t] = u * x_t + (gha * Af[None]).sum(-1)
        dA = dA + (gha * dt_t[..., None]).sum(0)
        g = g * a
    dD = (dyf * xf).sum((0, 1))
    return (ddt.to(dt.dtype), dx.to(xf.dtype).to(x.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype), dA.to(A.dtype), dD.to(D.dtype), g.to(h0.dtype))


def _kernel():
    fn = _build.load("selective_scan.cu").selective_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(what, dt, x, Bm, Cm, A, D, h0, extra=()) -> None:
    """What both kernels refuse, before they look at the device: a d_state
    not in D_STATES, dtypes, layouts; then tensors not on one CUDA device."""
    N = A.shape[1]
    if N not in D_STATES:
        raise ValueError(f"{what} takes d_state in {D_STATES}, got {N}")
    f32 = (dt, Bm, Cm, A, D, h0, *extra)
    if any(t.dtype != torch.float32 for t in f32) \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes x in float32 or bfloat16 and the rest in "
                        f"float32, got dt, x, Bm, Cm, A, D, h0 "
                        f"{'and the cotangents ' if extra else ''}in "
                        f"{[t.dtype for t in (dt, x, Bm, Cm, A, D, h0, *extra)]}")
    if any(t.stride(2) != 1 for t in (dt, x, Bm, Cm)) \
            or not all(t.is_contiguous() for t in (A, D, h0)) \
            or A.data_ptr() % 16 or h0.data_ptr() % 16:
        raise ValueError(f"{what} needs unit stride over the last axis of dt, x, Bm, "
                         "Cm, contiguous A, D, h0, and A and h0 on 16 bytes")
    tensors = (dt, x, Bm, Cm, A, D, h0, *extra)
    if dt.device.type != "cuda" or any(t.device != dt.device for t in tensors):
        raise ValueError(f"{what} needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")


def selective_scan_cuda(dt, x, Bm, Cm, A, D, h0, *, return_states: bool = False):
    """The recurrence on a CUDA device by the hand-written kernel, on the
    current stream; one call is one launch.  dt, x, Bm and Cm are read
    through their strides (unit stride over the last axis required; Bm and
    Cm may be column slices of the ``x_proj`` output); A, D and h0
    contiguous, A and h0 starting on 16 bytes (the kernel reads their rows
    by 16-byte loads).  y comes back (B, S, di) float32 contiguous, h_T (B, di,
    N) float32.  With ``return_states`` it returns (y, h_T, states): the
    state before every STATES_EVERY-th step, (B, ceil(S / STATES_EVERY),
    di, N) float32, which the backward kernel takes (None for S <=
    STATES_EVERY, where the backward walks from h0); y and h_T are those
    of the call without, bit for bit.  Raises on a d_state the kernel was
    not built for (any not in D_STATES), on wrong dtypes or layouts (all
    before it looks at the device), on tensors not on one CUDA device, and if the launch is
    refused.  It computes no gradient itself: :class:`SelectiveScanFn`
    does."""
    global launches
    _check(dt, x, Bm, Cm, A, D, h0)
    _check_cuda("selective_scan_cuda", dt, x, Bm, Cm, A, D, h0)
    B, S, di = dt.shape
    N = A.shape[1]
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    hT = torch.empty((B, di, N), dtype=torch.float32, device=dt.device)
    states = None
    if return_states and S > STATES_EVERY:
        states = torch.empty((B, -(-S // STATES_EVERY), di, N), dtype=torch.float32,
                             device=dt.device)
    if B == 0 or di == 0:
        return (y, hT, states) if return_states else (y, hT)
    fn = _kernel()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (dt, x, Bm, Cm, A, D, h0, y, hT)),
                 None if states is None else states.data_ptr(),
                 B, S, di, N, int(x.dtype == torch.bfloat16),
                 *(st for t in (dt, x, Bm, Cm, y) for st in t.stride()[:2]), stream)
    if err:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return (y, hT, states) if return_states else (y, hT)


def _backward_kernel():
    """The launcher and the channels a block of ``csrc/selective_scan_bwd.cu``."""
    lib = _build.load("selective_scan_bwd.cu")
    fn = lib.selective_scan_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    every = (lib.selective_scan_bwd_states_every(),
             _build.load("selective_scan.cu").selective_scan_states_every())
    if every != (STATES_EVERY, STATES_EVERY):
        raise RuntimeError(f"selective_scan_bwd.cu walks spans of {every[0]} steps and "
                           f"selective_scan.cu stores states every {every[1]}: both must "
                           f"be STATES_EVERY = {STATES_EVERY}")
    return fn, lib.selective_scan_bwd_block_channels()


def selective_scan_backward_cuda(dt, x, Bm, Cm, A, D, h0, dy, dhT, *, states=None):
    """Gradients (ddt, dx, dBm, dCm, dA, dD, dh0) of the recurrence on a
    CUDA device by the hand-written backward kernel
    (``csrc/selective_scan_bwd.cu``: two launches, the walk and a
    fixed-order sum of its partials), on the current stream; one call
    counts one launch.  ``states`` is the forward's
    ``selective_scan_cuda(..., return_states=True)`` output, required for S
    > STATES_EVERY.  dt, x, Bm, Cm and dy are read through their strides
    (unit stride over the last axis: dt, x, Bm, Cm must have it, dy is made
    contiguous when it has not); A, D, h0 contiguous, A and h0 on 16 bytes;
    dhT made contiguous.  ddt (B, S, di) float32, dx in x's dtype, dBm and
    dCm (B, S, N), dA (di, N), dD (di,), dh0 (B, di, N), all contiguous
    float32 but dx.  Raises on anything the kernel does not take (before it
    looks at the device), on tensors not on one CUDA device, and if a
    launch is refused; it never falls back to the plain backward."""
    global launches_bwd
    _check(dt, x, Bm, Cm, A, D, h0)
    if dy.shape != dt.shape or dhT.shape != h0.shape:
        raise ValueError(f"selective_scan_backward_cuda: dy {tuple(dy.shape)} and dhT "
                         f"{tuple(dhT.shape)} do not fit dt {tuple(dt.shape)}")
    _check_cuda("selective_scan_backward_cuda", dt, x, Bm, Cm, A, D, h0, (dy, dhT))
    B, S, di = dt.shape
    N = A.shape[1]
    nc = -(-S // STATES_EVERY)
    if nc > 1 and states is None:
        raise ValueError(f"selective_scan_backward_cuda at S > {STATES_EVERY} needs the "
                         "forward's states: selective_scan_cuda(..., "
                         "return_states=True)[2]")
    if states is not None and (states.shape != (B, nc, di, N)
                               or states.dtype != torch.float32
                               or not states.is_contiguous()
                               or states.device != dt.device):
        raise ValueError(f"selective_scan_backward_cuda: states {tuple(states.shape)} "
                         f"{states.dtype} on {states.device} must be contiguous float32 "
                         f"{(B, nc, di, N)} on {dt.device}")
    if dy.stride(2) != 1:
        dy = dy.contiguous()
    dhT = dhT.contiguous()
    dev = dt.device
    ddt = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    dx = torch.empty((B, S, di), dtype=x.dtype, device=dev)
    dB, dC = (torch.empty((B, S, N), dtype=torch.float32, device=dev) for _ in range(2))
    if S == 0 or B == 0 or di == 0:
        return (ddt, dx, dB, dC, torch.zeros_like(A), torch.zeros_like(D),
                dhT.clone())
    dA = torch.empty((di, N), dtype=torch.float32, device=dev)
    dD = torch.empty((di,), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    # each channel block's dB_t | dC_t, and each b's dA and dD, summed by
    # the second launch in a fixed order
    fn, block_channels = _backward_kernel()
    part_bc = torch.empty((-(-di // block_channels), B, S, 2 * N), dtype=torch.float32,
                          device=dev)
    part_a = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    part_d = torch.empty((B, di), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (dt, x, Bm, Cm, A, D, h0, dy, dhT)),
                 None if states is None else states.data_ptr(),
                 *(t.data_ptr() for t in (ddt, dx, dB, dC, dA, dD, dh0, part_bc, part_a,
                                          part_d)),
                 B, S, di, N, int(x.dtype == torch.bfloat16),
                 *(st for t in (dt, x, Bm, Cm, dy) for st in t.stride()[:2]), stream)
    if err:
        raise RuntimeError(f"selective_scan backward kernel launch failed: CUDA error {err}")
    launches_bwd += 1
    return ddt, dx, dB, dC, dA, dD, dh0


class SelectiveScanFn(torch.autograd.Function):
    """The differentiable recurrence: (y, h_T) of dt, x, Bm, Cm, A, D, h0,
    forward and backward on the tensors' device — the plain versions for
    CPU tensors, the kernels for CUDA tensors (never one for the other).
    The backward takes dy and dh_T (zeros when h_T is unused) and returns
    dh0 too, so a carried state differentiates.  On CUDA tensors that need
    a gradient the forward kernel also stores the state before every
    STATES_EVERY-th step, which the backward kernel walks from: (B, S / 8,
    di, N) float32, 1.07 GB at jamba's (2, 4096, 16384, 16), held until the
    backward.  Under remat (non-reentrant ``torch.utils.checkpoint``) the
    first run's states are dropped with its other saved tensors, and the
    period's recompute stores them again for its own backward."""

    @staticmethod
    def forward(ctx, dt, x, Bm, Cm, A, D, h0):
        states = None
        if dt.device.type == "cpu":
            y, hT = selective_scan_plain(dt, x, Bm, Cm, A, D, h0)
        elif dt.device.type == "cuda":
            if any(ctx.needs_input_grad):
                y, hT, states = selective_scan_cuda(dt, x, Bm, Cm, A, D, h0,
                                                    return_states=True)
            else:
                y, hT = selective_scan_cuda(dt, x, Bm, Cm, A, D, h0)
        else:
            raise ValueError(f"selective_scan: no path for device {dt.device}")
        ctx.save_for_backward(dt, x, Bm, Cm, A, D, h0, states)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        dt, x, Bm, Cm, A, D, h0, states = ctx.saved_tensors
        if dt.device.type == "cpu":
            grads = selective_scan_backward_plain(dt, x, Bm, Cm, A, D, h0, dy, dhT)
        else:
            grads = selective_scan_backward_cuda(dt, x, Bm, Cm, A, D, h0, dy, dhT,
                                                 states=states)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
