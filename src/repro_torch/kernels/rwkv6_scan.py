"""RWKV6 wkv recurrence with data-dependent decay: plain PyTorch version +
Hopper kernel.

Port of ``repro.kernels.rwkv6_scan`` (``rwkv6_scan``, the Pallas kernel)
with the semantics of its oracle ``repro.kernels.ref.rwkv6_scan_ref``.  Per
(batch, head), r, k, v, w (B, H, T, hd) float32, u (H, hd), state S
(hd_k, hd_v) starting at s0 (B, H, hd, hd):

    y_t = r_t . (S + (u * k_t) v_t^T)
    S  <- diag(w_t) S + k_t v_t^T

returning (y (B, H, T, hd), S_T).  Calls compose: two halves with the state
carried give the whole.

:func:`rwkv6_plain` is the oracle's step loop; :func:`rwkv6_cuda` launches
the hand-written kernels (``csrc/rwkv6_scan.cu``), reading r, k, v, w through
their strides: for T >= CHUNK the chunked-parallel form (one block a
chunk, each chunk's state handed to the next), for shorter T (decode) the
recurrent kernel.  ``repro_torch.kernels.ops.rwkv6_wkv`` picks by where the
tensors lie: the plain version for CPU tensors, the kernel for CUDA tensors,
which launches or raises; there is no fallback.

The gradient (the reference differentiates its ``lax.scan``; there is no
Pallas backward) is :class:`Rwkv6Fn`, whose backward carries dS backward in
time from dS_T:

    dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t      du += r_t * k_t (v_t . dy_t)
    dk_t = r_t * u (v_t . dy_t) + dS_t v_t         dw_t = rowsum(dS_t * S_{t-1})
    dv_t = (sum_i r_t u k_t) dy_t + dS_t^T k_t     dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T

ending with ds0 = dS_0 (du summed over the batch).  For CPU tensors
:func:`rwkv6_backward_plain` (every state kept), for CUDA tensors
:func:`rwkv6_backward_cuda` (``csrc/rwkv6_scan_bwd.cu``: one launch, a
block a chunk of CHUNK steps, dS handed from chunk to chunk in reverse and
each chunk's steps walked from the state it starts from, which the forward
kernel stores when asked; no division by w, which may be 0).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64, 128)
BWD_HEAD_DIMS = (16, 32, 64)  # csrc/rwkv6_scan_bwd.cu's instances
CHUNK = 64                # csrc/rwkv6_scan.cu's kChunk: T >= CHUNK runs chunked

# Launches since the last reset (set them to 0): of rwkv6_cuda, and of
# rwkv6_backward_cuda (one call, its two launches, counts one).
launches = 0
launches_bwd = 0


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions compute in float32, or in float64 on float64
    inputs (``torch.autograd.gradcheck``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6 takes r, k, v, w of one shape (B, H, T, hd), got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, _, hd = r.shape
    if u.shape != (H, hd) or s0.shape != (B, H, hd, hd):
        raise ValueError(f"rwkv6: u {tuple(u.shape)} and s0 {tuple(s0.shape)} do "
                         f"not fit r {tuple(r.shape)}")


def rwkv6_plain(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence step by step in plain PyTorch on the tensors' own
    device (``ref.rwkv6_scan_ref``: the reference for the kernel, and the
    CPU path).  Returns (y in r's dtype, S_T in float32, float64 for
    float64 inputs)."""
    _check(r, k, v, w, u, s0)
    rf, kf, vf, wf = (_wide(t) for t in (r, k, v, w))
    uf = _wide(u)[None, :, :, None]
    s = _wide(s0)
    ys = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], s + uf * kv))
        s = s * wf[:, :, t, :, None] + kv
    y = torch.stack(ys, dim=2) if ys else rf.new_zeros(r.shape)
    return y.to(r.dtype), s


def rwkv6_backward_plain(r, k, v, w, u, s0, dy, dsT):
    """Gradients (dr, dk, dv, dw, du, ds0) of :func:`rwkv6_plain` for the
    upstream dy (B, H, T, hd) and dS_T (B, H, hd, hd): the reverse loop in
    plain PyTorch, from every state of a forward pass kept (the reference
    for the kernel, and the CPU path).  Each gradient in its input's dtype."""
    _check(r, k, v, w, u, s0)
    rf, kf, vf, wf, dyf = (_wide(t) for t in (r, k, v, w, dy))
    uf = _wide(u)[None]
    s = _wide(s0)
    states = []
    for t in range(r.shape[2]):
        states.append(s)
        s = s * wf[:, :, t, :, None] + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    g = _wide(dsT)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(rf[:, :, 0])
    for t in reversed(range(r.shape[2])):
        rt, kt, vt, wt, dyt = (x[:, :, t] for x in (rf, kf, vf, wf, dyf))
        vdy = (vt * dyt).sum(-1, keepdim=True)
        bonus = (rt * uf * kt).sum(-1, keepdim=True)
        dr[:, :, t] = torch.einsum("bhkv,bhv->bhk", states[t], dyt) + uf * kt * vdy
        dk[:, :, t] = rt * uf * vdy + torch.einsum("bhkv,bhv->bhk", g, vt)
        dv[:, :, t] = bonus * dyt + torch.einsum("bhkv,bhk->bhv", g, kt)
        dw[:, :, t] = (g * states[t]).sum(-1)
        du = du + rt * kt * vdy
        g = g * wt[..., None] + rt[..., None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.sum(0).to(u.dtype), g.to(s0.dtype))


def _kernel() -> ctypes.CDLL:
    lib = _build.load("rwkv6_scan.cu")
    fn = lib.rwkv6_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 15 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    if lib.rwkv6_scan_chunk() != CHUNK:
        raise RuntimeError(f"rwkv6_scan.cu chunks {lib.rwkv6_scan_chunk()} steps, "
                           f"the wrapper expects {CHUNK}")
    return lib


def rwkv6_cuda(r, k, v, w, u, s0, *, return_states: bool = False):
    """The recurrence on a CUDA device by the hand-written kernels (chunked
    for T >= CHUNK, recurrent below), on the current stream; one call counts
    one launch.  r, k, v, w are read through their strides (unit stride
    over hd required); y comes back as a (B, H, T, hd) view of (B, T, H, hd)
    memory, so the model's transpose back to (B, T, H * hd) is free.  With
    ``return_states`` it returns (y, S_T, states): the state each chunk of
    CHUNK steps starts from, (B, H, ceil(T / CHUNK), hd, hd) float32, which
    the backward kernel takes (None below CHUNK steps, where the backward
    needs none); without, the kernel stores none.  Raises on anything the
    kernels do not take (before it looks at the device), on tensors not on
    one CUDA device, and if a launch is refused.  It computes no gradient
    itself: :class:`Rwkv6Fn` does."""
    global launches
    _check(r, k, v, w, u, s0)
    tensors = (r, k, v, w, u, s0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"rwkv6_cuda takes float32 inputs, got "
                        f"{[t.dtype for t in tensors]}")
    B, H, T, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_cuda takes hd in {HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (r, k, v, w)) \
            or not (u.is_contiguous() and s0.is_contiguous()):
        raise ValueError("rwkv6_cuda needs unit stride over hd and contiguous u, s0")
    chunked = T >= CHUNK
    if chunked and any(t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:3])
                       for t in (r, k, v, w)):
        raise ValueError(f"rwkv6_cuda at T >= {CHUNK} (the chunked form) needs every "
                         "row of r, k, v, w on 16 bytes (pointers and strides)")
    if r.device.type != "cuda" or any(t.device != r.device for t in tensors):
        raise ValueError("rwkv6_cuda needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device).transpose(1, 2)
    sT = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    scratch = (None, None)
    states = None
    if chunked:
        # two state slots a (b, h), handed from chunk to chunk, and the
        # ticket counter and one flag a chunk (zeroed)
        slots = torch.empty((B, H, 2, hd, hd), dtype=torch.float32, device=r.device)
        sync = torch.zeros(1 + B * H * -(-T // CHUNK), dtype=torch.int32, device=r.device)
        scratch = (slots.data_ptr(), sync.data_ptr())
        if return_states:
            states = torch.empty((B, H, -(-T // CHUNK), hd, hd), dtype=torch.float32,
                                 device=r.device)
    lib = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_scan_launch(
            *(t.data_ptr() for t in (r, k, v, w, u, s0, y, sT)), *scratch, B, H, T, hd,
            *(s for t in (r, k, v, w, y) for s in t.stride()[:3]),
            None if states is None else states.data_ptr(), stream)
    if err:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    return (y, sT, states) if return_states else (y, sT)


def _backward_kernel():
    fn = _build.load("rwkv6_scan_bwd.cu").rwkv6_scan_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 27 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _rows_on_16_bytes(t: torch.Tensor) -> bool:
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
        and all(st % 4 == 0 for st in t.stride()[:3])


def rwkv6_backward_cuda(r, k, v, w, u, s0, dy, dsT, *, states=None):
    """Gradients (dr, dk, dv, dw, du, ds0) of the recurrence on a CUDA
    device by the hand-written backward kernel (``csrc/rwkv6_scan_bwd.cu``:
    one launch, a block a chunk of CHUNK steps), on the current stream; one
    call counts one launch.  ``states`` is the forward's
    ``rwkv6_cuda(..., return_states=True)`` output, the state each chunk
    starts from; it is required for T > CHUNK.  r, k, v, w
    and dy are read through their strides (unit stride over hd and rows on
    16 bytes: r, k, v, w must have them, dy is made contiguous when it has
    not); s0 contiguous, dsT made so.  dr, dk, dv, dw come back as (B, H, T,
    hd) views of (B, T, H, hd) memory, du (H, hd) summed over the chunks and
    the batch in a fixed order, ds0 (B, H, hd, hd).  Raises on anything the
    kernel does not take (before it looks at the device), on tensors not on
    one CUDA device, and if a launch is refused."""
    global launches_bwd
    _check(r, k, v, w, u, s0)
    B, H, T, hd = r.shape
    nc = -(-T // CHUNK)
    if nc > 1 and states is None:
        raise ValueError(f"rwkv6_backward_cuda at T > {CHUNK} needs the forward's chunk "
                         "states: rwkv6_cuda(..., return_states=True)[2]")
    if states is not None and (states.shape != (B, H, nc, hd, hd)
                               or states.dtype != torch.float32
                               or not states.is_contiguous()):
        raise ValueError(f"rwkv6_backward_cuda: states {tuple(states.shape)} "
                         f"{states.dtype} must be contiguous float32 "
                         f"{(B, H, nc, hd, hd)}")
    tensors = (r, k, v, w, u, s0, dy, dsT)
    if dy.shape != r.shape or dsT.shape != s0.shape:
        raise ValueError(f"rwkv6_backward_cuda: dy {tuple(dy.shape)} and dsT "
                         f"{tuple(dsT.shape)} do not fit r {tuple(r.shape)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"rwkv6_backward_cuda takes float32 inputs, got "
                        f"{[t.dtype for t in tensors]}")
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"rwkv6_backward_cuda takes hd in {BWD_HEAD_DIMS}, got {hd}")
    if not all(_rows_on_16_bytes(t) for t in (r, k, v, w)) \
            or not (u.is_contiguous() and s0.is_contiguous()):
        raise ValueError("rwkv6_backward_cuda needs unit stride over hd and every row "
                         "of r, k, v, w on 16 bytes (pointers and strides), and "
                         "contiguous u, s0")
    if r.device.type != "cuda" or any(t.device != r.device for t in tensors):
        raise ValueError("rwkv6_backward_cuda needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not _rows_on_16_bytes(dy):
        dy = dy.contiguous()
    dsT = dsT.contiguous()
    grads = [torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device
                         ).transpose(1, 2) for _ in range(4)]      # dr, dk, dv, dw
    if T == 0:
        return (*grads, torch.zeros_like(u), dsT.clone())
    if states is not None and states.device != r.device:
        raise ValueError(f"rwkv6_backward_cuda: states on {states.device}, r on {r.device}")
    du = torch.empty((H, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    # dS handed between chunks (two slots a (b, h)), each chunk's du, and
    # (zeroed) the ticket counter, one flag a chunk and the ticket of each
    # head's last block, which sums du over the chunks and the batch
    slots = torch.empty((B, H, 2, hd, hd), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, nc, hd), dtype=torch.float32, device=r.device)
    sync = torch.zeros(1 + B * H * nc + H, dtype=torch.int32, device=r.device)
    seqs = (r, k, v, w, dy, *grads)
    fn = _backward_kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (*seqs, u, s0, dsT)),
                 None if states is None else states.data_ptr(),
                 *(t.data_ptr() for t in (du, ds0, slots, du_part, sync)),
                 B, H, T, hd, *(st for t in seqs for st in t.stride()[:3]), stream)
    if err:
        raise RuntimeError(f"rwkv6 backward kernel launch failed: CUDA error {err}")
    launches_bwd += 1
    dr, dk, dv, dw = grads
    return dr, dk, dv, dw, du, ds0


class Rwkv6Fn(torch.autograd.Function):
    """The differentiable recurrence: (y, S_T) of r, k, v, w, u, s0, forward
    and backward on the tensors' device — plain versions for CPU tensors,
    the kernels for CUDA tensors (never one for the other).  The backward
    takes dy and dS_T (zeros when S_T is unused) and returns ds0 too, so a
    carried state differentiates.  On CUDA tensors that need a gradient the
    forward kernel also stores the state each chunk starts from, which the
    backward kernel walks from: (B, H, ceil(T / CHUNK), hd, hd) float32,
    84 MB at (2, 40, 4096, 64), held until the backward.  Under remat a
    layer's states live only through its own backward; without remat every
    layer's are held at once (about 2.7 GB at 32 such layers)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        states = None
        if r.device.type == "cpu":
            y, sT = rwkv6_plain(r, k, v, w, u, s0)
        elif r.device.type == "cuda":
            if any(ctx.needs_input_grad) and r.shape[3] in BWD_HEAD_DIMS:
                y, sT, states = rwkv6_cuda(r, k, v, w, u, s0, return_states=True)
            else:
                y, sT = rwkv6_cuda(r, k, v, w, u, s0)
        else:
            raise ValueError(f"rwkv6_wkv: no path for device {r.device}")
        ctx.save_for_backward(r, k, v, w, u, s0, states)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, w, u, s0, states = ctx.saved_tensors
        if r.device.type == "cpu":
            grads = rwkv6_backward_plain(r, k, v, w, u, s0, dy, dsT)
        else:
            grads = rwkv6_backward_cuda(r, k, v, w, u, s0, dy, dsT, states=states)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
