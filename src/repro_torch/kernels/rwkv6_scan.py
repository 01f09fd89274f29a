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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64, 128)
CHUNK = 64                # csrc/rwkv6_scan.cu's kChunk: T >= CHUNK runs chunked

# Launches of rwkv6_cuda since the last reset (set it to 0).
launches = 0


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
    CPU path).  Returns (y in r's dtype, S_T float32)."""
    _check(r, k, v, w, u, s0)
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = s0.float()
    ys = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], s + uf * kv))
        s = s * wf[:, :, t, :, None] + kv
    y = torch.stack(ys, dim=2) if ys else rf.new_zeros(r.shape)
    return y.to(r.dtype), s


def _kernel() -> ctypes.CDLL:
    lib = _build.load("rwkv6_scan.cu")
    fn = lib.rwkv6_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if lib.rwkv6_scan_chunk() != CHUNK:
        raise RuntimeError(f"rwkv6_scan.cu chunks {lib.rwkv6_scan_chunk()} steps, "
                           f"the wrapper expects {CHUNK}")
    return lib


def rwkv6_cuda(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence on a CUDA device by the hand-written kernels (chunked
    for T >= CHUNK, recurrent below), on the current stream; one call counts
    one launch.  r, k, v, w are read through their strides (unit stride
    over hd required); y comes back as a (B, H, T, hd) view of (B, T, H, hd)
    memory, so the model's transpose back to (B, T, H * hd) is free.  Raises
    on anything the kernels do not take (before it looks at the device), on
    an input that requires grad (they have no backward yet), on tensors not
    on one CUDA device, and if a launch is refused."""
    global launches
    _check(r, k, v, w, u, s0)
    tensors = (r, k, v, w, u, s0)
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("rwkv6_cuda has no backward kernel yet: call it "
                           "under torch.no_grad() or inference_mode()")
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
    if chunked:
        # two state slots a (b, h), handed from chunk to chunk, and the
        # ticket counter and one flag a chunk (zeroed)
        slots = torch.empty((B, H, 2, hd, hd), dtype=torch.float32, device=r.device)
        sync = torch.zeros(1 + B * H * -(-T // CHUNK), dtype=torch.int32, device=r.device)
        scratch = (slots.data_ptr(), sync.data_ptr())
    lib = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_scan_launch(
            *(t.data_ptr() for t in (r, k, v, w, u, s0, y, sT)), *scratch, B, H, T, hd,
            *(s for t in (r, k, v, w, y) for s in t.stride()[:3]), stream)
    if err:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    return y, sT
