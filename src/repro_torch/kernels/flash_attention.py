"""Causal / sliding-window GQA attention: plain PyTorch version + Hopper
kernel.

Port of ``repro.kernels.flash_attention`` (``flash_attention``, the Pallas
online-softmax kernel) with the semantics of its oracle
``repro.kernels.ref.attention_ref``.  For q (B, S, Hq, hd) and k, v
(B, S, Hkv, hd), query head h reads kv head ``h // (Hq // Hkv)``:

    s[q, k]  = q_q . k_k / sqrt(hd), set to NEG_INF = -1e30 unless
               k <= q (causal) and q - k < window (window > 0)
    out[q]   = softmax_k(s[q, :]) @ v          (fp32 inside, q's dtype out)

:func:`attention_plain` follows ``attention_ref`` (materialises the scores);
:func:`flash_attention_cuda` launches a hand-written kernel on the tensors'
strides, with no transposes and any S, chosen by the tensors' dtype: bf16
goes to ``csrc/flash_attention_sm90.cu`` (TMA, wgmma), float32 to
``csrc/flash_attention.cu`` (mma.sync in 3xTF32: each float32 operand split
into two TF32 terms, so the tensor cores keep float32 accuracy).
``repro_torch.kernels.ops.attention`` picks by where the tensors lie: the
plain version for CPU tensors, a kernel for CUDA tensors, which launches or
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_GROUP = 16            # query heads per kv head: the kernels' rows a block
# each input dtype's kernel: its source and launch function (the same
# arguments: q, k, v, out; B, S, Hq, Hkv, hd; the nine strides; causal,
# window, scale, stream)
_KERNELS = {torch.float32: ("flash_attention.cu", "flash_attention_launch"),
            torch.bfloat16: ("flash_attention_sm90.cu", "flash_attention_sm90_launch")}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

# Launches since the last reset (set them to 0): of the float32 kernel
# (csrc/flash_attention.cu) and of the bf16 tensor-core kernel
# (csrc/flash_attention_sm90.cu).
launches = 0
launches_bf16 = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention takes q (B, S, Hq, hd) and k, v (B, S, Hkv, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % k.shape[2]:
        raise ValueError(f"attention: k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive softmax attention with GQA, in plain PyTorch on the tensors'
    own device (``ref.attention_ref``: the reference for the kernel, and the
    CPU path).  Sq and Sk may differ; positions are 0..S-1 on both."""
    _check(q, k, v)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd).float() / (hd ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    s = torch.where(ok, s, s.new_full((), NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def _launcher(dtype: torch.dtype):
    """The launch function of ``dtype``'s kernel, built at first use."""
    source, symbol = _KERNELS[dtype]
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, S, Hq, hd) attention on a CUDA device by the hand-written kernel
    of the tensors' dtype (bf16: wgmma; float32: 3xTF32 mma.sync), on the
    current stream; the result is (B, S, Hq, hd) contiguous in q's dtype.
    q, k and v are read through their strides (unit stride over hd and rows
    on 16 bytes required: the kernels copy 16 bytes or TMA boxes).  Raises
    on anything the kernels do not take (whatever the device), on an input
    that requires grad (they have no backward yet), on tensors not on one
    CUDA device, and if the launch is refused."""
    global launches, launches_bf16
    _check(q, k, v)
    tensors = (q, k, v)
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("flash_attention_cuda has no backward kernel yet: "
                           "call it under torch.no_grad() or inference_mode()")
    if q.dtype not in _KERNELS or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {[t.dtype for t in tensors]}")
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if k.shape[1] != S:
        raise ValueError(f"flash_attention_cuda needs Sq == Sk, got {S} and {k.shape[1]}")
    if hd > MAX_HEAD_DIM or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_attention_cuda takes hd <= {MAX_HEAD_DIM} and at "
                         f"most {MAX_GROUP} query heads per kv head, got hd={hd}, "
                         f"G={Hq // Hkv}")
    item = q.element_size()
    if any(t.stride(3) != 1 or t.data_ptr() % 16
           or any(st * item % 16 for st in (*t.stride()[:3], hd)) for t in tensors):
        raise ValueError("flash_attention_cuda needs unit stride over head_dim and "
                         "every row on 16 bytes (hd * itemsize, the other strides "
                         "times itemsize and the pointers multiples of 16)")
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention_cuda needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    launch = _launcher(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(*pointers, B, S, Hq, Hkv, hd, *strides, int(causal), int(window),
                     1.0 / (hd ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    if q.dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return out
