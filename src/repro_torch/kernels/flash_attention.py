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

The gradient (the reference differentiates its jnp attention; there is no
Pallas backward) is :class:`FlashAttentionFn`: its forward saves q, k, v and
the output, and its backward gives dq, dk, dv from them and dO —
:func:`attention_backward_plain` for CPU tensors (scores materialised in
float32), :func:`flash_attention_backward_cuda` for CUDA tensors
(``csrc/flash_attention_bwd.cu``: per-row log-sum-exp and dO . O, then dK /
dV per kv tile summed over the query heads of its group inside the block,
then dQ per query tile; float32 CUDA-core products for both dtypes, no
atomics).  ``repro_torch.kernels.ops.attention`` goes through the Function
on both devices: plain forward and plain backward for CPU tensors, kernel
forward and kernel backward for CUDA tensors, which launch or raise; there
is no fallback.
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
# the backward (csrc/flash_attention_bwd.cu, both dtypes): q, k, v, out, dout,
# dq, dk, dv, lse and delta scratch; B, S, Hq, Hkv, hd; q, k, v's nine
# strides; causal, window, scale, bf16, stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                    ctypes.c_void_p])

# Launches since the last reset (set them to 0): of the float32 kernel
# (csrc/flash_attention.cu), of the bf16 tensor-core kernel
# (csrc/flash_attention_sm90.cu), and of the backward kernel
# (csrc/flash_attention_bwd.cu; one call, its three launches, counts one)
# on float32 and on bf16 inputs.
launches = 0
launches_bf16 = 0
launches_bwd = 0
launches_bwd_bf16 = 0


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions compute in float32, or in float64 on float64
    inputs (``torch.autograd.gradcheck``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


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
    qg = _wide(q.reshape(B, Sq, Hkv, G, hd)) / (hd ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, _wide(k))
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    s = torch.where(ok, s, s.new_full((), NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, _wide(v))
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of :func:`attention_plain` for the upstream ``dout``, in
    plain PyTorch with the scores materialised in float32 (the reference
    for the kernel, and the CPU path).  P is recomputed as the forward
    computes it; ``out`` is the forward's output (Delta = dO . O):

        dv = P^T dO,  dS = P * (dO V^T - Delta),  dq = dS K / sqrt(hd),
        dk = dS^T Q / sqrt(hd)      (dk, dv summed over each group's heads)

    Returns dq, dk, dv in q's, k's and v's dtypes."""
    _check(q, k, v)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = _wide(q.reshape(B, Sq, Hkv, G, hd)) / (hd ** 0.5)
    kf, vf = _wide(k), _wide(v)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    p = torch.softmax(torch.where(ok, s, s.new_full((), NEG_INF)), dim=-1)
    del s
    dog = _wide(dout.reshape(B, Sq, Hkv, G, hd))
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dog, _wide(out.reshape(B, Sq, Hkv, G, hd)))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dog, vf) - delta[..., None])
    del p
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) / (hd ** 0.5)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _launcher(dtype: torch.dtype):
    """The launch function of ``dtype``'s kernel, built at first use."""
    source, symbol = _KERNELS[dtype]
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str) -> None:
    """What both kernels (forward and backward) take; raises on anything
    else, whatever the device, and then on tensors not on one CUDA device."""
    _check(q, k, v)
    tensors = (q, k, v)
    if q.dtype not in _KERNELS or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {[t.dtype for t in tensors]}")
    S, Hq, hd = q.shape[1:]
    Hkv = k.shape[2]
    if k.shape[1] != S:
        raise ValueError(f"{what} needs Sq == Sk, got {S} and {k.shape[1]}")
    if hd > MAX_HEAD_DIM or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{what} takes hd <= {MAX_HEAD_DIM} and at most {MAX_GROUP} "
                         f"query heads per kv head, got hd={hd}, G={Hq // Hkv}")
    item = q.element_size()
    if any(t.stride(3) != 1 or t.data_ptr() % 16
           or any(st * item % 16 for st in (*t.stride()[:3], hd)) for t in tensors):
        raise ValueError(f"{what} needs unit stride over head_dim and every row on "
                         "16 bytes (hd * itemsize, the other strides times itemsize "
                         "and the pointers multiples of 16)")
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{what} needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, S, Hq, hd) attention on a CUDA device by the hand-written kernel
    of the tensors' dtype (bf16: wgmma; float32: 3xTF32 mma.sync), on the
    current stream; the result is (B, S, Hq, hd) contiguous in q's dtype.
    q, k and v are read through their strides (unit stride over hd and rows
    on 16 bytes required: the kernels copy 16 bytes or TMA boxes).  Raises
    on anything the kernels do not take (whatever the device), on tensors
    not on one CUDA device, and if the launch is refused.  It computes no
    gradient itself: :class:`FlashAttentionFn` does."""
    global launches, launches_bf16
    _check_cuda(q, k, v, "flash_attention_cuda")
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
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


def _backward_launcher():
    fn = _build.load("flash_attention_bwd.cu").flash_attention_bwd_launch
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  out: torch.Tensor, dout: torch.Tensor, *,
                                  causal: bool = True, window: int = 0
                                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of the attention on a CUDA device by the hand-written
    backward kernel (``csrc/flash_attention_bwd.cu``, float32 or bf16 inputs,
    float32 sums), on the current stream: three launches, counted as one.
    q, k, v are read through their strides under the forward's checks;
    ``out`` (the forward's output) and ``dout`` are made contiguous here
    when they are not (a copy; the kernel reads them as (B, S, Hq, hd)
    rows).  dq comes back (B, S, Hq, hd), dk and dv (B, S, Hkv, hd),
    contiguous, in the inputs' dtype.  Raises where the forward raises and
    if a launch is refused."""
    global launches_bwd, launches_bwd_bf16
    if out.shape != q.shape or dout.shape != q.shape \
            or any(t.dtype != q.dtype for t in (out, dout)):
        raise ValueError(f"flash_attention_backward_cuda: out {tuple(out.shape)} "
                         f"{out.dtype} and dout {tuple(dout.shape)} {dout.dtype} must "
                         f"match q {tuple(q.shape)} {q.dtype}")
    _check_cuda(q, k, v, "flash_attention_backward_cuda")
    if any(t.device != q.device for t in (out, dout)):
        raise ValueError("flash_attention_backward_cuda needs CUDA tensors on one "
                         f"device, got q on {q.device}, out on {out.device}, dout on "
                         f"{dout.device}")
    out, dout = out.contiguous(), dout.contiguous()
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    dq = torch.empty_like(out)
    dk = torch.empty((B, S, Hkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk, dv
    # per (b, query head, row): the log-sum-exp of the scaled scores (log2
    # units) and Delta = dO . O
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    pointers = (q, k, v, out, dout, dq, dk, dv, lse, delta)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    launch = _backward_launcher()
    bf16 = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(*(t.data_ptr() for t in pointers), B, S, Hq, Hkv, hd, *strides,
                     int(causal), int(window), 1.0 / (hd ** 0.5), int(bf16), stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {err}")
    if bf16:
        launches_bwd_bf16 += 1
    else:
        launches_bwd += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable attention: forward and backward on the tensors'
    device — plain versions for CPU tensors, the kernels for CUDA tensors
    (never one for the other).  The forward saves q, k, v and its output,
    and hands the same output to whichever backward runs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if q.device.type == "cpu":
            out = attention_plain(q, k, v, causal=causal, window=window)
        elif q.device.type == "cuda":
            out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        else:
            raise ValueError(f"attention: no path for device {q.device}")
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        backward = (attention_backward_plain if q.device.type == "cpu"
                    else flash_attention_backward_cuda)
        grads = backward(q, k, v, out, dout, causal=ctx.causal, window=ctx.window)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)
