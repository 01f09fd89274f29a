"""Causal / sliding-window / full GQA attention: plain PyTorch version +
Hopper kernel.

Port of ``repro.kernels.flash_attention`` (``flash_attention``, the Pallas
online-softmax kernel) with the semantics of its oracle
``repro.kernels.ref.attention_ref``, and of the reference's
``repro.models.attention.attend_full`` where the lengths differ.  For q
(B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd), query head h reads kv head
``h // (Hq // Hkv)``, positions 0..Sq-1 against 0..Sk-1:

    s[q, k]  = q_q . k_k / sqrt(hd), set to NEG_INF = -1e30 unless
               k <= q (causal) and q - k < window (window > 0)
    out[q]   = softmax_k(s[q, :]) @ v          (fp32 inside, q's dtype out)

(a row the mask empties is the softmax of Sk equal scores: the mean of v).
Sq != Sk is the decoder's cross-attention over the encoder's frames.
:func:`attention_plain` follows ``attention_ref`` (materialises the scores);
:func:`flash_attention_cuda` launches a hand-written kernel on the tensors'
strides, with no transposes and any Sq, Sk, chosen by the tensors' dtype: bf16
goes to ``csrc/flash_attention_sm90.cu`` (TMA, wgmma), float32 to
``csrc/flash_attention.cu`` (mma.sync in 3xTF32: each float32 operand split
into two TF32 terms, so the tensor cores keep float32 accuracy).

The gradient (the reference differentiates its jnp attention; there is no
Pallas backward) is :class:`FlashAttentionFn`: its forward saves q, k, v and
the output (and, for CUDA tensors, each row's log-sum-exp L, which the
forward kernel writes), and its backward gives dq, dk, dv from them and dO
— :func:`attention_backward_plain` for CPU tensors (scores materialised in
float32), :func:`flash_attention_backward_cuda` for CUDA tensors, both
dtypes at any Sq and Sk in three launches (dO . O, then dK / dV per kv tile
summed over the query heads of its group inside the block, then dQ per
query tile) with the forward's L: bf16 goes to
``csrc/flash_attention_bwd_sm90.cu`` (every product on wgmma, P and dS in
two bf16 terms; at head_dim <= 64 a pair of kernels of its own,
:func:`bwd_sm90_plan`), float32 to ``csrc/flash_attention_bwd.cu`` (every
product on mma.sync in 3xTF32, P and dS split like the inputs); neither
uses atomics.  ``repro_torch.kernels.ops.attention`` goes through the
Function on both devices: plain forward and plain backward for CPU
tensors, kernel forward and kernel backward for CUDA tensors, which launch
or raise; there is no fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 256
MAX_GROUP = 16            # query heads per kv head: the kernels' rows a block
# each input dtype's kernel: its source, launch function and argument types
# (q, k, v, out; B, Sq, Sk, Hq, Hkv, hd; the nine strides; causal, window,
# scale; the lse buffer or null; stream)
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
         + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 2)
# the bf16 kernel also takes the plan's kernel (sm90_plan) before the lse buffer
_ARGS_SM90 = _ARGS[:-2] + [ctypes.c_int] + _ARGS[-2:]
_KERNELS = {torch.float32: ("flash_attention.cu", "flash_attention_launch", _ARGS),
            torch.bfloat16: ("flash_attention_sm90.cu", "flash_attention_sm90_launch",
                             _ARGS_SM90)}
# the backward kernels, float32 csrc/flash_attention_bwd.cu and bf16
# csrc/flash_attention_bwd_sm90.cu: q, k, v, out, dout, the forward's lse,
# dq, dk, dv, delta scratch; B, Sq, Sk, Hq, Hkv, hd; q, k, v's nine strides;
# causal, window, scale, (bf16: the plan's kernel, bwd_sm90_plan,) stream
_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_BWD_ARGS_SM90 = _BWD_ARGS[:-1] + [ctypes.c_int] + _BWD_ARGS[-1:]
_BWD_KERNELS = {
    torch.float32: ("flash_attention_bwd.cu", "flash_attention_bwd_launch", _BWD_ARGS),
    torch.bfloat16: ("flash_attention_bwd_sm90.cu", "flash_attention_bwd_sm90_launch",
                     _BWD_ARGS_SM90)}

# Launches since the last reset (set them to 0): of the float32 kernel
# (csrc/flash_attention.cu), of the bf16 tensor-core kernel
# (csrc/flash_attention_sm90.cu), and of the backward kernels on float32
# (csrc/flash_attention_bwd.cu) and on bf16 inputs
# (csrc/flash_attention_bwd_sm90.cu); one backward call, its three
# launches, counts one.
launches = 0
launches_bf16 = 0
launches_bwd = 0
launches_bwd_bf16 = 0


@dataclasses.dataclass(frozen=True)
class Sm90Plan:
    """Which kernel of ``csrc/flash_attention_sm90.cu`` takes a bf16 call:
    ``kernel`` is the launcher's number for it, ``ctas_per_sm`` the CTAs an
    SM its registers and shared memory are laid out for."""
    name: str
    kernel: int
    ctas_per_sm: int


def sm90_plan(hd: int) -> Sm90Plan:
    """The bf16 kernel for head_dim ``hd``: up to 64 the hd-64 kernel (64-key
    tiles, two CTAs an SM: at hd 64 the softmax costs about what the
    products cost, and four warpgroups an SM hide more of it than one
    warpgroup's own products do); up to 128 the narrow kernel (128-key
    tiles, one CTA, each warpgroup's softmax under its own products); up
    to 256 the wide kernel (64-key tiles, the warpgroups taking turns)."""
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"the bf16 flash kernels take head_dim 1..{MAX_HEAD_DIM}, got {hd}")
    if hd <= 64:
        return Sm90Plan("flash_sm90_hd64_kernel", 0, 2)
    if hd <= 128:
        return Sm90Plan("flash_sm90_narrow_kernel<2>", 1, 1)
    return Sm90Plan(f"flash_sm90_kernel<{(hd + 63) // 64}>", 2, 1)


def sm90_occupancy(hd: int) -> dict:
    """The registers a thread and the CTAs an SM of the built bf16 kernel
    that runs at head_dim ``hd`` (the runtime's occupancy with its shared
    memory); raises if they are not the CTAs an SM its plan is laid out
    for.  Needs the card."""
    plan = sm90_plan(hd)
    fn = _build.load(_KERNELS[torch.bfloat16][0]).flash_attention_sm90_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    err = fn(plan.kernel, hd, ctypes.byref(regs), ctypes.byref(ctas))
    if err:
        raise RuntimeError(f"flash_attention_sm90_occupancy failed: CUDA error {err}")
    if ctas.value != plan.ctas_per_sm:
        raise RuntimeError(f"{plan.name} fits {ctas.value} CTAs an SM at {regs.value} "
                           f"registers a thread, not the {plan.ctas_per_sm} it is laid out for")
    return {"kernel": plan.name, "registers": regs.value, "ctas_per_sm": ctas.value}


@dataclasses.dataclass(frozen=True)
class BwdSm90Plan:
    """Which kernels of ``csrc/flash_attention_bwd_sm90.cu`` take a bf16
    backward: ``kernel`` is the launcher's number for them, ``dkdv`` and
    ``dq`` the dK / dV and dQ kernels' names, ``ctas_per_sm`` the CTAs an SM
    each is laid out for (dK / dV, dQ)."""
    name: str
    kernel: int
    dkdv: str
    dq: str
    ctas_per_sm: tuple[int, int]


def bwd_sm90_plan(hd: int) -> BwdSm90Plan:
    """The bf16 backward kernels for head_dim ``hd``: up to 64 the hd-64
    pair (each warpgroup owns 64 keys of a 128-key dK / dV CTA and feeds P^T
    and dS^T to its products from registers; dQ over 64-key tiles); above,
    the template at ceil(hd / 64) head-dim boxes (64 keys a dK / dV CTA
    shared by both warpgroups through shared memory; dQ over 32-key
    tiles)."""
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"the bf16 flash backward takes head_dim 1..{MAX_HEAD_DIM}, got {hd}")
    if hd <= 64:
        return BwdSm90Plan("flash_bwd_hd64", 0, "dkdv_hd64_kernel", "dq_hd64_kernel", (1, 2))
    nch = (hd + 63) // 64
    return BwdSm90Plan(f"flash_bwd<{nch}>", 1, f"dkdv_kernel<{nch}>", f"dq_kernel<{nch}>",
                       (1, 1))


def bwd_sm90_occupancy(hd: int) -> dict:
    """The registers a thread and the CTAs an SM of the built dK / dV and dQ
    kernels that run a bf16 backward at head_dim ``hd`` (the runtime's
    occupancy with their shared memory); raises if either's CTAs an SM are
    not its plan's.  Needs the card."""
    plan = bwd_sm90_plan(hd)
    fn = _build.load(_BWD_KERNELS[torch.bfloat16][0]).flash_attention_bwd_sm90_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {"kernel": plan.name}
    for which, (name, want) in enumerate(zip((plan.dkdv, plan.dq), plan.ctas_per_sm)):
        regs, ctas = ctypes.c_int(), ctypes.c_int()
        err = fn(plan.kernel, hd, which, ctypes.byref(regs), ctypes.byref(ctas))
        if err:
            raise RuntimeError(f"flash_attention_bwd_sm90_occupancy failed: CUDA error {err}")
        if ctas.value != want:
            raise RuntimeError(f"{name} fits {ctas.value} CTAs an SM at {regs.value} "
                               f"registers a thread, not the {want} it is laid out for")
        out[("dkdv", "dq")[which]] = {"name": name, "registers": regs.value,
                                      "ctas_per_sm": ctas.value}
    return out


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions compute in float32, or in float64 on float64
    inputs (``torch.autograd.gradcheck``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention takes q (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % k.shape[2]:
        raise ValueError(f"attention: k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int
                   ) -> torch.Tensor:
    """The scaled scores (B, Hkv, G, Sq, Sk) in float32 (float64 on float64
    inputs), NEG_INF where the mask drops a pair; positions 0..Sq-1 against
    0..Sk-1."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = _wide(q.reshape(B, Sq, Hkv, Hq // Hkv, hd)) / (hd ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, _wide(k))
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    return torch.where(ok, s, s.new_full((), NEG_INF))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive softmax attention with GQA, in plain PyTorch on the tensors'
    own device (``ref.attention_ref``: the reference for the kernel, and the
    CPU path).  Sq and Sk may differ; positions are 0..Sq-1 against
    0..Sk-1, as the reference's ``attend_full`` defaults them."""
    _check(q, k, v)
    B, Sq, Hq, hd = q.shape
    p = torch.softmax(_masked_scores(q, k, causal, window), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, _wide(v))
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp of the scaled, masked scores of
    :func:`attention_plain`, in log2 units, float32 (B, Hq, Sq): the plain
    version of the L that the forward kernels write for their backward
    (``flash_attention_cuda(..., return_lse=True)``)."""
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, causal, window), dim=-1)
    return (lse * LOG2E).reshape(B, Hq, Sq).float()


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
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = _wide(q.reshape(B, Sq, Hkv, G, hd)) / (hd ** 0.5)
    kf, vf = _wide(k), _wide(v)
    p = torch.softmax(_masked_scores(q, k, causal, window), dim=-1)
    dog = _wide(dout.reshape(B, Sq, Hkv, G, hd))
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dog, _wide(out.reshape(B, Sq, Hkv, G, hd)))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dog, vf) - delta[..., None])
    del p
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) / (hd ** 0.5)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _launcher(kernels: dict, dtype: torch.dtype):
    """The launch function of ``dtype``'s kernel in ``kernels``, built at
    first use."""
    source, symbol, argtypes = kernels[dtype]
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _bwd_sm90_scratch(B: int, Sq: int, Hq: int, Hkv: int, kernel: int) -> int:
    """The floats of the delta scratch the bf16 backward launcher takes."""
    fn = _build.load(_BWD_KERNELS[torch.bfloat16][0]).flash_attention_bwd_sm90_scratch
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    n = fn(B, Sq, Hq, Hkv, kernel)
    if n <= 0:
        raise ValueError(f"flash_attention_backward_cuda: no scratch for B={B}, Sq={Sq}, "
                         f"Hq={Hq}, Hkv={Hkv}")
    return n


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str) -> None:
    """What the kernels (forward and backward) take, at any Sq and Sk;
    raises on anything else, whatever the device, and then on tensors not
    on one CUDA device."""
    _check(q, k, v)
    tensors = (q, k, v)
    if q.dtype not in _KERNELS or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {[t.dtype for t in tensors]}")
    Sq, Hq, hd = q.shape[1:]
    Sk, Hkv = k.shape[1:3]
    if Sk == 0 and Sq > 0:
        raise ValueError(f"{what} needs at least one key, got Sk = 0")
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
                         causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """Attention of q (B, Sq, Hq, hd) over k, v (B, Sk, Hkv, hd) on a CUDA
    device by the hand-written kernel of the tensors' dtype (bf16: wgmma;
    float32: 3xTF32 mma.sync), on the current stream; the result is
    (B, Sq, Hq, hd) contiguous in q's dtype.  With ``return_lse`` it
    returns (out, lse): each row's log-sum-exp of the scaled scores in log2
    units, float32 (B, Hq, Sq), which the backward kernel of the same dtype
    takes; without, the kernel writes no L.
    q, k and v are read through their strides (unit stride over hd and rows
    on 16 bytes required: the kernels copy 16 bytes or TMA boxes).  Raises
    on anything the kernels do not take (whatever the device), on tensors
    not on one CUDA device, and if the launch is refused.  It computes no
    gradient itself: :class:`FlashAttentionFn` does."""
    global launches, launches_bf16
    bf16 = q.dtype == torch.bfloat16
    _check_cuda(q, k, v, "flash_attention_cuda")
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1:3]
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    launch = _launcher(_KERNELS, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernel = (sm90_plan(hd).kernel,) if bf16 else ()
        err = launch(*pointers, B, Sq, Sk, Hq, Hkv, hd, *strides, int(causal), int(window),
                     1.0 / (hd ** 0.5), *kernel, None if lse is None else lse.data_ptr(),
                     stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return (out, lse) if return_lse else out


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  out: torch.Tensor, dout: torch.Tensor, *,
                                  causal: bool = True, window: int = 0,
                                  lse: torch.Tensor | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of the attention of q (B, Sq, Hq, hd) over k, v (B, Sk,
    Hkv, hd) on a CUDA device by the hand-written backward kernel of the
    inputs' dtype, on the current stream: three launches, counted as one,
    with the forward's per-row L (``lse``, float32 (B, Hq, Sq), from
    ``flash_attention_cuda(..., return_lse=True)``), which both dtypes
    require: no launch recomputes it.  bf16:
    ``csrc/flash_attention_bwd_sm90.cu`` (wgmma, float32 sums; the kernels
    of ``bwd_sm90_plan(hd)``); float32: ``csrc/flash_attention_bwd.cu``
    (mma.sync in 3xTF32, float32 sums).  Sq and Sk may differ (the
    decoder's cross-attention); a row the mask empties (a window that
    closes before the keys reach it, only where Sq > Sk) took the mean of v
    forward, and its gradient spreads over every key with P = 1 / Sk, as
    the plain backward's.  q, k, v are read through their strides under
    the forward's checks; ``out`` (the forward's output) and ``dout`` are
    made contiguous here when they are not (a copy; the kernels read them
    as (B, Sq, Hq, hd) rows).  dq comes back (B, Sq, Hq, hd), dk and dv
    (B, Sk, Hkv, hd), contiguous, in the inputs' dtype.  Raises where the
    forward raises (before it looks at the device) and if a launch is
    refused."""
    global launches_bwd, launches_bwd_bf16
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape \
            or any(t.dtype != q.dtype for t in (out, dout)):
        raise ValueError(f"flash_attention_backward_cuda: out {tuple(out.shape)} "
                         f"{out.dtype} and dout {tuple(dout.shape)} {dout.dtype} must "
                         f"match q {tuple(q.shape)} {q.dtype}")
    bf16 = q.dtype == torch.bfloat16
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1:3]
    if lse is None or lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        got = None if lse is None else f"{tuple(lse.shape)} {lse.dtype}"
        raise ValueError("flash_attention_backward_cuda takes the forward's lse: "
                         f"float32 contiguous ({B}, {Hq}, {Sq}); got {got}")
    _check_cuda(q, k, v, "flash_attention_backward_cuda")
    if any(t.device != q.device for t in (out, dout, lse)):
        raise ValueError("flash_attention_backward_cuda needs CUDA tensors on one "
                         f"device, got q on {q.device}, out on {out.device}, dout on "
                         f"{dout.device}, lse on {lse.device}")
    out, dout = out.contiguous(), dout.contiguous()
    dq = torch.empty_like(out)
    dk = torch.empty((B, Sk, Hkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    launch = _launcher(_BWD_KERNELS, q.dtype)
    kernel = (bwd_sm90_plan(hd).kernel,) if bf16 else ()
    # per (b, query head, row): Delta = dO . O; the bf16 hd-64 kernels also
    # take each row's L and Delta in their tile order, past it
    n = _bwd_sm90_scratch(B, Sq, Hq, Hkv, *kernel) if bf16 else B * Hq * Sq
    delta = torch.empty((n,), dtype=torch.float32, device=q.device)
    pointers = (q, k, v, out, dout, lse, dq, dk, dv, delta)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(*(t.data_ptr() for t in pointers), B, Sq, Sk, Hq, Hkv, hd, *strides,
                     int(causal), int(window), 1.0 / (hd ** 0.5), *kernel, stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {err}")
    if bf16:
        launches_bwd_bf16 += 1
    else:
        launches_bwd += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable attention of q (B, Sq, Hq, hd) over k, v (B, Sk, Hkv,
    hd), Sq and Sk equal or not: forward and backward on the tensors'
    device — plain versions for CPU tensors, the kernels for CUDA tensors
    (never one for the other).  The forward saves q, k, v and its output,
    and hands the same output to whichever backward runs; on CUDA tensors
    that need a gradient it also saves the L its kernel writes, which the
    backward kernel takes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        lse = None
        if q.device.type == "cpu":
            out = attention_plain(q, k, v, causal=causal, window=window)
        elif q.device.type == "cuda":
            if any(ctx.needs_input_grad[:3]):
                out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                                return_lse=True)
            else:
                out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        else:
            raise ValueError(f"attention: no path for device {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = attention_backward_plain(q, k, v, out, dout, causal=ctx.causal,
                                             window=ctx.window)
        else:
            grads = flash_attention_backward_cuda(q, k, v, out, dout, causal=ctx.causal,
                                                  window=ctx.window, lse=lse)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)
