"""The gradients of the port's attention and RWKV6 wkv (`FlashAttentionFn`,
`Rwkv6Fn`, their plain backward versions and CUDA backward kernels)
against `jax.vjp` of the reference's oracles `repro.kernels.ref.
attention_ref` / `rwkv6_scan_ref`, on the same numpy inputs and cotangents.

Tolerances, with their reasons:
  * attention, float32: each of dq, dk, dv within 2e-5 max(1, max |want|)
    (the forward's tolerance, scaled to the gradient; float32 sums in
    another order, P recomputed from the same scores);
  * wkv, float32: each of dr, dk, dv, dw, du, ds0 within 1e-4 max(1,
    max |want|) (the forward's 1e-4; T-step float32 recurrences summed in
    another order);
  * `torch.autograd.gradcheck` of both Functions in float64 at tiny shapes
    (its own finite-difference tolerances);
  * on the card (`cuda` marker, skipped without one), each backward kernel
    against its plain version: float32 inputs within 1e-4 max |want|;
    bf16 inputs element by element against the float32 plain backward of
    the same inputs (the same bf16 output O), |got - want| <= 2^-8 |want| +
    1e-3 max |want| (the kernel sums in float32 and rounds once to bf16;
    the float32 Delta and P it recomputes differ from the plain version's
    in the last bits, which dS = P (dP - Delta) magnifies where dP and
    Delta nearly cancel); wkv within 1e-4 max(1, max |want|).

The Functions run on the CPU as on the card: plain forward and plain
backward for CPU tensors, so these tests exercise the same saved tensors,
GQA sums, dtypes and `None` gradients the card runs."""
import functools

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as twkv  # noqa: E402

ATTN_RTOL = 2e-5
WKV_RTOL = 1e-4
CARD_F32_RTOL = 1e-4
CARD_BF16_RTOL = 2.0 ** -8
CARD_BF16_ATOL = 1e-3          # of max |want|


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _within(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    limit = rtol * max(1.0, float(np.abs(want).max()))
    assert err <= limit, f"{what}: max abs error {err} > {limit}"


@functools.partial(jax.jit, static_argnums=(4, 5))
def _attn_vjp_jit(q, k, v, dout, causal, window):
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, causal=causal,
                                                        window=window), q, k, v)
    return vjp(dout)


def _attn_vjp(q, k, v, dout, causal, window):
    """The reference's gradient: jax.vjp of attention_ref (jitted: one
    compile a shape instead of one a primitive)."""
    return [np.asarray(g) for g in _attn_vjp_jit(q, k, v, dout, causal, window)]


ATTN_CASES = {
    # name: (B, S, Hq, Hkv, hd, causal, window)
    "causal-g1-hd32": (1, 24, 2, 2, 32, True, 0),
    "causal-g2-hd32": (2, 24, 4, 2, 32, True, 0),
    "causal-g4-hd120": (1, 20, 4, 1, 120, True, 0),
    "window8-g2-hd32": (1, 40, 4, 2, 32, True, 8),
    "window8-g4-hd120": (1, 33, 8, 2, 120, True, 8),
    "noncausal-g1-hd32": (1, 24, 2, 2, 32, False, 0),
    "noncausal-g2-hd120": (2, 17, 4, 2, 120, False, 0),
    "ragged-causal-g2-hd32": (1, 37, 4, 2, 32, True, 0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_backward_plain_and_function_match_jax_grad(case):
    B, S, Hq, Hkv, hd, causal, window = ATTN_CASES[case]
    rng = np.random.default_rng(S + hd)
    q, k, v, dout = (_rand(rng, B, S, Hq, hd), _rand(rng, B, S, Hkv, hd),
                     _rand(rng, B, S, Hkv, hd), _rand(rng, B, S, Hq, hd))
    want = _attn_vjp(q, k, v, dout, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out = tfa.attention_plain(tq, tk, tv, causal=causal, window=window)
    plain = tfa.attention_backward_plain(tq, tk, tv, out, tdo, causal=causal,
                                         window=window)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    got_out = tops.attention(*leaves, causal=causal, window=window)
    assert torch.equal(got_out.detach(), out)
    fn = torch.autograd.grad(got_out, leaves, tdo)
    for name, p, f, w in zip("qkv", plain, fn, want):
        assert p.shape == f.shape == w.shape and p.dtype == torch.float32
        _within(p.numpy(), w, ATTN_RTOL, f"plain d{name}")
        assert torch.equal(p, f), f"the Function's d{name} is the plain backward's"


def test_attention_function_gives_none_for_inputs_without_grad_and_keeps_dtypes():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 16, 4, 32)).to(torch.bfloat16),
               torch.from_numpy(_rand(rng, 1, 16, 2, 32)).to(torch.bfloat16),
               torch.from_numpy(_rand(rng, 1, 16, 2, 32)).to(torch.bfloat16))
    k.requires_grad_(True)
    out = tops.attention(q, k, v, causal=True, window=4)
    out.float().sum().backward()
    assert q.grad is None and v.grad is None
    assert k.grad.dtype == torch.bfloat16 and k.grad.shape == k.shape
    dq, dk, dv = tfa.attention_backward_plain(q, k.detach(), v, out.detach(),
                                              torch.ones_like(out), causal=True, window=4)
    assert torch.equal(dk, k.grad) and dq.dtype == dv.dtype == torch.bfloat16


@settings(database=None, derandomize=True, max_examples=6, deadline=None)
@given(S=st.integers(1, 30), G=st.sampled_from([1, 2, 4]), hd=st.sampled_from([8, 32]),
       causal=st.booleans(), window=st.sampled_from([0, 1, 5]))
def test_attention_backward_plain_property(S, G, hd, causal, window):
    """Any S (1 included), group, window and causality: the plain backward
    is jax.grad's."""
    rng = np.random.default_rng(S * 7 + G)
    Hkv = 2
    q, k, v, dout = (_rand(rng, 1, S, Hkv * G, hd), _rand(rng, 1, S, Hkv, hd),
                     _rand(rng, 1, S, Hkv, hd), _rand(rng, 1, S, Hkv * G, hd))
    want = _attn_vjp(q, k, v, dout, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out = tfa.attention_plain(tq, tk, tv, causal=causal, window=window)
    got = tfa.attention_backward_plain(tq, tk, tv, out, tdo, causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        _within(g.numpy(), w, ATTN_RTOL, f"d{name}")


def _wkv_arrays(B, H, T, hd, seed, kind="plain"):
    rng = np.random.default_rng(seed)
    r, k, v = _rand(rng, B, H, T, hd), _rand(rng, B, H, T, hd), _rand(rng, B, H, T, hd)
    if kind == "strong":        # the model's w = exp(-exp(x)), x over -6..3
        w = np.exp(-np.exp(rng.uniform(-6.0, 3.0, (B, H, T, hd)))).astype(np.float32)
    else:
        w = (1 / (1 + np.exp(-_rand(rng, B, H, T, hd))) * 0.4 + 0.55).astype(np.float32)
    if kind == "w0":
        w[:] = 0.0
    u, s0 = _rand(rng, H, hd, scale=0.1), _rand(rng, B, H, hd, hd, scale=0.1)
    dy, dsT = _rand(rng, B, H, T, hd), _rand(rng, B, H, hd, hd)
    return (r, k, v, w, u, s0), (dy, dsT)


@jax.jit
def _wkv_vjp_jit(inputs, cot):
    _, vjp = jax.vjp(jref.rwkv6_scan_ref, *inputs)
    return vjp(cot)


def _wkv_vjp(inputs, cot):
    return [np.asarray(g) for g in _wkv_vjp_jit(tuple(inputs), tuple(cot))]


WKV_CASES = {
    # name: (B, H, T, hd, kind, dS_T used)
    "plain": (2, 2, 19, 16, "plain", False),
    "carried-state": (1, 3, 23, 32, "plain", True),
    "strong-decays": (2, 2, 17, 16, "strong", True),
    "w0": (1, 2, 9, 16, "w0", True),
    "t1": (2, 2, 1, 8, "plain", True),
}


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv_backward_plain_and_function_match_jax_grad(case):
    B, H, T, hd, kind, used = WKV_CASES[case]
    inputs, (dy, dsT) = _wkv_arrays(B, H, T, hd, seed=T + hd, kind=kind)
    if not used:
        dsT = np.zeros_like(dsT)
    want = _wkv_vjp(inputs, (dy, dsT))
    tin = [torch.from_numpy(x) for x in inputs]
    plain = twkv.rwkv6_backward_plain(*tin, torch.from_numpy(dy), torch.from_numpy(dsT))
    leaves = [t.clone().requires_grad_(True) for t in tin]
    y, sT = tops.rwkv6_wkv(*leaves)
    outs, cots = ((y, sT), (torch.from_numpy(dy), torch.from_numpy(dsT))) if used \
        else ((y,), (torch.from_numpy(dy),))
    fn = torch.autograd.grad(outs, leaves, cots)
    for name, p, f, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), plain, fn, want):
        assert p.shape == f.shape == w.shape
        _within(p.numpy(), w, WKV_RTOL, f"plain {name}")
        assert torch.equal(p, f), f"the Function's {name} is the plain backward's"


def test_gradcheck_both_functions_in_float64():
    """On one intra-op thread: thousands of tiny float64 calls, which
    threads only slow (200 s a run beside five other busy workers, 2 s
    alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _gradcheck_both_functions()
    finally:
        torch.set_num_threads(threads)


def _gradcheck_both_functions():
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64, requires_grad=True)
    for causal, window, G in ((True, 0, 2), (True, 3, 1), (False, 0, 4)):
        q, k, v = randn(1, 6, 2 * G, 4), randn(1, 6, 2, 4), randn(1, 6, 2, 4)
        assert torch.autograd.gradcheck(
            lambda a, b, c: tops.attention(a, b, c, causal=causal, window=window), (q, k, v))
    w = torch.rand(2, 2, 5, 4, generator=gen, dtype=torch.float64).requires_grad_()
    args = (randn(2, 2, 5, 4), randn(2, 2, 5, 4), randn(2, 2, 5, 4), w, randn(2, 4),
            randn(2, 2, 4, 4))
    assert torch.autograd.gradcheck(tops.rwkv6_wkv, args)


BWD_REFUSED = {
    "flash-float16": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 32), (1, 8, 1, 32), torch.float16)),
    "flash-hd-past-256": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 264), (1, 8, 1, 264), torch.bfloat16)),
    "flash-group-of-17": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 17, 32), (1, 8, 1, 32), torch.bfloat16)),
    "flash-dout-shape": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 32), (1, 8, 1, 32), torch.float32)[:4],
        torch.zeros(1, 8, 2, 16)),
    "wkv-hd-8": lambda: twkv.rwkv6_backward_cuda(*_wkv_torch(1, 1, 4, 8)),
    "wkv-hd-128": lambda: twkv.rwkv6_backward_cuda(*_wkv_torch(1, 1, 4, 128)),
    "wkv-float64": lambda: twkv.rwkv6_backward_cuda(
        *(t.double() for t in _wkv_torch(1, 1, 4, 16))),
}


def _halves(qshape, kshape, dtype):
    q, k = torch.zeros(qshape, dtype=dtype), torch.zeros(kshape, dtype=dtype)
    return q, k, k.clone(), q.clone(), q.clone()


def _wkv_torch(B, H, T, hd):
    inputs, (dy, dsT) = _wkv_arrays(B, H, T, hd, seed=0)
    return (*(torch.from_numpy(x) for x in inputs), torch.from_numpy(dy),
            torch.from_numpy(dsT))


@pytest.mark.parametrize("case", sorted(BWD_REFUSED))
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(case):
    """Refused before any device is looked at, so on the CPU as on the card,
    and counted as no launch."""
    before = (tfa.launches_bwd, tfa.launches_bwd_bf16, twkv.launches_bwd)
    with pytest.raises((TypeError, ValueError)) as info:
        BWD_REFUSED[case]()
    assert "CUDA tensors" not in str(info.value)
    assert (tfa.launches_bwd, tfa.launches_bwd_bf16, twkv.launches_bwd) == before


def test_backward_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_backward_cuda(*_halves((1, 8, 2, 32), (1, 8, 1, 32),
                                                   torch.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        twkv.rwkv6_backward_cuda(*_wkv_torch(1, 1, 4, 16))


# --------------------------------------------------------------------------- #
# On the card: each backward kernel against its plain version
# --------------------------------------------------------------------------- #

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


CUDA_ATTN_BWD = {
    "main-window1024-bf16": (2, 4096, 8, 4, 256, True, 1024, torch.bfloat16),
    "main-global-bf16": (2, 4096, 8, 4, 256, True, 0, torch.bfloat16),
    "main-window1024-fp32": (2, 4096, 8, 4, 256, True, 1024, torch.float32),
    "main-global-fp32": (2, 4096, 8, 4, 256, True, 0, torch.float32),
    "ragged-fp32": (1, 1000, 4, 2, 64, True, 0, torch.float32),
    "ragged-bf16": (1, 1000, 4, 2, 64, True, 0, torch.bfloat16),
    "gqa8-window100-bf16": (1, 300, 8, 1, 64, True, 100, torch.bfloat16),
    "hd120-fp32": (1, 130, 4, 1, 120, True, 0, torch.float32),
    "noncausal-bf16": (1, 512, 4, 4, 128, False, 0, torch.bfloat16),
    "hd32-window64-fp32": (2, 256, 4, 2, 32, True, 64, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_ATTN_BWD))
def test_cuda_flash_backward_matches_plain(case):
    _need_cuda()
    B, S, Hq, Hkv, hd, causal, window, dtype = CUDA_ATTN_BWD[case]
    rng = np.random.default_rng(S)
    q, k, v, dout = (torch.from_numpy(_rand(rng, *shape)).to("cuda", dtype)
                     for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                                   (B, S, Hq, hd)))
    out = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    before = (tfa.launches_bwd, tfa.launches_bwd_bf16)
    got = tfa.flash_attention_backward_cuda(q, k, v, out, dout, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (tfa.launches_bwd, tfa.launches_bwd_bf16) == (before[0] + (not bf16),
                                                         before[1] + bf16)
    want = tfa.attention_backward_plain(q.float(), k.float(), v.float(), out.float(),
                                        dout.float(), causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        diff = (g.float() - w).abs()
        top = float(w.abs().max())
        limit = (CARD_BF16_RTOL * w.abs() + CARD_BF16_ATOL * top) if bf16 \
            else torch.full_like(w, CARD_F32_RTOL * top)
        assert bool((diff <= limit).all()), f"d{name}: max abs error {float(diff.max())}"


@pytest.mark.cuda
def test_cuda_flash_backward_through_the_function():
    """q.requires_grad_() goes through FlashAttentionFn: the forward kernel,
    then the backward kernel, whose q.grad is the plain backward's."""
    _need_cuda()
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_rand(rng, *shape)).cuda()
               for shape in ((1, 300, 4, 64), (1, 300, 2, 64), (1, 300, 2, 64)))
    q.requires_grad_()
    before = (tfa.launches, tfa.launches_bwd)
    out = tops.attention(q, k, v, causal=True, window=100)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert k.grad is None
    want = tfa.attention_backward_plain(q.detach(), k, v, out.detach(), torch.ones_like(out),
                                        causal=True, window=100)[0]
    top = float(want.abs().max())
    assert float((q.grad - want).abs().max()) <= CARD_F32_RTOL * top


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_strided_inputs_and_noncontiguous_dout(dtype):
    """q, k, v read through their strides (views of one fused (B, S, Hq +
    2 Hkv, hd) buffer) and a transposed dO give the contiguous inputs'
    gradients, bit for bit."""
    _need_cuda()
    B, S, Hq, Hkv, hd = 1, 200, 4, 2, 64
    rng = np.random.default_rng(11)
    fused = torch.from_numpy(_rand(rng, B, S, Hq + 2 * Hkv, hd)).to("cuda", dtype)
    q, k, v = fused[:, :, :Hq], fused[:, :, Hq:Hq + Hkv], fused[:, :, Hq + Hkv:]
    dout = torch.from_numpy(_rand(rng, B, Hq, S, hd)).to("cuda", dtype).transpose(1, 2)
    out = tfa.flash_attention_cuda(q, k, v, causal=True, window=50)
    got = tfa.flash_attention_backward_cuda(q, k, v, out, dout, causal=True, window=50)
    want = tfa.flash_attention_backward_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                             out, dout.contiguous(), causal=True, window=50)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


CUDA_WKV_BWD = {
    # name: (B, H, T, hd, kind)
    "main": (2, 40, 4096, 64, "strong"),
    "ragged-t1000": (2, 40, 1000, 64, "plain"),
    "t1": (2, 40, 1, 64, "plain"),
    "w0": (1, 4, 200, 64, "w0"),
    "hd32": (1, 3, 77, 32, "plain"),
    "hd16": (1, 2, 130, 16, "strong"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_WKV_BWD))
def test_cuda_wkv_backward_matches_plain(case):
    _need_cuda()
    B, H, T, hd, kind = CUDA_WKV_BWD[case]
    inputs, cot = _wkv_arrays(B, H, T, hd, seed=T, kind=kind)
    args = [torch.from_numpy(x).cuda() for x in (*inputs, *cot)]
    before = twkv.launches_bwd
    got = twkv.rwkv6_backward_cuda(*args)
    torch.cuda.synchronize()
    assert twkv.launches_bwd == before + 1
    want = twkv.rwkv6_backward_plain(*args)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        _within(g.cpu().numpy(), w.cpu().numpy(), WKV_RTOL, name)
