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
    against its plain version: float32 inputs within 1e-4 max |want|
    (1e-4 max(1, max |want|) below 16 rows, where dq and dk are near
    zero: at S = 1 both are zero exactly and the kernel's are rounding
    noise);
    bf16 inputs element by element against the float32 plain backward of
    the same inputs (the same bf16 output O), |got - want| <= 2^-8 |want| +
    1e-3 max |want| (the kernel sums in float32 and rounds once to bf16;
    the float32 Delta and P it recomputes differ from the plain version's
    in the last bits, which dS = P (dP - Delta) magnifies where dP and
    Delta nearly cancel); wkv within 1e-4 max(1, max |want|).

At Sq != Sk (the decoder's cross-attention) the plain backward and
`FlashAttentionFn` on CPU tensors hold the same 2e-5 against `jax.vjp` of
the reference's `repro.models.attention.attend_full`, and both backward
kernels their plain version on the card; there two calls of a backward
kernel give the same bits (no atomics).

The Functions run on the CPU as on the card: plain forward and plain
backward for CPU tensors, so these tests exercise the same saved tensors,
GQA sums, dtypes and `None` gradients the card runs.

The arithmetic of the Hopper backward kernels is settled here too, in
PyTorch on the CPU: the bf16 flash backward's rounding (P and dS enter the
tensor cores as bf16: one term breaks the card's per-element limit, two
terms hold it, so `csrc/flash_attention_bwd_sm90.cu` uses two), the float32
flash backward's 3xTF32 products (`csrc/flash_attention_bwd.cu`: all five
products in three TF32 terms hold 1e-4 of max |want| against `jax.vjp`,
one term does not), the plain L the forwards write
(`attention_lse_plain`) against `jax.nn.logsumexp`
of the reference's scores, and the chunk-parallel wkv backward of
`csrc/rwkv6_scan_bwd.cu` (chunk states, dS handed back chunk to chunk,
each chunk walked in sub-chunks) against `jax.vjp` and the plain
backward."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
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


CROSS_CASES = {
    # name: (B, Sq, Sk, Hq, Hkv, hd, causal, window)
    "longer-keys-noncausal-g1": (2, 9, 30, 2, 2, 32, False, 0),
    "longer-keys-causal-g4": (1, 9, 30, 8, 2, 32, True, 0),
    "shorter-keys-noncausal-g4": (1, 30, 9, 4, 1, 64, False, 0),
    "shorter-keys-causal-g1": (2, 30, 9, 2, 2, 32, True, 0),
    "shorter-keys-window5-g4": (1, 30, 9, 8, 2, 32, True, 5),
    # whisper's cross-attention ratio (448 x 1500) at hd 64, cut
    "whisper-ratio-hd64": (1, 45, 150, 2, 2, 64, False, 0),
}


@functools.partial(jax.jit, static_argnums=(4, 5))
def _attend_full_vjp(q, k, v, dout, causal, window):
    _, vjp = jax.vjp(lambda a, b, c: jattn.attend_full(a, b, c, causal=causal,
                                                       window=window), q, k, v)
    return vjp(dout)


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_attention_backward_at_two_lengths_matches_jax_grad(case):
    """dq (B, Sq, Hq, hd) and dk, dv (B, Sk, Hkv, hd) of the plain backward
    and of `FlashAttentionFn` on CPU tensors, against `jax.vjp` of the
    reference's `attend_full` (rows with no live key included)."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window = CROSS_CASES[case]
    rng = np.random.default_rng(Sq * Sk + hd)
    q, k, v, dout = (_rand(rng, B, Sq, Hq, hd), _rand(rng, B, Sk, Hkv, hd),
                     _rand(rng, B, Sk, Hkv, hd), _rand(rng, B, Sq, Hq, hd))
    want = [np.asarray(g) for g in _attend_full_vjp(q, k, v, dout, causal, window)]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out = tfa.attention_plain(tq, tk, tv, causal=causal, window=window)
    plain = tfa.attention_backward_plain(tq, tk, tv, out, tdo, causal=causal,
                                         window=window)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fn = torch.autograd.grad(tops.attention(*leaves, causal=causal, window=window),
                             leaves, tdo)
    for name, pg, f, w in zip("qkv", plain, fn, want):
        assert pg.shape == f.shape == w.shape
        _within(pg.numpy(), w, ATTN_RTOL, f"plain d{name}")
        assert torch.equal(pg, f), f"the Function's d{name} is the plain backward's"


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


# --------------------------------------------------------------------------- #
# The Hopper backward kernels' arithmetic, emulated on the CPU
# --------------------------------------------------------------------------- #

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _attention_backward_bf16(q, k, v, out, dout, *, causal, window, terms):
    """csrc/flash_attention_bwd_sm90.cu's arithmetic on bf16 values held in
    float32: S and dP exact in float32 (bf16 products), P = 2^(S scale
    log2(e) - L) with the forward's L, dS = P (dP - Delta); P and dS enter
    dV = P^T dO, dK = dS^T Q scale, dQ = dS K scale as ``terms`` bf16 terms
    (hi = bf16(x), lo = bf16(x - hi)), summed in float32; each gradient
    rounded once to bf16."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qh, oh, doh = (t.permute(0, 2, 1, 3) for t in (q, out, dout))          # (B, Hq, S, hd)
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1) for t in (k, v))
    scale = 1.0 / hd ** 0.5
    lse = tfa.attention_lse_plain(q, k, causal=causal, window=window)[..., None]
    pos = torch.arange(S)
    ok = pos[None, :] <= pos[:, None] if causal else torch.ones(S, S, dtype=torch.bool)
    if window > 0:
        ok &= pos[:, None] - pos[None, :] < window
    p = torch.where(ok, torch.exp2((qh @ kh.transpose(-1, -2)) * (scale * tfa.LOG2E) - lse),
                    0.0)
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * oh).sum(-1, keepdim=True))

    def split(x):
        hi = _bf16(x)
        return (hi,) if terms == 1 else (hi, _bf16(x - hi))
    dv = sum(t.transpose(-1, -2) @ doh for t in split(p))
    dk = sum(t.transpose(-1, -2) @ qh for t in split(ds)) * scale
    dq = sum(t @ kh for t in split(ds)) * scale
    dk, dv = (t.reshape(B, Hkv, G, S, hd).sum(2) for t in (dk, dv))
    return [_bf16(t.permute(0, 2, 1, 3)) for t in (dq, dk, dv)]


@pytest.mark.parametrize("shape,window", [((1, 512, 4, 2, 256), 128),
                                          ((1, 512, 4, 2, 256), 0),
                                          ((1, 300, 16, 1, 64), 100)])
def test_two_bf16_terms_of_p_and_ds_hold_the_card_limit_and_one_does_not(shape, window):
    """bf16 inputs, causal: with P and dS in two bf16 terms every gradient
    stays within chip_smoke.py's per-element limit (2^-8 |want| + 1e-3
    max |want|) of the float32 plain backward; one rounding of P and dS
    does not (why the kernel carries two)."""
    B, S, Hq, Hkv, hd = shape
    rng = np.random.default_rng(S + hd)
    q, k, v, dout = (_bf16(torch.from_numpy(_rand(rng, *sh)))
                     for sh in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                                (B, S, Hq, hd)))
    out = _bf16(tfa.attention_plain(q, k, v, causal=True, window=window))
    want = tfa.attention_backward_plain(q, k, v, out, dout, causal=True, window=window)
    share = {}
    for terms in (1, 2):
        got = _attention_backward_bf16(q, k, v, out, dout, causal=True, window=window,
                                       terms=terms)
        share[terms] = max(float(((g - w).abs() / (CARD_BF16_RTOL * w.abs() + CARD_BF16_ATOL
                                                   * w.abs().max())).max())
                           for g, w in zip(got, want))
    assert share[2] <= 1.0 < share[1], share


def _attention_backward_hd64(q, k, v, out, dout, *, causal, window, terms):
    """The arithmetic of csrc/flash_attention_bwd_sm90.cu's hd-64 kernels
    (dkdv_hd64_kernel, dq_hd64_kernel) on bf16 values held in float32, at
    any Sq and Sk: S and dP exact in float32, P = 2^(S scale log2(e) - L)
    with the forward's L (1 / Sk on every key of a row with no live key),
    dS = P (dP - Delta).  dK / dV walk query tiles of 64 rows (64 / G
    positions, each with the group's G heads) and add each tile's products
    to their sums in order; dQ walks kv tiles of 64 keys likewise.  P and dS
    enter the products as ``terms`` bf16 terms (hi = bf16(x), lo = bf16(x -
    hi); None: float32 as they are); each gradient is rounded once to bf16
    (not at ``terms`` None)."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qh, oh, doh = (t.permute(0, 2, 1, 3) for t in (q, out, dout))          # (B, Hq, Sq, hd)
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1) for t in (k, v))
    scale = 1.0 / hd ** 0.5
    lse = tfa.attention_lse_plain(q, k, causal=causal, window=window)[..., None]
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    dropped = torch.where(ok.any(-1, keepdim=True), 0.0, 1.0 / Sk)
    p = torch.where(ok, torch.exp2((qh @ kh.transpose(-1, -2)) * (scale * tfa.LOG2E) - lse),
                    dropped)
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * oh).sum(-1, keepdim=True))

    def split(x):
        if terms is None:
            return (x,)
        hi = _bf16(x)
        return (hi,) if terms == 1 else (hi, _bf16(x - hi))

    def group_sum(t):                                      # (B, Hq, ...) -> (B, Hkv, ...)
        return t.reshape(B, Hkv, G, *t.shape[2:]).sum(2)
    dk = dv = torch.zeros(B, Hkv, Sk, hd)
    P = 64 // G
    for p0 in range(0, Sq, P):
        rows = slice(p0, p0 + P)
        dv = dv + group_sum(sum(t[..., rows, :].transpose(-1, -2) @ doh[..., rows, :]
                                for t in split(p)))
        dk = dk + group_sum(sum(t[..., rows, :].transpose(-1, -2) @ qh[..., rows, :]
                                for t in split(ds)))
    dq = torch.zeros(B, Hq, Sq, hd)
    for k0 in range(0, Sk, 64):
        keys = slice(k0, k0 + 64)
        dq = dq + sum(t[..., keys] @ kh[..., keys, :] for t in split(ds))
    grads = [t.permute(0, 2, 1, 3) for t in (dq * scale, dk * scale, dv)]
    return grads if terms is None else [_bf16(t) for t in grads]


# whisper-large-v3's three attention shapes cut to B = 1 and 2 heads:
# (B, Sq, Sk, Hq, Hkv, hd), causal
HD64_WHISPER = {"encoder": ((1, 1500, 1500, 2, 2, 64), False),
                "cross": ((1, 448, 1500, 2, 2, 64), False),
                "decoder": ((1, 448, 448, 2, 2, 64), True)}


@pytest.mark.parametrize("case", sorted(HD64_WHISPER))
def test_hd64_kernels_need_two_bf16_terms_at_whispers_shapes(case):
    """bf16 inputs: the hd-64 kernels' arithmetic with P and dS in two bf16
    terms keeps every gradient within chip_smoke.py's per-element limit
    (2^-8 |want| + 1e-3 max |want|) of the float32 plain backward at
    whisper's shapes; one rounding of P and dS does not."""
    (B, Sq, Sk, Hq, Hkv, hd), causal = HD64_WHISPER[case]
    rng = np.random.default_rng(Sq + Sk)
    q, k, v, dout = (_bf16(torch.from_numpy(_rand(rng, *sh)))
                     for sh in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
                                (B, Sq, Hq, hd)))
    out = _bf16(tfa.attention_plain(q, k, v, causal=causal))
    want = tfa.attention_backward_plain(q, k, v, out, dout, causal=causal)
    share = {}
    for terms in (1, 2):
        got = _attention_backward_hd64(q, k, v, out, dout, causal=causal, window=0,
                                       terms=terms)
        share[terms] = max(float(((g - w).abs() / (CARD_BF16_RTOL * w.abs() + CARD_BF16_ATOL
                                                   * w.abs().max())).max())
                           for g, w in zip(got, want))
    assert share[2] <= 1.0 < share[1], share


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_hd64_kernels_tile_walk_matches_jax_grad_at_two_lengths(case):
    """The hd-64 kernels' tile walk in float32 (P and dS unsplit, no bf16
    rounding): dq (B, Sq, Hq, hd), dk and dv (B, Sk, Hkv, hd) within 2e-5
    max(1, max |want|) of `jax.vjp` of the reference's `attend_full`, rows
    with no live key included (P = 1 / Sk on every key)."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window = CROSS_CASES[case]
    rng = np.random.default_rng(Sq * Sk + hd)
    q, k, v, dout = (_rand(rng, B, Sq, Hq, hd), _rand(rng, B, Sk, Hkv, hd),
                     _rand(rng, B, Sk, Hkv, hd), _rand(rng, B, Sq, Hq, hd))
    want = [np.asarray(g) for g in _attend_full_vjp(q, k, v, dout, causal, window)]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out = tfa.attention_plain(tq, tk, tv, causal=causal, window=window)
    got = _attention_backward_hd64(tq, tk, tv, out, tdo, causal=causal, window=window,
                                   terms=None)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        _within(g.numpy(), w, ATTN_RTOL, f"d{name}")


@pytest.mark.parametrize("hd", [8, 32, 48, 64, 72, 128, 136, 256])
def test_bwd_sm90_plan_picks_the_kernels_by_head_dim(hd):
    """hd <= 64 takes the hd-64 pair (kernel 0: one dK / dV CTA and two dQ
    CTAs an SM), wider head dims the template at ceil(hd / 64) boxes
    (kernel 1, one CTA an SM each); past 256 and at 0 the plan refuses."""
    plan = tfa.bwd_sm90_plan(hd)
    if hd <= 64:
        assert (plan.kernel, plan.dkdv, plan.dq, plan.ctas_per_sm) == (
            0, "dkdv_hd64_kernel", "dq_hd64_kernel", (1, 2))
    else:
        nch = -(-hd // 64)
        assert (plan.kernel, plan.dkdv, plan.dq, plan.ctas_per_sm) == (
            1, f"dkdv_kernel<{nch}>", f"dq_kernel<{nch}>", (1, 1))
    for bad in (0, 264):
        with pytest.raises(ValueError):
            tfa.bwd_sm90_plan(bad)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero:
    cvt.rna.tf32.f32): add half of the dropped 13 bits, then mask them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_rz(x):
    """x cut to TF32 (rounded toward zero): what the tensor cores read of a
    float32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, terms, lo=_tf32_rz):
    """a @ b with TF32 operands and float32 sums: one term (hi hi', hi =
    tf32(x) to nearest) or three (hi hi' + hi lo' + lo hi', lo = x - hi
    rounded to TF32 by ``lo``: cut, as csrc/flash_attention_bwd.cu does, or
    to nearest, as csrc/flash_attention.cu does)."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if terms == 3:
        out = out + ah @ lo(b - bh) + lo(a - ah) @ bh
    return out


def _attention_backward_tf32(q, k, v, dout, *, causal, window, terms):
    """The float32 kernels' arithmetic, every product of TF32 operands in
    ``terms`` terms with float32 sums: the forward (csrc/flash_attention.cu,
    lo to nearest) gives O = (P V) / l and L = m + log2(l) in log2 units
    from S = Q K^T; the backward (csrc/flash_attention_bwd.cu, lo cut) S
    again, P = 2^(S scale log2(e) - L),
    dP = dO V^T, Delta = dO . O, dS = P (dP - Delta), dV = P^T dO,
    dK = dS^T Q scale, dQ = dS K scale (P and dS split like the inputs)."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qh, doh = (t.permute(0, 2, 1, 3) for t in (q, dout))                 # (B, Hq, S, hd)
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1) for t in (k, v))
    scale = 1.0 / hd ** 0.5
    pos = torch.arange(S)
    ok = pos[None, :] <= pos[:, None] if causal else torch.ones(S, S, dtype=torch.bool)
    if window > 0:
        ok &= pos[:, None] - pos[None, :] < window
    s = _mm_tf32(qh, kh.transpose(-1, -2), terms, lo=_tf32) * (scale * tfa.LOG2E)
    m = s.masked_fill(~ok, -torch.inf).amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp2(s - m), 0.0)
    lsum = p.sum(-1, keepdim=True)
    o = _mm_tf32(p, vh, terms, lo=_tf32) / lsum
    lse = m + torch.log2(lsum)
    s = _mm_tf32(qh, kh.transpose(-1, -2), terms) * (scale * tfa.LOG2E)
    p = torch.where(ok, torch.exp2(s - lse), 0.0)
    ds = p * (_mm_tf32(doh, vh.transpose(-1, -2), terms) - (doh * o).sum(-1, keepdim=True))
    dv = _mm_tf32(p.transpose(-1, -2), doh, terms)
    dk = _mm_tf32(ds.transpose(-1, -2), qh, terms) * scale
    dq = _mm_tf32(ds, kh, terms) * scale
    dk, dv = (t.reshape(B, Hkv, G, S, hd).sum(2) for t in (dk, dv))
    return [t.permute(0, 2, 1, 3) for t in (dq, dk, dv)]


@pytest.mark.parametrize("shape,causal,window", [((1, 512, 4, 2, 256), True, 128),
                                                 ((1, 300, 8, 2, 120), True, 0)])
def test_three_tf32_terms_hold_the_float32_backward_limit_and_one_does_not(shape, causal,
                                                                           window):
    """Full-mantissa float32 inputs: with every one of the five products in
    three TF32 terms each gradient stays within chip_smoke.py's float32
    limit (1e-4 of max |want|) of jax.vjp of attention_ref; one TF32 term a
    product does not (why csrc/flash_attention_bwd.cu splits every operand,
    P and dS too)."""
    B, S, Hq, Hkv, hd = shape
    rng = np.random.default_rng(S + hd + 2)
    q, k, v, dout = (_rand(rng, B, S, Hq, hd), _rand(rng, B, S, Hkv, hd),
                     _rand(rng, B, S, Hkv, hd), _rand(rng, B, S, Hq, hd))
    want = _attn_vjp(q, k, v, dout, causal, window)
    share = {}
    for terms in (1, 3):
        got = _attention_backward_tf32(*(torch.from_numpy(x) for x in (q, k, v, dout)),
                                       causal=causal, window=window, terms=terms)
        share[terms] = max(float(np.abs(g.numpy().astype(np.float64) - w).max())
                           / (CARD_F32_RTOL * float(np.abs(w).max()))
                           for g, w in zip(got, want))
    assert share[3] <= 1.0 < share[1], share


@pytest.mark.parametrize("case", ["causal-g2-hd32", "window8-g4-hd120", "noncausal-g2-hd120",
                                  "ragged-causal-g2-hd32"])
def test_attention_lse_plain_matches_jax_logsumexp(case):
    """The plain L (log2 units) against jax.nn.logsumexp of the reference's
    masked scores (attention_ref's), times log2(e)."""
    B, S, Hq, Hkv, hd, causal, window = ATTN_CASES[case]
    rng = np.random.default_rng(S + hd + 1)
    q, k = _rand(rng, B, S, Hq, hd), _rand(rng, B, S, Hkv, hd)
    qg = jnp.asarray(q).reshape(B, S, Hkv, Hq // Hkv, hd) / (hd ** 0.5)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qg, jnp.asarray(k))
    pos = jnp.arange(S)
    ok = pos[None, :] <= pos[:, None] if causal else jnp.ones((S, S), bool)
    if window > 0:
        ok &= pos[:, None] - pos[None, :] < window
    want = np.asarray(jax.nn.logsumexp(jnp.where(ok, s, -1e30), axis=-1)
                      ).reshape(B, Hq, S) / np.log(2.0)
    got = tfa.attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k), causal=causal,
                                  window=window)
    assert got.shape == (B, Hq, S) and got.dtype == torch.float32
    _within(got.numpy(), want, ATTN_RTOL, "L")


def _wkv_backward_chunked(r, k, v, w, u, s0, dy, dsT, L=64, sub=8):
    """csrc/rwkv6_scan_bwd.cu's arithmetic, chunk-parallel in time, chunks of
    L steps in sub-chunks of ``sub``; decays only ever multiplied:
    1. the state S_c each chunk starts from, by the forward's hand-off
       S_{c+1} = diag(D_c) S_c + K_c (K_c, D_c from the chunk alone);
    2. dS handed back: each chunk's Lambda_c = sum_t (r_t * w_start ...
       w_{t-1}) dy_t^T and D_c = prod_t w_t, dS at its start = diag(D_c)
       dS_end + Lambda_c, from dS_T; the first chunk's is ds0;
    3. each chunk walked backward from its dS_end, the states recomputed
       forward from S_c, one sub-chunk's at a time: dr, dk, dv, dw and
       du (summed over the chunks, then the batch)."""
    B, H, T, hd = r.shape
    nc = -(-T // L)
    uf = u[None]
    span = [(c * L, min(T, (c + 1) * L)) for c in range(nc)]

    def step(s, t):
        return s * w[:, :, t, :, None] + k[:, :, t, :, None] * v[:, :, t, None, :]
    states, s = [], s0
    for t0, t1 in span:
        states.append(s)
        kc, dc = torch.zeros_like(s0), torch.ones_like(s0[..., 0])
        for t in range(t0, t1):
            kc = step(kc, t)
            dc = dc * w[:, :, t]
        s = dc[..., None] * s + kc
    ends, g = [None] * nc, dsT
    for c in reversed(range(nc)):
        ends[c] = g
        lam, pre = torch.zeros_like(s0), torch.ones_like(s0[..., 0])
        for t in range(*span[c]):
            lam = lam + (r[:, :, t] * pre)[..., None] * dy[:, :, t, None, :]
            pre = pre * w[:, :, t]
        g = pre[..., None] * g + lam
    ds0 = g
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(r[:, :, 0])
    for c in range(nc):
        t0, t1 = span[c]
        bounds, s = [], states[c]
        for z0 in range(t0, t1, sub):
            bounds.append(s)
            for t in range(z0, min(t1, z0 + sub)):
                s = step(s, t)
        g = ends[c]
        for zi in reversed(range(len(bounds))):
            z0 = t0 + zi * sub
            hist, s = [], bounds[zi]
            for t in range(z0, min(t1, z0 + sub)):
                hist.append(s)
                s = step(s, t)
            for x in reversed(range(len(hist))):
                t = z0 + x
                rt, kt, vt, wt, dyt = (a[:, :, t] for a in (r, k, v, w, dy))
                vdy = (vt * dyt).sum(-1, keepdim=True)
                dr[:, :, t] = torch.einsum("bhkv,bhv->bhk", hist[x], dyt) + uf * kt * vdy
                dk[:, :, t] = rt * uf * vdy + torch.einsum("bhkv,bhv->bhk", g, vt)
                dv[:, :, t] = (rt * uf * kt).sum(-1, keepdim=True) * dyt \
                    + torch.einsum("bhkv,bhk->bhv", g, kt)
                dw[:, :, t] = (g * hist[x]).sum(-1)
                du = du + rt * kt * vdy
                g = g * wt[..., None] + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.sum(0), ds0


WKV_CHUNKED_CASES = {
    # name: (B, H, T, hd, kind, chunk L): T off the chunk and sub-chunk grids
    "ragged-t150-l64": (1, 2, 150, 8, "plain", 64),
    "t-not-divided-l16": (2, 2, 37, 8, "plain", 16),
    "strong-decays-l16": (1, 3, 50, 16, "strong", 16),
    "w0-l16": (1, 2, 41, 8, "w0", 16),
    "one-step": (1, 2, 1, 8, "plain", 64),
}


@pytest.mark.parametrize("case", sorted(WKV_CHUNKED_CASES))
def test_chunk_parallel_wkv_backward_matches_jax_grad_and_plain(case):
    """The chunk-parallel backward, non-zero s0 and dS_T, against jax.vjp
    of rwkv6_scan_ref and against rwkv6_backward_plain, each gradient
    within 1e-4 max(1, max |want|)."""
    B, H, T, hd, kind, L = WKV_CHUNKED_CASES[case]
    inputs, cot = _wkv_arrays(B, H, T, hd, seed=T + hd + L, kind=kind)
    want = _wkv_vjp(inputs, cot)
    args = [torch.from_numpy(x) for x in (*inputs, *cot)]
    got = _wkv_backward_chunked(*args, L=L)
    plain = twkv.rwkv6_backward_plain(*args)
    for name, g, w, p in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want, plain):
        _within(g.numpy(), w, WKV_RTOL, f"{name} vs jax.vjp")
        _within(g.numpy(), p.numpy(), WKV_RTOL, f"{name} vs the plain backward")


@settings(database=None, derandomize=True, max_examples=5, deadline=None)
@given(T=st.integers(1, 40), L=st.sampled_from([8, 16]), sub=st.sampled_from([2, 4]),
       kind=st.sampled_from(["plain", "strong", "w0"]))
def test_chunk_parallel_wkv_backward_property(T, L, sub, kind):
    """Any T, chunk and sub-chunk length: the chunk-parallel backward is the
    plain backward's."""
    inputs, cot = _wkv_arrays(1, 2, T, 8, seed=T * 3 + L, kind=kind)
    args = [torch.from_numpy(x) for x in (*inputs, *cot)]
    for name, g, p in zip(("dr", "dk", "dv", "dw", "du", "ds0"),
                          _wkv_backward_chunked(*args, L=L, sub=sub),
                          twkv.rwkv6_backward_plain(*args)):
        _within(g.numpy(), p.numpy(), WKV_RTOL, name)


BWD_REFUSED = {
    "flash-float16": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 32), (1, 8, 1, 32), torch.float16), lse=torch.zeros(1, 2, 8)),
    "flash-hd-past-256": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 264), (1, 8, 1, 264), torch.bfloat16),
        lse=torch.zeros(1, 2, 8)),
    "flash-group-of-17": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 17, 32), (1, 8, 1, 32), torch.bfloat16),
        lse=torch.zeros(1, 17, 8)),
    "flash-dout-shape": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 32), (1, 8, 1, 32), torch.float32)[:4],
        torch.zeros(1, 8, 2, 16)),
    "wkv-hd-8": lambda: twkv.rwkv6_backward_cuda(*_wkv_torch(1, 1, 4, 8)),
    "wkv-hd-128": lambda: twkv.rwkv6_backward_cuda(*_wkv_torch(1, 1, 4, 128)),
    "wkv-float64": lambda: twkv.rwkv6_backward_cuda(
        *(t.double() for t in _wkv_torch(1, 1, 4, 16))),
    "flash-float32-lse-shape": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 32), (1, 8, 1, 32), torch.float32), lse=torch.zeros(1, 2, 9)),
    "flash-lse-shape": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 32), (1, 8, 1, 32), torch.bfloat16), lse=torch.zeros(1, 2, 9)),
    # at Sq != Sk the forward's L is a query row's: (B, Hq, Sq), not (B, Hq, Sk)
    "flash-lse-over-keys": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 32), (1, 12, 1, 32), torch.bfloat16), lse=torch.zeros(1, 2, 12)),
    "wkv-states-shape": lambda: twkv.rwkv6_backward_cuda(
        *_wkv_torch(1, 1, 130, 16), states=torch.zeros(1, 1, 2, 16, 16)),
    # the forward's outputs are required, never recomputed
    "flash-bf16-without-lse": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 32), (1, 8, 1, 32), torch.bfloat16)),
    "flash-float32-without-lse": lambda: tfa.flash_attention_backward_cuda(
        *_halves((1, 8, 2, 32), (1, 8, 1, 32), torch.float32)),
    "wkv-two-chunks-without-states": lambda: twkv.rwkv6_backward_cuda(
        *_wkv_torch(1, 1, 65, 16)),
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
                                                   torch.float32), lse=torch.zeros(1, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        twkv.rwkv6_backward_cuda(*_wkv_torch(1, 1, 4, 16))


# --------------------------------------------------------------------------- #
# On the card: each backward kernel against its plain version
# --------------------------------------------------------------------------- #

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


CUDA_ATTN_BWD = {
    # name: (B, Sq, Sk, Hq, Hkv, hd, causal, window, dtype)
    "main-window1024-bf16": (2, 4096, 4096, 8, 4, 256, True, 1024, torch.bfloat16),
    "main-global-bf16": (2, 4096, 4096, 8, 4, 256, True, 0, torch.bfloat16),
    "main-window1024-fp32": (2, 4096, 4096, 8, 4, 256, True, 1024, torch.float32),
    "main-global-fp32": (2, 4096, 4096, 8, 4, 256, True, 0, torch.float32),
    "ragged-fp32": (1, 1000, 1000, 4, 2, 64, True, 0, torch.float32),
    "ragged-bf16": (1, 1000, 1000, 4, 2, 64, True, 0, torch.bfloat16),
    "gqa8-window100-bf16": (1, 300, 300, 8, 1, 64, True, 100, torch.bfloat16),
    "hd120-fp32": (1, 130, 130, 4, 1, 120, True, 0, torch.float32),
    "noncausal-bf16": (1, 512, 512, 4, 4, 128, False, 0, torch.bfloat16),
    "hd32-window64-fp32": (2, 256, 256, 4, 2, 32, True, 64, torch.float32),
    # G = 16, hd 64 / 120 / 128 / 256, S off the 64-row tiles, window edges
    # inside a tile
    "g16-hd64-bf16": (1, 200, 200, 16, 1, 64, True, 0, torch.bfloat16),
    "g16-hd120-window50-bf16": (1, 130, 130, 16, 1, 120, True, 50, torch.bfloat16),
    "g16-hd128-s333-bf16": (1, 333, 333, 32, 2, 128, True, 0, torch.bfloat16),
    "g16-hd256-window77-bf16": (1, 333, 333, 32, 2, 256, True, 77, torch.bfloat16),
    "g5-hd64-bf16": (1, 257, 257, 10, 2, 64, True, 0, torch.bfloat16),
    "hd256-window100-s1000-bf16": (1, 1000, 1000, 4, 2, 256, True, 100, torch.bfloat16),
    "g16-hd256-window77-fp32": (1, 333, 333, 32, 2, 256, True, 77, torch.float32),
    # Sq != Sk: whisper's cross-attention (448 decoder positions over 1500
    # frames); Sq on both sides of the 64-row dK / dV tile and of the
    # 128-row dQ block over 1500 keys (11 x 128 + 92: the last dK / dV CTA's
    # second warpgroup is part-empty); more queries than keys, causal; G = 4
    # with a window that leaves rows 136.. without a live key (their P is
    # 1 / Sk on every key); hd 32, 48, 128 and 256 at Sq != Sk
    "cross-whisper-bf16": (2, 448, 1500, 20, 20, 64, False, 0, torch.bfloat16),
    "cross-whisper-fp32": (2, 448, 1500, 20, 20, 64, False, 0, torch.float32),
    "cross-sq1-bf16": (2, 1, 1500, 4, 4, 64, False, 0, torch.bfloat16),
    "cross-sq1-fp32": (2, 1, 1500, 4, 4, 64, False, 0, torch.float32),
    "cross-sq65-bf16": (1, 65, 1500, 4, 4, 64, False, 0, torch.bfloat16),
    "cross-sq65-fp32": (1, 65, 1500, 4, 4, 64, False, 0, torch.float32),
    "cross-sq127-bf16": (1, 127, 1500, 4, 4, 64, False, 0, torch.bfloat16),
    "cross-sq127-fp32": (1, 127, 1500, 4, 4, 64, False, 0, torch.float32),
    "cross-sq129-bf16": (1, 129, 1500, 4, 4, 64, False, 0, torch.bfloat16),
    "cross-sq129-fp32": (1, 129, 1500, 4, 4, 64, False, 0, torch.float32),
    "cross-300x37-causal-bf16": (1, 300, 37, 4, 4, 64, True, 0, torch.bfloat16),
    "cross-300x37-causal-fp32": (1, 300, 37, 4, 4, 64, True, 0, torch.float32),
    "cross-300x37-g4-window100-bf16": (1, 300, 37, 8, 2, 64, True, 100, torch.bfloat16),
    "cross-300x37-g4-window100-fp32": (1, 300, 37, 8, 2, 64, True, 100, torch.float32),
    "cross-hd32-448x1500-bf16": (1, 448, 1500, 8, 8, 32, False, 0, torch.bfloat16),
    "cross-hd32-448x1500-fp32": (1, 448, 1500, 8, 8, 32, False, 0, torch.float32),
    "cross-hd48-200x700-g4-causal-bf16": (1, 200, 700, 8, 2, 48, True, 0, torch.bfloat16),
    "cross-hd48-200x700-g4-causal-fp32": (1, 200, 700, 8, 2, 48, True, 0, torch.float32),
    "cross-hd128-200x700-g4-bf16": (1, 200, 700, 8, 2, 128, False, 0, torch.bfloat16),
    "cross-hd128-200x700-g4-fp32": (1, 200, 700, 8, 2, 128, False, 0, torch.float32),
    "cross-hd256-200x700-g4-causal-bf16": (1, 200, 700, 8, 2, 256, True, 0, torch.bfloat16),
    "cross-hd256-500x130-window100-bf16": (1, 500, 130, 4, 1, 256, True, 100, torch.bfloat16),
    "cross-hd256-500x130-window100-fp32": (1, 500, 130, 4, 1, 256, True, 100, torch.float32),
}


def _cuda_attn_inputs(B, Sq, Sk, Hq, Hkv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(_rand(rng, *shape)).to("cuda", dtype)
                 for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
                               (B, Sq, Hq, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_ATTN_BWD))
def test_cuda_flash_backward_matches_plain(case):
    _need_cuda()
    B, Sq, Sk, Hq, Hkv, hd, causal, window, dtype = CUDA_ATTN_BWD[case]
    q, k, v, dout = _cuda_attn_inputs(B, Sq, Sk, Hq, Hkv, hd, dtype, seed=Sq)
    bf16 = dtype == torch.bfloat16
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    want_lse = tfa.attention_lse_plain(q, k, causal=causal, window=window)
    live = want_lse > 0.5 * tfa.NEG_INF * tfa.LOG2E
    assert float((lse - want_lse)[live].abs().max()) <= 2e-5 * max(1.0, float(
        want_lse[live].abs().max())), "the forward's L"
    before = (tfa.launches_bwd, tfa.launches_bwd_bf16)
    got = tfa.flash_attention_backward_cuda(q, k, v, out, dout, causal=causal,
                                            window=window, lse=lse)
    torch.cuda.synchronize()
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
    again = tfa.flash_attention_backward_cuda(q, k, v, out, dout, causal=causal,
                                              window=window, lse=lse)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2), "two calls give the same bits (no atomics)"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_function_at_two_lengths_round_trip(dtype):
    """Whisper's cross-attention shape (448 queries over 1500 keys) through
    FlashAttentionFn on the card, q, k and v all needing a gradient: one
    forward and one backward launch, and the gradients the backward kernel
    gives on the forward's own output and L, bit for bit."""
    _need_cuda()
    q, k, v, dout = _cuda_attn_inputs(1, 448, 1500, 20, 20, 64, dtype, seed=12)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    bf16 = dtype == torch.bfloat16
    before = (tfa.launches, tfa.launches_bf16, tfa.launches_bwd, tfa.launches_bwd_bf16)
    out = tops.attention(*leaves, causal=False)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.launches_bf16, tfa.launches_bwd, tfa.launches_bwd_bf16) == (
        before[0] + (not bf16), before[1] + bf16, before[2] + (not bf16), before[3] + bf16)
    out2, lse = tfa.flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    assert torch.equal(out2, out.detach())
    want = tfa.flash_attention_backward_cuda(q, k, v, out2, dout, causal=False, lse=lse)
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.shape == leaf.shape and torch.equal(leaf.grad, w), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_at_two_lengths_strided(dtype, hd):
    """q a view of a fused (B, Sq, Hq + 4, hd) buffer, k and v views of a
    fused (B, Sk, 2 Hkv, hd) one, Sq != Sk, and a transposed dO: the
    contiguous inputs' gradients, bit for bit."""
    _need_cuda()
    B, Sq, Sk, Hq, Hkv = 1, 130, 333, 8, 2
    rng = np.random.default_rng(13)
    fq = torch.from_numpy(_rand(rng, B, Sq, Hq + 4, hd)).to("cuda", dtype)
    fkv = torch.from_numpy(_rand(rng, B, Sk, 2 * Hkv, hd)).to("cuda", dtype)
    q, k, v = fq[:, :, 2:2 + Hq], fkv[:, :, :Hkv], fkv[:, :, Hkv:]
    dout = torch.from_numpy(_rand(rng, B, Hq, Sq, hd)).to("cuda", dtype).transpose(1, 2)
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=True, window=200, return_lse=True)
    got = tfa.flash_attention_backward_cuda(q, k, v, out, dout, causal=True, window=200,
                                            lse=lse)
    want = tfa.flash_attention_backward_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                             out, dout.contiguous(), causal=True, window=200,
                                             lse=lse)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("S", [1, 2, 7, 15])
def test_cuda_float32_flash_backward_at_a_few_rows(S, hd, causal):
    """The float32 backward below one 16-row tile, L from the forward, each
    gradient within 1e-4 max(1, max |want|) of the plain backward."""
    _need_cuda()
    rng = np.random.default_rng(S * hd)
    q, k, v, dout = (torch.from_numpy(_rand(rng, *shape)).cuda()
                     for shape in ((1, S, 2, hd), (1, S, 1, hd), (1, S, 1, hd),
                                   (1, S, 2, hd)))
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    got = tfa.flash_attention_backward_cuda(q, k, v, out, dout, causal=causal, lse=lse)
    want = tfa.attention_backward_plain(q, k, v, out, dout, causal=causal)
    for name, g, w in zip("qkv", got, want):
        _within(g.cpu().numpy(), w.cpu().numpy(), CARD_F32_RTOL, f"d{name}")


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
def test_cuda_bf16_functions_hand_their_saved_outputs_to_the_backward_kernels():
    """bf16 attention and the wkv through their Functions on the card: one
    forward launch and one backward launch each (the backward takes the L
    and the chunk states its forward stored; no forward runs again), and
    the gradients of the kernels' own forward outputs."""
    _need_cuda()
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(_rand(rng, *shape)).to("cuda", torch.bfloat16)
               for shape in ((1, 300, 4, 64), (1, 300, 2, 64), (1, 300, 2, 64)))
    k.requires_grad_()
    before = (tfa.launches_bf16, tfa.launches_bwd_bf16)
    out = tops.attention(q, k, v, causal=True, window=100)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (tfa.launches_bf16, tfa.launches_bwd_bf16) == (before[0] + 1, before[1] + 1)
    lse = tfa.flash_attention_cuda(q, k.detach(), v, causal=True, window=100,
                                   return_lse=True)[1]
    want = tfa.flash_attention_backward_cuda(q, k.detach(), v, out.detach(),
                                             torch.ones_like(out), causal=True,
                                             window=100, lse=lse)[1]
    assert torch.equal(k.grad, want)
    inputs, (dy, _) = _wkv_arrays(1, 3, 200, 64, seed=4)
    leaves = [torch.from_numpy(x).cuda().requires_grad_() for x in inputs]
    before = (twkv.launches, twkv.launches_bwd)
    y, _ = tops.rwkv6_wkv(*leaves)
    y.backward(torch.from_numpy(dy).cuda())
    torch.cuda.synchronize()
    assert (twkv.launches, twkv.launches_bwd) == (before[0] + 1, before[1] + 1)
    want = twkv.rwkv6_backward_plain(*(t.detach() for t in leaves),
                                     torch.from_numpy(dy).cuda(),
                                     torch.zeros_like(leaves[5]))
    for name, t, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), leaves, want):
        _within(t.grad.cpu().numpy(), w.cpu().numpy(), WKV_RTOL, name)


@pytest.mark.cuda
def test_cuda_float32_function_hands_its_forward_l_to_the_backward_kernel():
    """float32 attention through FlashAttentionFn on the card: one forward
    launch (which writes L) and one backward launch, whose gradients are
    the kernel's on the forward's own L and output, bit for bit, and the
    plain backward's within the float32 limit."""
    _need_cuda()
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(_rand(rng, *shape)).cuda()
               for shape in ((1, 300, 4, 64), (1, 300, 2, 64), (1, 300, 2, 64)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tfa.launches, tfa.launches_bwd)
    out = tops.attention(*leaves, causal=True, window=100)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.launches_bwd) == (before[0] + 1, before[1] + 1)
    out2, lse = tfa.flash_attention_cuda(q, k, v, causal=True, window=100, return_lse=True)
    assert torch.equal(out2, out.detach())
    got = tfa.flash_attention_backward_cuda(q, k, v, out2, torch.ones_like(out2), causal=True,
                                            window=100, lse=lse)
    want = tfa.attention_backward_plain(q, k, v, out2, torch.ones_like(out2), causal=True,
                                        window=100)
    for name, leaf, g, w in zip("qkv", leaves, got, want):
        assert torch.equal(leaf.grad, g), f"d{name}"
        assert float((g - w).abs().max()) <= CARD_F32_RTOL * float(w.abs().max()), f"d{name}"


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
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=True, window=50, return_lse=True)
    got = tfa.flash_attention_backward_cuda(q, k, v, out, dout, causal=True, window=50,
                                            lse=lse)
    want = tfa.flash_attention_backward_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                             out, dout.contiguous(), causal=True, window=50,
                                             lse=lse)
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
    # either side of one chunk (64 steps), and the main length at each hd
    "t63": (2, 40, 63, 64, "plain"),
    "t64": (2, 40, 64, 64, "plain"),
    "t65": (2, 40, 65, 64, "strong"),
    "t4096-hd16": (1, 8, 4096, 16, "strong"),
    "t4096-hd32": (1, 8, 4096, 32, "plain"),
    "t65-hd32": (2, 3, 65, 32, "w0"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_WKV_BWD))
def test_cuda_wkv_backward_matches_plain(case):
    _need_cuda()
    B, H, T, hd, kind = CUDA_WKV_BWD[case]
    inputs, cot = _wkv_arrays(B, H, T, hd, seed=T, kind=kind)
    args = [torch.from_numpy(x).cuda() for x in (*inputs, *cot)]
    states = twkv.rwkv6_cuda(*args[:6], return_states=True)[2]
    assert (states is None) == (T < twkv.CHUNK)
    before = twkv.launches_bwd
    got = twkv.rwkv6_backward_cuda(*args, states=states)
    torch.cuda.synchronize()
    assert twkv.launches_bwd == before + 1
    if T > twkv.CHUNK:                                # never recomputed
        with pytest.raises(ValueError, match="chunk states"):
            twkv.rwkv6_backward_cuda(*args)
        assert twkv.launches_bwd == before + 1
    want = twkv.rwkv6_backward_plain(*args)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        _within(g.cpu().numpy(), w.cpu().numpy(), WKV_RTOL, name)
