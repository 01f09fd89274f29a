"""The port's attention and RWKV6 wkv kernels (`repro_torch.kernels.
flash_attention`, `.rwkv6_scan`, through `ops.attention` / `ops.rwkv6_wkv`)
against the reference, on the same numpy inputs.

On the CPU the wrappers take the plain versions; they are held against the
Pallas kernels in interpret mode (`repro.kernels.ops`) and against the
oracles `repro.kernels.ref.attention_ref` / `rwkv6_scan_ref`, at the
reference's own tolerances: attention 2e-5 in float32 and 3e-2 in bfloat16,
wkv 1e-4.  Covered: causal, sliding-window and non-causal attention, GQA
groups of 1, 2, 4 and 8, head_dim 32, 64, 128 and 256, S off every block
size; the model's two attention forms (`attend_full`, `attend_chunked`);
wkv at T = 1, chunked composition (two halves == the whole), w = 0; and
queries and keys of two lengths (Sk > Sq, Sk < Sq, causal or not, a window
that leaves rows with no live key, G = 1 and 4) against the reference's
`attend_full`, through `attention_plain` and `FlashAttentionFn`.  The
arithmetic of four Hopper designs is checked here too, in PyTorch: the
float32 flash kernel's 3xTF32 products hold 2e-5 where one TF32 product
does not; the bf16 kernel's hd <= 128 form (128-key tiles, the scale in
the exponent's FMA, P in two bf16 terms) holds the card's per-element
limit at G = 5, 6 and 8, causal and windowed; its hd <= 64 form (64-key
tiles, the row sums in two chains a lane, the exponent reference moved
only past a slack of 8) holds it at whisper-large-v3's three attention
shapes, and with P's low term dropped does not; the host's choice of
bf16 kernel by head_dim (`sm90_plan`) is checked; and the wkv kernel's
chunked form (chunks and sub-chunks, decays only multiplied) matches the
plain version and the Pallas kernel at ragged T, w = 0 (exactly the last
k v^T), strong decays and a split off every chunk boundary.

The CUDA kernels are held against the plain versions on the card (`cuda`
marker; skipped without one): the float32 kernel at 2e-5, and the bf16
tensor-core kernel element by element against the float32 result of the
same inputs, within one rounding to bfloat16 (2^-8 |want| + 2e-5), at the
LM path's (2, 4096, 8 / 4, 256) with windows 1024 and 0 (float32 on
full-mantissa inputs) and at the edge cases (ragged S, non-causal, G = 8
and 5, head_dim 32, 120 and 128, windows; the hd <= 128 kernel at G = 5,
6 and 8, causal and windowed, S = 1000 off its tiles; both kernels at Sk !=
Sq: whisper's cross-attention (2, 448 x 1500, 20, 64), Sq = 1, ragged
lengths causal, non-causal and windowed, hd 128 and 256, G = 4, their L
against the plain log-sum-exp; the hd <= 64 kernel at whisper's encoder,
decoder and cross shapes, S and Sq on both sides of its 128-row block and
of a warpgroup's 64 rows, G = 1 and 4, hd 32 and 48, a window that leaves
rows with no live key); the wkv kernels (chunked for
T >= 64, recurrent below) at the LM shape, ragged T, strong decays, a
split off the chunk boundaries and w = 0, the recurrent kernel at T = 1,
16 and 63 for every head dim (rows on and off the 16-byte grid), four
T = 1 steps against one T = 4 call, and w = 0 at T = 1; and a q that
requires grad
goes through `FlashAttentionFn` to the backward kernel, whose q.grad must
match the plain backward (`tests/test_torch_lm_grad.py` holds both backward
kernels at their shapes); the bf16 forward and backward called first from
a fresh thread (no current CUDA context: their TMA maps need one) give the
main thread's bits.  What the kernels do not take, the wrappers
refuse before they look at the device, so those refusals are tested here
on the CPU."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as twkv  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

ATOL_F32 = 2e-5
ATOL_BF16 = 3e-2
WKV_ATOL = 1e-4
# the bf16 kernel against the float32 result of its inputs, per element: it
# computes in float32 and rounds once to bf16 (half an ulp, 2^-8 |x|)
RTOL_BF16_ROUNDING = 2.0 ** -8
# the backward kernel against the plain backward (tests/test_torch_lm_grad.py):
# float32 within 1e-4 max |want|; bf16 per element, one rounding plus 1e-3 max |want|
GRAD_RTOL_F32 = 1e-4
GRAD_ATOL_BF16 = 1e-3


def _qkv(B, S, Hq, Hkv, hd, seed=0, Sk=None):
    """q (B, S, Hq, hd), k and v (B, Sk, Hkv, hd) (Sk = S by default)."""
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))


def _torch(*arrays, dtype=torch.float32, device="cpu"):
    return tuple(torch.from_numpy(a).to(device, dtype) for a in arrays)


def _np(t):
    return t.float().cpu().numpy()


def _jax_bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


ATTN_CASES = {
    # name: (B, S, Hq, Hkv, hd, causal, window)
    "causal-gqa2-hd32": (2, 128, 4, 2, 32, True, 0),
    "causal-mha-hd64": (1, 128, 2, 2, 64, True, 0),
    "causal-gqa8-hd32": (1, 128, 8, 1, 32, True, 0),
    "window48-hd32": (2, 256, 4, 2, 32, True, 48),
    "window200-hd128": (1, 256, 2, 1, 128, True, 200),
    "noncausal-hd64": (1, 128, 2, 2, 64, False, 0),
    "causal-gqa4-hd256": (1, 128, 4, 1, 256, True, 0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_attention_matches_pallas_and_oracle(case):
    B, S, Hq, Hkv, hd, causal, window = ATTN_CASES[case]
    q, k, v = _qkv(B, S, Hq, Hkv, hd, seed=S + Hq + hd)
    got = _np(tops.attention(*_torch(q, k, v), causal=causal, window=window))
    pal = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window))
    ora = np.asarray(jref.attention_ref(q, k, v, causal=causal, window=window))
    np.testing.assert_allclose(got, pal, rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(got, ora, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("window", [0, 24])
def test_plain_attention_bf16(window):
    q, k, v = _qkv(2, 128, 4, 2, 64, seed=3 + window)
    got = _np(tops.attention(*_torch(q, k, v, dtype=torch.bfloat16), causal=True,
                             window=window))
    qb, kb, vb = (_jax_bf16(a) for a in (q, k, v))
    pal = np.asarray(jops.attention(qb, kb, vb, causal=True, window=window), np.float32)
    ora = np.asarray(jref.attention_ref(qb, kb, vb, causal=True, window=window),
                     np.float32)
    np.testing.assert_allclose(got, pal, rtol=0, atol=ATOL_BF16)
    np.testing.assert_allclose(got, ora, rtol=0, atol=ATOL_BF16)


@pytest.mark.parametrize("S,window", [(100, 0), (100, 30), (200, 0), (37, 5)])
def test_plain_attention_ragged_length(S, window):
    """S off every block size: against the Pallas kernel where it takes the
    shape (S < 128 is one block), always against the oracle."""
    q, k, v = _qkv(1, S, 4, 2, 32, seed=S)
    got = _np(tops.attention(*_torch(q, k, v), causal=True, window=window))
    ora = np.asarray(jref.attention_ref(q, k, v, causal=True, window=window))
    np.testing.assert_allclose(got, ora, rtol=0, atol=ATOL_F32)
    if S < 128:
        pal = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, window=window))
        np.testing.assert_allclose(got, pal, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("window", [0, 48])
def test_model_attention_forms_match_reference(window):
    """`attend_full` and `attend_chunked` of the port (their CPU forms)
    against the reference's, and against the kernel's plain version."""
    q, k, v = _qkv(2, 256, 4, 2, 32, seed=9 + window)
    tq, tk, tv = _torch(q, k, v)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    full = _np(tattn.attend_full(tq, tk, tv, causal=True, window=window))
    chunked = _np(tattn.attend_chunked(tq, tk, tv, causal=True, window=window,
                                       q_chunk=64, k_chunk=64))
    np.testing.assert_allclose(full, np.asarray(jattn.attend_full(
        jq, jk, jv, causal=True, window=window)), rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(chunked, np.asarray(jattn.attend_chunked(
        jq, jk, jv, causal=True, window=window, q_chunk=64, k_chunk=64)),
        rtol=0, atol=ATOL_F32)
    plain = _np(tfa.attention_plain(tq, tk, tv, causal=True, window=window))
    np.testing.assert_allclose(full, plain, rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(chunked, plain, rtol=0, atol=ATOL_F32)


CROSS_CASES = {
    # name: (B, Sq, Sk, Hq, Hkv, hd, causal, window)
    "longer-keys-noncausal-g1": (2, 12, 40, 2, 2, 32, False, 0),
    "longer-keys-causal-g4": (1, 12, 40, 8, 2, 32, True, 0),
    "shorter-keys-noncausal-g4": (1, 40, 12, 4, 1, 64, False, 0),
    "shorter-keys-causal-g1": (2, 40, 12, 2, 2, 32, True, 0),
    # rows 17.. have no live key: the softmax of Sk equal scores, the mean of v
    "shorter-keys-window6-g4": (1, 40, 12, 8, 2, 32, True, 6),
    "one-query-g4-hd128": (2, 1, 37, 4, 1, 128, False, 0),
}


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_attention_at_two_lengths_matches_attend_full(case):
    """Sq != Sk (the decoder's cross-attention) through `attention_plain`
    and `FlashAttentionFn` on CPU tensors, against the reference's
    `attend_full` at its default positions, 0..Sq-1 against 0..Sk-1."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window = CROSS_CASES[case]
    q, k, v = _qkv(B, Sq, Hq, Hkv, hd, seed=Sq * Sk, Sk=Sk)
    want = np.asarray(jattn.attend_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, window=window))
    args = _torch(q, k, v)
    for got in (tfa.attention_plain(*args, causal=causal, window=window),
                tops.attention(*args, causal=causal, window=window)):
        assert got.shape == (B, Sq, Hq, hd)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATOL_F32)


def test_attend_decode_matches_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 8, 2, 32)).astype(np.float32) for _ in range(2))
    for pos, window in [(3, 0), (5, 8), (11, 8)]:
        got = _np(tattn.attend_decode(*_torch(q, kc, vc), pos, window=window))
        want = np.asarray(jattn.attend_decode(jnp.asarray(q), jnp.asarray(kc),
                                              jnp.asarray(vc), jnp.asarray(pos),
                                              window=window))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


def _wkv_inputs(B, H, T, hd, seed=0):
    """The reference test's distribution: decays in (0.55, 0.95)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, hd)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((B, H, T, hd)))) * 0.4 + 0.55).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _wkv_check(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a) if isinstance(a, torch.Tensor) else a,
                                   np.asarray(b), rtol=0, atol=WKV_ATOL)


@pytest.mark.parametrize("B,H,T,hd", [(1, 1, 8, 8), (2, 3, 33, 16), (1, 4, 128, 32),
                                      (2, 2, 1, 64), (1, 2, 16, 64)])
def test_plain_wkv_matches_pallas_and_oracle(B, H, T, hd):
    args = _wkv_inputs(B, H, T, hd, seed=T + hd)
    before = twkv.launches
    got = tops.rwkv6_wkv(*_torch(*args))
    assert twkv.launches == before           # no kernel on CPU tensors
    _wkv_check(got, jops.rwkv6_wkv(*(jnp.asarray(a) for a in args)))
    _wkv_check(got, jref.rwkv6_scan_ref(*(jnp.asarray(a) for a in args)))


def test_plain_wkv_chunked_composition():
    """Two halves with the state carried == the whole sequence."""
    r, k, v, w, u, s0 = _torch(*_wkv_inputs(1, 2, 64, 16, seed=5))
    y_full, s_full = tops.rwkv6_wkv(r, k, v, w, u, s0)
    y1, s_mid = tops.rwkv6_wkv(r[:, :, :32], k[:, :, :32], v[:, :, :32], w[:, :, :32],
                               u, s0)
    y2, s_end = tops.rwkv6_wkv(r[:, :, 32:], k[:, :, 32:], v[:, :, 32:], w[:, :, 32:],
                               u, s_mid)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], dim=2)), _np(y_full), atol=WKV_ATOL)
    np.testing.assert_allclose(_np(s_end), _np(s_full), atol=WKV_ATOL)


def test_plain_wkv_zero_decay_forgets_state():
    r, k, v, w, u, s0 = _wkv_inputs(1, 1, 4, 8, seed=9)
    w[:] = 0.0
    y, sT = tops.rwkv6_wkv(*_torch(r, k, v, w, u, s0))
    np.testing.assert_allclose(_np(sT)[0, 0], k[0, 0, -1][:, None] * v[0, 0, -1][None, :],
                               atol=1e-5)
    _wkv_check((y, sT), jops.rwkv6_wkv(*(jnp.asarray(a) for a in (r, k, v, w, u, s0))))


# --------------------------------------------------------------------------- #
# The arithmetic of the two Hopper designs, in PyTorch on the CPU (test-only
# helpers, on no path): csrc/flash_attention.cu's 3xTF32 products and
# csrc/rwkv6_scan.cu's chunked form
# --------------------------------------------------------------------------- #

def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero:
    cvt.rna.tf32.f32): add half of the dropped 13 bits, then mask them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, terms):
    """a @ b with TF32 operands and float32 sums: one term (hi hi') or
    three (hi hi' + hi lo' + lo hi', lo = tf32(x - hi))."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if terms == 3:
        out = out + ah @ _tf32(b - bh) + _tf32(a - ah) @ bh
    return out


def _attention_tf32(q, k, v, *, causal, window, terms):
    """The float32 kernel's arithmetic: S = (Q K^T) scale and O = P V, each
    product of TF32 operands, the softmax in float32."""
    B, S, Hq, hd = q.shape
    G = Hq // k.shape[2]
    qh = q.permute(0, 2, 1, 3)                                   # (B, Hq, S, hd)
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1) for t in (k, v))
    s = _mm_tf32(qh, kh.transpose(-1, -2), terms) / (hd ** 0.5)
    pos = torch.arange(S)
    ok = pos[None, :] <= pos[:, None] if causal else torch.ones(S, S, dtype=torch.bool)
    if window > 0:
        ok &= pos[:, None] - pos[None, :] < window
    p = torch.softmax(s.masked_fill(~ok, tfa.NEG_INF), dim=-1)
    return _mm_tf32(p, vh, terms).permute(0, 2, 1, 3)


@pytest.mark.parametrize("shape,window", [((1, 128, 4, 2, 64), 0),
                                          ((1, 160, 4, 1, 256), 48)])
def test_three_tf32_terms_hold_the_float32_tolerance_and_one_does_not(shape, window):
    """Full-mantissa float32 inputs: the 3xTF32 products stay within 2e-5 of
    the plain version, one TF32 product does not (why the kernel splits)."""
    q, k, v = _torch(*_qkv(*shape, seed=sum(shape)))
    want = tfa.attention_plain(q, k, v, causal=True, window=window)
    err = {terms: float((_attention_tf32(q, k, v, causal=True, window=window,
                                         terms=terms) - want).abs().max())
           for terms in (1, 3)}
    assert err[3] <= ATOL_F32 < err[1], err


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _chain_sums(p, keys, chains=2):
    """Each quad lane's sum of a tile's p (..., keys) as the hd-64 kernel
    takes it: lane t holds columns 8 j + 2 t + e (j < keys / 8, e < 2) of
    a row, in `chains` chains c = j % chains, each summed from 0 in order
    of j and e, then added in order of c; returns (..., 4), the lanes'
    sums (the epilogue joins them)."""
    n = p.shape[-1]
    p = torch.nn.functional.pad(p, (0, keys - n)).reshape(
        *p.shape[:-1], keys // (8 * chains), chains, 4, 2)
    part = torch.zeros(p.shape[:-4] + (4, chains), dtype=p.dtype)     # (..., t, c)
    for jj in range(keys // (8 * chains)):
        for e in range(2):
            part = part + p[..., jj, :, :, e].transpose(-1, -2)
    lanes = part[..., 0]
    for c in range(1, chains):
        lanes = lanes + part[..., c]
    return lanes


def _flash_narrow_emulation(q, k, v, *, causal, window, keys=128, rows=128, terms=2,
                            sum_chains=False, slack=0.0):
    """csrc/flash_attention_sm90.cu's kernels for hd <= 128 on bf16 values
    held in float32: a CTA per `rows` packed (position, head) rows (rows / G
    positions), its live kv range in tiles of `keys` keys over Sk =
    k.shape[1] keys; S = q.k in float32; masked scores -inf; the running
    max m in log2 units, moved to max(m, max(S) scale log2 e) each tile and
    O, l rescaled by exp2(m_old - m); p = exp2(S scale log2 e - m) with the
    exponent one fused rounding; O += P_hi V + P_lo V (P in two bf16 terms,
    or P_hi alone with `terms` 1); out = bf16(O / max(l, 1e-30)).  With
    `sum_chains` l takes each tile's p as the hd-64 kernel sums it
    (_chain_sums: per lane, then the four lanes at the end); with `slack`
    m moves only where the tile's max passes it by more than `slack`."""
    B, S, Hq, hd = q.shape
    Sk = k.shape[1]
    G = Hq // k.shape[2]
    c = torch.tensor(tfa.LOG2E / hd ** 0.5, dtype=torch.float32)
    qh = q.permute(0, 2, 1, 3)                                   # (B, Hq, S, hd)
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1) for t in (k, v))
    out = torch.empty(B, Hq, S, hd)
    P = rows // G
    for q_lo in range(0, S, P):
        q_hi = min(q_lo + P, S) - 1
        kv_lo = max(0, q_lo - window + 1) if window > 0 else 0
        kv_hi = min(q_hi, Sk - 1) if causal else Sk - 1
        pos = torch.arange(q_lo, q_hi + 1)[:, None]
        qb = qh[:, :, q_lo:q_hi + 1]
        m = torch.full(qb.shape[:3] + (1,), tfa.NEG_INF * tfa.LOG2E)
        l = torch.zeros(qb.shape[:3] + ((4,) if sum_chains else (1,)))
        o = torch.zeros_like(qb)
        for t in range(kv_lo // keys, kv_hi // keys + 1):
            kp = torch.arange(t * keys, min(Sk, (t + 1) * keys))[None, :]
            s = qb @ kh[:, :, kp[0]].transpose(-1, -2)
            ok = torch.ones(pos.shape[0], kp.shape[1], dtype=torch.bool)
            if causal:
                ok &= kp <= pos
            if window > 0:
                ok &= pos - kp < window
            s = s.masked_fill(~ok, float("-inf"))
            mx = s.amax(-1, keepdim=True) * c
            n = torch.where(mx > m + slack, mx, m)
            corr = torch.exp2(m - n)
            p = torch.exp2((s.double() * c.double() - n.double()).float())
            hi = _bf16(p)
            lo = _bf16(p - hi)
            vt = vh[:, :, kp[0]]
            o = o * corr + hi @ vt + (lo @ vt if terms == 2 else 0.0)
            l = l * corr + (_chain_sums(p, keys) if sum_chains else p.sum(-1, keepdim=True))
            m = n
        if sum_chains:                       # the epilogue's shuffles: xor 1, then 2
            l = l + l[..., [1, 0, 3, 2]]
            l = (l + l[..., [2, 3, 0, 1]])[..., :1]
        out[:, :, q_lo:q_hi + 1] = o / torch.clamp(l, min=1e-30)
    return _bf16(out.permute(0, 2, 1, 3))


@pytest.mark.parametrize("Hq,Hkv,window", [(10, 2, 0), (10, 2, 100), (12, 2, 0),
                                           (12, 2, 100), (8, 1, 0), (8, 1, 100)])
def test_flash_hd128_tile_order_holds_the_card_limit(Hq, Hkv, window):
    """The hd <= 128 kernel's arithmetic (128-key tiles, scores in log2
    units with the scale in the exponent's FMA, P in two bf16 terms, a
    rescale whenever the max moves) on bf16 inputs at G = 5, 6 and 8,
    causal and windowed, S off the tiles: every element within one bf16
    rounding plus 2e-5 of the float32 plain version (chip_smoke.py's
    per-element check)."""
    q, k, v = (_bf16(t) for t in _torch(*_qkv(1, 300, Hq, Hkv, 128, seed=Hq + window)))
    got = _flash_narrow_emulation(q, k, v, causal=True, window=window)
    want = tfa.attention_plain(q, k, v, causal=True, window=window)
    share = float(((got - want).abs() / (RTOL_BF16_ROUNDING * want.abs() + ATOL_F32)).max())
    assert share <= 1.0, share


@pytest.mark.parametrize("Sq,Sk,causal", [(448, 1500, False), (1500, 1500, False),
                                           (448, 448, True)])
def test_flash_hd64_arithmetic_holds_the_card_limit_at_whisper_shapes(Sq, Sk, causal):
    """The hd-64 kernel's arithmetic (flash_sm90_hd64_kernel: 128 rows a
    CTA and 64-key tiles, P in two bf16 terms, each tile's row sums in two
    chains a lane, a row's exponent reference moved only where its max
    passes it by more than 8) at whisper-large-v3's three attention shapes
    (4 heads of its 20, standard normal inputs as chip_smoke.py's check
    takes them): every element within one bf16 rounding plus 2e-5 of the
    float32 plain version; with P's low term dropped an element is not."""
    q, k, v = (_bf16(t) for t in _torch(*_qkv(1, Sq, 4, 4, 64, seed=Sq + Sk, Sk=Sk)))
    want = tfa.attention_plain(q, k, v, causal=causal)
    limit = RTOL_BF16_ROUNDING * want.abs() + ATOL_F32
    share = {terms: float(((_flash_narrow_emulation(
        q, k, v, causal=causal, window=0, keys=64, terms=terms, sum_chains=True,
        slack=8.0) - want).abs() / limit).max()) for terms in (1, 2)}
    assert share[2] <= 1.0 < share[1], share


def test_sm90_plan_picks_the_kernel_by_head_dim():
    """The bf16 kernel of each head_dim the wrappers take (multiples of 8
    up to 256): the hd-64 kernel (two CTAs an SM) up to 64, the narrow
    kernel up to 128, the wide one beyond; refused past 256."""
    for hd in range(8, tfa.MAX_HEAD_DIM + 1, 8):
        plan = tfa.sm90_plan(hd)
        want = (0, 2) if hd <= 64 else (1, 1) if hd <= 128 else (2, 1)
        assert (plan.kernel, plan.ctas_per_sm) == want, (hd, plan)
    assert tfa.sm90_plan(64).name == "flash_sm90_hd64_kernel"
    assert tfa.sm90_plan(120).name == "flash_sm90_narrow_kernel<2>"
    assert tfa.sm90_plan(256).name == "flash_sm90_kernel<4>"
    for hd in (0, tfa.MAX_HEAD_DIM + 8):
        with pytest.raises(ValueError, match="head_dim"):
            tfa.sm90_plan(hd)


def _wkv_chunked(r, k, v, w, u, s0, L, sub):
    """csrc/rwkv6_scan.cu's chunked form: T in chunks of L, each chunk in
    sub-chunks of ``sub`` steps; decays only ever multiplied, never divided,
    so no factor exceeds 1 and w = 0 is exact:
    1. per chunk, from a zero state: A[t, s] (s < t) = r_t . (k_s * w_{s+1}
       ... w_{t-1}); within a sub-chunk by carrying q_s = k_s * (product so
       far) forward in t, which leaves k^_s = k_s decayed to its sub-chunk's
       end; across sub-chunks sa < tc as r^_t . (M k^_s), r^_t = r_t decayed
       from tc's start, M the whole products F of the sub-chunks between.
       The bonus (r_t . u k_t) on the diagonal; y = A v; the chunk's state
       K = sum_g diag(F_{g+1} ... F_last) sum_{s in g} k^_s v_s^T and its
       decay D = prod_g F_g;
    2. across chunks: S_{c+1} = diag(D_c) S_c + K_c, from s0;
    3. y_t += (r^_t * F_0 ... F_{g(t)-1}) . S_c."""
    B, H, T, hd = r.shape
    nc, ns = -(-T // L), L // sub
    pad = nc * L - T

    def chunks(x, fill):
        x = torch.cat([x, x.new_full((B, H, pad, hd), fill)], dim=2)
        return x.reshape(B, H, nc, L, hd)
    rc, kc, vc, wc = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0), chunks(w, 1.0)
    idx = torch.arange(L)
    q, A = kc.clone(), torch.zeros(B, H, nc, L, L)
    for t in range(L):
        live = (idx < t) & (idx // sub == t // sub)     # s < t, t's sub-chunk
        A[..., t, :] = torch.where(live, (q * rc[..., t, None, :]).sum(-1), 0.0)
        q = torch.where(live[:, None], q * wc[..., t, None, :], q)
    rhat, F = torch.zeros_like(rc), torch.ones(B, H, nc, ns, hd)
    for t in range(L):
        g = t // sub
        rhat[..., t, :] = rc[..., t, :] * F[..., g, :]
        F[..., g, :] = F[..., g, :] * wc[..., t, :]

    def blk(x, g):
        return x[..., g * sub:(g + 1) * sub, :]
    for sa in range(ns):
        for tc in range(sa + 1, ns):
            m = torch.ones(B, H, nc, hd)
            for g in range(sa + 1, tc):
                m = m * F[..., g, :]
            A[..., tc * sub:(tc + 1) * sub, sa * sub:(sa + 1) * sub] = \
                blk(rhat, tc) @ (blk(q, sa) * m[..., None, :]).transpose(-1, -2)
    A = A + torch.diag_embed((rc * u[None, :, None, None, :] * kc).sum(-1))
    y = A @ vc
    K = torch.zeros(B, H, nc, hd, hd)
    for g in range(ns):
        d = torch.ones(B, H, nc, hd)
        for x in range(g + 1, ns):
            d = d * F[..., x, :]
        K = K + d[..., None] * (blk(q, g).transpose(-1, -2) @ blk(vc, g))
    decay = torch.ones(B, H, nc, hd)
    for g in range(ns):
        decay = decay * F[..., g, :]
    S = s0.clone()
    states = []
    for c in range(nc):
        states.append(S)
        S = decay[:, :, c, :, None] * S + K[:, :, c]
    pre = torch.ones(B, H, nc, hd)
    for g in range(ns):
        rhat[..., g * sub:(g + 1) * sub, :] *= pre[..., None, :]
        pre = pre * F[..., g, :]
    y = y + rhat @ torch.stack(states, 2)
    return y.reshape(B, H, nc * L, hd)[:, :, :T], S


def _strong_decay(args, seed):
    """The model's decay w = exp(-exp(x)) with x over -6..3: from 0.9975
    (the init's w0 = -6) down to 2e-9."""
    x = np.random.default_rng(seed).uniform(-6.0, 3.0, args[3].shape)
    return args[:3] + (np.exp(-np.exp(x)).astype(np.float32),) + args[4:]


WKV_CHUNKED = {
    # name: ((B, H, T, hd), L, sub-chunk, decay)
    "ragged-T": ((1, 2, 100, 16), 16, 4, "reference"),
    "one-partial-chunk": ((2, 1, 13, 8), 16, 8, "reference"),
    "strong-decay": ((1, 2, 96, 32), 32, 8, "strong"),
    "zero-decay": ((1, 3, 70, 16), 16, 4, "zero"),
    "kernel-chunks-hd64": ((1, 1, 130, 64), 64, 16, "strong"),
}


@pytest.mark.parametrize("case", sorted(WKV_CHUNKED))
def test_chunked_wkv_form_matches_plain_and_pallas(case):
    shape, L, sub, decay = WKV_CHUNKED[case]
    args = _wkv_inputs(*shape, seed=sum(shape) + L)
    if decay == "strong":
        args = _strong_decay(args, seed=L)
    elif decay == "zero":
        args[3][:] = 0.0
    got = _wkv_chunked(*_torch(*args), L, sub)
    _wkv_check(got, twkv.rwkv6_plain(*_torch(*args)))
    _wkv_check(got, jops.rwkv6_wkv(*(jnp.asarray(a) for a in args)))
    if decay == "zero":                       # only the last k v^T is left
        k, v = args[1], args[2]
        last = k[:, :, -1, :, None] * v[:, :, -1, None, :]
        assert np.array_equal(_np(got[1]), last)


def test_chunked_wkv_split_off_a_chunk_boundary():
    """Two calls split at T = 37 (off every chunk boundary of L = 16), the
    state carried, against the whole sequence in one plain call."""
    r, k, v, w, u, s0 = _torch(*_strong_decay(_wkv_inputs(1, 2, 90, 16, seed=11), 12))
    y1, s1 = _wkv_chunked(r[:, :, :37], k[:, :, :37], v[:, :, :37], w[:, :, :37], u, s0,
                          16, 4)
    y2, s2 = _wkv_chunked(r[:, :, 37:], k[:, :, 37:], v[:, :, 37:], w[:, :, 37:], u, s1,
                          16, 4)
    _wkv_check((torch.cat([y1, y2], 2), s2), twkv.rwkv6_plain(r, k, v, w, u, s0))


FLASH_REFUSED = {
    # name: ((B, S, Hq, Hkv, hd), q dtype, error)
    "float16": ((1, 8, 2, 1, 32), torch.float16, TypeError),
    "float64": ((1, 8, 2, 1, 32), torch.float64, TypeError),
    "head-dim-past-256": ((1, 8, 2, 1, 264), torch.bfloat16, ValueError),
    "group-of-17": ((1, 8, 17, 1, 32), torch.bfloat16, ValueError),
    "bf16-rows-off-16-bytes": ((1, 8, 2, 1, 12), torch.bfloat16, ValueError),
    "fp32-rows-off-16-bytes": ((1, 8, 2, 1, 6), torch.float32, ValueError),
}


@pytest.mark.parametrize("case", sorted(FLASH_REFUSED))
def test_flash_wrapper_refuses_what_the_kernels_do_not_take(case):
    """Refused before any device is looked at, so on the CPU as on the card:
    a bf16 input the tensor-core kernel cannot take raises, and goes to no
    other kernel or plain version."""
    shape, dtype, error = FLASH_REFUSED[case]
    q, k, v = _torch(*_qkv(*shape), dtype=dtype)
    before = (tfa.launches, tfa.launches_bf16)
    with pytest.raises(error) as info:
        tfa.flash_attention_cuda(q, k, v)
    assert "CUDA tensors" not in str(info.value)
    assert (tfa.launches, tfa.launches_bf16) == before


def test_wkv_wrapper_refuses_rows_off_16_bytes_in_the_chunked_form():
    """At T >= CHUNK the kernels copy 16-byte rows: a slice that starts a
    row off the grid is refused before the device is looked at."""
    r, k, v, w, u, s0 = _torch(*_wkv_inputs(1, 2, twkv.CHUNK + 1, 8))
    off = torch.zeros(r.numel() + 1)[1:].view(r.shape).copy_(r)     # 4 bytes off
    with pytest.raises(ValueError, match="16 bytes"):
        twkv.rwkv6_cuda(off, k, v, w, u, s0)
    with pytest.raises(ValueError, match="CUDA tensors"):    # aligned: on to the device
        twkv.rwkv6_cuda(r, k, v, w, u, s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", [(448, 1500), (1, 1500), (300, 37)])
def test_flash_wrapper_takes_two_lengths_and_refuses_only_for_the_device(Sq, Sk, dtype):
    """Sq != Sk passes every check of the forward's and the backward's
    wrappers (the backward takes L as (B, Hq, Sq)); on CPU tensors only the
    device is refused, and no kernel is counted."""
    q, k, v = _torch(*_qkv(1, Sq, 4, 4, 64, Sk=Sk), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(q, k, v, causal=False)
    lse = torch.zeros((1, 4, Sq))
    before = (tfa.launches_bwd, tfa.launches_bwd_bf16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_backward_cuda(q, k, v, q, q, causal=False, lse=lse)
    assert (tfa.launches_bwd, tfa.launches_bwd_bf16) == before
    with pytest.raises(ValueError, match="at least one key"):
        tfa.flash_attention_cuda(q, k[:, :0], v[:, :0])


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = _torch(*_qkv(1, 8, 2, 1, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        twkv.rwkv6_cuda(*_torch(*_wkv_inputs(1, 1, 4, 8)))


# --------------------------------------------------------------------------- #
# On the card: each kernel against its plain version
# --------------------------------------------------------------------------- #

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


CUDA_ATTN = {
    "main-shape-window1024-bf16": (2, 4096, 8, 4, 256, True, 1024, torch.bfloat16),
    "main-shape-global-bf16": (2, 4096, 8, 4, 256, True, 0, torch.bfloat16),
    "main-window1024-bf16": (1, 2048, 8, 4, 256, True, 1024, torch.bfloat16),
    "main-global-bf16": (1, 1024, 8, 4, 256, True, 0, torch.bfloat16),
    "ragged-fp32": (1, 1000, 4, 2, 64, True, 0, torch.float32),
    "noncausal-fp32": (2, 300, 4, 4, 128, False, 0, torch.float32),
    "gqa8-hd32-fp32": (1, 257, 8, 1, 32, True, 100, torch.float32),
    "hd120-fp32": (1, 130, 4, 1, 120, True, 0, torch.float32),
    "hd256-window1024-fp32": (1, 2048, 8, 4, 256, True, 1024, torch.float32),
    # full-mantissa float32 (one TF32 product would miss 2e-5; 3xTF32 holds it)
    "main-shape-window1024-fp32": (2, 4096, 8, 4, 256, True, 1024, torch.float32),
    "main-shape-global-fp32": (2, 4096, 8, 4, 256, True, 0, torch.float32),
    "ragged-bf16": (1, 1000, 4, 2, 64, True, 0, torch.bfloat16),
    "noncausal-bf16": (1, 512, 4, 4, 128, False, 0, torch.bfloat16),
    "gqa8-window100-bf16": (1, 300, 8, 1, 64, True, 100, torch.bfloat16),
    "hd32-window64-bf16": (2, 256, 4, 2, 32, True, 64, torch.bfloat16),
    "hd128-bf16": (1, 384, 4, 2, 128, True, 0, torch.bfloat16),
    "hd120-bf16": (1, 130, 4, 1, 120, True, 0, torch.bfloat16),
    "gqa5-bf16": (1, 257, 10, 2, 64, True, 0, torch.bfloat16),
    # the hd <= 128 kernel: G = 5, 6 and 8, causal and windowed, S off its
    # 128-key tiles; hd 64 and 120 through the same kernel
    "hd128-gqa5-S1000-bf16": (1, 1000, 10, 2, 128, True, 0, torch.bfloat16),
    "hd128-gqa5-S1000-window300-bf16": (1, 1000, 10, 2, 128, True, 300, torch.bfloat16),
    "hd128-gqa6-S1000-bf16": (1, 1000, 12, 2, 128, True, 0, torch.bfloat16),
    "hd128-gqa6-S1000-window100-bf16": (2, 1000, 12, 2, 128, True, 100, torch.bfloat16),
    "hd128-gqa8-S1000-bf16": (2, 1000, 16, 2, 128, True, 0, torch.bfloat16),
    "hd128-gqa8-S1000-window300-bf16": (1, 1000, 8, 1, 128, True, 300, torch.bfloat16),
    "hd64-gqa6-S1000-window300-bf16": (1, 1000, 12, 2, 64, True, 300, torch.bfloat16),
    "hd120-gqa8-S1000-bf16": (1, 1000, 8, 1, 120, True, 0, torch.bfloat16),
    # the hd-64 kernel (two CTAs an SM, 64-key tiles, 128 rows a CTA):
    # whisper's encoder (non-causal, 1500) and decoder (causal, 448: the last
    # block's second warpgroup has no row), G = 4, S on both sides of the
    # 128-row block and of a warpgroup's 64 rows, hd 32 and 48
    "hd64-encoder-1500-noncausal-bf16": (2, 1500, 20, 20, 64, False, 0, torch.bfloat16),
    "hd64-decoder-448-causal-bf16": (2, 448, 20, 20, 64, True, 0, torch.bfloat16),
    "hd64-gqa4-S333-bf16": (1, 333, 16, 4, 64, True, 0, torch.bfloat16),
    "hd64-gqa4-S333-window50-bf16": (1, 333, 16, 4, 64, True, 50, torch.bfloat16),
    "hd64-S127-bf16": (2, 127, 4, 4, 64, True, 0, torch.bfloat16),
    "hd64-S129-bf16": (2, 129, 4, 4, 64, True, 0, torch.bfloat16),
    "hd64-S192-noncausal-bf16": (1, 192, 4, 4, 64, False, 0, torch.bfloat16),
    "hd64-S193-noncausal-bf16": (1, 193, 4, 4, 64, False, 0, torch.bfloat16),
    "hd32-S448-causal-bf16": (1, 448, 8, 8, 32, True, 0, torch.bfloat16),
    "hd48-S500-window64-bf16": (1, 500, 8, 2, 48, True, 64, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_ATTN))
def test_cuda_flash_matches_plain(case):
    _need_cuda()
    B, S, Hq, Hkv, hd, causal, window, dtype = CUDA_ATTN[case]
    q, k, v = _torch(*_qkv(B, S, Hq, Hkv, hd, seed=S), dtype=dtype, device="cuda")
    before = (tfa.launches, tfa.launches_bf16)
    got = tops.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    # one launch, of the kernel of the inputs' dtype
    bf16 = dtype == torch.bfloat16
    assert (tfa.launches, tfa.launches_bf16) == (before[0] + (not bf16), before[1] + bf16)
    want = tfa.attention_plain(q.float(), k.float(), v.float(), causal=causal,
                               window=window)
    rtol = RTOL_BF16_ROUNDING if dtype == torch.bfloat16 else 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=ATOL_F32)
    # q that requires grad goes through FlashAttentionFn: the forward kernel
    # again, then the backward kernel, whose q.grad is the plain backward's
    q.requires_grad_()
    before = (tfa.launches_bwd, tfa.launches_bwd_bf16)
    out = tops.attention(q, k, v, causal=causal, window=window)
    dout = torch.ones_like(out)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (tfa.launches_bwd, tfa.launches_bwd_bf16) == (before[0] + (not bf16),
                                                         before[1] + bf16)
    want_dq = tfa.attention_backward_plain(q.detach().float(), k.float(), v.float(),
                                           out.detach().float(), dout.float(),
                                           causal=causal, window=window)[0]
    diff = (q.grad.float() - want_dq).abs()
    top = float(want_dq.abs().max())
    limit = (RTOL_BF16_ROUNDING * want_dq.abs() + GRAD_ATOL_BF16 * top) if bf16 \
        else torch.full_like(want_dq, GRAD_RTOL_F32 * top)
    assert bool((diff <= limit).all()), f"q.grad: max abs error {float(diff.max())}"


CUDA_CROSS = {
    # name: (B, Sq, Sk, Hq, Hkv, hd, causal, window, dtype)
    "whisper-cross-bf16": (2, 448, 1500, 20, 20, 64, False, 0, torch.bfloat16),
    "whisper-cross-fp32": (2, 448, 1500, 20, 20, 64, False, 0, torch.float32),
    "one-query-bf16": (2, 1, 1500, 20, 20, 64, False, 0, torch.bfloat16),
    "one-query-fp32": (2, 1, 1500, 20, 20, 64, False, 0, torch.float32),
    "37x300-noncausal-bf16": (1, 37, 300, 4, 4, 64, False, 0, torch.bfloat16),
    "300x37-causal-bf16": (1, 300, 37, 4, 4, 64, True, 0, torch.bfloat16),
    # rows 136.. have no live key: the mean of v, L at the masked value
    "300x37-window100-bf16": (1, 300, 37, 4, 4, 64, True, 100, torch.bfloat16),
    "300x37-window100-fp32": (1, 300, 37, 4, 4, 64, True, 100, torch.float32),
    "hd128-g4-bf16": (1, 200, 700, 8, 2, 128, False, 0, torch.bfloat16),
    "hd256-g4-causal-bf16": (1, 200, 700, 8, 2, 256, True, 0, torch.bfloat16),
    "hd256-window100-bf16": (1, 500, 130, 4, 1, 256, True, 100, torch.bfloat16),
    # the hd-64 kernel at Sq != Sk: whisper's 448 x 1500, Sq off the 128-row
    # block by one either way, G = 4, hd 32 and 48, and a window that
    # leaves rows with no live key at G = 4
    "hd64-cross-448x1500-g1-bf16": (1, 448, 1500, 20, 20, 64, False, 0, torch.bfloat16),
    "hd64-cross-127x1500-bf16": (1, 127, 1500, 4, 4, 64, False, 0, torch.bfloat16),
    "hd64-cross-129x1500-bf16": (1, 129, 1500, 4, 4, 64, False, 0, torch.bfloat16),
    "hd64-cross-65x1500-bf16": (1, 65, 1500, 4, 4, 64, False, 0, torch.bfloat16),
    "hd64-cross-448x1500-g4-bf16": (1, 448, 1500, 16, 4, 64, False, 0, torch.bfloat16),
    "hd64-300x37-g4-window100-bf16": (1, 300, 37, 8, 2, 64, True, 100, torch.bfloat16),
    "hd32-cross-448x1500-bf16": (1, 448, 1500, 8, 8, 32, False, 0, torch.bfloat16),
    "hd48-cross-200x700-g4-causal-bf16": (1, 200, 700, 8, 2, 48, True, 0, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CROSS))
def test_cuda_flash_at_two_lengths_matches_plain(case):
    """Both forward kernels at Sq != Sk against the plain version, per
    element at the limits of `test_cuda_flash_matches_plain`, one launch
    each; L against the plain log-sum-exp within 2e-5 max(1, max |L|) over
    the rows with a live key, and within 2e-5 |L| where the mask empties
    a row (L is then -1e30 log2(e))."""
    _need_cuda()
    B, Sq, Sk, Hq, Hkv, hd, causal, window, dtype = CUDA_CROSS[case]
    q, k, v = _torch(*_qkv(B, Sq, Hq, Hkv, hd, seed=Sq + Sk, Sk=Sk), dtype=dtype,
                     device="cuda")
    bf16 = dtype == torch.bfloat16
    before = (tfa.launches, tfa.launches_bf16)
    got, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.launches_bf16) == (before[0] + (not bf16), before[1] + bf16)
    assert got.shape == (B, Sq, Hq, hd) and lse.shape == (B, Hq, Sq)
    want = tfa.attention_plain(q.float(), k.float(), v.float(), causal=causal,
                               window=window)
    rtol = RTOL_BF16_ROUNDING if bf16 else 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=ATOL_F32)
    want_lse = tfa.attention_lse_plain(q.float(), k.float(), causal=causal, window=window)
    live = want_lse > 0.5 * tfa.NEG_INF * tfa.LOG2E
    top = max(1.0, float(want_lse[live].abs().max()))
    np.testing.assert_allclose(_np(lse[live]), _np(want_lse[live]), rtol=0,
                               atol=ATOL_F32 * top)
    np.testing.assert_allclose(_np(lse[~live]), _np(want_lse[~live]), rtol=ATOL_F32)


@pytest.mark.cuda
def test_cuda_bf16_flash_launches_from_a_thread_without_a_context():
    """The bf16 forward and backward encode TMA maps with libcuda's
    cuTensorMapEncodeTiled, which needs a current CUDA context.  Called first from a thread
    that has made no CUDA runtime call (as the autograd engine's device
    thread may be, its buffers coming from the allocator's cache), both
    must launch and give the main thread's bits: the launchers bind the
    device's primary context (the maps were refused with
    CUDA_ERROR_INVALID_CONTEXT, and the launch reported 801, before)."""
    _need_cuda()
    q, k, v = _torch(*_qkv(1, 257, 10, 2, 64, seed=5), dtype=torch.bfloat16, device="cuda")
    out, lse = tfa.flash_attention_cuda(q, k, v, return_lse=True)
    dout = torch.ones_like(out)
    want = (out, *tfa.flash_attention_backward_cuda(q, k, v, out, dout, lse=lse))
    torch.cuda.synchronize()
    results = {}

    def run():
        try:
            o, l = tfa.flash_attention_cuda(q, k, v, return_lse=True)
            results["got"] = (o, *tfa.flash_attention_backward_cuda(q, k, v, o, dout, lse=l))
            torch.cuda.synchronize()
        except Exception as err:            # reported below, in the test's thread
            results["error"] = err
    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert "error" not in results, repr(results.get("error"))
    for g, w in zip(results["got"], want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,hd", [(2, 40, 1024, 64), (2, 40, 1, 64), (1, 3, 77, 32),
                                      (1, 2, 50, 128), (1, 1, 9, 8), (2, 40, 1000, 64),
                                      (1, 2, 200, 128), (1, 3, 130, 8)])
def test_cuda_wkv_matches_plain(B, H, T, hd):
    _need_cuda()
    args = _torch(*_wkv_inputs(B, H, T, hd, seed=T), device="cuda")
    before = twkv.launches
    got = tops.rwkv6_wkv(*args)
    torch.cuda.synchronize()
    assert twkv.launches == before + 1
    want = twkv.rwkv6_plain(*args)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= WKV_ATOL
    # two halves == the whole, on the card
    h = T // 2
    if h:
        r, k, v, w, u, s0 = args
        y1, s1 = twkv.rwkv6_cuda(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h], u, s0)
        y2, s2 = twkv.rwkv6_cuda(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:], u, s1)
        assert float((torch.cat([y1, y2], 2) - got[0]).abs().max()) <= WKV_ATOL
        assert float((s2 - got[1]).abs().max()) <= WKV_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,hd,split", [(2, 40, 4096, 64, 1001), (1, 4, 300, 16, 77),
                                            (1, 2, 130, 128, 65)])
def test_cuda_wkv_strong_decay_and_off_chunk_split(B, H, T, hd, split):
    """The model's decays w = exp(-exp(x)), x over -6..3, through the chunked
    form, whole and in two calls split off every chunk boundary."""
    _need_cuda()
    args = _torch(*_strong_decay(_wkv_inputs(B, H, T, hd, seed=T), seed=split),
                  device="cuda")
    want = twkv.rwkv6_plain(*args)
    got = twkv.rwkv6_cuda(*args)
    r, k, v, w, u, s0 = args
    y1, s1 = twkv.rwkv6_cuda(r[:, :, :split], k[:, :, :split], v[:, :, :split],
                             w[:, :, :split], u, s0)
    y2, s2 = twkv.rwkv6_cuda(r[:, :, split:], k[:, :, split:], v[:, :, split:],
                             w[:, :, split:], u, s1)
    for pair in (got, (torch.cat([y1, y2], 2), s2)):
        for a, b in zip(pair, want):
            assert float((a - b).abs().max()) <= WKV_ATOL


@pytest.mark.cuda
def test_cuda_wkv_zero_decay_leaves_the_last_kv():
    _need_cuda()
    args = list(_torch(*_wkv_inputs(1, 4, 200, 64, seed=2), device="cuda"))
    args[3].zero_()
    _, sT = twkv.rwkv6_cuda(*args)
    last = args[1][:, :, -1, :, None] * args[2][:, :, -1, None, :]
    assert torch.equal(sT, last)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 63])
@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
def test_cuda_recurrent_wkv_matches_plain(T, hd):
    """The recurrent kernel (T < CHUNK: decode and short prefills) at every
    head dim, on contiguous inputs and on rows that start 4 bytes off the
    16-byte grid."""
    _need_cuda()
    args = _torch(*_wkv_inputs(2, 5, T, hd, seed=T * hd), device="cuda")
    want = twkv.rwkv6_plain(*args)
    before = twkv.launches
    got = twkv.rwkv6_cuda(*args)
    shifted = []
    for x in args[:4]:
        buf = torch.zeros(*x.shape[:3], hd + 1, device="cuda")
        buf[..., 1:] = x
        shifted.append(buf[..., 1:])
    got_shifted = twkv.rwkv6_cuda(*shifted, *args[4:])
    torch.cuda.synchronize()
    assert twkv.launches == before + 2
    for pair in (got, got_shifted):
        for a, b in zip(pair, want):
            assert float((a - b).abs().max()) <= WKV_ATOL


@pytest.mark.cuda
def test_cuda_recurrent_wkv_steps_carry_the_state():
    """Four T = 1 calls, each taking the state the last one returned, give
    one T = 4 call's outputs and state."""
    _need_cuda()
    r, k, v, w, u, s0 = _torch(*_wkv_inputs(2, 40, 4, 64, seed=3), device="cuda")
    y, sT = twkv.rwkv6_cuda(r, k, v, w, u, s0)
    state, ys = s0, []
    for t in range(4):
        step = (x[:, :, t:t + 1] for x in (r, k, v, w))
        y_t, state = twkv.rwkv6_cuda(*step, u, state)
        ys.append(y_t)
    torch.cuda.synchronize()
    assert float((torch.cat(ys, 2) - y).abs().max()) <= WKV_ATOL
    assert float((state - sT).abs().max()) <= WKV_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 64, 128])
def test_cuda_recurrent_wkv_zero_decay_leaves_exactly_the_last_kv(hd):
    """w = 0 at T = 1: the state forgets s0 and is exactly k v^T."""
    _need_cuda()
    args = list(_torch(*_wkv_inputs(2, 3, 1, hd, seed=hd), device="cuda"))
    args[3].zero_()
    _, sT = twkv.rwkv6_cuda(*args)
    assert torch.equal(sT, args[1][:, :, -1, :, None] * args[2][:, :, -1, None, :])
