"""The port's selective-scan kernel (`repro_torch.kernels.selective_scan`,
through `ops.selective_scan`): Mamba's recurrence, which the reference runs
as a `lax.scan` (`repro.models.mamba`; `tests/test_torch_mamba_moe.py`
holds the port's Mamba mixer against it).  This file imports no JAX, so
its `cuda` tests run on a card without it.

On the CPU: `selective_scan_plain` against a float64 numpy oracle of the
recurrence, within SCAN_RTOL of the largest |y| and |h| (float32 sums in
another order), at S = 1, 37 and 130, with the model's decays (dt from
softplus around 0.01), strong decays (dt up to 5: exp(dt A) down to
exp(-80)), a non-zero h0 and x in bf16; two halves with the state carried
equal the whole bit for bit; CPU tensors launch nothing and
differentiate through the plain version.  The kernel's arithmetic (four
lanes of four states, the shuffle order of y's sum, exp2 of dt (A log2 e))
is emulated in PyTorch and held against the oracle at the same cases, and
split on and off its chunks.  What the kernel does not take,
`selective_scan_cuda` refuses before it looks at the device (a d_state
outside D_STATES, dtypes, layouts, alignment), and it refuses CPU tensors.

The gradient on the CPU: `selective_scan_backward_plain` against torch
autograd through `selective_scan_plain` in float64 within GRAD_RTOL_F64 of
max(1, max |want|) (x in float32 and bf16, strong decays, non-zero h0 and
dh_T, S = 1, 37 and 130, and a derandomized hypothesis case); two halves
with the state carried give the gradients of the whole; `SelectiveScanFn`
on CPU tensors returns exactly what the plain backward returns; the
backward kernel's wrapper refuses what the kernel does not take, and CPU
tensors, before it looks at the device.  The backward kernel's arithmetic
(spans of STATES_EVERY steps recomputed from the stored states, the
lanes' slot orders, the select-free sums over each warp's 8 channels, the
fixed-order block and b sums) is emulated in PyTorch and held against
autograd in float64 within SCAN_BWD_RTOL (strong decays, bf16 x, h0 and
dh_T, d_inner off the block of 64, a derandomized hypothesis case), and
two halves with the state carried give the whole's per-step gradients
and dh0 bit for bit.

On the card (`cuda` marker, skipped without one): the kernel against the
plain version within SCAN_RTOL at S = 1, 4 and 5 (the two sides of the
switch between its decode and chunked forms), 63, 64, 65 and 1000,
d_inner on and off the block of 64 channels, strong decays, a non-zero h0,
x in float32 and bf16, Bm and Cm as column slices of one projection; two
halves against the whole, split on and off a chunk; one launch a call.
The forward storing the state every STATES_EVERY steps gives y and h_T
bit for bit, and each stored row is the state a call of that many steps
ends in; the backward kernel, from those states, against the plain
backward within SCAN_BWD_RTOL of max(1, max |want|) (dx in bf16 per
element within 2^-8 |want| more), around the 8-step span and the 16-step
chunk and at S = 1, bit-identical on a second call; autograd through `ops.selective_scan` on CUDA tensors
launches the forward once and the backward once, and under remat
(`torch.utils.checkpoint`) the forward twice, with the same gradients
and without holding the first run's states."""
import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402

# float32 against the float64 oracle, and the kernel against the plain
# version: |got - want| <= SCAN_RTOL max(1, max |want|), per output
SCAN_RTOL = 1e-5
# the plain backward against autograd through the plain forward, both in
# float64: the same products summed in other orders
GRAD_RTOL_F64 = 1e-10
# the backward kernel against the plain backward in float32 (chip_smoke.py's
# SCAN_BWD_RTOL), and dx in bf16 per element: one rounding, 2^-8 |want|
SCAN_BWD_RTOL = 1e-4
BF16_RTOL = 2.0 ** -8
N = 16
DT_RANK = 8


def _inputs(B, S, di, seed, *, strong=False, h0_scale=0.0, x_dtype=np.float32):
    """dt, x, Bm, Cm, A, D, h0 as numpy float64 arrays (x rounded to
    ``x_dtype`` first); Bm and Cm are column slices of one projection, as
    the model takes them."""
    g = np.random.default_rng(seed)
    if strong:
        dt = g.uniform(0.0, 5.0, (B, S, di))
    else:   # softplus(z - 4.6): the init's dt_bias puts dt around 0.01
        dt = np.logaddexp(g.standard_normal((B, S, di)) - 4.6, 0.0)
    x = g.standard_normal((B, S, di))
    if x_dtype != np.float32:
        x = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    proj = g.standard_normal((B, S, DT_RANK + 2 * N))
    A = -np.tile(np.arange(1, N + 1, dtype=np.float64), (di, 1)) \
        * np.exp(0.1 * g.standard_normal((di, N)))
    D = g.standard_normal(di)
    h0 = h0_scale * g.standard_normal((B, di, N))
    dt, x, proj, A, D, h0 = (a.astype(np.float32).astype(np.float64)
                             for a in (dt, x, proj, A, D, h0))
    return dt, x, proj[..., DT_RANK:DT_RANK + N], proj[..., DT_RANK + N:], A, D, h0


def _oracle(dt, x, Bm, Cm, A, D, h0):
    h = h0.copy()
    y = np.empty(dt.shape)
    for t in range(dt.shape[1]):
        h = h * np.exp(dt[:, t, :, None] * A[None]) \
            + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        y[:, t] = np.einsum("bdn,bn->bd", h, Cm[:, t]) + x[:, t] * D
    return y, h


def _torch(arrays, device="cpu", x_dtype=torch.float32):
    """The numpy inputs as the model passes them: float32 (x in
    ``x_dtype``), Bm and Cm strided views of one (B, S, P) projection."""
    dt, x, Bm, Cm, A, D, h0 = arrays
    proj = np.concatenate([np.zeros(Bm.shape[:2] + (DT_RANK,)), Bm, Cm], axis=-1)
    proj = torch.from_numpy(proj).to(device, torch.float32)
    f32 = [torch.from_numpy(a).to(device, torch.float32) for a in (dt, A, D, h0)]
    return (f32[0], torch.from_numpy(x).to(device, x_dtype),
            proj[..., DT_RANK:DT_RANK + N], proj[..., DT_RANK + N:], *f32[1:])


def _assert_close(got, want, what):
    for name, g, w in zip(("y", "h_T"), got, want):
        g = g.double().cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.double().cpu().numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        if w.size:
            err = np.abs(g - w).max()
            assert err <= SCAN_RTOL * max(1.0, np.abs(w).max()), (what, name, err)


CPU_CASES = {"S = 1": dict(B=2, S=1, di=64),
             "S = 37": dict(B=2, S=37, di=48),
             "S = 130, non-zero h0": dict(B=1, S=130, di=32, h0_scale=1.0),
             "strong decays": dict(B=2, S=37, di=48, strong=True, h0_scale=1.0),
             "x in bf16": dict(B=2, S=37, di=48, x_dtype="bf16")}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_plain_matches_float64_oracle(case):
    kw = dict(CPU_CASES[case])
    bf16 = kw.pop("x_dtype", None) == "bf16"
    arrays = _inputs(seed=len(case), x_dtype="bf16" if bf16 else np.float32, **kw)
    got = tss.selective_scan_plain(*_torch(arrays, x_dtype=torch.bfloat16 if bf16
                                           else torch.float32))
    assert got[0].dtype == got[1].dtype == torch.float32
    _assert_close(got, _oracle(*arrays), case)


def test_plain_two_halves_equal_the_whole_bit_for_bit():
    dt, x, Bm, Cm, A, D, h0 = _torch(_inputs(2, 40, 32, 5, h0_scale=1.0))
    y, hT = tss.selective_scan_plain(dt, x, Bm, Cm, A, D, h0)
    y1, h1 = tss.selective_scan_plain(dt[:, :17], x[:, :17], Bm[:, :17], Cm[:, :17], A, D, h0)
    y2, h2 = tss.selective_scan_plain(dt[:, 17:], x[:, 17:], Bm[:, 17:], Cm[:, 17:], A, D, h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, hT)


def test_cpu_tensors_take_the_plain_version_and_differentiate():
    args = [t.clone().requires_grad_(True)
            for t in _torch(_inputs(2, 9, 16, 6, h0_scale=1.0))]
    before = tss.launches
    y, hT = tops.selective_scan(*args)
    assert tss.launches == before
    want = tss.selective_scan_plain(*args)
    assert torch.equal(y, want[0]) and torch.equal(hT, want[1])
    (y.square().sum() + hT.sum()).backward()
    for t in args:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    assert float(args[0].grad.abs().max()) > 0.0


# --------------------------------------------------------------------------- #
# The kernel's arithmetic, emulated on the CPU (test-only, on no path):
# csrc/selective_scan.cu's four lanes a channel
# --------------------------------------------------------------------------- #

LOG2E = 1.4426950408889634
LANES = 4                  # lanes a channel; N // LANES states each


def _f32(x):
    """A float64 result rounded once to float32: one fused operation."""
    return x.to(torch.float32)


def _scan_kernel_emulation(dt, x, Bm, Cm, A, D, h0):
    """The kernel's arithmetic in float32: exp(dt A) as exp2(dt (A log2 e))
    (A log2 e rounded once, then the product); h = fma(h, e, (dt x) B);
    each lane's partial sum of h C over its 4 states by fmas in state
    order, lane 0's starting from x D (the others from 0); y the shuffle
    reduce-scatter's sum, (lanes 0 + 2) + (lanes 1 + 3).  Time is walked
    as the kernel walks it: whole chunks of CHUNK steps (S > DECODE_MAX_S)
    or whole groups of LANES steps (the decode form), the steps past S
    staged as zeros and walked like the others, their y dropped."""
    B, S, di = dt.shape
    group = LANES if S <= tss.DECODE_MAX_S else tss.CHUNK
    pad = max(group, -(-S // group) * group) - S

    def staged(t):
        return torch.cat([t.float(), t.new_zeros(B, pad, t.shape[-1]).float()], dim=1)

    dt, xf, Bm, Cm = staged(dt), staged(x), staged(Bm), staged(Cm)
    h = h0.float().clone()
    A2 = A.float() * np.float32(LOG2E)
    y = torch.empty(B, S + pad, di)
    for t in range(S + pad):
        dt_t, x_t = dt[:, t, :, None], xf[:, t, :, None]
        e = torch.exp2(dt_t * A2)
        h = _f32(h.double() * e.double() + ((dt_t * x_t) * Bm[:, t, None, :]).double())
        part = torch.zeros(B, di, LANES)
        part[..., 0] = x_t[..., 0] * D
        lane_h = h.view(B, di, LANES, N // LANES)
        lane_c = Cm[:, t, None, :].view(B, 1, LANES, N // LANES)
        for k in range(N // LANES):
            part = _f32(lane_h[..., k].double() * lane_c[..., k].double() + part.double())
        y[:, t] = (part[..., 0] + part[..., 2]) + (part[..., 1] + part[..., 3])
    return y[:, :S], h


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_kernel_arithmetic_emulation_matches_float64_oracle(case):
    """Four lanes of four states, the shuffle-order sum and exp2 of dt (A
    log2 e) hold SCAN_RTOL against the float64 oracle, strong decays (down
    to exp(-80) and below float32's range) and bf16 x included."""
    kw = dict(CPU_CASES[case])
    bf16 = kw.pop("x_dtype", None) == "bf16"
    arrays = _inputs(seed=len(case), x_dtype="bf16" if bf16 else np.float32, **kw)
    got = _scan_kernel_emulation(*_torch(arrays, x_dtype=torch.bfloat16 if bf16
                                         else torch.float32))
    _assert_close(got, _oracle(*arrays), case)


@pytest.mark.parametrize("cut", [tss.CHUNK, tss.CHUNK + 5, tss.DECODE_MAX_S])
def test_kernel_arithmetic_emulation_split_equals_the_whole(cut):
    """Two calls with the state carried, split on a chunk boundary, off
    one (each call then walks zero steps past its end), and where the first
    call takes the decode form: the whole, bit for bit (the zero steps
    leave the state as it was, and the state is all a call hands on)."""
    dt, x, Bm, Cm, A, D, h0 = _torch(_inputs(2, 70, 24, 12, strong=True, h0_scale=1.0))
    y, hT = _scan_kernel_emulation(dt, x, Bm, Cm, A, D, h0)
    y1, h1 = _scan_kernel_emulation(dt[:, :cut], x[:, :cut], Bm[:, :cut], Cm[:, :cut],
                                    A, D, h0)
    y2, h2 = _scan_kernel_emulation(dt[:, cut:], x[:, cut:], Bm[:, cut:], Cm[:, cut:],
                                    A, D, h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, hT)


def test_constants_match_the_kernel_source():
    """CHUNK, DECODE_MAX_S and the emulation's LANES are the kernel's
    kChunk, kDecodeMaxS and kLanes, and the C entry point launches a decode
    instance for every S up to DECODE_MAX_S."""
    src = (Path(tss.__file__).parent / "csrc" / "selective_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kChunk"), const("kDecodeMaxS"), const("kLanes")) == \
        (tss.CHUNK, tss.DECODE_MAX_S, LANES)
    cases = [int(c) for c in re.findall(r"case (\d+): scan_decode_kernel<\1,", src)]
    assert cases == list(range(tss.DECODE_MAX_S + 1))


def _refused(kind):
    """Arguments the kernel does not take, on the CPU."""
    args = list(_torch(_inputs(1, 4, 32, 7)))
    if kind == "d_state 8":
        args[2], args[3], args[4] = args[2][..., :8], args[3][..., :8], args[4][:, :8]
        args[6] = args[6][..., :8].contiguous()
    elif kind == "float64 dt":
        args[0] = args[0].double()
    elif kind == "float16 x":
        args[1] = args[1].half()
    elif kind == "dt strided over di":
        args[0] = args[0].transpose(0, 2).contiguous().transpose(0, 2)
    elif kind == "h0 off 16 bytes":
        args[6] = torch.zeros(args[6].numel() + 1)[1:].view(args[6].shape)
    return args


@pytest.mark.parametrize("kind,error,match", [
    ("d_state 8", ValueError, r"d_state in \(16,\)"),
    ("float64 dt", TypeError, "float32"),
    ("float16 x", TypeError, "bfloat16"),
    ("dt strided over di", ValueError, "unit stride"),
    ("h0 off 16 bytes", ValueError, "16 bytes"),
    ("CPU tensors", ValueError, "CUDA tensors"),
])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(kind, error, match):
    before = tss.launches
    with pytest.raises(error, match=match):
        tss.selective_scan_cuda(*_refused(kind))
    assert tss.launches == before


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the selective-scan kernel)")


CUDA_CASES = {"S = 1 (2, 1, 384)": dict(B=2, S=1, di=384, h0_scale=1.0),
              # the two sides of the switch between the decode and chunked forms
              "S = 4 decode form, off the block (2, 4, 200)": dict(
                  B=2, S=tss.DECODE_MAX_S, di=200, h0_scale=1.0),
              "S = 5 chunked form, off the block (2, 5, 200)": dict(
                  B=2, S=tss.DECODE_MAX_S + 1, di=200, h0_scale=1.0, strong=True),
              "S = 63 off the block (2, 63, 200)": dict(B=2, S=63, di=200),
              "S = 64 (1, 64, 256)": dict(B=1, S=64, di=256, h0_scale=1.0),
              "S = 65 (3, 65, 130)": dict(B=3, S=65, di=130),
              "S = 1000 (2, 1000, 1000)": dict(B=2, S=1000, di=1000),
              "strong decays (2, 300, 512)": dict(B=2, S=300, di=512, strong=True,
                                                  h0_scale=1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_cuda_scan_matches_plain(case, x_dtype):
    _need_cuda()
    args = _torch(_inputs(seed=len(case), **CUDA_CASES[case]), device="cuda",
                  x_dtype=x_dtype)
    before = tss.launches
    got = tss.selective_scan_cuda(*args)
    torch.cuda.synchronize()
    assert tss.launches == before + 1
    _assert_close(got, tss.selective_scan_plain(*args), case)


@pytest.mark.cuda
def test_cuda_two_halves_match_the_whole():
    _need_cuda()
    dt, x, Bm, Cm, A, D, h0 = _torch(_inputs(2, 500, 300, 8, h0_scale=1.0), device="cuda")
    whole = tss.selective_scan_cuda(dt, x, Bm, Cm, A, D, h0)
    y1, h1 = tss.selective_scan_cuda(dt[:, :77], x[:, :77], Bm[:, :77], Cm[:, :77], A, D, h0)
    y2, h2 = tss.selective_scan_cuda(dt[:, 77:], x[:, 77:], Bm[:, 77:], Cm[:, 77:], A, D, h1)
    _assert_close((torch.cat([y1, y2], dim=1), h2), whole, "two halves")


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [tss.CHUNK, tss.CHUNK + 13, tss.DECODE_MAX_S])
def test_cuda_split_on_and_off_a_chunk_boundary(cut):
    """Split on the chunk boundary, off it, and with a first call in the
    decode form; d_inner 520, off the block of 64 channels."""
    _need_cuda()
    dt, x, Bm, Cm, A, D, h0 = _torch(_inputs(2, 300, 520, 13, strong=True, h0_scale=1.0),
                                     device="cuda", x_dtype=torch.bfloat16)
    whole = tss.selective_scan_cuda(dt, x, Bm, Cm, A, D, h0)
    y1, h1 = tss.selective_scan_cuda(dt[:, :cut], x[:, :cut], Bm[:, :cut], Cm[:, :cut],
                                     A, D, h0)
    y2, h2 = tss.selective_scan_cuda(dt[:, cut:], x[:, cut:], Bm[:, cut:], Cm[:, cut:],
                                     A, D, h1)
    _assert_close((torch.cat([y1, y2], dim=1), h2), whole, f"split at {cut}")
    _assert_close(whole, tss.selective_scan_plain(dt, x, Bm, Cm, A, D, h0), "whole")


def _cotangents(B, S, di, seed, *, dhT_scale=1.0):
    g = np.random.default_rng(seed + 1000)
    return g.standard_normal((B, S, di)), dhT_scale * g.standard_normal((B, di, N))


def _grad_close(got, want, what, rtol):
    names = ("ddt", "dx", "dBm", "dCm", "dA", "dD", "dh0")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name, g.shape, w.shape,
                                                          g.dtype, w.dtype)
        g, w = g.double().cpu(), w.double().cpu()
        if w.numel():
            err = float((g - w).abs().max())
            assert err <= rtol * max(1.0, float(w.abs().max())), (what, name, err)


def _autograd_plain(args, dy, dhT):
    """The gradients of sum(y dy) + sum(h_T dh_T) by torch autograd through
    selective_scan_plain, Bm and Cm as slices of one leaf as the model has
    them."""
    dt, x, Bm, Cm, A, D, h0 = args
    proj = torch.cat([Bm, Cm], dim=-1).detach().requires_grad_(True)
    leaves = [t.detach().requires_grad_(True) for t in (dt, x, A, D, h0)]
    y, hT = tss.selective_scan_plain(leaves[0], leaves[1], proj[..., :N], proj[..., N:],
                                     *leaves[2:])
    ((y * dy).sum() + (hT * dhT).sum()).backward()
    return (leaves[0].grad, leaves[1].grad, proj.grad[..., :N], proj.grad[..., N:],
            leaves[2].grad, leaves[3].grad, leaves[4].grad)


def _f64(arrays, x_dtype=torch.float64):
    dt, x, Bm, Cm, A, D, h0 = (torch.from_numpy(a) for a in arrays)
    return dt, x.to(x_dtype), Bm, Cm, A, D, h0


GRAD_CASES = {"S = 1, h0 and dh_T": dict(B=2, S=1, di=32, h0_scale=1.0),
              "S = 37, x float32": dict(B=2, S=37, di=24),
              "S = 37, x bf16": dict(B=2, S=37, di=24, x_dtype="bf16"),
              "S = 130, strong decays, h0 and dh_T": dict(B=1, S=130, di=16, strong=True,
                                                          h0_scale=1.0),
              "S = 64, dh_T 0": dict(B=2, S=64, di=20, h0_scale=1.0, dhT_scale=0.0)}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_plain_backward_matches_autograd_in_float64(case):
    kw = dict(GRAD_CASES[case])
    bf16 = kw.pop("x_dtype", None) == "bf16"
    dhT_scale = kw.pop("dhT_scale", 1.0)
    arrays = _inputs(seed=len(case), x_dtype="bf16" if bf16 else np.float32, **kw)
    args = _f64(arrays, torch.bfloat16 if bf16 else torch.float64)
    dy, dhT = (torch.from_numpy(a) for a in _cotangents(kw["B"], kw["S"], kw["di"],
                                                        len(case), dhT_scale=dhT_scale))
    got = tss.selective_scan_backward_plain(*args, dy, dhT)
    _grad_close(got, _autograd_plain(args, dy, dhT), case, GRAD_RTOL_F64)
    assert got[1].dtype == (torch.bfloat16 if bf16 else torch.float64)


@settings(database=None, derandomize=True, max_examples=12, deadline=None)
@given(B=st.integers(1, 2), S=st.integers(1, 40), di=st.integers(1, 12),
       strong=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_plain_backward_matches_autograd_hypothesis(B, S, di, strong, seed):
    args = _f64(_inputs(B, S, di, seed, strong=strong, h0_scale=1.0))
    dy, dhT = (torch.from_numpy(a) for a in _cotangents(B, S, di, seed))
    got = tss.selective_scan_backward_plain(*args, dy, dhT)
    _grad_close(got, _autograd_plain(args, dy, dhT), (B, S, di, strong, seed),
                GRAD_RTOL_F64)


@pytest.mark.parametrize("cut", [1, 16, 23])
def test_plain_backward_two_halves_give_the_whole(cut):
    """The second half's backward from dh_T, then the first half's from
    the second's dh0: the per-step gradients and dh0 of the whole, dA and
    dD the sums of the halves'."""
    B, S, di = 2, 40, 16
    args = _f64(_inputs(B, S, di, 21, strong=True, h0_scale=1.0))
    dt, x, Bm, Cm, A, D, h0 = args
    dy, dhT = (torch.from_numpy(a) for a in _cotangents(B, S, di, 21))
    whole = tss.selective_scan_backward_plain(*args, dy, dhT)
    _, h_mid = tss.selective_scan_plain(dt[:, :cut], x[:, :cut], Bm[:, :cut], Cm[:, :cut],
                                        A, D, h0)
    second = tss.selective_scan_backward_plain(dt[:, cut:], x[:, cut:], Bm[:, cut:],
                                               Cm[:, cut:], A, D, h_mid, dy[:, cut:], dhT)
    first = tss.selective_scan_backward_plain(dt[:, :cut], x[:, :cut], Bm[:, :cut],
                                              Cm[:, :cut], A, D, h0, dy[:, :cut], second[6])
    joined = [torch.cat([f, s], dim=1) for f, s in zip(first[:4], second[:4])]
    joined += [first[4] + second[4], first[5] + second[5], first[6]]
    _grad_close(joined, whole, f"split at {cut}", GRAD_RTOL_F64)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_function_on_cpu_returns_the_plain_backward(x_dtype):
    """Autograd through ops.selective_scan on CPU tensors: the forward is
    the plain version, the gradients exactly the plain backward's, no
    launch."""
    arrays = _inputs(2, 21, 24, 31, h0_scale=1.0,
                     x_dtype="bf16" if x_dtype == torch.bfloat16 else np.float32)
    args = _torch(arrays, x_dtype=x_dtype)
    dy, dhT = (torch.from_numpy(a).float() for a in _cotangents(2, 21, 24, 31))
    leaves = [t.detach().requires_grad_(True) for t in args]
    before = (tss.launches, tss.launches_bwd)
    y, hT = tops.selective_scan(*leaves)
    want_y, want_h = tss.selective_scan_plain(*args)
    assert torch.equal(y, want_y) and torch.equal(hT, want_h)
    ((y * dy).sum() + (hT * dhT).sum()).backward()
    assert (tss.launches, tss.launches_bwd) == before
    want = tss.selective_scan_backward_plain(*args, dy, dhT)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == w.dtype and torch.equal(t.grad, w)


# --------------------------------------------------------------------------- #
# The backward kernel's arithmetic, emulated on the CPU (test-only, on no
# path): csrc/selective_scan_bwd.cu
# --------------------------------------------------------------------------- #

LN2 = 0.6931471805599453
BWD_CHANNELS = 64          # channels a block; 8 warps of 8 channels


def _channel_sums(terms):
    """Per-step sums over d_inner of (B, di, N) terms in the kernel's fixed
    order: each warp's 8 channels by the tree ((c0 + c4) + (c2 + c6)) + ((c1
    + c5) + (c3 + c7)) of its select-free reduce-scatter, the block's 8
    warps in order, then the blocks in order (the second launch); the
    channels past d_inner, up to a whole block, contribute zeros."""
    B, di, n = terms.shape
    pad = -(-di // BWD_CHANNELS) * BWD_CHANNELS - di
    t = torch.cat([terms, terms.new_zeros(B, pad, n)], dim=1).view(B, -1, 8, 8, n)
    c = [t[:, :, :, i] for i in range(8)]
    warps = ((c[0] + c[4]) + (c[2] + c[6])) + ((c[1] + c[5]) + (c[3] + c[7]))
    blocks = warps[:, :, 0]
    for w in range(1, 8):
        blocks = blocks + warps[:, :, w]
    tot = blocks[:, 0]
    for k in range(1, blocks.shape[1]):
        tot = tot + blocks[:, k]
    return tot


def _scan_bwd_kernel_emulation(dt, x, Bm, Cm, A, D, h0, dy, dhT):
    """The backward kernel's arithmetic in float32, (ddt, dx, dBm, dCm, dA,
    dD, dh0): every state and exp2(dt (A log2 e)) recomputed as the forward
    computes them (the walk's exponential is the same ex2 of the same
    product, so one value serves both); the walk g = fma(dy, C, g), u by fmas over the
    lane's slots in its slot order (slot k of lane group j holding state
    4 j + (k ^ p), p = (channel mod 8) >> 1), dB's term g dt x, then g *= a,
    g a h_{t-1} into dA by an fma with dt and into q (in units of ln 2) by
    an fma with A log2 e; the 4 lanes' u and q summed (0 + 2) + (1 + 3);
    ddt = fma(u, x, q ln 2), dx = fma(u, dt, dy D); dB and dC summed over
    channels by _channel_sums; dA and dD each lane's steps in order, then b
    in order.  Time is walked in whole spans of STATES_EVERY steps, the
    steps past S staged as zeros and walked like the others."""
    B, S, di = dt.shape
    pad = -(-S // tss.STATES_EVERY) * tss.STATES_EVERY - S

    def staged(t):
        return torch.cat([t.float(), t.new_zeros(B, pad, t.shape[-1]).float()], dim=1)

    dt, xf, Bm, Cm, dy = (staged(t) for t in (dt, x, Bm, Cm, dy))
    A2 = A.float() * np.float32(LOG2E)
    p = (torch.arange(di) % 8) // 2
    k = torch.arange(N) % LANES
    order = (torch.arange(N) - k)[None] + (k[None] ^ p[:, None])        # (di, N)

    def slots(t):                         # (B, di, N) in each channel's slot order
        return t.expand(B, di, N).gather(-1, order.expand(B, di, N)).view(B, di, LANES, -1)

    def fma(a, b, c):
        return _f32(a.double() * b.double() + c.double())

    hs, es = [h0.float().clone()], []
    for t in range(S + pad):
        e = torch.exp2(dt[:, t, :, None] * A2)
        hs.append(fma(hs[-1], e, (dt[:, t] * xf[:, t])[..., None] * Bm[:, t, None, :]))
        es.append(e)
    g = dhT.float().clone()
    dA = torch.zeros(B, di, N)
    dD = torch.zeros(B, di)
    ddt, dx = torch.zeros(B, S + pad, di), torch.zeros(B, S + pad, di)
    dB, dC = torch.zeros(B, S + pad, N), torch.zeros(B, S + pad, N)
    a2s = slots(A2[None])
    for t in reversed(range(S + pad)):
        dt_t, x_t, dy_t = dt[:, t], xf[:, t], dy[:, t]
        g = fma(dy_t[..., None], Cm[:, t, None, :], g)
        gs, bs = slots(g), slots(Bm[:, t, None, :])
        u = torch.zeros(B, di, LANES)
        for j in range(N // LANES):
            u = fma(gs[..., j], bs[..., j], u)
        dB[:, t] = _channel_sums(g * (dt_t * x_t)[..., None])
        dC[:, t] = _channel_sums(dy_t[..., None] * hs[t + 1])
        g = g * es[t]
        gh = g * hs[t]
        dA = fma(gh, dt_t[..., None], dA)
        q = torch.zeros(B, di, LANES)
        ghs = slots(gh)
        for j in range(N // LANES):
            q = fma(ghs[..., j], a2s[..., j], q)
        dD = fma(dy_t, x_t, dD)
        u = (u[..., 0] + u[..., 2]) + (u[..., 1] + u[..., 3])
        q = (q[..., 0] + q[..., 2]) + (q[..., 1] + q[..., 3])
        ddt[:, t] = fma(u, x_t, q * np.float32(LN2))
        dx[:, t] = fma(u, dt_t, dy_t * D.float())
    dA_tot, dD_tot = dA[0], dD[0]
    for b in range(1, B):
        dA_tot, dD_tot = dA_tot + dA[b], dD_tot + dD[b]
    return (ddt[:, :S], dx[:, :S].to(x.dtype), dB[:, :S], dC[:, :S], dA_tot, dD_tot, g)


EMU_BWD_CASES = {"S = 1, h0 and dh_T": dict(B=2, S=1, di=32, h0_scale=1.0),
                 "S = 37, x float32, two blocks": dict(B=2, S=37, di=70),
                 "S = 37, x bf16": dict(B=2, S=37, di=24, x_dtype="bf16"),
                 "S = 130, strong decays, h0 and dh_T": dict(B=1, S=130, di=16, strong=True,
                                                             h0_scale=1.0),
                 "S = 45, strong decays, bf16 x, h0, three blocks": dict(
                     B=2, S=45, di=130, strong=True, h0_scale=1.0, x_dtype="bf16"),
                 "S = 64, dh_T 0": dict(B=2, S=64, di=20, h0_scale=1.0, dhT_scale=0.0)}


def _emulation_vs_oracle(arrays, cot, bf16, what):
    """The backward emulation on float32 inputs against autograd through
    the plain forward in float64: every gradient within SCAN_BWD_RTOL
    max(1, max |want|), dx in bf16 per element within BF16_RTOL |want|
    more."""
    dy, dhT = (torch.from_numpy(a) for a in cot)
    got = _scan_bwd_kernel_emulation(*_torch(arrays, x_dtype=torch.bfloat16 if bf16
                                             else torch.float32), dy.float(), dhT.float())
    want = _autograd_plain(_f64(arrays), dy, dhT)
    _grad_close([g.double() for i, g in enumerate(got) if i != 1],
                [w for i, w in enumerate(want) if i != 1], what, SCAN_BWD_RTOL)
    assert got[1].dtype == (torch.bfloat16 if bf16 else torch.float32)
    err = (got[1].double() - want[1]).abs()
    limit = (BF16_RTOL if bf16 else 0.0) * want[1].abs() \
        + SCAN_BWD_RTOL * max(1.0, float(want[1].abs().max()))
    assert bool((err <= limit).all()), (what, "dx", float((err - limit).max()))


@pytest.mark.parametrize("case", sorted(EMU_BWD_CASES))
def test_backward_kernel_emulation_matches_float64_autograd(case):
    """The recompute and the walk, the slot orders and select-free channel
    sums, the fixed-order block and b sums: within
    SCAN_BWD_RTOL of the float64 gradients, strong decays (exp(dt A) below
    float32's range), bf16 x, non-zero h0 and dh_T, d_inner off the block
    of 64 channels, S on and off the span of STATES_EVERY steps."""
    kw = dict(EMU_BWD_CASES[case])
    bf16 = kw.pop("x_dtype", None) == "bf16"
    dhT_scale = kw.pop("dhT_scale", 1.0)
    arrays = _inputs(seed=len(case), x_dtype="bf16" if bf16 else np.float32, **kw)
    cot = _cotangents(kw["B"], kw["S"], kw["di"], len(case), dhT_scale=dhT_scale)
    _emulation_vs_oracle(arrays, cot, bf16, case)


@settings(database=None, derandomize=True, max_examples=8, deadline=None)
@given(B=st.integers(1, 2), S=st.integers(1, 30), di=st.integers(1, 80),
       strong=st.booleans(), bf16=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_backward_kernel_emulation_hypothesis(B, S, di, strong, bf16, seed):
    arrays = _inputs(B, S, di, seed, strong=strong, h0_scale=1.0,
                     x_dtype="bf16" if bf16 else np.float32)
    _emulation_vs_oracle(arrays, _cotangents(B, S, di, seed), bf16,
                         (B, S, di, strong, bf16, seed))


@pytest.mark.parametrize("cut", [1, tss.STATES_EVERY, 13])
def test_backward_kernel_emulation_two_halves_give_the_whole(cut):
    """The second half's backward from dh_T and the state the forward
    emulation reaches at the cut, then the first half's from the second's
    dh0: the per-step gradients and dh0 of the whole bit for bit (a span's
    arithmetic does not depend on where spans start; zero steps leave h
    and g as they are), dA and dD the sums of the halves' within
    SCAN_BWD_RTOL."""
    B, S, di = 2, 40, 70
    dt, x, Bm, Cm, A, D, h0 = _torch(_inputs(B, S, di, 21, strong=True, h0_scale=1.0),
                                     x_dtype=torch.bfloat16)
    dy, dhT = (torch.from_numpy(a).float() for a in _cotangents(B, S, di, 21))
    whole = _scan_bwd_kernel_emulation(dt, x, Bm, Cm, A, D, h0, dy, dhT)
    _, h_mid = _scan_kernel_emulation(dt[:, :cut], x[:, :cut], Bm[:, :cut], Cm[:, :cut],
                                      A, D, h0)
    second = _scan_bwd_kernel_emulation(dt[:, cut:], x[:, cut:], Bm[:, cut:], Cm[:, cut:],
                                        A, D, h_mid, dy[:, cut:], dhT)
    first = _scan_bwd_kernel_emulation(dt[:, :cut], x[:, :cut], Bm[:, :cut], Cm[:, :cut],
                                       A, D, h0, dy[:, :cut], second[6])
    for i in range(4):
        assert torch.equal(torch.cat([first[i], second[i]], dim=1), whole[i]), i
    assert torch.equal(first[6], whole[6])
    _grad_close([first[4] + second[4], first[5] + second[5]], whole[4:6],
                f"split at {cut}", SCAN_BWD_RTOL)


def _refused_bwd(kind):
    """Backward arguments the kernel does not take, on the CPU."""
    if kind == "float64 dy":
        args = _refused("CPU tensors")
        return args + [torch.zeros(1, 4, 32, dtype=torch.float64), torch.zeros(1, 32, N)]
    if kind == "dy of another shape":
        return _refused("CPU tensors") + [torch.zeros(1, 5, 32), torch.zeros(1, 32, N)]
    args = _refused(kind)
    return args + [torch.zeros(args[0].shape), torch.zeros(args[6].shape)]


@pytest.mark.parametrize("kind,error,match", [
    ("d_state 8", ValueError, r"d_state in \(16,\)"),
    ("float64 dt", TypeError, "float32"),
    ("float16 x", TypeError, "bfloat16"),
    ("float64 dy", TypeError, "cotangents"),
    ("dy of another shape", ValueError, "do not fit"),
    ("dt strided over di", ValueError, "unit stride"),
    ("h0 off 16 bytes", ValueError, "16 bytes"),
    ("CPU tensors", ValueError, "CUDA tensors"),
])
def test_cuda_backward_refuses_what_the_kernel_does_not_take(kind, error, match):
    before = tss.launches_bwd
    with pytest.raises(error, match=match):
        tss.selective_scan_backward_cuda(*_refused_bwd(kind))
    assert tss.launches_bwd == before


def test_backward_chunk_matches_the_kernel_source():
    """The backward walks spans of the forward's states interval:
    STATES_EVERY is the kStatesEvery of both sources; the emulation's
    lanes, channels a block and warps a block are the backward's."""
    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    for source in ("selective_scan.cu", "selective_scan_bwd.cu"):
        src = (Path(tss.__file__).parent / "csrc" / source).read_text()
        assert const(src, "kStatesEvery") == tss.STATES_EVERY
    src = (Path(tss.__file__).parent / "csrc" / "selective_scan_bwd.cu").read_text()
    assert (const(src, "kLanes"), const(src, "kChannels"), const(src, "kPerms")) == \
        (LANES, BWD_CHANNELS, LANES)
    assert "kThreads = kChannels * kLanes" in src and "kWarps = kThreads / 32" in src


@pytest.mark.cuda
@pytest.mark.parametrize("S", [5, 8, 9, 16, 17, 300])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_cuda_forward_storing_states_gives_the_same_bits(S, x_dtype):
    _need_cuda()
    args = _torch(_inputs(2, S, 200, S, strong=True, h0_scale=1.0), device="cuda",
                  x_dtype=x_dtype)
    y, hT = tss.selective_scan_cuda(*args)
    y2, h2, states = tss.selective_scan_cuda(*args, return_states=True)
    assert torch.equal(y, y2) and torch.equal(hT, h2)
    if S <= tss.STATES_EVERY:
        assert states is None
    else:
        every = tss.STATES_EVERY
        assert states.shape == (2, -(-S // every), 200, N)
        assert torch.equal(states[:, 0], args[6])
        for r in range(1, states.shape[1]):
            _, h_r = tss.selective_scan_cuda(*(t[:, :r * every] for t in args[:4]), *args[4:])
            assert torch.equal(states[:, r], h_r), r


CUDA_GRAD_CASES = {"S = 1 (2, 1, 384), h0": dict(B=2, S=1, di=384, h0_scale=1.0),
                   "S = 8 (2, 8, 200)": dict(B=2, S=8, di=200, h0_scale=1.0),
                   "S = 9 (2, 9, 70), strong": dict(B=2, S=9, di=70, strong=True,
                                                     h0_scale=1.0),
                   "S = 15 (2, 15, 200)": dict(B=2, S=15, di=200, h0_scale=1.0),
                   "S = 16 (1, 16, 256)": dict(B=1, S=16, di=256),
                   "S = 17 (3, 17, 130), strong": dict(B=3, S=17, di=130, strong=True,
                                                        h0_scale=1.0),
                   "S = 1000 (2, 1000, 1000)": dict(B=2, S=1000, di=1000, h0_scale=1.0),
                   "strong decays (2, 300, 512)": dict(B=2, S=300, di=512, strong=True,
                                                       h0_scale=1.0)}


def _cuda_bwd_check(args, dy, dhT, what):
    states = tss.selective_scan_cuda(*args, return_states=True)[2]
    before = tss.launches_bwd
    got = tss.selective_scan_backward_cuda(*args, dy, dhT, states=states)
    again = tss.selective_scan_backward_cuda(*args, dy, dhT, states=states)
    torch.cuda.synchronize()
    assert tss.launches_bwd == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a), what                 # the same bits on a second call
    want = tss.selective_scan_backward_plain(*args, dy, dhT)
    bf16 = args[1].dtype == torch.bfloat16
    # dx in bf16 against the float32 plain backward of the same inputs
    want_dx = tss.selective_scan_backward_plain(args[0], args[1].float(), *args[2:],
                                                dy, dhT)[1] if bf16 else want[1]
    _grad_close([g for i, g in enumerate(got) if i != 1],
                [w for i, w in enumerate(want) if i != 1], what, SCAN_BWD_RTOL)
    assert got[1].dtype == args[1].dtype
    err = (got[1].float() - want_dx).abs()
    limit = (BF16_RTOL if bf16 else 0.0) * want_dx.abs() \
        + SCAN_BWD_RTOL * max(1.0, float(want_dx.abs().max()))
    assert bool((err <= limit).all()), (what, "dx", float((err - limit).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_GRAD_CASES))
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain(case, x_dtype):
    _need_cuda()
    kw = CUDA_GRAD_CASES[case]
    args = _torch(_inputs(seed=len(case), **kw), device="cuda", x_dtype=x_dtype)
    dy, dhT = (torch.from_numpy(a).float().cuda()
               for a in _cotangents(kw["B"], kw["S"], kw["di"], len(case)))
    _cuda_bwd_check(args, dy, dhT, case)


@pytest.mark.cuda
def test_cuda_remat_recomputes_the_same_states_and_drops_the_first():
    """Under non-reentrant ``torch.utils.checkpoint`` (the model's remat)
    the forward kernel runs twice and the backward once; the gradients
    equal those without checkpoint bit for bit (the recompute stores the
    same states), and the first run's states are not held until the
    backward: after the forward, the checkpointed call holds less device
    memory than the plain one, by the states' size within 10%."""
    _need_cuda()
    B, S, di = 2, 1024, 1024
    args = _torch(_inputs(B, S, di, 17, h0_scale=1.0), device="cuda",
                  x_dtype=torch.bfloat16)
    states_bytes = B * -(-S // tss.STATES_EVERY) * di * N * 4
    grads, held = [], []
    for remat in (False, True):
        leaves = [t.detach().requires_grad_(True) for t in args]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        before = (tss.launches, tss.launches_bwd)
        if remat:
            y, hT = torch.utils.checkpoint.checkpoint(tops.selective_scan, *leaves,
                                                      use_reentrant=False)
        else:
            y, hT = tops.selective_scan(*leaves)
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated() - base)
        (y.square().sum() + hT.sum()).backward()
        torch.cuda.synchronize()
        assert (tss.launches - before[0], tss.launches_bwd - before[1]) == \
            ((2 if remat else 1), 1)
        grads.append([t.grad for t in leaves])
        del y, hT, leaves
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert abs(held[0] - held[1] - states_bytes) <= 0.1 * states_bytes, (held, states_bytes)


@pytest.mark.cuda
def test_cuda_autograd_launches_the_forward_and_backward_kernels():
    _need_cuda()
    args = _torch(_inputs(2, 100, 128, 9, h0_scale=1.0), device="cuda",
                  x_dtype=torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in args]
    before = (tss.launches, tss.launches_bwd)
    y, hT = tops.selective_scan(*leaves)
    (y.square().sum() + hT.sum()).backward()
    torch.cuda.synchronize()
    assert (tss.launches, tss.launches_bwd) == (before[0] + 1, before[1] + 1)
    want = tss.selective_scan_backward_plain(*args, 2.0 * y.detach(), torch.ones_like(hT))
    _grad_close([t.grad for t in leaves if t is not leaves[1]],
                [w for i, w in enumerate(want) if i != 1], "autograd", SCAN_BWD_RTOL)
