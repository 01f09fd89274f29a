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

On the card (`cuda` marker, skipped without one): the kernel against the
plain version within SCAN_RTOL at S = 1, 4 and 5 (the two sides of the
switch between its decode and chunked forms), 63, 64, 65 and 1000,
d_inner on and off the block of 64 channels, strong decays, a non-zero h0,
x in float32 and bf16, Bm and Cm as column slices of one projection; two
halves against the whole, split on and off a chunk; one launch a call; a
backward through it raises naming ROADMAP item 7e."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402

# float32 against the float64 oracle, and the kernel against the plain
# version: |got - want| <= SCAN_RTOL max(1, max |want|), per output
SCAN_RTOL = 1e-5
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


@pytest.mark.cuda
def test_cuda_backward_raises_naming_item_7e():
    _need_cuda()
    args = [t.clone().requires_grad_(True)
            for t in _torch(_inputs(1, 8, 128, 9), device="cuda")]
    y, _ = tops.selective_scan(*args)
    with pytest.raises(NotImplementedError, match="item 7e"):
        y.sum().backward()
