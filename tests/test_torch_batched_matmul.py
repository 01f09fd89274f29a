"""The fixed-order batched product (`repro_torch.kernels.batched_matmul`)
that makes the port's local training batch-invariant on the card.

On the CPU: the plain version (each element summed over k in order, every
product and sum rounded once) within 1e-5 of max(1, max |want|) of
`torch.matmul` at `ExperimentSpec()`'s widths (the forward's three
products of a 16-row batch, the shared eval batch, the backward's
transposed forms, FedProto's class sums); bit-invariant across m = 100 in
one call, 4 calls of 25 and 3 calls of 34 (the last padded, as the engine
pads); `BatchedMatmulFn`'s gradients (the plain backward on CPU tensors)
against `torch.matmul`'s autograd; `ops.batched_matmul` keeping
`torch.matmul` on the CPU bit for bit; the CUDA wrapper's refusals, which
come before it looks at the device.  The `cuda`-marked tests hold the
kernel to the plain version bit for bit at the same shapes (the eval
round's three products, the kernel's class and tile edges), transposed
operands, expanded gradients as either operand, ragged tiles and operands
off the 16-byte path, and each client's rows equal in calls of 25, 34 and
100.  No JAX here: the reference leaves these
products to XLA and has no kernel to compare with."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import batched_matmul as bm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RTOL = 1e-5     # of max(1, max |want|): two float32 orders of a 64-term sum
# ExperimentSpec()'s MLP 64 -> 64 -> 32 -> 10, a client's batch of 16 rows,
# 100 clients; the eval forward's three products over the shared
# 1024-example batch
SHAPES = {"layer 0": ((100, 16, 64), (100, 64, 64)),
          "layer 1": ((100, 16, 64), (100, 64, 32)),
          "head": ((100, 16, 32), (100, 32, 10)),
          "eval, a shared": ((1024, 64), (100, 64, 64)),
          "eval layer 1": ((100, 1024, 64), (100, 64, 32)),
          "eval head": ((100, 1024, 32), (100, 32, 10)),
          "ragged tiles": ((3, 17, 33), (3, 33, 70)),
          "K = 1": ((5, 16, 1), (5, 1, 10))}
# the kernel's class and tile edges (csrc/batched_matmul.cu): M one below, at
# and one above the row tiles 16 / 64 / 128 (128 also the edge of the rows
# class), N about the column tiles 16 / 32 / 64, K about the 4-wide loads and
# the 64-deep stages (two and three stages); a shared a whose clients do not
# split evenly over the blocks, and one staged in chunks (K > 64)
EDGES = {"M 15, N 15, K 3": ((3, 15, 3), (3, 3, 15)),
         "M 16, N 16, K 4": ((3, 16, 4), (3, 4, 16)),
         "M 17, N 17, K 5": ((3, 17, 5), (3, 5, 17)),
         "M 63, N 31, K 63": ((3, 63, 63), (3, 63, 31)),
         "M 64, N 32, K 64": ((3, 64, 64), (3, 64, 32)),
         "M 65, N 33, K 65": ((3, 65, 65), (3, 65, 33)),
         "M 127, N 63, K 127": ((3, 127, 127), (3, 127, 63)),
         "M 128, N 64, K 128": ((3, 128, 128), (3, 128, 64)),
         "M 129, N 65, K 129": ((3, 129, 129), (3, 129, 65)),
         "rows class, N 15": ((3, 129, 33), (3, 33, 15)),
         "rows class, N 16": ((3, 128, 16), (3, 16, 16)),
         "rows class, N 17": ((3, 200, 20), (3, 20, 17)),
         "rows class, N 33": ((3, 200, 20), (3, 20, 33)),
         "a shared, 101 clients": ((1024, 64), (101, 64, 64)),
         "a shared, K 65": ((200, 65), (9, 65, 40))}
SHAPES.update(EDGES)
EVAL_FORWARD = ("eval layer 1", "eval head")


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _operands(name, seed=0):
    sa, sb = SHAPES[name]
    return _rand(sa, seed), _rand(sb, seed + 1)


def _forms(a, b, seed=2, backward=True):
    """The product and, for per-model a, its two backward forms through
    transposed views: dY @ B^T and A^T @ dY."""
    yield "a @ b", a, b
    if a.dim() == 3 and backward:
        dy = _rand((b.shape[0], a.shape[1], b.shape[2]), seed).to(a.device)
        yield "dY @ B^T", dy, b.transpose(1, 2)
        yield "A^T @ dY", a.transpose(1, 2), dy


def _close(got, want):
    return float((got - want).abs().max()) <= RTOL * max(1.0, float(want.abs().max()))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_matches_torch_matmul(name):
    a, b = _operands(name)
    # the eval forward has no backward; its A^T @ dY would sum over 1024
    # rows in the plain version's K-step loop (the card checks those forms)
    for form, x, y in _forms(a, b, backward=name not in EVAL_FORWARD):
        got = bm.batched_matmul_plain(x, y)
        assert got.shape == torch.matmul(x, y).shape, form
        assert _close(got, torch.matmul(x, y)), form


def test_plain_class_sums_match_torch_matmul():
    rng = np.random.default_rng(3)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(
        rng.integers(0, 10, size=(100, 16))), 10).float()
    reps = _rand((100, 16, 32), 4)
    got = bm.batched_matmul_plain(onehot.transpose(1, 2), reps)
    assert _close(got, torch.matmul(onehot.transpose(1, 2), reps))


@pytest.mark.parametrize("name", ["layer 0", "layer 1", "head", "eval, a shared"])
def test_plain_is_batch_invariant(name):
    a, b = _operands(name)
    for form, x, y in _forms(a, b):
        whole = _bits(bm.batched_matmul_plain(x, y))
        for split in ((25, 25, 25, 25), (34, 34, 32)):
            parts, start = [], 0
            for m in split:
                pad = max(split) - m
                sl = slice(start, start + m)
                xs = x if x.dim() == 2 else torch.cat([x[sl], x[:1].expand(pad, *x.shape[1:])])
                ys = torch.cat([y[sl], y[:1].expand(pad, *y.shape[1:])])
                parts.append(bm.batched_matmul_plain(xs, ys)[:m])
                start += m
            assert torch.equal(_bits(torch.cat(parts)), whole), (form, split)


def test_plain_sums_in_order_from_plus_zero():
    # (1e8 + 1) - 1e8 in order is 0 in float32: the first two terms round
    a = torch.tensor([[[1e8, 1.0, -1e8]]])
    b = torch.ones((1, 3, 1))
    assert float(bm.batched_matmul_plain(a, b)) == 0.0
    # a sum of -0.0 products starts from +0.0, so it is +0.0
    z = bm.batched_matmul_plain(-torch.zeros((1, 2, 4)), torch.ones((1, 4, 3)))
    assert not torch.signbit(z).any()


@pytest.mark.parametrize("name", ["layer 1", "head", "eval, a shared"])
def test_function_gradients_match_torch_matmul(name):
    a, b = _operands(name)
    b = b[:8]                           # 8 models keep the plain K-loop quick
    a = a if a.dim() == 2 else a[:8]
    dy = _rand((b.shape[0], a.shape[-2], b.shape[2]), 5)
    a1, b1 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    a2, b2 = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    out = bm.BatchedMatmulFn.apply(a1, b1)
    assert torch.equal(out, bm.batched_matmul_plain(a, b))
    got = torch.autograd.grad(out, (a1, b1), dy)
    want = torch.autograd.grad(torch.matmul(a2, b2), (a2, b2), dy)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _close(g, w)
    # the backward is the plain product of the transposed forms, in order
    assert torch.equal(got[1], bm.batched_matmul_plain(a.transpose(-1, -2), dy))


def test_function_gradient_of_b_alone():
    a, b = _operands("layer 0")
    b = b.requires_grad_(True)
    out = bm.BatchedMatmulFn.apply(a, b)
    (g,) = torch.autograd.grad(out.sum(), (b,))
    ones = torch.ones_like(out)
    assert torch.equal(g, bm.batched_matmul_plain(a.transpose(1, 2), ones))


def test_ops_keeps_torch_matmul_on_the_cpu():
    for name in SHAPES:
        a, b = _operands(name)
        assert torch.equal(ops.batched_matmul(a, b), torch.matmul(a, b)), name


def test_cuda_wrapper_refuses_before_the_device():
    a, b = _operands("layer 1")
    with pytest.raises(TypeError):
        bm.batched_matmul_cuda(a.double(), b)
    with pytest.raises(ValueError):
        bm.batched_matmul_cuda(a, b[:, :5])
    with pytest.raises(ValueError):
        bm.batched_matmul_cuda(a[:50], b)
    with pytest.raises(ValueError):
        bm.batched_matmul_cuda(a[0, 0], b)
    with pytest.raises(ValueError):
        bm.batched_matmul_cuda(_rand((bm.MAX_BATCH + 1, 1, 1), 0),
                               _rand((bm.MAX_BATCH + 1, 1, 1), 1))
    with pytest.raises(ValueError, match="CUDA"):
        bm.batched_matmul_cuda(a, b)
    with pytest.raises(TypeError):
        bm.batched_matmul_plain(a.half(), b.half())


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_cuda_kernel_equals_plain(name):
    dev = _cuda()
    a, b = (t.to(dev) for t in _operands(name))
    for form, x, y in _forms(a, b):
        got = bm.batched_matmul_cuda(x, y)
        assert torch.equal(_bits(got), _bits(bm.batched_matmul_plain(x, y))), form
    dy = _rand((b.shape[0], a.shape[-2], b.shape[2]), 6).to(dev)
    expanded = dy[:1, :1].expand_as(dy)
    at = a.transpose(-1, -2)
    assert torch.equal(_bits(bm.batched_matmul_cuda(at, expanded)),
                       _bits(bm.batched_matmul_plain(at, expanded)))
    bt = b.transpose(1, 2)
    assert torch.equal(_bits(bm.batched_matmul_cuda(expanded, bt)),
                       _bits(bm.batched_matmul_plain(expanded, bt)))


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_on_strided_views():
    """Operands off the 16-byte path: an unaligned base, a row pitch off 4
    floats, a non-unit inner stride, in both classes and both operands."""
    dev = _cuda()
    a_big = _rand((3, 300, 67), 8).to(dev)
    b_big = _rand((3, 66, 130), 9).to(dev)
    cases = {"a off 16 bytes": (a_big[:, :17, 1:65], b_big[:, :64, :64]),
             "a row pitch 67": (a_big[:, :200, :64], b_big[:, :64, :32]),
             "a inner stride 2": (a_big[:, :17, ::2], b_big[:, :34, :40]),
             "b off 16 bytes": (a_big[:, :200, :64], b_big[:, 1:65, 1:65]),
             "b inner stride 2": (a_big[:, :17, :64], b_big[:, :64, ::2]),
             "b row pitch 130, N 10": (a_big[:, :150, :66], b_big[:, :, :10]),
             "shared a off 16 bytes": (a_big[0, :300, 1:65], b_big[:, :64, :64])}
    for what, (x, y) in cases.items():
        got = bm.batched_matmul_cuda(x, y)
        assert torch.equal(_bits(got), _bits(bm.batched_matmul_plain(x, y))), what


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["layer 0", "layer 1", "head", "eval, a shared",
                                  "eval layer 1", "eval head"])
def test_cuda_kernel_is_batch_invariant(name):
    dev = _cuda()
    a, b = (t.to(dev) for t in _operands(name))
    whole = _bits(bm.batched_matmul_cuda(a, b))
    for m in (25, 34):
        part = bm.batched_matmul_cuda(a if a.dim() == 2 else a[:m], b[:m])
        assert torch.equal(_bits(part), whole[:m]), m


@pytest.mark.cuda
def test_cuda_function_and_launch_count():
    dev = _cuda()
    a, b = (t.to(dev).requires_grad_(True) for t in _operands("layer 1"))
    dy = _rand((100, 16, 32), 7).to(dev)
    bm.launches = 0
    out = ops.batched_matmul(a, b)
    got = torch.autograd.grad(out, (a, b), dy)
    assert bm.launches == 3
    want = (bm.batched_matmul_plain(dy, b.detach().transpose(1, 2)),
            bm.batched_matmul_plain(a.detach().transpose(1, 2), dy))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
