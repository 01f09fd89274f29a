#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (the script then exits non-zero):

1. kernels — builds every CUDA source of the port (`nvcc`, sm_90a) and holds
   the fingerprint kernel bit for bit against its plain PyTorch version on
   the card, at the serving bank (5, 6570), a commit cohort (100, 6570), a
   population (1000, 6570), ragged (17, 131) and (1, 1) shapes, rows split
   over several blocks (3, 70001), an all-zero row, rows off the 16-byte
   grid, and fp32 arena rows read in place; then times kernel and plain
   version with CUDA events (median device time, cold L2).
2. serve — the port's serving path at the default model width
   (MLP 64-64-32-10, N = 6570 params) for n = 1000 clients in K = 5
   clusters: three commit blocks whose cohort digests come through the
   kernel (one freerider copying a peer's digest in each, refused by
   `verify_round`), `serve()` (snapshot -> release block -> verify ->
   engine), an explicit `verify_bank`, 64 mixed-cluster requests on a
   virtual clock with full-bucket, deadline and drain flushes, a tampered
   bank refused by `verify_bank` and `ServingEngine`.  The kernel's launch
   count is reset just before this phase and must be > 0 after it.

Prints the card's name and power limit (`nvidia-smi`), one JSON line
`{"kernels": [...]}` with each kernel's launches on the serve path, error,
times and bound, one JSON line `{"serve": {...}}`, and last
`{"ok": true, "device": {...}}`.  Without CUDA it exits non-zero and prints
no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.blockchain import (  # noqa: E402
    AGG_COMMIT_KIND,
    MODEL_COMMIT_KIND,
    Blockchain,
    RoundCommitments,
    Transaction,
    TxPool,
)
from repro_torch.kernels import _build, fingerprint as fp  # noqa: E402
from repro_torch.models import classifier as clf  # noqa: E402
from repro_torch.runtime.arena import ParamArena  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ProvenanceError,
    ServeConfig,
    ServingEngine,
    serve,
    tampered,
    verify_bank,
)
from repro_torch.serve.snapshot import mlp_layout  # noqa: E402
from repro_torch.sim import VirtualClock  # noqa: E402

SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and 32-bit arithmetic
# outside the tensor cores (the fp32 rate; int32 runs on the same lanes).
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12
FP_OPS_PER_ELEMENT = 6        # mix: xor + shift; two multiply-adds
FORWARD_TOL = 1e-5            # fused vs per-request, if not bitwise
SLEEP_CYCLES = 2_000_000      # ~1 ms at the H100's clocks


def fingerprint_bound_us(m: int, n: int) -> tuple[float, str]:
    """Least time for the fingerprint of an (m, n) matrix: each input byte
    read once, each output byte written once, or its integer operations."""
    t_bytes = (m * n * 4 + m * 2 * 4) / HBM_BYTES_PER_S * 1e6
    t_ops = FP_OPS_PER_ELEMENT * m * n / ALU32_OPS_PER_S * 1e6
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def median_us(fn, arg, reps: int, flush: torch.Tensor) -> float:
    """Median device time over ``reps`` CUDA-event-timed calls, each after
    the L2 cache was overwritten (a 128 MiB write; the H100's L2 holds
    50 MB).  A ~1 ms device-side sleep before each start event lets the host
    queue the whole call first, so the time is the device's alone and not
    the host's launch overhead."""
    for _ in range(3):
        fn(arg)
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) * 1e3 for s, e in times]))


def random_bits(rng: np.random.Generator, m: int, n: int, dev) -> torch.Tensor:
    x = rng.integers(0, 2**32, size=(m, n), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(x).to(dev)


def check_exact(bits: torch.Tensor, what: str) -> int:
    """Kernel vs plain version on the same bits; returns the largest
    difference of a residue (as unsigned 32-bit integers), which must be 0."""
    got = fp.fingerprint_cuda(bits).long() & 0xFFFFFFFF
    want = fp.fingerprint_plain(bits).long() & 0xFFFFFFFF
    err = int((got - want).abs().max())
    if err:
        bad = int((got != want).any(dim=1).sum())
        raise AssertionError(f"fingerprint kernel != plain version on {what}: "
                             f"{bad} of {bits.shape[0]} rows differ")
    return err


def kernel_phase(dev) -> tuple[list[dict], int]:
    rng = np.random.default_rng(SEED)
    timed = [(5, 6570), (100, 6570), (1000, 6570)]
    # (3, 70001): rows long enough to split over several blocks per row
    errs = [check_exact(random_bits(rng, m, n, dev), f"({m}, {n})")
            for m, n in timed + [(17, 131), (1, 1), (3, 70001)]]
    x = random_bits(rng, 100, 6570, dev)
    x[7] = 0
    errs.append(check_exact(x, "an all-zero row"))
    if fp.fingerprint_cuda(x)[7].any():
        raise AssertionError("an all-zero row must fingerprint to (0, 0)")
    buf = random_bits(rng, 1, 17 * 131 + 1, dev)[0]
    errs.append(check_exact(buf[1:].view(17, 131),
                            "rows starting off the 16-byte grid"))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.randn((1000, 6570), generator=gen, device=dev)
    errs.append(check_exact(rows.view(torch.int32),
                            "fp32 arena rows read in place"))

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    shapes = []
    for m, n in timed:
        bits = random_bits(rng, m, n, dev)
        bound, bound_by = fingerprint_bound_us(m, n)
        shapes.append({
            "m": m, "n": n, "bit_exact": True,
            "kernel_us": median_us(fp.fingerprint_cuda, bits, 200, flush),
            "plain_us": median_us(fp.fingerprint_plain, bits, 30, flush),
            "bound_us": bound, "bound_by": bound_by})
    return shapes, max(errs)


class FlushLog:
    """A recorder for the serving path's ``obs`` hook that keeps the wall
    time and attributes of every ``serve.flush`` span and drops the rest."""

    def __init__(self):
        self.flushes: list[dict] = []

    def span(self, name: str, **attrs):
        return _Span(self.flushes if name == "serve.flush" else None)

    def inc(self, *args, **kwargs) -> None:
        pass

    event = observe = set_gauge = inc


class _Span:
    def __init__(self, sink):
        self.sink, self.attrs = sink, {}

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.sink is not None:
            self.sink.append(dict(self.attrs,
                                  ms=(time.perf_counter() - self.t0) * 1e3))
        return False


def commit_round(chain, pool, arena, rng, r: int, n: int, k: int) -> None:
    """One training round's commitments: every cohort member commits the
    digest of its row, the producer records what it aggregated; the last
    member is a freerider committing a copy of a peer's digest."""
    cohort = rng.choice(n, size=k, replace=False)
    digests = fp.row_digests(arena.data[torch.as_tensor(cohort,
                                                        device=arena.data.device)])
    producer = int(cohort[0])
    for i, cid in enumerate(cohort):
        claimed = digests[0] if i == k - 1 else digests[i]
        pool.submit(Transaction(MODEL_COMMIT_KIND, int(cid), claimed, r))
    rc = RoundCommitments(r, tuple(zip(cohort.tolist(), digests)))
    pool.submit(Transaction(AGG_COMMIT_KIND, producer, rc.to_payload(), r))
    ok = chain.verify_round(chain.pack_block(r, producer, pool), n)
    want = np.zeros(n, dtype=bool)
    want[cohort[:-1]] = True
    if not np.array_equal(ok, want):
        raise AssertionError(f"verify_round decisions wrong in round {r}")


def submit_schedule(fe, clock, xs, cids) -> list[int]:
    """64 requests: a burst of 40 at t=0 (one full-bucket flush in submit,
    the rest by deadline), 20 spaced 1 ms apart (deadline flushes), 4 more
    drained.  Returns the flush count after each stage."""
    marks = []
    for i in range(40):
        fe.submit(int(cids[i]), xs[i])
    marks.append(fe.n_flushes)
    clock.advance_to(0.01)
    fe.pump()
    marks.append(fe.n_flushes)
    for i in range(40, 60):
        clock.advance_to(0.02 + 0.001 * (i - 40))
        fe.pump()
        fe.submit(int(cids[i]), xs[i])
    clock.advance_to(0.05)
    fe.pump()
    for i in range(60, 64):
        fe.submit(int(cids[i]), xs[i])
    fe.drain()
    marks.append(fe.n_flushes)
    return marks


def serve_phase(dev) -> dict:
    mcfg = clf.MLPConfig(in_dim=64, hidden=(64,), rep_dim=32, num_classes=10)
    n, n_clusters, cohort_k, rounds = 1000, 5, 100, 3
    layout = mlp_layout(mcfg)
    if layout.n_params != 6570:
        raise AssertionError(f"expected N = 6570, got {layout.n_params}")
    # population: one shared init plus per-client drift, all on the card
    gen = torch.Generator().manual_seed(SEED)
    base = layout.flatten({k: v[None] for k, v in
                           clf.init_mlp(mcfg, gen, device=dev).items()})
    dgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = base + 0.05 * torch.randn((n, layout.n_params), generator=dgen,
                                     device=dev)
    arena = ParamArena(layout, rows)
    rng = np.random.default_rng(SEED)
    labels = rng.integers(0, n_clusters, size=n)
    labels[rng.choice(n, size=n // 20, replace=False)] = -1   # never assigned
    chain, pool = Blockchain(), TxPool()
    sim = SimpleNamespace(pop=SimpleNamespace(n_clients=n),
                          cfg=SimpleNamespace(n_clusters=n_clusters),
                          arena=arena, last_labels=labels, mcfg=mcfg,
                          trainer=SimpleNamespace(chain=chain, pool=pool),
                          clock=VirtualClock(), obs=None)
    xs = rng.standard_normal((64, mcfg.in_dim)).astype(np.float32)
    cids = rng.integers(0, n_clusters, size=64)
    log = FlushLog()

    fp.launches = 0
    t0 = time.perf_counter()
    for r in range(rounds):
        commit_round(chain, pool, arena, rng, r, n, cohort_k)
    fe = serve(sim, config=ServeConfig(), obs=log)
    bank, engine = fe.engine.bank, fe.engine
    verify_bank(bank, chain)
    marks = submit_schedule(fe, sim.clock, xs, cids)
    done = fe.take_completed()
    bad = tampered(bank, 1)
    for gate in (verify_bank, ServingEngine):
        try:
            gate(bad, chain)
        except ProvenanceError:
            continue
        raise AssertionError(f"{gate.__name__} did not refuse a tampered bank")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fp.launches
    if launches == 0:
        raise AssertionError("the serve path never launched the kernel")

    # -- checks against plain references ------------------------------- #
    if not chain.validate():
        raise AssertionError("chain does not validate")
    host_rows = rows.cpu().numpy().astype(np.float64)
    host_bank = bank.data.cpu().numpy()
    for c in range(n_clusters):
        want = host_rows[labels == c].mean(axis=0)
        np.testing.assert_allclose(host_bank[c], want, rtol=0, atol=1e-6)
    reasons = [f["reason"] for f in log.flushes]
    if marks[0] != 1 or marks[1] != 2 or not {"full", "deadline", "drain"} <= set(reasons):
        raise AssertionError(f"unexpected flushes: marks {marks}, reasons {reasons}")
    if sorted(c.req_id for c in done) != list(range(64)) or \
            any(c.status != "ok" for c in done):
        raise AssertionError("not every request was answered")
    served = np.stack([c.logits for c in sorted(done, key=lambda c: c.req_id)])
    per_req = engine.forward_per_request(xs, cids).cpu().numpy()
    fused = engine.forward(xs[:32], cids[:32]).cpu().numpy()
    cpu_ref = ServingEngine(dataclasses.replace(bank, data=bank.data.cpu()),
                            verify=False).forward_per_request(xs, cids).numpy()
    if served.shape != (64, mcfg.num_classes) or not np.isfinite(served).all():
        raise AssertionError("served logits are not finite (64, 10)")
    bitwise = bool(np.array_equal(served.view(np.int32), per_req.view(np.int32))
                   and np.array_equal(fused.view(np.int32),
                                      per_req[:32].view(np.int32)))
    max_diff = float(max(np.abs(served - per_req).max(),
                         np.abs(fused - per_req[:32]).max()))
    if max_diff > FORWARD_TOL:
        raise AssertionError(f"fused vs per-request differ by {max_diff}")
    cpu_diff = float(np.abs(served - cpu_ref).max())
    np.testing.assert_allclose(served, cpu_ref, rtol=0, atol=FORWARD_TOL)
    flush_ms = [f["ms"] for f in log.flushes]
    return {"launches": launches, "n_clients": n, "n_clusters": n_clusters,
            "n_params": layout.n_params, "blocks": len(chain.blocks),
            "requests": len(done), "flushes": len(flush_ms),
            "flush_reasons": sorted(set(reasons)),
            "fused_bitwise_per_request": bitwise,
            "fused_vs_per_request_max_abs": max_diff,
            "card_vs_cpu_max_abs": cpu_diff,
            "flush_ms_p50": float(np.median(flush_ms)),
            "serve_path_wall_s": wall_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        print(log.read_text().strip(), flush=True)

    shapes, max_err = kernel_phase(dev)
    served = serve_phase(dev)
    top = shapes[0]                     # the serving bank, (5, 6570)
    print(json.dumps({"kernels": [{
        "name": "fingerprint", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fingerprint.cu",
        "replaces": "src/repro/kernels/fingerprint.py:102",
        "launches": served["launches"], "max_abs_err": max_err,
        "tolerance": 0,
        "ms": top["kernel_us"] / 1e3, "plain_ms": top["plain_us"] / 1e3,
        "bound_ms": top["bound_us"] / 1e3, "bound_by": top["bound_by"],
        "library_ms": None,
        "bit_exact": True, "shapes": shapes,
        "kernel_us": top["kernel_us"], "plain_us": top["plain_us"],
        "bound_us": top["bound_us"]}]}), flush=True)
    print(json.dumps({"serve": served}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
