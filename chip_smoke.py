#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (the script then exits non-zero):

1. kernels — builds every CUDA source of the port (`nvcc`, sm_90a, one
   process per source, all at once; both flash kernels must compile
   without register spills) and holds each kernel against its plain
   PyTorch version on the card:
   * the launch floors: an empty kernel, and one that moves 16 bytes
     (`csrc/launch_floor.cu`), under the same timer as every kernel;
   * fingerprint, bit for bit, at the serving bank (5, 6570), a commit
     cohort (100, 6570), a population (1000, 6570), ragged (17, 131) and
     (1, 1) shapes, rows split over several blocks (3, 70001), an all-zero
     row, rows off the 16-byte grid, fp32 arena rows read in place, and
     every cluster size (1, 2, 4, 8) on and off the 16-byte grid; one call
     must make exactly one device launch (torch.profiler); timed at every
     shape a path launches it at, (1 / 5 / 100 / 1000, 6570), at the
     chooser's cluster size and at each forced one, and once more after an
     L2 flush that leaves no dirty lines;
   * cluster aggregation, bit for bit, in float32 and bf16 rows, at the
     train path's (100, 6570) with C = 5, m = 1, m = 3, ragged (37, 131), a
     whole population (1000, 6570), m = 3000 (more than one 256-row chunk),
     odd N (100, 6571), the most rows the kernel takes (65536, 40), an empty
     cluster, all-zero weights, zero-weight rows holding NaN, a row of -0.0
     and a bad label;
   * Pearson, at atol 1e-5, at the train path's (100, 32), (7, 5), (1, 3),
     a constant row, (300, 600), (129, 33), (1, 1), (2000, 32) and
     (300, 600) + 1e3 (a large mean), the last four exactly symmetric; one
     call must make exactly one device launch; timed at (100, 32) and at
     (300, 600);
   * flash attention: the bf16 tensor-core kernel at the LM path's
     (2, 4096, 8 / 4, 256) with window 1024 and 0, element by element
     against the float32 result of the same inputs (|got - want| <=
     2^-8 |want| + 2e-5: one rounding to bf16), and the float32 kernel at
     the same shape (atol 2e-5), on those values and on full-mantissa
     float32 inputs (which one TF32 product would not hold); then both at
     ragged (1, 1000, 4, 2, 64), non-causal, G = 8 with window 100,
     head_dim 32 with window 64, 128 and 120, and G = 5, each at its own
     limit;
   * the RWKV6 wkv recurrence, at the LM path's (2, 40, 4096, 64) (the
     chunked form), with the model's strong decays w = exp(-exp(x)), at a
     ragged T = 1000, at T = 1 (the recurrent kernel), two halves and a
     split at 1001 against the whole, and w = 0 (atol 1e-4; w = 0 must
     leave exactly the last k v^T);
   * the shapes only the baselines' and the paper's paths give the
     kernels: the flat strategies' masked mean (cluster_agg at C = 1,
     zero-weight rows holding NaN) at (100, 6570) and at Table II's
     (20, 17226) and (20, 23076), BFLN's cluster means there at C = 2 / 5 /
     7, all bit for bit; the fingerprint of those (20, N) rows at every
     forced cluster size, on and off the 16-byte grid, bit for bit; the
     Pearson matrix of (20, 64) prototypes within 1e-5, exactly symmetric;
   * the async path's shapes (ASYNC_SHAPE, a flush's (16, 6570) rows): the
     fingerprint at every forced cluster size, on and off the 16-byte grid,
     and the merge — cluster_agg at C = 1 over staleness weights gated by
     verification, zero-weight rows holding NaN, through
     `weighted_delta_mean` (one launch, the plain version's row 0) and with
     every weight 0 (an exact +0.0 delta), all bit for bit;
   then times kernel, plain version and (where one PyTorch call computes
   the same function) the library call with CUDA events (median device
   time, cold L2) beside the least time the card could take; flash beside
   SDPA with the band mask and, causal, with `is_causal=True` and no mask,
   naming the backend PyTorch chose for each.
2. train — the paper's main path, `repro_torch.api.run(ExperimentSpec())`
   at its defaults (BFLN sync, n = 1000, cohort 100, 20 rounds, MLP
   64-64-32-10 so N = 6570, 5 clusters) on the card, with every kernel's
   launch count reset just before and read just after: each kernel must
   have launched, about once per non-empty round.  The chain must
   validate, the ledger conserve, and the same spec on the CPU must log the
   same events (event-log digest) and reach a final accuracy within
   ACC_TOL.  Since neither of those depends tightly on the trained
   weights, one `sync_step` then runs on the card and on the CPU from
   identical rows and cohort data: equal labels, the Pearson matrix within
   1e-5, the new rows within STEP_ROWS_TOL.  `serve(result.sim)` must then
   pass `verify_bank` and answer mixed-cluster requests.
3. strategies — each of the four Table II baselines (fedavg, fedprox,
   fedproto, fedhkd) through `run(ExperimentSpec(train=TrainSpec(
   strategy=s)))` at the defaults on the card, its launches counted
   (fingerprint once a round plus the freeriders' claim; cluster_agg once a
   round, none for fedproto), then on the host CPU at the same depth: equal event-log digests, `chain_valid` and `ledger_conserved`
   on both, balances within BALANCE_TOL, final accuracy within ACC_TOL;
   round wall p50 and per-stage spans.
4. async — FedBuff, `run(ExperimentSpec(train=TrainSpec(mode="async")))`
   at the defaults (n = 1000, N = 6570, buffer 16, concurrency 64, alpha
   0.5, server lr 1.0, 20 flushes, eval every 5) on the card, launches
   counted (the fingerprint once a flush plus the freeriders' claim,
   cluster_agg once a flush for the merge, Pearson never) beside the counts
   the code implies, then on the host CPU: equal event logs and balances,
   chain valid and ledger conserved on both, final accuracy within
   ACC_TOL; flush wall p50 / p99 and every `flush.*` stage's wall.
5. faults — FAULT_SCHEDULE (a producer failure, a bad block, a dropped and
   a delayed commit, retry on) in one sync and one async run at the
   defaults, on the card and the CPU: equal event logs, balances,
   quarantined rounds, late commits and verified fractions; chain valid,
   ledger conserved.
6. resume — in both modes on the card at the defaults, snapshots every
   RESUME_INTERVAL: checkpointing moves no digest; a crash at boundary
   RESUME_CRASH by `InjectedCrash` in process and by SIGKILL in a child
   process (`subprocess.run` with a timeout, return code -9), each resumed
   in this process with `run(..., resume_from=dir)`: resume_step the crash
   boundary, event-log, block-hash and balances digests and final accuracy
   equal to the uninterrupted run's; a snapshot corrupted or truncated by
   the injector skipped by `load_latest`.  The snapshot directories lie in
   a `tempfile.mkdtemp()` removed afterwards.
7. paper — the port's Table II campaign at `table2_accuracy.main()`'s
   defaults (synth10 and synth100, beta 0.1 / 0.3 / 0.5, bfln-2 / 5 / 7,
   fedavg, fedprox, fedproto, fedhkd, 12 rounds of 20 clients, MLP
   64-128-64-C) and `fig2_rewards.main()` on the card, each run's wall and
   accuracy, Fig 2's reward-size correlation and spread; every BFLN run
   must keep its chain valid and its ledger conserved, and the launches
   must be those of the runs' rounds.  One cell (synth10, 0.1, bfln-5)
   again on the host CPU: accuracy within PAPER_ACC_TOL, rewards equal in
   every round whose labels agree.  The paper's orderings are recorded,
   not gated.
8. serve — the port's serving path at the default model width
   (MLP 64-64-32-10, N = 6570 params) for n = 1000 clients in K = 5
   clusters: three commit blocks whose cohort digests come through the
   kernel (one freerider copying a peer's digest in each, refused by
   `verify_round`), `serve()` (snapshot -> release block -> verify ->
   engine), an explicit `verify_bank`, 64 mixed-cluster requests on a
   virtual clock with full-bucket, deadline and drain flushes, a tampered
   bank refused by `verify_bank` and `ServingEngine`.  The fingerprint
   kernel's launch count is reset just before this phase and must be > 0
   after it.
9. lm — the LM zoo's inference path at full width, depth cut: gemma3-4b
   (6 layers: five SWA-1024 and one global) and rwkv6-3b (4 layers), bf16
   weights from `init_params(seed)`.  Per configuration: `make_eval_step`
   at B = 2, S = 4096 (loss, wall) and `greedy_generate` at B = 2, a
   16-token prompt, 16 new tokens (wall per token), each with every
   kernel's launch count reset just before and read just after (bf16
   flash: 6 per gemma3 forward, 0 in decode; wkv: 4 per rwkv6 forward and
   per decode step); `decode_step` over 32 tokens against `forward` on them
   (relative max error <= DECODE_RTOL, the reference's contract); and the
   same configuration in float32, one period, B = 1, S = 128, on the card
   (kernels; the path `lm_fp32`, where the float32 flash kernel runs, its
   counts read around the card's forward) against the host CPU (plain
   versions) within CARD_CPU_RTOL.

Prints the card's name and power limit (`nvidia-smi`), one JSON line
`{"kernels": [...]}` with each kernel's launches on its main path (and per
path: train, train_fedavg, train_fedprox, train_fedproto, train_fedhkd,
async, faults, resume, paper, serve, lm_forward, lm_decode, lm_fp32), error,
times, bound and the two launch floors (the fingerprint and cluster_agg
entries with their `async_shape` row), one JSON line each
`{"train": {...}}`, `{"strategies": {...}}`, `{"async": {...}}`,
`{"faults": {...}}`, `{"resume": {...}}`, `{"paper": {...}}`,
`{"serve": {...}}`, `{"lm": {...}}`, and last `{"ok": true, "device":
{...}}`.  Without CUDA
it exits non-zero and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.blockchain import (  # noqa: E402
    AGG_COMMIT_KIND,
    MODEL_COMMIT_KIND,
    Blockchain,
    RoundCommitments,
    Transaction,
    TxPool,
)
from repro_torch.api import (  # noqa: E402
    CheckpointSpec,
    ExperimentSpec,
    FaultSpec,
    InjectedCrash,
    TrainSpec,
    run,
)
from repro_torch.api.registry import build_strategy  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.engine import RoundEngine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.data.lm import batch_stream, make_token_stream  # noqa: E402
from repro_torch.kernels import cluster_agg as ca  # noqa: E402
from repro_torch.kernels import fingerprint as fp  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import pearson as pe  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wk  # noqa: E402
from repro_torch.models import classifier as clf  # noqa: E402
from repro_torch.models import decode as lmdec  # noqa: E402
from repro_torch.models import lm as lmsteps  # noqa: E402
from repro_torch.models import transformer as lmt  # noqa: E402
from repro_torch.paper import common as paper_common  # noqa: E402
from repro_torch.paper import fig2_rewards, table2_accuracy  # noqa: E402
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
from repro_torch.sim.async_agg import staleness_weight, weighted_delta_mean  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

SEED = 0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and 32-bit arithmetic
# outside the tensor cores (the fp32 rate; int32 runs on the same lanes).
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12
FP_OPS_PER_ELEMENT = 6        # mix: xor + shift; two multiply-adds
FORWARD_TOL = 1e-5            # fused vs per-request, if not bitwise
SLEEP_CYCLES = 2_000_000      # ~1 ms at the H100's clocks
PEARSON_TOL = 1e-5            # the reference's own Pearson tolerance
# Card vs CPU final accuracy of the default run: the two Pearson matrices
# differ in the last bits, so a near-tie in spectral clustering can flip a
# label (round 0 starts from identical models) and move a few clients'
# models; the event log must still match exactly.
ACC_TOL = 0.02
# One sync step on the card vs the same step on the CPU from identical rows
# and data: the Pearson matrix at the reference's tolerance; the new rows at
# STEP_ROWS_TOL (the two trainings sum their float32 products in different
# orders, and Adam's first step lr*g/(|g|+eps) turns a gradient's last-bit
# difference into up to lr where |g| is near eps).
STEP_ROWS_TOL = 1e-5
# bf16 dense tensor-core peak (NVIDIA data sheet): the rate bf16 inputs allow
BF16_OPS_PER_S = 989e12
# TF32 dense tensor-core peak, half the bf16 rate: float32 work at float32
# accuracy takes three TF32 products per product (3xTF32)
TF32_OPS_PER_S = BF16_OPS_PER_S / 2
TF32_PRODUCTS_PER_FP32 = 3
# the reference's kernel tolerances (tests/test_kernels_{flash_attention,rwkv6}.py)
FLASH_TOL_F32 = 2e-5
WKV_TOL = 1e-4
# bf16 flash against the float32 result of its bf16 inputs, element by
# element: the kernel computes in float32 (within FLASH_TOL_F32 of the plain
# version) and rounds once to bf16, at most half an ulp, 2^-8 |x|
FLASH_RTOL_BF16 = 2.0 ** -8
# the wkv function's flops per step and (b, h): r.S into y (2 hd^2), w*S + k v^T
# (3 hd^2); the bonus r.((u*k) v^T) = (sum_i r_i u_i k_i) v is 5 hd
WKV_FLOPS_PER_STATE, WKV_FLOPS_PER_CHANNEL = 5, 5
# decode_step vs forward, max |diff| / max |logit| (tests/test_decode_parity.py)
DECODE_RTOL = 2e-2
# card (kernels, cuBLAS) vs host CPU (plain versions, MKL) in float32, one
# period, max |diff| / max |logit|: summation order moves ~1e-6; a masking
# or indexing fault in a kernel moves logits by O(1)
CARD_CPU_RTOL = 1e-3
LM_CONFIGS = (("gemma3-4b", 6), ("rwkv6-3b", 4))
# the flash kernels keep O, S and P in registers: a spill serialises them
NO_SPILL_SOURCES = ("flash_attention_sm90.cu", "flash_attention.cu")
LM_BATCH, LM_SEQ = 2, 4096              # train_4k's sequence length
PROMPT, NEW_TOKENS, PARITY_TOKENS = 16, 16, 32
# the four Table II baselines, each run through run(spec) at the defaults
BASELINES = ("fedavg", "fedprox", "fedproto", "fedhkd")
# with one cluster and the identity affinity the producers and rewards do
# not depend on the trained bits: card and CPU balances differ only by the
# float64 sums of equal float32 rewards
BALANCE_TOL = 1e-6
# Table II's MLP 64-128-64-C: N per client at C = 10 (synth10) and 100 (synth100)
TABLE2_WIDTHS = (17226, 23076)
# the paper cell repeated on the host CPU, and its accuracy tolerance: the
# personalised accuracy of 20 clients on 64 local test examples each, where
# a flipped BFLN label moves a client to another cluster's model
PAPER_CPU_CELL = ("synth10", 0.1, "bfln", 5)
PAPER_ACC_TOL = 0.02
# torch.profiler captures of one call, each checked by a marker kernel
CAPTURE_TRIES = 3
# a FedBuff flush's rows: AsyncSpec().buffer_size updates of N = 6570
ASYNC_SHAPE = (16, 6570)
# resume: a snapshot every RESUME_INTERVAL rounds/flushes, the crash at the
# boundary RESUME_CRASH, the child process's time limit
RESUME_INTERVAL, RESUME_CRASH, CHILD_TIMEOUT_S = 5, 10, 300
DIGEST_KEYS = ("event_log_digest", "block_hashes_digest", "balances_digest",
               "final_accuracy")
# a producer failure, a bad block, a dropped and a delayed commit, retry on
FAULT_SCHEDULE = FaultSpec(seed=19, producer_fail_rounds=(2, 7),
                           bad_block_rounds=(3, 11), drop_commit_rounds=(4, 12),
                           delay_commit_rounds=(5,), retry=True)
# the child killed by an injected SIGKILL: argv = src path, spec JSON
KILL_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.api import ExperimentSpec, run
run(ExperimentSpec.from_json(sys.argv[2]))
raise SystemExit("survived an injected SIGKILL")
"""
# each kernel: its module and the module's launch counter
KERNELS = {"fingerprint": (fp, "launches"), "cluster_agg": (ca, "launches"),
           "pearson": (pe, "launches"), "flash_attention_bf16": (fa, "launches_bf16"),
           "flash_attention_fp32": (fa, "launches"), "rwkv6": (wk, "launches")}


def reset_launches() -> None:
    for mod, counter in KERNELS.values():
        setattr(mod, counter, 0)


def read_launches() -> dict[str, int]:
    return {name: getattr(mod, counter) for name, (mod, counter) in KERNELS.items()}


def fingerprint_bound_us(m: int, n: int) -> tuple[float, str]:
    """Least time for the fingerprint of an (m, n) matrix: each input byte
    read once, each output byte written once, or its integer operations."""
    t_bytes = (m * n * 4 + m * 2 * 4) / HBM_BYTES_PER_S * 1e6
    t_ops = FP_OPS_PER_ELEMENT * m * n / ALU32_OPS_PER_S * 1e6
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_no_spills() -> None:
    """Both flash kernels keep O, S and P in registers (241 of them at
    head_dim 256 in the bf16 kernel): ptxas must compile every instance of
    each without spilling, or their tensor-core products serialise on local
    memory."""
    for source in NO_SPILL_SOURCES:
        log = _build.library_path(source).with_suffix(".log").read_text()
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        if not spills or any(spills):
            raise AssertionError(f"{source}: ptxas spill stores {spills}")
        print(f"{source}: {len(spills)} instances, no spills", flush=True)


def median_us(fn, arg, reps: int, flush: torch.Tensor,
              clean_l2: bool = False) -> float:
    """Median device time over ``reps`` CUDA-event-timed calls, each after
    the L2 cache was overwritten (a 128 MiB write; the H100's L2 holds
    50 MB).  A ~1 ms device-side sleep before each start event lets the host
    queue the whole call first, so the time is the device's alone and not
    the host's launch overhead.  The write leaves L2 full of dirty lines, so
    a call that reads B bytes from memory may also write up to B bytes back;
    ``clean_l2`` overwrites the cache by reading the 128 MiB instead."""
    for _ in range(3):
        fn(arg)
    times = []
    for _ in range(reps):
        if clean_l2:
            flush.view(torch.float32).sum()
        else:
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


def bound_us(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for work that must move ``n_bytes`` and do ``n_ops``
    32-bit operations: the larger of the two at the card's peak rates."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e6
    t_ops = n_ops / ALU32_OPS_PER_S * 1e6
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def device_kernels(fn) -> list[str]:
    """The device activities (kernels, copies, fills) of one call of
    ``fn``, by name, one entry each (torch.profiler).  Each capture also
    records one marker kernel launched just before the call
    (``torch.cuda._sleep``, PyTorch's ``spin_kernel``); a capture without
    it recorded nothing of the device (seen once on the card: a capture of
    no activity at all) and is taken again, at most CAPTURE_TRIES times.
    The marker is not among the names returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(CAPTURE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn(None)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA for _ in range(e.count)]
        marker = [n for n in names if "spin_kernel" in n]
        if marker:
            names.remove(marker[0])
            return names
    raise AssertionError(f"torch.profiler recorded no marker kernel in "
                         f"{CAPTURE_TRIES} captures: {names}")


def one_launch(fn, what: str) -> str:
    """Raises unless one call of ``fn`` makes exactly one device launch;
    returns that kernel's name."""
    names = device_kernels(fn)
    if len(names) != 1:
        raise AssertionError(f"{what}: one call made {len(names)} device "
                             f"launches, expected 1: {names}")
    return names[0]


def launch_floors_us(flush: torch.Tensor) -> dict:
    """The device times, under median_us, of the two kernels of
    csrc/launch_floor.cu: an empty one (the least any one launch can show)
    and one that loads 16 bytes and stores them elsewhere (a launch plus one
    memory round trip)."""
    lib = _build.load("launch_floor.cu")
    lib.launch_floor_launch.argtypes = [ctypes.c_void_p]
    lib.round_trip_launch.argtypes = [ctypes.c_void_p] * 3
    src = torch.zeros(4, device=flush.device)
    dst = torch.empty(4, device=flush.device)

    def empty(_):
        if lib.launch_floor_launch(torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the empty kernel's launch failed")

    def round_trip(_):
        if lib.round_trip_launch(src.data_ptr(), dst.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the round-trip kernel's launch failed")
    one_launch(empty, "the empty kernel")
    one_launch(round_trip, "the round-trip kernel")
    return {"empty_us": median_us(empty, None, 200, flush),
            "round_trip_us": median_us(round_trip, None, 200, flush)}


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
    # every cluster size, on rows on and off the 16-byte grid
    buf = random_bits(rng, 1, 100 * 6570 + 1, dev)[0]
    for c in fp.CLUSTER_SIZES:
        for off in (0, 1):
            bits = buf[off:off + 100 * 6570].view(100, 6570)
            want = fp.fingerprint_plain(bits)
            if not torch.equal(fp.fingerprint_cuda(bits, cluster=c), want):
                raise AssertionError(f"fingerprint kernel at cluster size {c} "
                                     f"(offset {off}) != plain version")

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    shapes = []
    # every shape a path launches it at: the start-up digest (1, .), the
    # serving bank (5, .), a cohort (100, .), and a population (1000, .)
    for m, n in [(1, 6570)] + timed:
        bits = random_bits(rng, m, n, dev)
        bound, bound_by = fingerprint_bound_us(m, n)
        kernel = one_launch(lambda _: fp.fingerprint_cuda(bits),
                            f"fingerprint_cuda at ({m}, {n})")
        shapes.append({
            "m": m, "n": n, "bit_exact": True, "cluster": fp.cluster_size(m, n),
            "device_kernels_per_call": 1, "device_kernel": kernel,
            "kernel_us": median_us(fp.fingerprint_cuda, bits, 200, flush),
            "kernel_us_clean_l2": median_us(fp.fingerprint_cuda, bits, 200, flush,
                                            clean_l2=True),
            "kernel_us_by_cluster": {
                c: median_us(lambda b: fp.fingerprint_cuda(b, cluster=c), bits,
                             100, flush) for c in fp.CLUSTER_SIZES},
            "plain_us": median_us(fp.fingerprint_plain, bits, 30, flush),
            "bound_us": bound, "bound_by": bound_by})
    return shapes, max(errs)


def agg_case(rng, m: int, n: int, c: int, dev, kind: str = "random"):
    """(rows, labels, weights) on the card for one cluster-aggregation check."""
    rows = rng.standard_normal((m, n)).astype(np.float32)
    labels = rng.integers(0, c, size=m)
    w = (rng.random(m) < 0.8).astype(np.float32)
    if kind == "empty cluster":
        labels[labels == c - 1] = 0
    elif kind == "all-zero weights":
        w[:] = 0.0
    elif kind == "NaN at zero weight":
        w[::3] = 0.0
        rows[::3] = np.nan
    elif kind == "a row of -0.0":
        labels[:] = np.arange(m) % c
        w[:] = 1.0
        w[c::c] = 0.0                  # row 0 is alone at weight 1 in cluster 0
        rows[0] = -0.0
    elif kind == "a bad label":
        labels[3] = -1                 # weighs in no cluster; its row is NaN
    return tuple(torch.from_numpy(a).to(dev) for a in (rows, labels, w))


def check_agg(rows, labels, w, c: int, what: str) -> float:
    """Kernel vs plain version, bit for bit, in the rows' dtype; returns the
    largest difference (0.0)."""
    wo, denom = ca.cluster_weights(labels, c, w)
    got = ca.cluster_agg_cuda(rows, labels, wo, denom)
    want = ca.cluster_agg_plain(rows, labels, wo, denom)
    bits = torch.int32 if rows.dtype == torch.float32 else torch.int16
    if got.dtype != rows.dtype or not torch.equal(got.view(bits), want.view(bits)):
        bad = int((got.view(bits) != want.view(bits)).sum())
        raise AssertionError(f"cluster_agg kernel != plain version on {what} "
                             f"{rows.dtype}: {bad} elements differ")
    return float((got.float() - want.float()).nan_to_num().abs().max())


def cluster_agg_phase(dev) -> tuple[dict, dict]:
    rng = np.random.default_rng(SEED + 2)
    m, n, c = 100, 6570, 5                   # the train path's cohort rows
    dtypes = (torch.float32, torch.bfloat16)
    errs = {dtype: [] for dtype in dtypes}
    # a whole population as the cohort, more than one 256-row chunk, odd N,
    # the most rows the kernel takes
    for mm, nn, cc in [(m, n, c), (1, 64, 3), (3, 7, 2), (37, 131, 4),
                       (1000, n, c), (3000, 131, c), (m, n + 1, c),
                       (ca.MAX_ROWS, 40, c)]:
        rows, labels, w = agg_case(rng, mm, nn, cc, dev)
        for dtype in dtypes:
            errs[dtype].append(check_agg(rows.to(dtype), labels, w, cc,
                                         f"({mm}, {nn}) C={cc}"))
    for kind in ("empty cluster", "all-zero weights", "NaN at zero weight",
                 "a row of -0.0", "a bad label"):
        rows, labels, w = agg_case(rng, 40, 131, 4, dev, kind)
        for dtype in dtypes:
            errs[dtype].append(check_agg(rows.to(dtype), labels, w, 4, kind))
            if kind == "a row of -0.0":
                mean = ca.cluster_mean_rows(rows.to(dtype), labels, 4, w)[0]
                if torch.signbit(mean).any():
                    raise AssertionError("a cluster of -0.0 rows must mean +0.0 "
                                         "(the padded adds are done)")

    rows, labels, w = agg_case(rng, m, n, c, dev)
    wo, denom = ca.cluster_weights(labels, c, w)
    # the library yardstick: the same function as one mixing-matrix product
    # (the Pallas kernel's form), mix precomputed; timed here only
    onehot = (labels[:, None] == torch.arange(c, device=dev)[None, :]).float()
    mix = (onehot / denom[None, :]) @ wo.T
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    # only positive-weight rows are read; every row is written
    n_live = int(w.gt(0).sum())
    n_bytes = (n_live * n + m * n + m * c + c) * 4 + m * 8     # int64 labels
    n_ops = 2 * n_live * n + c * n                # weighted adds + divides
    bound, bound_by = bound_us(n_bytes, n_ops)
    row = {"m": m, "n": n, "clusters": c, "dtype": "float32", "bit_exact": True,
           "max_abs_err": max(errs[torch.float32]),
           "kernel_us": median_us(lambda _: ca.cluster_agg_cuda(rows, labels, wo, denom),
                                  None, 200, flush),
           "plain_us": median_us(lambda _: ca.cluster_agg_plain(rows, labels, wo, denom),
                                 None, 30, flush),
           "library_us": median_us(lambda _: torch.matmul(mix, rows), None, 200, flush),
           "bound_us": bound, "bound_by": bound_by}
    # bf16 rows: half the row bytes; no one PyTorch call sums them in float32
    # and rounds once
    rows16 = rows.to(torch.bfloat16)
    bound16, bound16_by = bound_us(n_bytes - (n_live * n + m * n) * 2, n_ops)
    row16 = {
        "m": m, "n": n, "clusters": c, "dtype": "bfloat16", "bit_exact": True,
        "max_abs_err": max(errs[torch.bfloat16]),
        "kernel_us": median_us(lambda _: ca.cluster_agg_cuda(rows16, labels, wo, denom),
                               None, 200, flush),
        "plain_us": median_us(lambda _: ca.cluster_agg_plain(rows16, labels, wo, denom),
                              None, 30, flush),
        "library_us": None, "bound_us": bound16, "bound_by": bound16_by}
    return row, row16


def check_pearson(x: torch.Tensor, what: str) -> float:
    err = float((pe.pearson_cuda(x) - pe.pearson_plain(x)).abs().max())
    if not err <= PEARSON_TOL:
        raise AssertionError(f"pearson kernel vs plain version on {what}: "
                             f"max abs error {err} > {PEARSON_TOL}")
    return err


def pearson_phase(dev) -> tuple[dict, float]:
    rng = np.random.default_rng(SEED + 3)

    def protos(m, d):
        return torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(dev)
    m, d = 100, 32                           # the train path's prototypes
    errs = [check_pearson(protos(mm, dd), f"({mm}, {dd})")
            for mm, dd in [(m, d), (7, 5), (1, 3), (300, 600)]]
    x = protos(m, d)
    x[3] = 0.5
    errs.append(check_pearson(x, "a constant row"))
    if pe.pearson_cuda(x)[3].any():
        raise AssertionError("a constant row must correlate 0 with every row")
    # m off the tile, D off 4; one row; many tiles; a large mean (two-pass)
    for what, x in [("(129, 33)", protos(129, 33)), ("(1, 1)", protos(1, 1)),
                    ("(2000, 32)", protos(2000, 32)),
                    ("(300, 600) + 1e3", protos(300, 600) + 1e3)]:
        errs.append(check_pearson(x, what))
        got = pe.pearson_cuda(x)
        if not torch.equal(got, got.T):
            raise AssertionError(f"pearson on {what} is not exactly symmetric")

    x = protos(m, d)
    wide = protos(300, 600)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    bound, bound_by = bound_us((m * d + m * m) * 4, 2 * m * m * d + 3 * m * d)
    wide_bound, wide_by = bound_us((300 * 600 + 300 * 300) * 4,
                                   2 * 300 * 300 * 600 + 3 * 300 * 600)
    row = {"m": m, "d": d, "tile": pe.TILE,
           "device_kernels_per_call": 1,
           "device_kernel": one_launch(lambda _: pe.pearson_cuda(x),
                                       "pearson_cuda at (100, 32)"),
           "kernel_us": median_us(pe.pearson_cuda, x, 200, flush),
           "plain_us": median_us(pe.pearson_plain, x, 100, flush),
           "library_us": median_us(torch.corrcoef, x, 200, flush),
           "bound_us": bound, "bound_by": bound_by,
           "wide": {"m": 300, "d": 600, "bound_us": wide_bound, "bound_by": wide_by,
                    "kernel_us": median_us(pe.pearson_cuda, wide, 100, flush),
                    "plain_us": median_us(pe.pearson_plain, wide, 30, flush),
                    "library_us": median_us(torch.corrcoef, wide, 100, flush)}}
    return row, max(errs)


def table2_kernel_phase(dev) -> dict:
    """The three kernels of the baselines' and the paper's paths at the
    shapes only those paths give them, against their plain versions, each
    timed beside its bound: the flat strategies' masked mean (cluster_agg at
    C = 1, every label 0, zero-weight rows holding NaN) over the engine's
    (100, 6570) cohort and over Table II's (20, N) clients, N = 17226 (10
    classes) and 23076 (100 classes), rows that alternate on and off the
    16-byte grid; BFLN's cluster means there at C = 2 / 5 / 7; the
    fingerprint of those (20, N) rows at every forced cluster size, on and
    off the grid; and the Pearson matrix of BFLN's (20, 64) prototypes."""
    rng = np.random.default_rng(SEED + 8)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    agg_rows = []
    for m, n, c, masked in [(100, 6570, 1, True)] + [
            (20, n, c, c == 1) for n in TABLE2_WIDTHS for c in (1, 2, 5, 7)]:
        rows, labels, w = agg_case(rng, m, n, c, dev)
        if c == 1:
            labels.zero_()
        if masked:
            w[::3] = 0.0
            w[0] = 1.0
            rows[w == 0] = float("nan")
        else:
            w.fill_(1.0)                  # run_round: every client arrives
        err = check_agg(rows, labels, w, c, f"({m}, {n}) C={c}")
        wo, denom = ca.cluster_weights(labels, c, w)
        onehot = (labels[:, None] == torch.arange(c, device=dev)[None, :]).float()
        mix = (onehot / denom[None, :]) @ wo.T
        n_live = int(w.gt(0).sum())
        bound, bound_by = bound_us((n_live * n + m * n + m * c + c) * 4 + m * 8,
                                   2 * n_live * n + c * n)
        agg_rows.append({
            "m": m, "n": n, "clusters": c, "arrival_mask": masked,
            "nan_at_zero_weight": masked, "bit_exact": True, "max_abs_err": err,
            "kernel_us": median_us(lambda _: ca.cluster_agg_cuda(rows, labels, wo, denom),
                                   None, 200, flush),
            "plain_us": median_us(lambda _: ca.cluster_agg_plain(rows, labels, wo, denom),
                                  None, 30, flush),
            "library_us": median_us(lambda _: torch.matmul(mix, rows), None, 200, flush),
            "bound_us": bound, "bound_by": bound_by})

    fp_rows = []
    for n in TABLE2_WIDTHS:
        buf = random_bits(rng, 1, 20 * n + 1, dev)[0]
        for c in fp.CLUSTER_SIZES:
            for off in (0, 1):
                bits = buf[off:off + 20 * n].view(20, n)
                if not torch.equal(fp.fingerprint_cuda(bits, cluster=c),
                                   fp.fingerprint_plain(bits)):
                    raise AssertionError(f"fingerprint kernel at (20, {n}), cluster "
                                         f"size {c}, offset {off} != plain version")
        bits = random_bits(rng, 20, n, dev)
        err = check_exact(bits, f"(20, {n})")
        bound, bound_by = fingerprint_bound_us(20, n)
        fp_rows.append({
            "m": 20, "n": n, "bit_exact": True, "max_abs_err": err,
            "cluster": fp.cluster_size(20, n), "forced_clusters_checked": list(fp.CLUSTER_SIZES),
            "kernel_us": median_us(fp.fingerprint_cuda, bits, 200, flush),
            "plain_us": median_us(fp.fingerprint_plain, bits, 30, flush),
            "library_us": None, "bound_us": bound, "bound_by": bound_by})

    m, d = 20, 64
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(dev)
    err = check_pearson(x, f"({m}, {d})")
    got = pe.pearson_cuda(x)
    if not torch.equal(got, got.T):
        raise AssertionError(f"pearson on ({m}, {d}) is not exactly symmetric")
    bound, bound_by = bound_us((m * d + m * m) * 4, 2 * m * m * d + 3 * m * d)
    pe_row = {"m": m, "d": d, "max_abs_err": err, "tolerance": PEARSON_TOL,
              "exactly_symmetric": True,
              "kernel_us": median_us(pe.pearson_cuda, x, 200, flush),
              "plain_us": median_us(pe.pearson_plain, x, 100, flush),
              "library_us": median_us(torch.corrcoef, x, 200, flush),
              "bound_us": bound, "bound_by": bound_by}
    return {"cluster_agg": agg_rows, "fingerprint": fp_rows, "pearson": [pe_row]}


def async_kernel_phase(dev) -> dict:
    """The two kernels of the async path at a flush's shape ASYNC_SHAPE
    against their plain versions, each timed beside its bound: the
    fingerprint of the trained rows at every forced cluster size, on and
    off the 16-byte grid; the merge (cluster_agg at C = 1, every label 0)
    over staleness weights gated by verification, zero-weight rows holding
    NaN, through `weighted_delta_mean` (row 0 of the kernel's output), and
    with every weight 0 (an exact zero delta)."""
    rng = np.random.default_rng(SEED + 9)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    m, n = ASYNC_SHAPE
    buf = random_bits(rng, 1, m * n + 1, dev)[0]
    for c in fp.CLUSTER_SIZES:
        for off in (0, 1):
            bits = buf[off:off + m * n].view(m, n)
            if not torch.equal(fp.fingerprint_cuda(bits, cluster=c),
                               fp.fingerprint_plain(bits)):
                raise AssertionError(f"fingerprint kernel at ({m}, {n}), cluster "
                                     f"size {c}, offset {off} != plain version")
    bits = random_bits(rng, m, n, dev)
    err = check_exact(bits, f"({m}, {n})")
    bound, bound_by = fingerprint_bound_us(m, n)
    fp_row = {"m": m, "n": n, "bit_exact": True, "max_abs_err": err,
              "cluster": fp.cluster_size(m, n),
              "forced_clusters_checked": list(fp.CLUSTER_SIZES),
              "kernel_us": median_us(fp.fingerprint_cuda, bits, 200, flush),
              "plain_us": median_us(fp.fingerprint_plain, bits, 30, flush),
              "library_us": None, "bound_us": bound, "bound_by": bound_by}

    rows = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(dev)
    w = staleness_weight(rng.integers(0, 6, m)) * (rng.random(m) < 0.75)
    w[0] = 1.0
    rows[torch.from_numpy(w == 0).to(dev)] = float("nan")
    w = torch.from_numpy(w.astype(np.float32)).to(dev)
    labels = torch.zeros(m, dtype=torch.long, device=dev)
    err = check_agg(rows, labels, w, 1, f"({m}, {n}) C=1, NaN at zero weight")
    wo, denom = ca.cluster_weights(labels, 1, w)
    before = ca.launches
    merged = weighted_delta_mean(rows, w)
    want = ca.cluster_agg_plain(rows, labels, wo, denom)[0]
    if ca.launches != before + 1 or not torch.equal(merged.view(torch.int32),
                                                    want.view(torch.int32)) \
            or not torch.isfinite(merged).all():
        raise AssertionError("weighted_delta_mean on the card is not one launch "
                             "giving the plain version's row 0")
    if weighted_delta_mean(rows, torch.zeros_like(w)).view(torch.int32).any():
        raise AssertionError("a flush of all-zero weights must merge to +0.0")
    onehot = torch.ones((m, 1), device=dev)
    mix = (onehot / denom[None, :]) @ wo.T
    n_live = int(w.gt(0).sum())
    bound, bound_by = bound_us((n_live * n + m * n + m + 1) * 4 + m * 8,
                               2 * n_live * n + n)
    agg_row = {"m": m, "n": n, "clusters": 1, "live_rows": n_live,
               "nan_at_zero_weight": True, "bit_exact": True, "max_abs_err": err,
               "kernel_us": median_us(lambda _: ca.cluster_agg_cuda(rows, labels, wo, denom),
                                      None, 200, flush),
               "plain_us": median_us(lambda _: ca.cluster_agg_plain(rows, labels, wo, denom),
                                     None, 30, flush),
               "library_us": median_us(lambda _: torch.matmul(mix, rows), None, 200, flush),
               "bound_us": bound, "bound_by": bound_by}
    agg_row["kernel_over_library"] = agg_row["kernel_us"] / agg_row["library_us"]
    return {"fingerprint": fp_row, "cluster_agg": agg_row}


class RoundTimer:
    """A recorder for the training path's ``obs`` hook: the wall time of
    every span by name, the device drained at both ends of each span so a
    span's time is its own work."""

    enabled = False

    def __init__(self):
        self.spans: dict[str, list[float]] = {}

    def span(self, name: str, **attrs):
        return _DrainedSpan(self.spans.setdefault(name, []))

    def inc(self, *args, **kwargs) -> None:
        pass

    event = observe = set_gauge = inc


class _DrainedSpan:
    def __init__(self, sink):
        self.sink = sink

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        torch.cuda.synchronize()
        self.sink.append((time.perf_counter() - self.t0) * 1e3)
        return False


def step_parity(sim, dev) -> dict:
    """One ``RoundEngine.sync_step`` on the card and the same step on the
    CPU, from identical arena rows (five distinct models plus small noise,
    so the clusters are well separated) and the population's own cohort
    data: equal labels, the Pearson matrix within PEARSON_TOL and the new
    rows within STEP_ROWS_TOL.  Raises on any difference beyond those."""
    c, cfg = sim.cfg.n_clusters, sim.cfg
    layout, n = sim.arena.layout, sim.pop.n_clients
    gen = torch.Generator().manual_seed(SEED + 5)
    centers = layout.flatten(clf.init_stacked(sim.mcfg, gen, c, same_init=False,
                                              device="cpu"))
    rng = np.random.default_rng(SEED + 5)
    noise = torch.from_numpy(rng.standard_normal((n, layout.n_params))
                             .astype(np.float32))
    rows = centers[torch.arange(n) % c] + 0.002 * noise
    k = max(1, int(round(cfg.sample_frac * n)))
    cohort = np.sort(rng.choice(n, size=k, replace=False))
    arrived = (rng.random(k) < 0.8).astype(np.float32)
    cx, cy = sim.pop.cohort_data(cohort)

    outs, datas = [], []
    for d in (dev, torch.device("cpu")):
        strategy = build_strategy(cfg.strategy, sim.bundle,
                                  probe=sim.pop.probe.to(d),
                                  n_clusters=c, **cfg.strategy_params)
        eng = RoundEngine(layout, strategy=strategy, opt=sim.opt, n_clusters=c,
                          local_epochs=cfg.local_epochs,
                          stacked_apply_fn=sim.bundle.apply_fn)
        arena = ParamArena(layout, rows.to(d, copy=True))
        outs.append(eng.sync_step(arena, torch.as_tensor(cohort, device=d),
                                  cx.to(d), cy.to(d), torch.from_numpy(arrived).to(d)))
        datas.append(arena.data.cpu())
    card, cpu = outs
    labels = card.labels.cpu()
    # equal on both, and the five models' clusters found exactly
    found = set(zip((cohort % c).tolist(), labels.tolist()))
    if not torch.equal(labels, cpu.labels) or len(found) != c \
            or len(set(labels.tolist())) != c:
        raise AssertionError(f"sync_step labels differ on the card and the CPU: "
                             f"{labels.tolist()} vs {cpu.labels.tolist()}")
    corr_err = float((card.corr.cpu() - cpu.corr).abs().max())
    rows_diff = (card.new_rows.cpu() - cpu.new_rows).abs()
    arena_err = float((datas[0] - datas[1]).abs().max())
    loss_err = abs(float(card.mean_loss) - float(cpu.mean_loss))
    if not corr_err <= PEARSON_TOL:
        raise AssertionError(f"sync_step Pearson card vs CPU {corr_err} > {PEARSON_TOL}")
    if not (float(rows_diff.max()) <= STEP_ROWS_TOL and arena_err <= STEP_ROWS_TOL):
        raise AssertionError(f"sync_step new rows card vs CPU {float(rows_diff.max())} "
                             f"(arena {arena_err}) > {STEP_ROWS_TOL}")
    if not loss_err <= 1e-5 * abs(float(cpu.mean_loss)):
        raise AssertionError(f"sync_step loss card {float(card.mean_loss)} vs CPU "
                             f"{float(cpu.mean_loss)}")
    return {"cohort": k, "arrived": int(arrived.sum()), "labels_equal": True,
            "corr_max_abs": corr_err, "corr_tol": PEARSON_TOL,
            "new_rows_max_abs": float(rows_diff.max()),
            "new_rows_frac_above_1e-7": float((rows_diff > 1e-7).float().mean()),
            "arena_max_abs": arena_err, "rows_tol": STEP_ROWS_TOL,
            "loss_abs_diff": loss_err,
            "residues_equal": int((card.residues.cpu() == cpu.residues).all(dim=1).sum())}


def train_phase(dev) -> dict:
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: training must run in fp32")
    spec = ExperimentSpec()
    timer = RoundTimer()
    reset_launches()
    t0 = time.perf_counter()
    result = run(spec, device=dev, obs=timer)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()

    m, sim = result.manifest, result.sim
    nonempty = sum(bool(r.arrived.any()) for r in result.report.history)
    if sim.arena.data.shape != (1000, 6570) or sim.arena.data.device.type != "cuda":
        raise AssertionError(f"arena {tuple(sim.arena.data.shape)} on "
                             f"{sim.arena.data.device}, expected (1000, 6570) on the card")
    if not (m["chain_valid"] and m["ledger_conserved"]):
        raise AssertionError(f"chain_valid={m['chain_valid']} "
                             f"ledger_conserved={m['ledger_conserved']}")
    if m["rounds_run"] != spec.train.rounds or m["n_blocks"] != 1 + nonempty:
        raise AssertionError(f"{m['rounds_run']} rounds, {m['n_blocks']} blocks "
                             f"for {nonempty} non-empty rounds")
    # one launch per non-empty round each; the fingerprint also digests the
    # freeriders' all-zero claim once at start-up
    want = {"fingerprint": nonempty + 1, "cluster_agg": nonempty,
            "pearson": nonempty, "flash_attention_bf16": 0,
            "flash_attention_fp32": 0, "rwkv6": 0}
    if launches != want:
        raise AssertionError(f"train-path launches {launches}, expected {want}")
    acc = m["final_accuracy"]
    if not 0.0 < acc <= 1.0:
        raise AssertionError(f"final accuracy {acc}")
    # the tight check of training on the card: one step against the CPU's
    parity = step_parity(sim, dev)

    t1 = time.perf_counter()
    cpu = run(spec, device="cpu").manifest
    cpu_wall_s = time.perf_counter() - t1
    if cpu["event_log_digest"] != m["event_log_digest"]:
        raise AssertionError("card and CPU runs logged different events")
    if not (cpu["chain_valid"] and cpu["ledger_conserved"]):
        raise AssertionError("the CPU run's chain or ledger does not hold")
    if abs(cpu["final_accuracy"] - acc) > ACC_TOL:
        raise AssertionError(f"final accuracy card {acc} vs CPU "
                             f"{cpu['final_accuracy']} > {ACC_TOL} apart")

    # the trained run plugs into the serving tier unchanged
    fe = serve(result)
    verify_bank(fe.engine.bank, sim.trainer.chain)
    rng = np.random.default_rng(SEED + 4)
    for i in range(12):
        fe.submit(i % spec.train.n_clusters,
                  rng.standard_normal(sim.mcfg.in_dim).astype(np.float32))
    fe.drain()
    done = fe.take_completed()
    if len(done) != 12 or any(d.status != "ok" or not np.isfinite(d.logits).all()
                              for d in done):
        raise AssertionError("serve(result) did not answer every request")

    rounds_ms = timer.spans["round.total"]
    return {"launches": launches, "rounds": m["rounds_run"],
            "nonempty_rounds": nonempty, "n_clients": m["n_clients"],
            "cohort": max(1, round(spec.train.sample_frac * m["n_clients"])),
            "n_params": sim.arena.n_params, "n_blocks": m["n_blocks"],
            "chain_valid": m["chain_valid"],
            "ledger_conserved": m["ledger_conserved"],
            "round_ms_p50": float(np.median(rounds_ms)),
            "round_ms_max": float(np.max(rounds_ms)),
            "phase_ms_p50": {k: float(np.median(v)) for k, v in timer.spans.items()},
            "phase_ms_total": {k: float(np.sum(v)) for k, v in timer.spans.items()},
            "final_accuracy_card": acc, "final_accuracy_cpu": cpu["final_accuracy"],
            "acc_tol": ACC_TOL,
            "event_log_digest_match": True,
            "event_log_digest": m["event_log_digest"],
            "block_hashes_equal_cpu": cpu["block_hashes_digest"] == m["block_hashes_digest"],
            "run_wall_s": wall_s, "cpu_run_wall_s": cpu_wall_s,
            "step_parity": parity, "served_requests": len(done)}


def strategy_run(name: str, dev) -> dict:
    """One baseline through ``run(ExperimentSpec(train=TrainSpec(strategy=
    name)))`` at the defaults on the card, its launches counted, then the
    same spec on the host CPU at the same depth."""
    spec = ExperimentSpec(train=TrainSpec(strategy=name))
    timer = RoundTimer()
    reset_launches()
    t0 = time.perf_counter()
    result = run(spec, device=dev, obs=timer)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    m, sim = result.manifest, result.sim
    nonempty = sum(bool(r.arrived.any()) for r in result.report.history)
    if sim.arena.data.shape != (1000, 6570) or sim.arena.data.device.type != "cuda":
        raise AssertionError(f"{name}: arena {tuple(sim.arena.data.shape)} on "
                             f"{sim.arena.data.device}")
    if not (m["chain_valid"] and m["ledger_conserved"]):
        raise AssertionError(f"{name}: chain_valid={m['chain_valid']} "
                             f"ledger_conserved={m['ledger_conserved']}")
    if m["rounds_run"] != spec.train.rounds or m["n_blocks"] != 1 + nonempty:
        raise AssertionError(f"{name}: {m['rounds_run']} rounds, {m['n_blocks']} "
                             f"blocks for {nonempty} non-empty rounds")
    # the fingerprint once a round and once for the freeriders' claim; the
    # masked mean once a round, except FedProto's models, never averaged
    want = {k: 0 for k in KERNELS}
    want.update(fingerprint=nonempty + 1,
                cluster_agg=0 if name == "fedproto" else nonempty)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    acc = m["final_accuracy"]
    if not 0.0 < acc <= 1.0:
        raise AssertionError(f"{name}: final accuracy {acc}")

    # the card against the host CPU: equal event logs, and with one cluster
    # and the identity affinity the producers and rewards do not depend on
    # the trained bits (CACC runs on the host for both), so equal balances
    t1 = time.perf_counter()
    cpu_res = run(spec, device="cpu")
    cpu_wall_s = time.perf_counter() - t1
    cpu = cpu_res.manifest
    if cpu["event_log_digest"] != m["event_log_digest"]:
        raise AssertionError(f"{name}: card and CPU runs logged different events")
    if not (cpu["chain_valid"] and cpu["ledger_conserved"]):
        raise AssertionError(f"{name}: the CPU run's chain or ledger does not hold")
    bal_err = float(np.abs(result.report.balances - cpu_res.report.balances).max())
    if not bal_err <= BALANCE_TOL:
        raise AssertionError(f"{name}: balances card vs CPU differ by {bal_err}")
    if abs(cpu["final_accuracy"] - acc) > ACC_TOL:
        raise AssertionError(f"{name}: final accuracy card {acc} "
                             f"vs CPU {cpu['final_accuracy']} > {ACC_TOL} apart")
    rounds_ms = timer.spans["round.total"]
    return {"launches": launches, "rounds": m["rounds_run"],
            "nonempty_rounds": nonempty, "n_params": sim.arena.n_params,
            "n_blocks": m["n_blocks"], "chain_valid": m["chain_valid"],
            "ledger_conserved": m["ledger_conserved"],
            "round_ms_p50": float(np.median(rounds_ms)),
            "round_ms_max": float(np.max(rounds_ms)),
            "phase_ms_p50": {k: float(np.median(v)) for k, v in timer.spans.items()},
            "final_accuracy_card": acc,
            "final_accuracy_cpu": cpu["final_accuracy"], "acc_tol": ACC_TOL,
            "event_log_digest_match": True, "balances_max_abs_diff": bal_err,
            "balance_tol": BALANCE_TOL, "run_wall_s": wall_s,
            "cpu_run_wall_s": cpu_wall_s}


def strategies_phase(dev) -> dict:
    return {name: strategy_run(name, dev) for name in BASELINES}


def digests(manifest: dict) -> dict:
    return {k: manifest[k] for k in DIGEST_KEYS}


def card_and_cpu(spec: ExperimentSpec, dev, what: str,
                 gate_balances: bool = True) -> dict:
    """``spec`` through ``run`` on the card, its launches counted and its
    spans timed, then on the host CPU: equal event logs, the chain valid
    and the ledger conserved on both, final accuracy within ACC_TOL, and
    (``gate_balances``) balances within BALANCE_TOL.  Returns both results,
    the launches and the timer."""
    timer = RoundTimer()
    reset_launches()
    t0 = time.perf_counter()
    card = run(spec, device=dev, obs=timer)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    t1 = time.perf_counter()
    cpu = run(spec, device="cpu")
    cpu_wall_s = time.perf_counter() - t1
    m, c = card.manifest, cpu.manifest
    if card.sim.arena.data.device.type != "cuda":
        raise AssertionError(f"{what}: the run's arena is not on the card")
    for name, man in (("card", m), ("CPU", c)):
        if not (man["chain_valid"] and man["ledger_conserved"]):
            raise AssertionError(f"{what}: the {name} run's chain or ledger does "
                                 "not hold")
    if m["event_log_digest"] != c["event_log_digest"]:
        raise AssertionError(f"{what}: card and CPU runs logged different events")
    bal_err = float(np.abs(card.report.balances - cpu.report.balances).max())
    if gate_balances and not bal_err <= BALANCE_TOL:
        raise AssertionError(f"{what}: balances card vs CPU differ by {bal_err}")
    if abs(m["final_accuracy"] - c["final_accuracy"]) > ACC_TOL:
        raise AssertionError(f"{what}: final accuracy card {m['final_accuracy']} vs "
                             f"CPU {c['final_accuracy']} > {ACC_TOL} apart")
    return {"card": card, "cpu": cpu, "launches": launches, "timer": timer,
            "summary": {"event_log_digest_match": True,
                        "event_log_digest": m["event_log_digest"],
                        "balances_max_abs_diff": bal_err,
                        "balance_tol": BALANCE_TOL if gate_balances else None,
                        "chain_valid": True, "ledger_conserved": True,
                        "n_blocks": m["n_blocks"], "rounds_run": m["rounds_run"],
                        "final_accuracy_card": m["final_accuracy"],
                        "final_accuracy_cpu": c["final_accuracy"], "acc_tol": ACC_TOL,
                        "block_hashes_equal_cpu":
                            m["block_hashes_digest"] == c["block_hashes_digest"],
                        "run_wall_s": wall_s, "cpu_run_wall_s": cpu_wall_s}}


def async_phase(dev) -> dict:
    """FedBuff at the spec defaults (n = 1000, N = 6570, buffer 16,
    concurrency 64, alpha 0.5, server lr 1.0, 20 flushes, eval every 5) on
    the card and the CPU (`card_and_cpu`), with the flush's stage walls.
    Each flush launches the fingerprint once (async_step) and cluster_agg
    once (the merge); the fingerprint once more at start-up for the
    freeriders' claim; Pearson never (single-cluster CACC)."""
    spec = ExperimentSpec(train=TrainSpec(mode="async"))
    out = card_and_cpu(spec, dev, "async")
    card, timer, launches = out["card"], out["timer"], out["launches"]
    flushes = card.manifest["rounds_run"]
    if flushes != spec.train.rounds or card.manifest["n_blocks"] != 1 + flushes:
        raise AssertionError(f"async: {flushes} flushes, "
                             f"{card.manifest['n_blocks']} blocks")
    want = {k: 0 for k in KERNELS}
    want.update(fingerprint=flushes + 1, cluster_agg=flushes)
    if launches != want:
        raise AssertionError(f"async-path launches {launches}, expected {want}")
    flush_ms = timer.spans["flush.total"]
    hist = card.report.history
    return {"launches": launches, "launches_expected": want, "flushes": flushes,
            "n_clients": card.manifest["n_clients"],
            "buffer_size": spec.async_.buffer_size,
            "concurrency": spec.async_.concurrency,
            "n_params": card.sim.arena.n_params,
            "flush_ms_p50": float(np.median(flush_ms)),
            "flush_ms_p99": float(np.percentile(flush_ms, 99)),
            "flush_ms_max": float(np.max(flush_ms)),
            "phase_ms_p50": {k: float(np.median(v)) for k, v in timer.spans.items()},
            "phase_ms_total": {k: float(np.sum(v)) for k, v in timer.spans.items()},
            "staleness_mean": float(np.mean([r.staleness_mean for r in hist])),
            "events": len(card.report.event_log), **out["summary"]}


def faults_phase(dev) -> dict:
    """FAULT_SCHEDULE (a producer failure, a bad block, a dropped and a
    delayed commit, retry on) at the defaults in a BFLN sync run, a BFLN
    async run and a FedAvg sync run, each on the card and the CPU
    (`card_and_cpu`): equal event logs, quarantined rounds, late commits
    and verified fractions in every round.  Balances must be equal where
    they do not depend on the trained bits — async (single-cluster CACC)
    and FedAvg (one cluster, the identity affinity).  BFLN's sync producers
    and rewards follow its spectral labels, which the card's and the CPU's
    Pearson matrices (equal to 1e-5, not in every bit) may split
    differently, so there its balances and the rounds whose producers
    differ are reported, not gated."""
    out, launches = {}, {k: 0 for k in KERNELS}
    for name, strategy, mode in (("sync", "bfln", "sync"), ("async", "bfln", "async"),
                                 ("sync_fedavg", "fedavg", "sync")):
        spec = ExperimentSpec(train=TrainSpec(strategy=strategy, mode=mode),
                              faults=FAULT_SCHEDULE)
        res = card_and_cpu(spec, dev, f"faults/{name}",
                           gate_balances=name != "sync")
        chains = [r.sim.trainer.chain for r in (res["card"], res["cpu"])]
        quarantined = [[b.round_idx for b in c.quarantined] for c in chains]
        late = [[(b.round_idx, tx.sender, tx.round_idx) for b in c.blocks
                 for tx in b.transactions
                 if tx.kind == MODEL_COMMIT_KIND and tx.round_idx != b.round_idx]
                for c in chains]
        verified = [[r.verified_frac for r in x.report.history]
                    for x in (res["card"], res["cpu"])]
        if quarantined[0] != quarantined[1] or late[0] != late[1] \
                or verified[0] != verified[1]:
            raise AssertionError(f"faults/{name}: quarantine {quarantined}, late "
                                 f"commits {late} or verified fractions differ")
        if quarantined[0] != list(FAULT_SCHEDULE.bad_block_rounds) or not late[0]:
            raise AssertionError(f"faults/{name}: quarantined {quarantined[0]}, "
                                 f"late commits {late[0]}")
        for k, v in res["launches"].items():
            launches[k] += v
        hist, cpu_hist = res["card"].report.history, res["cpu"].report.history
        out[name] = {"strategy": strategy, "launches": res["launches"],
                     "quarantined": quarantined[0], "late_commits": late[0],
                     "verified_frac": verified[0],
                     "dropouts": [r.n_dropouts for r in hist],
                     "producers": [r.producer for r in hist],
                     "rounds_producer_differs_cpu": [
                         a.round_idx for a, b in zip(hist, cpu_hist, strict=True)
                         if a.producer != b.producer], **res["summary"]}
    return {"launches": launches, "faults": dataclasses.asdict(FAULT_SCHEDULE), **out}


def resume_phase(dev) -> dict:
    """Crash-consistent checkpoint/resume at the defaults, in both modes on
    the card, snapshots every RESUME_INTERVAL rounds/flushes under a
    ``tempfile.mkdtemp()`` directory removed afterwards: the uninterrupted
    run; the same with checkpoints on (digests equal: a pure observer); a
    crash at boundary RESUME_CRASH by exception in process and by SIGKILL
    in a child process (return code -9), each resumed here with the fault
    schedule cleared — resume_step RESUME_CRASH, digests equal; the newest
    snapshot corrupted or truncated by the injector, skipped by
    ``load_latest`` (resume_step RESUME_CRASH - RESUME_INTERVAL)."""
    root = tempfile.mkdtemp(prefix="bfln-resume-")
    src = str(Path(__file__).resolve().parent / "src")
    reset_launches()
    cases = []
    try:
        for mode in ("sync", "async"):
            base = ExperimentSpec(train=TrainSpec(mode=mode))
            t0 = time.perf_counter()
            want = digests(run(base, device=dev).manifest)
            plain_wall_s = time.perf_counter() - t0

            def resumed(name, faults, expect_step, crash="exception"):
                ck = CheckpointSpec(interval=RESUME_INTERVAL,
                                    dir=os.path.join(root, f"{mode}-{name}"))
                spec = dataclasses.replace(base, checkpoint=ck, faults=faults)
                timer = RoundTimer()
                t0 = time.perf_counter()
                if crash == "sigkill":
                    proc = subprocess.run(
                        [sys.executable, "-c", KILL_CHILD, src, spec.to_json()],
                        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
                    if proc.returncode != -9:
                        raise AssertionError(f"resume/{mode}/{name}: child exited "
                                             f"{proc.returncode}: {proc.stderr[-2000:]}")
                else:
                    try:
                        run(spec, device=dev, obs=timer)
                    except InjectedCrash:
                        pass
                    else:
                        raise AssertionError(f"resume/{mode}/{name}: no crash")
                crashed_s = time.perf_counter() - t0
                t1 = time.perf_counter()
                res = run(dataclasses.replace(base, checkpoint=ck), device=dev,
                          resume_from=ck.dir, obs=timer)
                torch.cuda.synchronize()
                m = res.manifest
                if m["resume_step"] != expect_step or digests(m) != want \
                        or not (m["chain_valid"] and m["ledger_conserved"]):
                    raise AssertionError(
                        f"resume/{mode}/{name}: step {m['resume_step']} (want "
                        f"{expect_step}), digests {digests(m)} vs {want}")
                cases.append({
                    "mode": mode, "case": name, "crash": crash,
                    "resume_step": m["resume_step"], "digests_equal": True,
                    "chain_valid": True, "ledger_conserved": True,
                    "snapshot_bytes": m["checkpoint_bytes"],
                    "ckpt_save_ms": timer.spans.get("ckpt.save"),
                    "ckpt_restore_ms": timer.spans.get("ckpt.restore"),
                    "crashed_run_wall_s": crashed_s,
                    "resumed_run_wall_s": time.perf_counter() - t1,
                    "plain_run_wall_s": plain_wall_s})

            # checkpoints on, no crash: a pure observer
            ck = CheckpointSpec(interval=RESUME_INTERVAL,
                                dir=os.path.join(root, f"{mode}-observer"))
            timer = RoundTimer()
            t0 = time.perf_counter()
            m = run(dataclasses.replace(base, checkpoint=ck), device=dev,
                    obs=timer).manifest
            if digests(m) != want or m["checkpoints_written"] != \
                    base.train.rounds // RESUME_INTERVAL:
                raise AssertionError(f"resume/{mode}: checkpointing moved the "
                                     "digests or missed a boundary")
            cases.append({"mode": mode, "case": "observer", "digests_equal": True,
                          "checkpoints_written": m["checkpoints_written"],
                          "snapshot_bytes": m["checkpoint_bytes"],
                          "ckpt_save_ms": timer.spans["ckpt.save"],
                          "run_wall_s": time.perf_counter() - t0,
                          "plain_run_wall_s": plain_wall_s})
            crash = dict(crash_round=RESUME_CRASH, crash_phase="post_checkpoint")
            for crash_mode in ("exception", "sigkill"):
                resumed(crash_mode, FaultSpec(crash_mode=crash_mode, **crash),
                        RESUME_CRASH, crash=crash_mode)
            for damage in ("corrupt", "truncate"):
                resumed(damage, FaultSpec(**crash, **{
                    f"{damage}_checkpoint_round": RESUME_CRASH}),
                    RESUME_CRASH - RESUME_INTERVAL)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": read_launches(), "interval": RESUME_INTERVAL,
            "crash_at": RESUME_CRASH, "cases": cases}


def paper_phase(dev) -> dict:
    """The port's Table II campaign at ``table2_accuracy.main()``'s
    defaults and ``fig2_rewards.main()``, on the card, each run observed
    through ``run_fl``: its wall, and for BFLN its chain and ledger, which
    must hold.  Then one cell (synth10, beta 0.1, bfln-5) again on the host
    CPU: its accuracy within PAPER_ACC_TOL of the card's, its rewards equal
    in every round whose labels agree."""
    runs, keep = [], {}

    def observed(dataset, bias, strategy, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr, acc = paper_common.run_fl(dataset, bias, strategy, **kw)
        torch.cuda.synchronize()
        rec = {"dataset": dataset, "bias": bias, "strategy": strategy,
               "n_clusters": kw.get("n_clusters"), "rounds": len(tr.history),
               "accuracy": acc, "wall_s": time.perf_counter() - t0}
        if strategy == "bfln":
            rec.update(chain_valid=tr.chain.validate(),
                       ledger_conserved=tr.ledger.conserved())
            if not (rec["chain_valid"] and rec["ledger_conserved"]):
                raise AssertionError(f"paper run {rec}: the chain or ledger "
                                     "does not hold")
        runs.append(rec)
        if (dataset, bias, strategy, kw.get("n_clusters")) == PAPER_CPU_CELL:
            keep["card"] = (tr, acc)
        return tr, acc

    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(table2_accuracy, "run_fl", observed), \
            mock.patch.object(fig2_rewards, "run_fl", observed):
        table2 = table2_accuracy.main(device=dev)
        fig2 = fig2_rewards.main(device=dev)
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    if len(table2) != 2 * 3 * len(table2_accuracy.STRATEGIES):
        raise AssertionError(f"Table II gave {len(table2)} cells")
    # a BFLN round: one Pearson matrix, one cluster mean, one fingerprint of
    # the trained rows; a flat round one masked mean (none for FedProto)
    want = {k: 0 for k in KERNELS}
    for rec in runs:
        if rec["strategy"] == "bfln":
            for k in ("cluster_agg", "pearson", "fingerprint"):
                want[k] += rec["rounds"]
        elif rec["strategy"] != "fedproto":
            want["cluster_agg"] += rec["rounds"]
    if launches != want:
        raise AssertionError(f"paper-path launches {launches}, expected {want}")

    dataset, bias, strategy, n_clusters = PAPER_CPU_CELL
    card_tr, card_acc = keep["card"]
    t1 = time.perf_counter()
    cpu_tr, cpu_acc = paper_common.run_fl(dataset, bias, strategy,
                                          n_clusters=n_clusters, device="cpu")
    cpu_wall_s = time.perf_counter() - t1
    if abs(card_acc - cpu_acc) > PAPER_ACC_TOL:
        raise AssertionError(f"paper cell {PAPER_CPU_CELL}: accuracy card {card_acc} "
                             f"vs CPU {cpu_acc} > {PAPER_ACC_TOL} apart")
    agree, differ = [], []
    for a, b in zip(card_tr.history, cpu_tr.history, strict=True):
        if np.array_equal(a.labels, b.labels):
            if not np.array_equal(a.rewards, b.rewards):
                raise AssertionError(f"paper cell round {a.round_idx}: equal labels, "
                                     f"rewards {a.rewards} vs {b.rewards}")
            agree.append(a.round_idx)
        else:
            differ.append(a.round_idx)
    return {"launches": launches, "runs": runs, "table2": table2,
            "fig2": {k: {f: v[f] for f in ("reward_size_correlation", "reward_spread",
                                           "chain_valid", "ledger_conserved")}
                     for k, v in fig2.items()},
            "wall_s": wall_s,
            "cpu_cell": {"cell": list(PAPER_CPU_CELL), "accuracy_card": card_acc,
                         "accuracy_cpu": cpu_acc, "acc_tol": PAPER_ACC_TOL,
                         "rounds_labels_agree": agree, "rounds_labels_differ": differ,
                         "rewards_equal_where_labels_agree": True,
                         "cpu_wall_s": cpu_wall_s}}


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

    reset_launches()
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
    by_kernel = read_launches()
    launches = by_kernel["fingerprint"]
    if launches == 0 or any(by_kernel[k] for k in ("flash_attention_bf16",
                                                     "flash_attention_fp32", "rwkv6")):
        raise AssertionError(f"serve-path launches {by_kernel}")

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
    return {"launches": launches, "launches_by_kernel": by_kernel,
            "n_clients": n, "n_clusters": n_clusters,
            "n_params": layout.n_params, "blocks": len(chain.blocks),
            "requests": len(done), "flushes": len(flush_ms),
            "flush_reasons": sorted(set(reasons)),
            "fused_bitwise_per_request": bitwise,
            "fused_vs_per_request_max_abs": max_diff,
            "card_vs_cpu_max_abs": cpu_diff,
            "flush_ms_p50": float(np.median(flush_ms)),
            "serve_path_wall_s": wall_s}


def qkv(rng, B: int, S: int, Hq: int, Hkv: int, hd: int, dtype, dev):
    """q (B, S, Hq, hd), k and v (B, S, Hkv, hd), standard normal."""
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(dev, dtype)
                 for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))


def check_flash(q, k, v, causal: bool, window: int, what: str) -> dict:
    """The kernel of the inputs' dtype against the plain version on their
    float32 values, element by element: |got - want| <= rtol |want| + atol,
    rtol 0 in float32 and FLASH_RTOL_BF16 in bf16."""
    rtol = FLASH_RTOL_BF16 if q.dtype == torch.bfloat16 else 0.0
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window).float()
    want = fa.attention_plain(q.float(), k.float(), v.float(), causal=causal,
                              window=window)
    diff = (got - want).abs()
    share = float((diff / (rtol * want.abs() + FLASH_TOL_F32)).max())
    err = float(diff.max())
    if not share <= 1.0:
        raise AssertionError(f"flash kernel vs plain version on {what}: an element "
                             f"is {share} of its limit {rtol} |want| + "
                             f"{FLASH_TOL_F32} (max abs error {err})")
    return {"max_abs_err": err, "max_share_of_limit": share,
            "rtol": rtol, "atol": FLASH_TOL_F32}


def live_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for one (batch, head)."""
    q = np.arange(S)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(S, dtype=np.int64)
    hi = q if causal else np.full(S, S - 1)
    return int((hi - lo + 1).sum())


def sdpa_backend(fn) -> dict:
    """The device kernels of one call of ``fn`` (torch.profiler), and the
    SDPA backend their names show."""
    names = sorted(set(device_kernels(fn)))
    low = " ".join(names).lower()
    # cuDNN's, PyTorch's flash (flash_fwd), memory-efficient (fmha_cutlass)
    # or, failing those, the math path (matmuls and a softmax)
    backend = ("cudnn" if "cudnn" in low else "flash" if "flash_fwd" in low
               else "efficient" if "fmha" in low else "math")
    return {"backend": backend, "kernels": [nm[:100] for nm in names]}


# the edge cases, each in float32 and in bf16: (B, S, Hq, Hkv, hd), causal, window
FLASH_CASES = {"ragged (1, 1000, 4, 2, 64)": ((1, 1000, 4, 2, 64), True, 0),
               "non-causal (1, 512, 4, 4, 128)": ((1, 512, 4, 4, 128), False, 0),
               "G = 8 (1, 300, 8, 1, 64) window 100": ((1, 300, 8, 1, 64), True, 100),
               "hd 32 (2, 256, 4, 2, 32) window 64": ((2, 256, 4, 2, 32), True, 64),
               "hd 128 (1, 384, 4, 2, 128)": ((1, 384, 4, 2, 128), True, 0),
               "hd 120 (1, 130, 4, 1, 120)": ((1, 130, 4, 1, 120), True, 0),
               "G = 5 (1, 257, 10, 2, 64)": ((1, 257, 10, 2, 64), True, 0)}


def flash_phase(dev) -> tuple[dict, dict]:
    """Both flash kernels against the plain version at the LM path's shape
    and at the edge cases; times at the main-path shape, per dtype."""
    rng = np.random.default_rng(SEED + 6)
    B, S, Hq, Hkv, hd = LM_BATCH, LM_SEQ, 8, 4, 256      # gemma3-4b's attention
    q, k, v = qkv(rng, B, S, Hq, Hkv, hd, torch.bfloat16, dev)
    inputs = {"bf16": (q, k, v), "fp32": tuple(t.float() for t in (q, k, v))}
    checks = {}
    for dt, args in inputs.items():
        for window in (1024, 0):
            what = f"main (2, 4096, 8, 4, 256) window {window} {dt}"
            checks[what] = check_flash(*args, True, window, what)
    for what, (shape, causal, window) in FLASH_CASES.items():
        args = qkv(rng, *shape, torch.float32, dev)
        checks[what + " fp32"] = check_flash(*args, causal, window, what)
        args = tuple(t.to(torch.bfloat16) for t in args)
        checks[what + " bf16"] = check_flash(*args, causal, window, what)
    # the bf16-rounded main-shape values have 8 significant bits, which one TF32
    # product holds exactly; full-mantissa inputs need all three of 3xTF32
    full = qkv(rng, B, S, Hq, Hkv, hd, torch.float32, dev)
    for window in (1024, 0):
        what = f"main full-mantissa (2, 4096, 8, 4, 256) window {window} fp32"
        checks[what] = check_flash(*full, True, window, what)

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    pos = torch.arange(S, device=dev)
    rows = {}
    for dt, (qd, kd, vd) in inputs.items():
        qt, kt, vt = (t.transpose(1, 2) for t in (qd, kd, vd))   # SDPA's (B, H, S, hd)
        n_bytes = (2 * qd.numel() + kd.numel() + vd.numel()) * qd.element_size()
        # bf16 on the tensor cores; float32 at float32 accuracy as three TF32
        # products each (the rate beside it: the CUDA cores' 67 TFLOP/s)
        ops_per_s = (BF16_OPS_PER_S if dt == "bf16"
                     else TF32_OPS_PER_S / TF32_PRODUCTS_PER_FP32)
        rows[dt] = []
        for window in (1024, 0):
            band = pos[None, :] <= pos[:, None]
            if window:
                band &= pos[:, None] - pos[None, :] < window
            n_ops = 4 * hd * B * Hq * live_pairs(S, True, window)   # q.k and p.v

            def band_sdpa(_):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                      enable_gqa=True)
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e6, n_ops / ops_per_s * 1e6
            row = {
                "shape": [B, S, Hq, Hkv, hd], "dtype": str(qd.dtype).removeprefix("torch."),
                "window": window,
                "kernel_us": median_us(lambda _: fa.flash_attention_cuda(
                    qd, kd, vd, causal=True, window=window), None, 10, flush),
                "plain_us": median_us(lambda _: fa.attention_plain(
                    qd, kd, vd, causal=True, window=window), None, 5, flush),
                "library_us": median_us(band_sdpa, None, 10, flush),
                "library_call": "F.scaled_dot_product_attention(band mask, enable_gqa=True)",
                "library_backend": sdpa_backend(band_sdpa),
                "bound_us": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations", "flop": n_ops}
            if dt == "fp32":
                row["bound_cuda_cores_us"] = max(t_bytes, n_ops / ALU32_OPS_PER_S * 1e6)
            if window == 0:
                # the causal row also beside SDPA with no mask tensor, where
                # PyTorch may pick its own flash backend
                def causal_sdpa(_):
                    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True)
                row["library_causal_us"] = median_us(causal_sdpa, None, 10, flush)
                row["library_causal_call"] = \
                    "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
                row["library_causal_backend"] = sdpa_backend(causal_sdpa)
            rows[dt].append(row)
    return rows, checks


def wkv_inputs(rng, B: int, H: int, T: int, hd: int, dev, strong: bool = False):
    """r, k, v standard normal; decays in (0.55, 0.95), or with ``strong``
    the model's w = exp(-exp(x)) with x over -6..3 (0.9975, the init's
    w0 = -6, down to 2e-9); u, s0 small."""
    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    if strong:
        w = np.exp(-np.exp(rng.uniform(-6.0, 3.0, (B, H, T, hd)))).astype(np.float32)
    else:
        w = (1 / (1 + np.exp(-randn(B, H, T, hd))) * 0.4 + 0.55).astype(np.float32)
    arrays = (randn(B, H, T, hd), randn(B, H, T, hd), randn(B, H, T, hd), w,
              randn(H, hd, scale=0.1), randn(B, H, hd, hd, scale=0.1))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def wkv_err(got, want, what: str) -> float:
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not err <= WKV_TOL:
        raise AssertionError(f"wkv kernel on {what}: max abs error {err} > {WKV_TOL}")
    return err


def wkv_phase(dev) -> tuple[dict, dict]:
    """The wkv kernels against their plain version at the LM path's shape
    (chunked), with strong decays, at a ragged T = 1000, at T = 1
    (recurrent), in two halves and split at 1001 (off every chunk boundary)
    against the whole, and at w = 0; times at the main-path shape."""
    rng = np.random.default_rng(SEED + 7)
    B, H, T, hd = LM_BATCH, 40, LM_SEQ, 64                 # rwkv6-3b's heads
    main = wkv_inputs(rng, B, H, T, hd, dev)
    full = wk.rwkv6_cuda(*main)
    checks = {"main (2, 40, 4096, 64)": wkv_err(full, wk.rwkv6_plain(*main), "main")}
    one = wkv_inputs(rng, B, H, 1, hd, dev)
    checks["T = 1 (2, 40, 1, 64)"] = wkv_err(wk.rwkv6_cuda(*one), wk.rwkv6_plain(*one),
                                             "T = 1")
    r, k, v, w, u, s0 = main
    h = T // 2
    y1, s1 = wk.rwkv6_cuda(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h], u, s0)
    y2, s2 = wk.rwkv6_cuda(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:], u, s1)
    checks["two halves vs the whole"] = wkv_err((torch.cat([y1, y2], 2), s2), full,
                                                "two halves")
    zero = wkv_inputs(rng, 1, 4, 64, hd, dev)
    zero[3].zero_()
    got = wk.rwkv6_cuda(*zero)
    checks["w = 0 (1, 4, 64, 64)"] = wkv_err(got, wk.rwkv6_plain(*zero), "w = 0")
    last = zero[1][:, :, -1, :, None] * zero[2][:, :, -1, None, :]
    if float((got[1] - last).abs().max()) > 1e-6:
        raise AssertionError("w = 0 must leave only the last k v^T in the state")
    y1, s1 = wk.rwkv6_cuda(r[:, :, :1001], k[:, :, :1001], v[:, :, :1001],
                           w[:, :, :1001], u, s0)
    y2, s2 = wk.rwkv6_cuda(r[:, :, 1001:], k[:, :, 1001:], v[:, :, 1001:],
                           w[:, :, 1001:], u, s1)
    checks["split at 1001 vs the whole"] = wkv_err((torch.cat([y1, y2], 2), s2), full,
                                                   "split at 1001")
    strong = wkv_inputs(rng, B, H, T, hd, dev, strong=True)
    checks["strong decay (2, 40, 4096, 64)"] = wkv_err(
        wk.rwkv6_cuda(*strong), wk.rwkv6_plain(*strong), "strong decay")
    ragged = wkv_inputs(rng, B, H, 1000, hd, dev)
    checks["ragged T = 1000 (2, 40, 1000, 64)"] = wkv_err(
        wk.rwkv6_cuda(*ragged), wk.rwkv6_plain(*ragged), "T = 1000")

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    n_bytes = sum(t.numel() for t in main) * 4 + (B * H * T * hd + B * H * hd * hd) * 4
    n_ops = B * H * T * (WKV_FLOPS_PER_STATE * hd * hd + WKV_FLOPS_PER_CHANNEL * hd)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e6, n_ops / ALU32_OPS_PER_S * 1e6
    row = {"shape": [B, H, T, hd], "dtype": "float32",
           "kernel_us": median_us(lambda _: wk.rwkv6_cuda(*main), None, 20, flush),
           "plain_us": median_us(lambda _: wk.rwkv6_plain(*main), None, 3, flush),
           "library_us": None,
           "bound_us": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "flop": n_ops}
    return row, checks


def lm_batch(cfg, dev) -> dict:
    """One (B, S) batch of the synthetic Markov token stream."""
    stream = make_token_stream(cfg.vocab_size, 4 * LM_BATCH * (LM_SEQ + 1), seed=SEED)
    x, y = next(batch_stream(stream, LM_BATCH, LM_SEQ, 1, seed=SEED))
    return {"tokens": torch.from_numpy(x).long().to(dev),
            "labels": torch.from_numpy(y).long().to(dev)}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def decode_vs_forward(cfg, params, tokens) -> float:
    """The logits of decode_step over the tokens against forward's."""
    B, T = tokens.shape
    with torch.inference_mode():
        ref, _, _ = lmt.forward(cfg, params, tokens=tokens)
        cache = lmdec.init_cache(cfg, B, T, device=tokens.device)
        outs = []
        for i in range(T):
            logits, cache = lmdec.decode_step(cfg, params, cache, tokens[:, i:i + 1])
            outs.append(logits)
    return rel_err(torch.cat(outs, dim=1), ref)


def card_vs_cpu(cfg, dev) -> dict:
    """The configuration in float32, one period, B = 1, S = 128: logits on
    the card (kernels) against the host CPU (plain versions), same weights.
    The card's forward is the path ``lm_fp32``: every kernel's launch count
    is reset just before it and read just after."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", n_layers=len(cfg.pattern))
    p_dev = lmt.init_params(cfg32, seed=SEED + 1, device=dev)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    gen = torch.Generator().manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)
    t0 = time.perf_counter()
    with torch.inference_mode():
        reset_launches()
        card = lmt.forward(cfg32, p_dev, tokens=toks.to(dev))[0]
        torch.cuda.synchronize()
        launches = read_launches()
        cpu = lmt.forward(cfg32, p_cpu, tokens=toks)[0]
    err = rel_err(card, cpu)
    if not err <= CARD_CPU_RTOL:
        raise AssertionError(f"{cfg.name}: card vs CPU logits rel err {err} > {CARD_CPU_RTOL}")
    n_attn = sum(s.mixer == "attn" for s in cfg32.pattern)
    want = {name: 0 for name in KERNELS}
    want.update(flash_attention_fp32=n_attn, rwkv6=cfg32.n_layers - n_attn)
    if launches != want:
        raise AssertionError(f"{cfg.name}: float32 forward launches {launches}, "
                             f"expected {want}")
    return {"n_layers": cfg32.n_layers, "shape": [1, 128], "rel_err": err,
            "tolerance": CARD_CPU_RTOL, "launches": launches,
            "wall_s": time.perf_counter() - t0}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lm_config_run(cfg, dev) -> dict:
    params = lmt.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = lm_batch(cfg, dev)
    n_attn = sum(s.mixer == "attn" for s in cfg.pattern) * cfg.n_periods \
        + sum(s.mixer == "attn" for s in cfg.remainder)
    n_rwkv = cfg.n_layers - n_attn

    eval_step = lmsteps.make_eval_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    loss, eval_cold_s = timed(lambda: eval_step(params, batch))
    forward_launches = read_launches()
    loss2, eval_warm_s = timed(lambda: eval_step(params, batch))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    loss, loss2 = float(loss), float(loss2)
    # random tied weights at full width put most of a position's mass on its
    # own input token (the scaled embedding dominates the final norm), so
    # the loss may sit far above ln V; it must be finite and positive
    if not (np.isfinite(loss) and loss > 0.0):
        raise AssertionError(f"{cfg.name}: eval loss {loss}")

    prompt = batch["tokens"][:, :PROMPT]
    reset_launches()
    toks, gen_cold_s = timed(lambda: lmsteps.greedy_generate(
        cfg, params, prompt, NEW_TOKENS, PROMPT + NEW_TOKENS))
    decode_launches = read_launches()
    toks2, gen_warm_s = timed(lambda: lmsteps.greedy_generate(
        cfg, params, prompt, NEW_TOKENS, PROMPT + NEW_TOKENS))
    steps = PROMPT + NEW_TOKENS - 1
    if toks.shape != (LM_BATCH, PROMPT + NEW_TOKENS) or not torch.equal(toks[:, :PROMPT], prompt) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: greedy_generate gave {tuple(toks.shape)}")

    want_fwd = {name: 0 for name in KERNELS}
    want_fwd.update(flash_attention_bf16=n_attn, rwkv6=n_rwkv)
    want_dec = dict(want_fwd, flash_attention_bf16=0, rwkv6=n_rwkv * steps)
    if forward_launches != want_fwd or decode_launches != want_dec:
        raise AssertionError(f"{cfg.name}: launches forward {forward_launches} (want "
                             f"{want_fwd}), decode {decode_launches} (want {want_dec})")

    parity = decode_vs_forward(cfg, params, batch["tokens"][:, :PARITY_TOKENS])
    if not parity <= DECODE_RTOL:
        raise AssertionError(f"{cfg.name}: decode vs forward rel err {parity} > {DECODE_RTOL}")
    del params
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "param_dtype": cfg.param_dtype, "n_params": n_params,
            "eval": {"batch": LM_BATCH, "seq": LM_SEQ, "loss": loss,
                     "loss_second_call": loss2, "wall_s_first": eval_cold_s,
                     "wall_s": eval_warm_s, "peak_gb": peak_gb,
                     "tokens_per_s": LM_BATCH * LM_SEQ / eval_warm_s},
            "generate": {"batch": LM_BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
                         "decode_steps": steps, "tokens": toks.cpu().tolist(),
                         "same_tokens_second_call": bool(torch.equal(toks, toks2)),
                         "wall_s_first": gen_cold_s, "wall_s": gen_warm_s,
                         "ms_per_step": gen_warm_s / steps * 1e3},
            "launches": {"lm_forward": forward_launches, "lm_decode": decode_launches},
            "decode_vs_forward": {"tokens": PARITY_TOKENS, "rel_err": parity,
                                  "tolerance": DECODE_RTOL},
            "card_vs_cpu": card_vs_cpu(cfg, dev)}


def lm_phase(dev) -> dict:
    return {name: lm_config_run(dataclasses.replace(ARCHS[name], n_layers=n), dev)
            for name, n in LM_CONFIGS}


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
    check_no_spills()

    res: dict = {}
    t0 = time.perf_counter()
    res["floors"] = launch_floors_us(torch.empty(128 << 20, dtype=torch.uint8,
                                                 device=dev))
    print(f"launch floors {res['floors']}", flush=True)
    res["fp"] = kernel_phase(dev)
    res["agg"] = cluster_agg_phase(dev)
    res["pe"] = pearson_phase(dev)
    res["flash"] = flash_phase(dev)
    res["wkv"] = wkv_phase(dev)
    res["table2_shapes"] = table2_kernel_phase(dev)
    res["async_shapes"] = async_kernel_phase(dev)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s", flush=True)
    for phase, run_phase in PHASES:
        t0 = time.perf_counter()
        res[phase] = run_phase(dev)
        print(f"{phase} phase {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": kernel_entries(res)}), flush=True)
    for phase, _ in PHASES:
        print(json.dumps({phase: res[phase]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_entries(res: dict) -> list[dict]:
    """The `kernels` line: each kernel's launches on its main path and on
    every path, error and tolerance, and its times beside its bound."""
    by_path = {"train": res["train"]["launches"],
               "serve": res["serve"]["launches_by_kernel"]}
    for name in BASELINES:
        by_path[f"train_{name}"] = res["strategies"][name]["launches"]
    by_path["paper"] = res["paper"]["launches"]
    for path in ("async", "faults", "resume"):
        by_path[path] = res[path]["launches"]
    for path in ("lm_forward", "lm_decode"):
        by_path[path] = {name: sum(run["launches"][path][name]
                                   for run in res["lm"].values())
                         for name in KERNELS}
    by_path["lm_fp32"] = {name: sum(run["card_vs_cpu"]["launches"][name]
                                    for run in res["lm"].values())
                          for name in KERNELS}

    def us_to_ms(row, key):
        return None if row.get(key) is None else row[key] / 1e3

    def entry(name, source, replaces, main_path, row, err, tolerance, **extra):
        paths = {path: counts[name] for path, counts in by_path.items()}
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces,
                "launches": paths[main_path], "main_path": main_path,
                "launches_by_path": paths,
                "max_abs_err": err, "tolerance": tolerance,
                "ms": us_to_ms(row, "kernel_us"), "plain_ms": us_to_ms(row, "plain_us"),
                "bound_ms": us_to_ms(row, "bound_us"), "bound_by": row["bound_by"],
                "library_ms": us_to_ms(row, "library_us"),
                "kernel_us": row["kernel_us"], "plain_us": row["plain_us"],
                "bound_us": row["bound_us"], "library_us": row.get("library_us"),
                "launch_floor_ms": res["floors"]["empty_us"] / 1e3,
                "round_trip_floor_ms": res["floors"]["round_trip_us"] / 1e3, **extra}

    shapes, fp_err = res["fp"]
    agg_row, agg_row16 = res["agg"]
    pe_row, pe_err = res["pe"]
    flash_rows, flash_checks = res["flash"]
    wkv_row, wkv_checks = res["wkv"]
    cohort = shapes[2]                  # (100, 6570): the train path's rows

    def flash(dt, source, main_path, tolerance):
        checks = {w: c for w, c in flash_checks.items() if w.endswith(dt)}
        main = max(c["max_abs_err"] for w, c in checks.items() if w.startswith("main"))
        causal = flash_rows[dt][1]
        # the main-path row is window 1024: five of gemma3's six layers
        return entry(f"flash_attention_{dt}", source,
                     "src/repro/kernels/flash_attention.py:80", main_path,
                     flash_rows[dt][0], main, tolerance, shape=[2, 4096, 8, 4, 256],
                     dtype=flash_rows[dt][0]["dtype"], window=1024,
                     library_call=flash_rows[dt][0]["library_call"],
                     library_causal_ms=us_to_ms(causal, "library_causal_us"),
                     library_causal_backend=causal.get("library_causal_backend"),
                     bound_cuda_cores_ms=us_to_ms(flash_rows[dt][0], "bound_cuda_cores_us"),
                     shapes=flash_rows[dt], checks=checks)

    # the shapes only the baselines' and the paper's paths give the kernels
    new = res["table2_shapes"]
    return [
        entry("fingerprint", "fingerprint.cu", "src/repro/kernels/fingerprint.py:102",
              "train", cohort, fp_err, 0, bit_exact=True, shape=[100, 6570],
              cluster=cohort["cluster"], shapes=shapes,
              paper_shapes=new["fingerprint"],
              async_shape=dict(res["async_shapes"]["fingerprint"],
                               launches_async=by_path["async"]["fingerprint"])),
        entry("cluster_agg", "cluster_agg.cu", "src/repro/kernels/cluster_agg.py:43",
              "train", agg_row, agg_row["max_abs_err"], 0, bit_exact=True,
              shape=[100, 6570], dtype="float32", library_call="torch.matmul(mix, rows)",
              masked_mean_shapes=new["cluster_agg"],
              async_shape=dict(res["async_shapes"]["cluster_agg"],
                               launches_async=by_path["async"]["cluster_agg"]),
              # the same kernel on bf16 rows, which no path gives it yet (the
              # launch counter counts both dtypes; every path's rows are fp32)
              bf16={"launches": "none on a path", "max_abs_err": agg_row16["max_abs_err"],
                    "ms": us_to_ms(agg_row16, "kernel_us"),
                    "plain_ms": us_to_ms(agg_row16, "plain_us"),
                    "bound_ms": us_to_ms(agg_row16, "bound_us"),
                    "bound_by": agg_row16["bound_by"], "library_ms": None,
                    "library_none_because": "no one PyTorch call sums bf16 rows in "
                                            "float32 and rounds the mean once",
                    "row": agg_row16}),
        entry("pearson", "pearson.cu", "src/repro/kernels/pearson.py:59",
              "train", pe_row, pe_err, PEARSON_TOL, shape=[100, 32],
              tile=pe_row["tile"], wide=pe_row["wide"],
              library_call="torch.corrcoef(protos)", paper_shapes=new["pearson"]),
        flash("bf16", "flash_attention_sm90.cu", "lm_forward",
              {"rtol": FLASH_RTOL_BF16, "atol": FLASH_TOL_F32,
               "against": "float32 plain version, per element"}),
        flash("fp32", "flash_attention.cu", "lm_fp32",
              {"rtol": 0.0, "atol": FLASH_TOL_F32, "against": "plain version"}),
        entry("rwkv6", "rwkv6_scan.cu", "src/repro/kernels/rwkv6_scan.py:45",
              "lm_forward", wkv_row, wkv_checks["main (2, 40, 4096, 64)"], WKV_TOL,
              shape=[2, 40, 4096, 64], dtype="float32", checks=wkv_checks),
    ]


PHASES = (("train", train_phase), ("strategies", strategies_phase),
          ("async", async_phase), ("faults", faults_phase),
          ("resume", resume_phase), ("paper", paper_phase),
          ("serve", serve_phase), ("lm", lm_phase))


if __name__ == "__main__":
    sys.exit(main())
