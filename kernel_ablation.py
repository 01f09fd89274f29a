#!/usr/bin/env python3
"""Time three of the port's kernels against variants of their own sources
on one NVIDIA GPU, each variant undoing one design step or trying one
alternative, and read jamba's decode-vs-forward error with each kernel
swapped in turn.

    python3 kernel_ablation.py [flash] [scan] [scan_bwd] [parity]

The kernels are the bf16 flash forward at head_dim <= 128
(`csrc/flash_attention_sm90.cu`, `flash_sm90_narrow_kernel`), Mamba's
selective scan (`csrc/selective_scan.cu`) and its backward
(`csrc/selective_scan_bwd.cu`).  Each variant is the committed source with
one text substitution (ABLATIONS) that undoes one design step or tries one
alternative, built with `nvcc` like the source itself into
`build/ablation/` (each compiler log beside its library); the script
refuses to run if a substitution no longer matches.  Variants marked
`diagnostic` compute a wrong result on purpose (they show where the time
goes) and are not checked; every other variant is held to the check its
kernel is held to in `chip_smoke.py`, with its tolerances (flash per
element within FLASH_RTOL_BF16 |want| + FLASH_TOL_F32 of the float32 plain
version; the scan within SCAN_RTOL max(1, max |want|) of the plain
version; its backward by `chip_smoke.scan_bwd_shares` against the plain
backward).  Times are `chip_smoke.median_us` medians (CUDA events, each
call after a 128 MiB write to flush L2), taken in turns (the source, each
variant, then back in reverse order), at jamba's attention layer (2,
4096, 64 / 8, 128) causal, at jamba's Mamba prefill (2, 4096, 16384, 16)
and decode (2, 1, 16384, 16), and for the backward at the prefill with x
in bf16, non-zero h0 and dh_T, from the forward's states, with Bm / Cm as
slices of a narrow projection and of the train path's (TRAIN_DT_RANK +
32 columns).

The parity witness runs `chip_smoke.py`'s decode-vs-forward check of
jamba (4 layers at full width, its 32 tokens) on PARITY_SEEDS weight seeds
with the committed kernels, then with one kernel swapped at a time
(PARITY_SWAPS: the scan with exp2f, the plain float32 scan, a float64
scan, the hd-256 flash design at hd 128), and prints each swap's errors.

Prints the card's name and power limit, a line per variant and per swap,
and last one JSON line ``{"kernel_ablation": {...}}``.  Exits non-zero
without CUDA.  Arguments name the parts to run (PARTS); with none it runs
them all.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.configs import ARCHS
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as sc
from repro_torch.models import transformer as lmt

OUT = Path(__file__).resolve().parent / "build" / "ablation"
FLASH, SCAN, SCAN_BWD = ("flash_attention_sm90.cu", "selective_scan.cu",
                         "selective_scan_bwd.cu")
# the warpgroups taking turns to start their products (FA3's ping-pong, as
# in flash_sm90_kernel), put back into the narrow kernel
_TURNS = ('  auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + cw) '
          ': "memory"); };\n  auto your_turn = [&]() { asm volatile("bar.arrive %0, '
          '256;\\n" ::"r"(4 - cw) : "memory"); };\n  if (cw == 1) your_turn();\n')
# source -> {variant: (what it undoes, diagnostic, [(old, new), ...])}
ABLATIONS = {
    FLASH: {
        "hd256_kernel": (
            "the hd <= 128 design: the hd-256 kernel (64-key tiles, 2 stages, no "
            "intra-warpgroup overlap) runs hd 128 as before", False,
            [("if constexpr (NCH <= 2) {      // hd <= 128: the narrow kernel",
              "if constexpr (NCH <= 0) {      // hd <= 128: the narrow kernel"),
             ("const int keys = hd <= 2 * kChunk ? kNarrowKeys : kKeys;",
              "const int keys = kKeys;")]),
        "stages_3": ("two stages: a ring of three", False,
                     [("constexpr int kNarrowStages = 2;", "constexpr int kNarrowStages = 3;")]),
        "ping_pong": (
            "no turns: the two warpgroups take turns to start their products", False,
            [("  uint32_t p_hi[32], p_lo[32];\n", "  uint32_t p_hi[32], p_lo[32];\n" + _TURNS),
             ("  issue_qk<NCH>(s, q_rows, sk);\n  wgmma_commit();\n",
              "  my_turn();\n  issue_qk<NCH>(s, q_rows, sk);\n  wgmma_commit();\n"
              "  your_turn();\n"),
             ("    issue_qk<NCH>(s, q_rows, sk + st * NCH * kKvBoxN);",
              "    my_turn();\n    issue_qk<NCH>(s, q_rows, sk + st * NCH * kKvBoxN);"),
             ("    wgmma_commit();\n    wgmma_wait_all_but_last();",
              "    wgmma_commit();\n    your_turn();\n    wgmma_wait_all_but_last();"),
             ("    issue_pv<NCH>(o, p_hi, p_lo, sv + st * NCH * kKvBoxN);\n"
              "    wgmma_commit();\n",
              "    my_turn();\n    issue_pv<NCH>(o, p_hi, p_lo, sv + st * NCH * kKvBoxN);\n"
              "    wgmma_commit();\n    if (cw == 0) your_turn();\n")]),
        "quotient_epilogue": (
            "one reciprocal a row in the epilogue: out = O / l per element", False,
            [("write_rows<NCH, true>(", "write_rows<NCH, false>(")]),
        "one_p_term": ("P's low bf16 term (fails the per-element check)", True,
                       [("    wgmma_pv<NCH>(o, p_lo + 4 * kk, dv);\n", "")]),
        "no_softmax": ("the softmax: its time beside the products'", True,
                       [("  const bool edge = k0 + kNarrowKeys > a.S",
                         "  if (k0 >= 0) return make_float2(1.f, 1.f);\n"
                         "  const bool edge = k0 + kNarrowKeys > a.S")]),
    },
    SCAN: {
        "accurate_exp2": ("one MUFU an exponential: exp2f, not ex2.approx", False,
                          [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                            "y = exp2f(x);")]),
        "lanes_2": ("four lanes a channel: two lanes of 8 states, 8 blocks of 128 threads "
                    "an SM (the same 32 warps, 64 registers)", False,
                    [("constexpr int kLanes = 4;", "constexpr int kLanes = 2;"),
                     ("constexpr int kBlocksPerSM = 4;", "constexpr int kBlocksPerSM = 8;")]),
        "lanes_2_16_warps": ("four lanes a channel: two lanes of 8 states, 4 blocks of 128 "
                             "threads an SM (16 warps, up to 128 registers)", False,
                             [("constexpr int kLanes = 4;", "constexpr int kLanes = 2;")]),
        "ring_of_4": ("the one-chunk-ahead copies: a ring of 4 buffers, three ahead", False,
                      [("constexpr int kBufs = 2;", "constexpr int kBufs = 4;")]),
        "no_exponentials": ("the exponentials, replaced by an FMA: the SFUs' share", True,
                            [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                              "y = 1.0f + x * 1e-9f;")]),
    },
}
# the channel sums: the kernel's select-free reduce-scatter, and a
# select-based one for slots in state order
_SELECT_FREE_SUMS = """#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    v[i][0] += __shfl_xor_sync(0xffffffffu, v[i][2], 16);
    v[i][1] += __shfl_xor_sync(0xffffffffu, v[i][3], 16);
  }
#pragma unroll
  for (int i = 0; i < kLanes; ++i) v[i][0] += __shfl_xor_sync(0xffffffffu, v[i][1], 8);
"""
_SELECT_SUMS = """  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 16, half = kPer / 2; m >= 8; m /= 2, half /= 2) {
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const bool upper = lane & m;
        const float keep = upper ? v[i][j + half] : v[i][j];
        const float send = upper ? v[i][j] : v[i][j + half];
        v[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
    }
  }
"""
_STAGE_AHEAD = """    if (c > 0) {
      copy(c - 1);
      load_x_chunk(xr, c - 1);
    }
    cp_async_commit();
"""
_WRITE_OUT = """    if (c * kChunk + o_row < a.S && o_n > 0) {
      store4(a.ddt + o_at, *reinterpret_cast<const float4*>(&sm.out[buf][0][o_row][o_ch]),
             o_vec, o_n);
      store4(static_cast<XT*>(a.dx) + o_at,
             *reinterpret_cast<const float4*>(&sm.out[buf][1][o_row][o_ch]), o_vec, o_n);
    }
"""
ABLATIONS[SCAN_BWD] = {
    "exponentials_kept": (
        "the walk's own exponentials: the forward pass's kept in shared memory (one a "
        "state a step; 32 KB more, so one block an SM)", False,
        [("  float out[kBufs][2][kChunk][kOutPad];",
          "  float4 at[kStatesEvery][kThreads];\n  float out[kBufs][2][kChunk][kOutPad];"),
         ("            v[i][k] = f.z * hk;                              // dC_t's term\n"
          "          }\n",
          "            v[i][k] = f.z * hk;                              // dC_t's term\n"
          "          }\n          sm.at[s][tid] = make_float4(e[0], e[1], e[2], e[3]);\n"),
         ("          const float dtx = f.x * f.y;\n          float u = 0.0f, q = 0.0f;",
          "          const float dtx = f.x * f.y;\n          float u = 0.0f, q = 0.0f;\n"
          "          const float4 eq = sm.at[s][tid];\n"
          "          const float e[kPer] = {eq.x, eq.y, eq.z, eq.w};"),
         ("gr[k] *= ex2(f.x * a2[k]);", "gr[k] *= e[k];")]),
    "exponentials_in_registers": (
        "the walk's own exponentials: the forward pass's kept in registers (one a state "
        "a step)", False,
        [("      float hs[kStatesEvery][kPer];\n",
          "      float hs[kStatesEvery][kPer], at[kStatesEvery][kPer];\n"),
         ("            e[k] = ex2(f.x * a2[k]);", "            e[k] = at[s][k] = ex2(f.x * a2[k]);"),
         ("gr[k] *= ex2(f.x * a2[k]);", "gr[k] *= at[s][k];")]),
    "channel_sums_with_selects": (
        "the slot orders: B_t | C_t staged in state order, dB / dC summed by the "
        "select-based reduce-scatter", False,
        [("const int so = p;", "const int so = 0;"), (_SELECT_FREE_SUMS, _SELECT_SUMS)]),
    "staging_in_turn": (
        "staging a chunk ahead: the next chunk's copies issued after the walk", False,
        [(_STAGE_AHEAD, ""),
         ("    if (c > 0) stage_x(xr, c - 1);\n",
          _STAGE_AHEAD + "    if (c > 0) stage_x(xr, c - 1);\n")]),
    "spans_a_chunk_1": ("16-step staging chunks of two spans: one span a chunk, a "
                        "barrier every 8 steps", False,
                        [("constexpr int kSpans = 2;", "constexpr int kSpans = 1;")]),
    "outputs_direct": (
        "the staged outputs: each lane stores its own ddt and dx element", False,
        [("        ddt_row[(s0 + g) * kOutPad] = fmaf(u, f.y, q * kLn2);\n"
          "        dx_row[(s0 + g) * kOutPad] = fmaf(u, f.x, f.z * Dd);\n",
          "        if (live && c * kChunk + r0 + s0 + g < a.S) {\n"
          "          const long long o = ((long long)b * a.S + c * kChunk + r0 + s0 + g) * "
          "a.di + d;\n"
          "          a.ddt[o] = fmaf(u, f.y, q * kLn2);\n"
          "          store4(static_cast<XT*>(a.dx) + o, make_float4(fmaf(u, f.x, f.z * Dd), "
          "0.f, 0.f, 0.f), false, 1);\n        }\n"),
         (_WRITE_OUT, "")]),
    "one_block_an_sm": ("two blocks an SM: one, up to 255 registers", False,
                        [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 1;")]),
    "blocks_of_32_channels": ("blocks of 64 channels: 32 channels, 128 threads", False,
                              [("constexpr int kChannels = 64; ", "constexpr int kChannels = 32; "),
                               ("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 3;")]),
    "no_exponentials": ("the exponentials, replaced by an FMA: the SFUs' share", True,
                        [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                          "y = 1.0f + x * 1e-9f;")]),
    "no_channel_sums": ("the dB / dC shuffles: the lane's terms added in registers", True,
                        [(_SELECT_FREE_SUMS,
                          "#pragma unroll\n  for (int i = 0; i < kLanes; ++i)\n"
                          "    v[i][0] = (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);\n"),
                         ("tot[i] = v[i][0] + __shfl_xor_sync(0xffffffffu, v[i][0], 4);",
                          "tot[i] = v[i][0];")]),
    "no_staging": ("the staging loads of dt, x, dy, B_t and C_t: zeros instead", True,
                   [("const bool ok = lc_live && s < n;", "const bool ok = false;"),
                    ("bc_src + j * kBcStep * bc_ss,\n                  s < n);",
                     "bc_src + j * kBcStep * bc_ss, false);"),
                    ("r[j] = lc_live && ls + j * kRowStep < n ?", "r[j] = false ?")]),
    "no_state_loads": ("the start states' loads: a constant instead", True,
                       [("h[k] = st_src[k ^ so];", "h[k] = 0.5f;")]),
    "no_output_stores": ("the stores of ddt and dx", True, [(_WRITE_OUT, "")]),
    "no_part_bc_stores": ("the block sums' stores to part_bc", True,
                          [("        bc_dst[i * kBcStep * 2 * kN] = tot;",
                            "        if (tot == 1234.5f) bc_dst[i * kBcStep * 2 * kN] = tot;")]),
    "no_walk": ("the backward pass: the recompute and its dC sums alone", True,
                [("for (int s0 = kStatesEvery - kLanes; s0 >= 0; s0 -= kLanes) {",
                  "for (int s0 = kStatesEvery - kLanes; s0 >= 0 && c < 0; s0 -= kLanes) {")]),
    "no_chunk_barrier": ("the barrier after each chunk (races: a diagnostic)", True,
                         [("    cp_async_wait_all();                    // chunk c - 1's copies "
                           "are in\n    __syncthreads();\n",
                           "    cp_async_wait_all();                    // chunk c - 1's copies "
                           "are in\n")]),
}
FLASH_SHAPE = (2, 4096, 64, 8, 128)        # jamba's attention layer, causal
SCAN_SHAPES = {"prefill": (2, 4096, 16384), "decode": (2, 1, 16384)}
# the parity witness: chip_smoke.py's jamba entry, weight seeds, and the
# swaps (scan library, flash library, function in place of ops.selective_scan)
PARITY_CONFIG = ("jamba-1.5-large-398b", 4)
PARITY_SEEDS = (0, 1, 2, 3, 4)


def scan_float64(dt, x, Bm, Cm, A, D, h0) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan step by step in float64, rounded once to float32:
    the witness's scan without float32 rounding."""
    dt, x, Bm, Cm, A, D, h = (t.double() for t in (dt, x, Bm, Cm, A, D, h0))
    ys = []
    for t in range(dt.shape[1]):
        h = h * torch.exp(dt[:, t, :, None] * A) + (dt[:, t] * x[:, t])[..., None] * \
            Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    return (torch.stack(ys, dim=1) + x * D).float(), h.float()


PARITY_SWAPS = {"committed kernels": ("source", "source", None),
                "scan with exp2f": ("accurate_exp2", "source", None),
                "scan plain float32": ("source", "source", sc.selective_scan_plain),
                "scan float64": ("source", "source", scan_float64),
                "flash hd-256 design": ("source", "hd256_kernel", None)}


def build(sources) -> dict[str, dict[str, ctypes.CDLL]]:
    """The committed ``sources`` (through _build) and every variant of
    them, one nvcc each, all at once."""
    _build.build(list(sources))
    libs = {src: {"source": _build.load(src)} for src in sources}
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        variants = ABLATIONS[src]
        text = (_build.CSRC / src).read_text()
        for name, (_, _, subs) in variants.items():
            vtext = text
            for old, new in subs:
                if vtext.count(old) != 1:
                    raise SystemExit(f"{src} / {name}: a substitution does not match "
                                     f"exactly once: {old!r}")
                vtext = vtext.replace(old, new)
            cu = OUT / f"{Path(src).stem}-{name}.cu"
            cu.write_text(vtext)
            so = cu.with_suffix(".so")
            procs.append((src, name, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, name, so, proc in procs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {src} / {name}:\n{log}")
        libs[src][name] = ctypes.CDLL(str(so))
    return libs


def in_turns(libs: dict, src: str, fn, reps: int, flush) -> dict[str, list[float]]:
    """Each library's time, the source's first, then again in reverse."""
    names = list(libs)
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for name in order:
            _build._libs[src] = libs[name]
            times[name].append(cs.median_us(lambda _: fn(), None, reps, flush))
    _build._libs[src] = libs["source"]
    return times


def flash_rows(libs: dict, flush) -> dict:
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, hd = FLASH_SHAPE
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).cuda().bfloat16()
               for sh in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    want = fa.attention_plain(q.float(), k.float(), v.float(), causal=True)
    limit = cs.FLASH_RTOL_BF16 * want.abs() + cs.FLASH_TOL_F32
    rows = {}
    for name, lib in libs.items():
        _build._libs[FLASH] = lib
        got = fa.flash_attention_cuda(q, k, v, causal=True).float()
        share = float(((got - want).abs() / limit).max())
        diagnostic = name != "source" and ABLATIONS[FLASH][name][1]
        if not diagnostic and not share <= 1.0:
            raise AssertionError(f"flash variant {name}: an element is {share} of its limit")
        rows[name] = {"share_of_limit": share}
    times = in_turns(libs, FLASH, lambda: fa.flash_attention_cuda(q, k, v, causal=True), 10,
                     flush)
    for name, t in times.items():
        rows[name]["us"] = t
    return rows


def scan_rows(libs: dict, flush) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {name: {} for name in libs}
    for what, (B, S, di) in SCAN_SHAPES.items():
        args = cs.scan_inputs(gen, B, S, di, "cuda", h0_scale=1.0)
        want = sc.selective_scan_plain(*args)
        for name, lib in libs.items():
            _build._libs[SCAN] = lib
            got = sc.selective_scan_cuda(*args)
            err = max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                      for g, w in zip(got, want))
            diagnostic = name != "source" and ABLATIONS[SCAN][name][1]
            if not diagnostic and not err <= cs.SCAN_RTOL:
                raise AssertionError(f"scan variant {name} at {what}: error {err}")
            rows[name][f"{what}_rel_err"] = err
        times = in_turns(libs, SCAN, lambda: sc.selective_scan_cuda(*args),
                         10 if what == "prefill" else 200, flush)
        for name, t in times.items():
            rows[name][f"{what}_us"] = t
    return rows


def scan_bwd_rows(libs: dict, flush) -> dict:
    """The scan's backward at jamba's prefill, x bf16, non-zero h0 and dh_T,
    from the forward kernel's states: every variant that is not diagnostic
    held to chip_smoke.scan_bwd_shares against the plain backward; each
    timed with Bm / Cm as slices of chip_smoke.py's narrow projection and
    of the train path's (TRAIN_DT_RANK + 32 columns)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    B, S, di = SCAN_SHAPES["prefill"]
    rows = {name: {} for name in libs}
    for layout, dt_rank in (("narrow", 8), ("train", cs.TRAIN_DT_RANK)):
        args = (*cs.scan_inputs(gen, B, S, di, "cuda", h0_scale=1.0, dt_rank=dt_rank),
                torch.randn((B, S, di), generator=gen, device="cuda"),
                torch.randn((B, di, 16), generator=gen, device="cuda"))
        states = sc.selective_scan_cuda(*args[:7], return_states=True)[2]
        if layout == "narrow":
            want = cs.scan_bwd_want(args)
            for name, lib in libs.items():
                _build._libs[SCAN_BWD] = lib
                got = sc.selective_scan_backward_cuda(*args, states=states)
                if name != "source" and ABLATIONS[SCAN_BWD][name][1]:
                    continue
                rows[name]["max_share_of_limit"] = cs.scan_bwd_shares(
                    got, want, f"variant {name}")["max_share_of_limit"]
            del want, got
        times = in_turns(libs, SCAN_BWD,
                         lambda: sc.selective_scan_backward_cuda(*args, states=states), 10,
                         flush)
        for name, t in times.items():
            rows[name][f"{layout}_us"] = t
        del args, states
        torch.cuda.empty_cache()
    return rows


def parity_rows(libs: dict) -> dict:
    """jamba's decode-vs-forward error (chip_smoke.decode_vs_forward) per
    weight seed, with the committed kernels and with each swap."""
    name, n_layers = PARITY_CONFIG
    cfg = dataclasses.replace(ARCHS[name], n_layers=n_layers)
    tokens = cs.lm_batch(cfg, "cuda")["tokens"][:, :cs.PARITY_TOKENS]
    errs = {what: [] for what in PARITY_SWAPS}
    for seed in PARITY_SEEDS:
        params = lmt.init_params(cfg, seed=seed, device="cuda")
        for what, (scan_lib, flash_lib, scan_fn) in PARITY_SWAPS.items():
            _build._libs[SCAN] = libs[SCAN][scan_lib]
            _build._libs[FLASH] = libs[FLASH][flash_lib]
            with mock.patch.object(ops, "selective_scan", scan_fn or ops.selective_scan):
                errs[what].append(cs.decode_vs_forward(cfg, params, tokens))
        del params
        torch.cuda.empty_cache()
    for src in (SCAN, FLASH):
        _build._libs[src] = libs[src]["source"]
    return {what: {"seeds": list(PARITY_SEEDS), "rel_err": e, "min": min(e),
                   "median": float(np.median(e)), "max": max(e),
                   "tolerance": cs.DECODE_RTOL}
            for what, e in errs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablation: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    parts = sys.argv[1:] or list(PARTS)
    if any(p not in PARTS for p in parts):
        raise SystemExit(f"kernel_ablation: parts are {list(PARTS)}, got {parts}")
    libs = build({src for p in parts for src in PARTS[p]})
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {"device": torch.cuda.get_device_name(0)}
    for kernel, rows in (("flash", flash_rows), ("scan", scan_rows),
                         ("scan_bwd", scan_bwd_rows)):
        if kernel not in parts:
            continue
        src = PARTS[kernel][0]
        out[kernel] = rows(libs[src], flush)
        for name, row in out[kernel].items():
            if name != "source":
                what, diagnostic, _ = ABLATIONS[src][name]
                row.update(undoes=what, diagnostic=diagnostic)
            print(f"{kernel} {name}: {json.dumps(row)}", flush=True)
    del flush
    if "parity" in parts:
        out["parity"] = {"config": list(PARITY_CONFIG), "tokens": cs.PARITY_TOKENS,
                         "swaps": parity_rows(libs)}
        for what, row in out["parity"]["swaps"].items():
            print(f"parity {what}: {json.dumps(row)}", flush=True)
    print(json.dumps({"kernel_ablation": out}), flush=True)
    return 0


# what each part of the run builds (its variants too)
PARTS = {"flash": (FLASH,), "scan": (SCAN,), "scan_bwd": (SCAN_BWD,),
         "parity": (SCAN, FLASH)}


if __name__ == "__main__":
    sys.exit(main())
