#!/usr/bin/env python3
"""Time five of the port's kernels against variants of their own sources
on one NVIDIA GPU, each variant undoing one design step or trying one
alternative, and read jamba's decode-vs-forward error with each kernel
swapped in turn.

    python3 kernel_ablation.py [flash] [flash_bwd] [scan] [scan_bwd] [bmm] [bmm_scalar]
                               [parity]

The kernels are the bf16 flash forward at head_dim <= 128
(`csrc/flash_attention_sm90.cu`: `flash_sm90_hd64_kernel` for hd <= 64,
`flash_sm90_narrow_kernel` for hd 65 .. 128), the bf16 flash backward at
head_dim <= 64 (`csrc/flash_attention_bwd_sm90.cu`: `dkdv_hd64_kernel` and
`dq_hd64_kernel`), Mamba's selective scan (`csrc/selective_scan.cu`) and
its backward (`csrc/selective_scan_bwd.cu`), and the fixed-order batched
product: `bmm` times `csrc/batched_matmul.cu` with one FMA in place of its
multiply and add, its k loop run twice or not at all, its staging's global
reads or its store removed (diagnostic), at one block a unit, with each
thread's columns contiguous and with the rows class's earlier 128 x 64
tile at TM = 8; `bmm_scalar` times its first
design (`csrc/batched_matmul_scalar.cu`) with its staging's global loads,
its k loop or its store removed (all diagnostic).  Both load each library
in turn as the wrapper's, at layer 0 of local training, (100, 16, 64) @
(100, 64, 64), and its dY @ B^T (b a transposed view), at the shared eval
batch, (1024, 64) @ (100, 64, 64), and at the eval's layer 1, (100, 1024,
64) @ (100, 64, 32); every library that is not diagnostic is held bit for
bit to the plain version.
Each variant is the committed source with one text substitution
(ABLATIONS) that undoes one design step or tries one alternative, built
with `nvcc` like the source itself into `build/ablation/` (each compiler
log beside its library); the script refuses to run if a substitution no
longer matches.  Variants marked `diagnostic` compute a wrong result on
purpose (they show where the time goes) and are not checked; every other
variant is held to the check its kernel is held to in `chip_smoke.py`,
with its tolerances (flash per element within FLASH_RTOL_BF16 |want| +
FLASH_TOL_F32 of the float32 plain version; its backward per element
within FLASH_RTOL_BF16 |want| + FLASH_BWD_ATOL_BF16 max |want| of the
float32 plain backward; the scan within SCAN_RTOL
max(1, max |want|) of the plain version; its backward by
`chip_smoke.scan_bwd_shares` against the plain backward).  Times are
`chip_smoke.median_us` medians (CUDA events, each call after a 128 MiB
write to flush L2), taken in turns (the source, each variant, then back in
reverse order): flash at jamba's attention layer (2, 4096, 64 / 8, 128)
causal and at whisper-large-v3's three (`chip_smoke.FLASH_WHISPER_SHAPES`:
the encoder (16, 1500, 20 / 20, 64), the cross-attention 448 x 1500 and
the causal decoder (16, 448), hd 64), each flash row with the registers a
thread and the spill stores ptxas reports for every kernel instance of
its library; the scan at jamba's Mamba prefill (2, 4096, 16384, 16) and
decode (2, 1, 16384, 16), and its backward at the prefill with x in bf16,
non-zero h0 and dh_T, from the forward's states, with Bm / Cm as slices
of a narrow projection and of the train path's (TRAIN_DT_RANK + 32
columns).  The flash variants of the hd-64 kernel: its earlier path (the
narrow kernel at hd 64), one CTA an SM, each tile's S issued in turn,
the idle warpgroup kept, one or four partial chains, 128-key tiles, no
slack before the exponent reference moves; the diagnostic ones drop P's
low term, the softmax or the exponentials.  The flash backward's, at
whisper's three shapes from the forward kernel's L: the hd-64 pair's dK /
dV, dQ and delta launches timed apart (diagnostic: the others removed);
the template at hd 64 (dkdv_kernel<1> / dq_kernel<1>, the earlier path)
and, on it, (a) its dV / dK wgmmas without their runtime condition, (b)
without the barrier after each tile, (c) at two CTAs an SM, and its dK /
dV and dQ launches apart; on the pair, one dQ CTA an SM, K and V read
from shared memory by every tile's products, three stages; the diagnostic
ones drop the low terms of P and dS or the exponentials.

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
from repro_torch.kernels import batched_matmul as bm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as sc
from repro_torch.models import transformer as lmt

OUT = Path(__file__).resolve().parent / "build" / "ablation"
FLASH, SCAN, SCAN_BWD = ("flash_attention_sm90.cu", "selective_scan.cu",
                         "selective_scan_bwd.cu")
FLASH_BWD = "flash_attention_bwd_sm90.cu"
# the batched product: the library the wrapper loads, and the first design
BMM, BMM_SCALAR = "batched_matmul.cu", "batched_matmul_scalar.cu"
# the warpgroups taking turns to start their products (FA3's ping-pong, as
# in flash_sm90_kernel), put back into the narrow kernel
_TURNS = ('  auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + cw) '
          ': "memory"); };\n  auto your_turn = [&]() { asm volatile("bar.arrive %0, '
          '256;\\n" ::"r"(4 - cw) : "memory"); };\n  if (cw == 1) your_turn();\n')
# the hd-64 kernel's walk over its tiles: S_{t+1} issued behind P_t V_t,
# and each tile in turn
_LOOKAHEAD = """  issue_s(t_lo);
  for (int t = t_lo; t < t_hi; ++t) {
    tile(t);
    issue_s(t + 1);                                // behind P_t V_t
    wgmma_wait_all_but_last();                     // P_t V_t
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    release_v(t, (t - t_lo) % kStg);
  }
  tile(t_hi);
  wgmma_wait_all();
  fence_regs(o);
"""
_IN_ORDER = """  for (int t = t_lo; t <= t_hi; ++t) {
    issue_s(t);
    tile(t);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    release_v(t, (t - t_lo) % kStg);
  }
"""
# source -> {variant: (what it undoes, diagnostic, [(old, new), ...])}
ABLATIONS = {
    FLASH: {
        "hd256_kernel": (
            "the hd <= 128 designs: the hd-256 kernel (64-key tiles, 2 stages, no "
            "intra-warpgroup overlap, the warpgroups taking turns) runs hd 64 and 128", False,
            [("  if (kernel == 0 && nch == 1)\n"
              "    return {(const void*)flash_sm90_hd64_kernel, (int)Hd64Smem<kHd64Keys>::bytes};",
              "  if (kernel == 0 && nch == 1)\n"
              "    return {(const void*)flash_sm90_kernel<1>, (int)Smem<1>::bytes};"),
             ("    return {(const void*)flash_sm90_narrow_kernel<2>, (int)NarrowSmem<2>::bytes};",
              "    return {(const void*)flash_sm90_kernel<2>, (int)Smem<2>::bytes};"),
             ("const int keys = kernel == 0 ? kHd64Keys : kernel == 1 ? kNarrowKeys : kKeys;",
              "const int keys = kKeys;")]),
        "narrow_kernel_at_hd64": (
            "the hd-64 kernel: the narrow kernel at NCH = 1 runs hd <= 64 (one CTA an SM, "
            "each warpgroup's softmax under its own products)", False,
            [("    return {(const void*)flash_sm90_hd64_kernel, (int)Hd64Smem<kHd64Keys>::bytes};",
              "    return {(const void*)flash_sm90_narrow_kernel<1>, (int)NarrowSmem<1>::bytes};"),
             ("const int keys = kernel == 0 ? kHd64Keys : kernel == 1 ? kNarrowKeys : kKeys;",
              "const int keys = kernel == 2 ? kKeys : kNarrowKeys;")]),
        "one_cta_an_sm": (
            "two CTAs an SM in the hd-64 kernel: one (each CTA asks for 120 KB more shared "
            "memory)", False,
            [("(int)Hd64Smem<kHd64Keys>::bytes}", "(int)Hd64Smem<kHd64Keys>::bytes + 120 * 1024}")]),
        "in_order": (
            "S_{t+1} issued behind P_t V_t (hd-64 kernel): each tile's S issued after the "
            "previous tile's product is in",
            False, [(_LOOKAHEAD, _IN_ORDER)]),
        "idle_warpgroup_runs": (
            "the early return of a warpgroup whose rows all lie past Sq (hd-64 kernel)", False,
            [("  const int busy = q_lo + 64 / G <= q_hi ? 2 : 1;", "  const int busy = 2;")]),
        "one_chain_sums": (
            "two partial chains a row for the max and the sum (hd-64 kernel): one chain",
            False, [("constexpr int kHd64Chains = 2;", "constexpr int kHd64Chains = 1;")]),
        "four_chain_sums": (
            "two partial chains a row for the max and the sum (hd-64 kernel): four",
            False, [("constexpr int kHd64Chains = 2;", "constexpr int kHd64Chains = 4;")]),
        "keys_128": ("64-key tiles in the hd-64 kernel: 128-key tiles", False,
                     [("constexpr int kHd64Keys = 64;", "constexpr int kHd64Keys = 128;")]),
        "no_slack": (
            "the slack of 8 (log2 units) before a row's exponent reference moves (hd-64 "
            "kernel): O and l rescaled whenever the row max grows", False,
            [("constexpr float kHd64Slack = 8.f;", "constexpr float kHd64Slack = 0.f;")]),
        "stages_3": ("two stages: a ring of three", False,
                     [("constexpr int kNarrowStages = 2;", "constexpr int kNarrowStages = 3;")]),
        "ping_pong": (
            "no turns in the narrow kernel: the two warpgroups take turns to start their "
            "products", False,
            [("  float s[64];\n  uint32_t p_hi[32], p_lo[32];\n",
              "  float s[64];\n  uint32_t p_hi[32], p_lo[32];\n" + _TURNS),
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
            [("write_rows<NCH, true>(", "write_rows<NCH, false>("),
             ("write_rows<1, true>(", "write_rows<1, false>(")]),
        "one_p_term": ("P's low bf16 term (fails the per-element check)", True,
                       [("    wgmma_pv<NCH>(o, p_lo + 4 * kk, dv);\n", "")]),
        "no_softmax": (
            "the softmax: its time beside the products'", True,
            [("float2 online_softmax(float (&s)[64], Rows& r, const Params& a,\n"
              "                                                 int k0, int q_lo, int q_hi) {\n",
              "float2 online_softmax(float (&s)[64], Rows& r, const Params& a,\n"
              "                                                 int k0, int q_lo, int q_hi) {\n"
              "  if (k0 >= 0) return make_float2(1.f, 1.f);\n"),
             ("  constexpr int N = K / 2, C = kHd64Chains;\n",
              "  constexpr int N = K / 2, C = kHd64Chains;\n"
              "  if (k0 >= 0) return make_float2(1.f, 1.f);\n")]),
        "no_exponentials": (
            "the exponentials, each replaced by an FMA: the special-function units' "
            "share", True,
            [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
              "y = fmaf(x, 0.999f, 1.0f);")]),
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
# the bf16 flash backward at hd <= 64: the hd-64 pair, and the template
# (dkdv_kernel<1> / dq_kernel<1>, the earlier path) at hd 64 with each of
# its costs removed in turn; each pair's dK / dV and dQ kernels timed apart
_TEMPLATE_AT_HD64 = [
    ("    c = {(const void*)dkdv_hd64_kernel, (int)Kv64Smem::bytes, (const void*)dq_hd64_kernel,\n"
     "         (int)Q64Smem::bytes, kKeys64};\n"
     "    if (m) c.kk = &m->k128, c.kv = &m->v128, c.qk = &m->k64, c.qv = &m->v64;\n",
     "    c = {(const void*)dkdv_kernel<1>, (int)KvSmem<1>::bytes, (const void*)dq_kernel<1>,\n"
     "         (int)QSmem<1>::bytes, kKeys};\n"
     "    if (m) c.kk = &m->k64, c.kv = &m->v64, c.qk = &m->k32, c.qv = &m->v32;\n")]
_NO_DQ = [("    cudaLaunchKernel(c.dq, dim3(a.nt, a.Hkv, B), dim3(kThreads), args, c.q_bytes, "
           "stream);\n", "")]
_NO_DKDV = [("    cudaLaunchKernel(c.dkdv, dim3((a.Sk + c.keys - 1) / c.keys, a.Hkv, B), "
             "dim3(kThreads),\n                     args, c.kv_bytes, stream);\n", "")]
ABLATIONS[FLASH_BWD] = {
    "dkdv_only": ("the dQ launch: delta and dK / dV alone", True, _NO_DQ),
    "dq_only": ("the dK / dV launch: delta and dQ alone", True, _NO_DKDV),
    "delta_only": ("the dK / dV and dQ launches: delta (and the L / Delta tiles) alone",
                   True, _NO_DQ + _NO_DKDV),
    "template_at_hd64": (
        "the hd-64 pair: the template at NCH = 1 (64 keys a dK / dV CTA shared by both "
        "warpgroups through shared memory, 32-key dQ tiles) runs hd <= 64", False,
        _TEMPLATE_AT_HD64),
    "template_dkdv_only": ("the template at hd 64, its dQ launch removed", True,
                           _TEMPLATE_AT_HD64 + _NO_DQ),
    "template_dq_only": ("the template at hd 64, its dK / dV launch removed", True,
                         _TEMPLATE_AT_HD64 + _NO_DKDV),
    "template_both_warpgroups": (
        "(a) the template at hd 64 with no runtime condition around its dV / dK wgmmas: "
        "the second warpgroup runs them on a box past hd", True,
        _TEMPLATE_AT_HD64 + [("        if (NCH % 2 == 0 || c < NCH) {",
                              "        if (true) {")]),
    "template_no_tile_barrier": (
        "(b) the template at hd 64 without the barrier after each tile's dV / dK (the "
        "ring refilled while the other warpgroup reads it)", True,
        _TEMPLATE_AT_HD64 + [("    // both warpgroups are done with stage st and with P^T, "
                              "dS^T\n    asm volatile(\"bar.sync 1, 256;\\n\" ::: "
                              "\"memory\");\n", "")]),
    "template_two_ctas": (
        "(c) the template at hd 64 at two CTAs an SM (its dK / dV CTA's 80 KB and dQ "
        "CTA's 48 KB fit twice)", False,
        _TEMPLATE_AT_HD64 + [
            ("__global__ void __launch_bounds__(kThreads, 1)\ndkdv_kernel(",
             "__global__ void __launch_bounds__(kThreads, NCH == 1 ? 2 : 1)\ndkdv_kernel("),
            ("__global__ void __launch_bounds__(kThreads, 1)\ndq_kernel(",
             "__global__ void __launch_bounds__(kThreads, NCH == 1 ? 2 : 1)\ndq_kernel(")]),
    "dq_one_cta": ("two dQ CTAs an SM (at most 128 registers): one", False,
                   [("constexpr int kDq64CtasPerSm = 2;", "constexpr int kDq64CtasPerSm = 1;")]),
    "kv_from_shared": ("K and V as S^T's and dP^T's A operand from registers: read from "
                       "shared memory by every tile's wgmmas", False,
                       [("    issue_frags64(s, kf, q_st);\n"
                         "    issue_frags64(dp, vf, g_st);\n",
                         "    issue_rows64(s, k_rows, q_st);\n"
                         "    issue_rows64(dp, v_rows, g_st);\n")]),
    "stages_3": ("two stages of the hd-64 rings: three", False,
                 [("constexpr int kStages64 = 2;", "constexpr int kStages64 = 3;")]),
    "one_term": ("the low bf16 terms of P and dS (fails the per-element check)", True,
                 [("    wgmma_rs_tb(d, lo + 4 * kk, db);\n", "")]),
    "no_exponentials": ("the exponentials, each replaced by an FMA: the SFUs' share", True,
                        [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                          "y = fmaf(x, 0.999f, 1.0f);")]),
}
# the batched product's first design (csrc/batched_matmul_scalar.cu) with its
# staging's global loads, its k loop or its store removed; every variant is a
# diagnostic (it computes a wrong result on purpose)
ABLATIONS[BMM_SCALAR] = {
    "no_staging_loads": (
        "the staging's global loads: the shared tiles filled with a constant", True,
        [("                     ? ab[(long long)(row0 + i) * sam + (long long)(k0 + k) * sak]\n",
          "                     ? 1.0f\n"),
         ("                     ? bb[(long long)(k0 + k) * sbk + (long long)(col0 + j) * sbn]\n",
          "                     ? 1.0f\n")]),
    "no_k_loop": (
        "the k loop: the sums stay zero (staging and store kept)", True,
        [("    for (int k = 0; k < kc; ++k) {      // only the chunk's real terms, in order\n"
          "      const float bv = b_s[k][tx];\n"
          "#pragma unroll\n"
          "      for (int r = 0; r < RPT; ++r)\n"
          "        acc[r] = __fadd_rn(acc[r], __fmul_rn(a_s[ty + r * RT][k], bv));\n"
          "    }\n", "")]),
    "no_store": (
        "the store: computed, never written (a condition that never holds)", True,
        [("    if (row < M) cb[(long long)row * N + col] = acc[r];\n",
          "    if (M < 0) cb[(long long)row * N + col] = acc[r];\n")]),
}
# the batched product's current design: its FP32 issue (one FMA in place of
# the multiply and the add: other bits), its k loop run twice or not at all,
# its staging's global reads or its store removed (diagnostic), and two
# design choices undone (not diagnostic: the same bits)
_BMM_TERMS = (("4 * j", "x"), ("4 * j + 1", "y"), ("4 * j + 2", "z"), ("4 * j + 3", "w"))
_BMM_SRC = (Path(__file__).resolve().parent / "src/repro_torch/kernels/csrc" / BMM).read_text()
_BMM_LOOP = _BMM_SRC[_BMM_SRC.index("    for (int k = 0; k < kc4; k += 4) {\n"):
                     _BMM_SRC.index("    if (cur.ch == nch - 1) {")]
ABLATIONS[BMM] = {
    "fma": ("the separate multiply and add: one FMA a multiply-add (other bits), the "
            "FP32 issue halved", True,
            [(f"            acc[r][{i}] = __fadd_rn(acc[r][{i}], __fmul_rn(x, bv[j].{c}));\n",
              f"            acc[r][{i}] = fmaf(x, bv[j].{c}, acc[r][{i}]);\n")
             for i, c in _BMM_TERMS]),
    "k_loop_twice": ("the k loop run twice over the same shared tiles: the second run is "
                     "the loop's own cost (other bits)", True, [(_BMM_LOOP, _BMM_LOOP * 2)]),
    "no_k_loop": ("the k loop: staging, barriers and the store of zeros alone", True,
                  [(_BMM_LOOP, "")]),
    "no_staging_reads": (
        "the staging's global reads: every piece zero-filled, every register load a "
        "constant", True,
        [("      cp_async16(dst + r * ld + c, n ? src + gr * sr + gc : src, 4 * n);\n",
          "      cp_async16(dst + r * ld + c, src, 0 * n);\n"),
         ("            v[u] = *reinterpret_cast<const float4*>(g);\n",
          "            v[u] = make_float4(1.f, 1.f, 1.f, 1.f);\n"),
         ("      cp_async4(dst + r * ld + c, in ? src + gr * sr + gc * sc : src, in ? 4 : 0);\n",
          "      cp_async4(dst + r * ld + c, src, 0);\n")]),
    "no_store": ("the store: computed, never written (a condition that always holds "
                 "skips it)", True,
                 [("          if (row >= M || col >= N) continue;\n",
                   "          if (M >= 0) continue;\n")]),
    "one_unit_a_block": (
        "the walk over several units a block: one block a unit (every shared a "
        "restaged)", False,
        [("  const unsigned grid = static_cast<unsigned>(units < resident[dev] ? units : "
          "resident[dev]);\n", "  const unsigned grid = static_cast<unsigned>(units);\n")]),
    "contiguous_columns": (
        "a thread's TN / 4 column groups 4 * TX apart: its TN columns contiguous (two "
        "shared-memory wavefronts a 16-byte load of b at TN = 8)", False,
        [("    const float* bs = b_s + (s & 1) * kChunkK * kLdB + tx * 4;\n",
          "    const float* bs = b_s + (s & 1) * kChunkK * kLdB + tx * TN;\n"),
         ("(bs + (k + q) * kLdB + j * 4 * TX);\n", "(bs + (k + q) * kLdB + 4 * j);\n"),
         ("          const int col = cur.ct * BN + j * 4 * TX + tx * 4;\n",
          "          const int col = cur.ct * BN + tx * TN + 4 * j;\n")]),
    "tile_128x64_tm8": ("the 64 x 64 tile at TM = 4, TN = 8 in the rows class: 128 x 64 "
                        "at TM = 8, TN = 4 (256 threads, 128-row units)", False,
                        [("      err = launch<64, 64, 4, 8>(",
                          "      err = launch<128, 64, 8, 4>(")]),
}
# jamba's attention layer and whisper-large-v3's three: (B, Sq, Sk, Hq, Hkv,
# hd), causal
FLASH_SHAPES = {"jamba (2, 4096, 64 / 8, 128) causal": ((2, 4096, 4096, 64, 8, 128), True),
                **cs.FLASH_WHISPER_SHAPES}
SCAN_SHAPES = {"prefill": (2, 4096, 16384), "decode": (2, 1, 16384)}
# the batched product at layer 0 of local training (and its dY @ B^T, b a
# transposed view), at the shared eval batch and at the eval's layer 1
BMM_SHAPES = {what: cs.BMM_SHAPES[what] for what in
              ("layer 0 (100, 16, 64) @ (100, 64, 64)",
               "eval (1024, 64) shared @ (100, 64, 64)",
               "eval layer 1 (100, 1024, 64) @ (100, 64, 32)")}
BMM_SHAPES["layer 0: dY @ B^T"] = BMM_SHAPES["layer 0 (100, 16, 64) @ (100, 64, 64)"]
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
    """Each flash variant at FLASH_SHAPES: checked per element against the
    float32 plain version unless diagnostic, timed in turns, with the
    registers a thread and the spill stores ptxas reports for each of the
    source's kernel instances."""
    rng = np.random.default_rng(0)
    rows = {name: {"ptxas": cs.ptxas_entries(_log(lib))} for name, lib in libs.items()}
    for what, ((B, Sq, Sk, Hq, Hkv, hd), causal) in FLASH_SHAPES.items():
        q, k, v = cs.qkv(rng, B, Sq, Hq, Hkv, hd, torch.bfloat16, "cuda", Sk=Sk)
        want = fa.attention_plain(q.float(), k.float(), v.float(), causal=causal)
        limit = cs.FLASH_RTOL_BF16 * want.abs() + cs.FLASH_TOL_F32
        for name, lib in libs.items():
            _build._libs[FLASH] = lib
            print(f"flash {name} at {what}", file=sys.stderr, flush=True)
            got = fa.flash_attention_cuda(q, k, v, causal=causal).float()
            torch.cuda.synchronize()
            share = float(((got - want).abs() / limit).max())
            diagnostic = name != "source" and ABLATIONS[FLASH][name][1]
            if not diagnostic and not share <= 1.0:
                raise AssertionError(f"flash variant {name} at {what}: an element is "
                                     f"{share} of its limit")
            rows[name].setdefault("share_of_limit", {})[what] = share
        del want, limit, got
        times = in_turns(libs, FLASH, lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
                         10 if Sq >= 4096 else 20, flush)
        for name, t in times.items():
            rows[name].setdefault("us", {})[what] = t
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def flash_bwd_rows(libs: dict, flush) -> dict:
    """Each variant of the bf16 flash backward at whisper's three shapes
    (chip_smoke.FLASH_WHISPER_SHAPES), from the forward kernel's output and
    L: checked per element against the float32 plain backward at
    chip_smoke.py's limits unless diagnostic, timed in turns, with the
    registers a thread and the spill stores ptxas reports for each kernel
    instance of its library."""
    rng = np.random.default_rng(1)
    rows = {name: {"ptxas": cs.ptxas_entries(_log(lib))} for name, lib in libs.items()}
    for what, ((B, Sq, Sk, Hq, Hkv, hd), causal) in cs.FLASH_WHISPER_SHAPES.items():
        q, k, v = cs.qkv(rng, B, Sq, Hq, Hkv, hd, torch.bfloat16, "cuda", Sk=Sk)
        dout = torch.from_numpy(rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
                                ).to("cuda", torch.bfloat16)
        out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        want = fa.attention_backward_plain(q.float(), k.float(), v.float(), out.float(),
                                           dout.float(), causal=causal)
        limits = [cs.FLASH_RTOL_BF16 * w.abs() + cs.FLASH_BWD_ATOL_BF16 * float(w.abs().max())
                  for w in want]

        def call():
            return fa.flash_attention_backward_cuda(q, k, v, out, dout, causal=causal,
                                                    lse=lse)
        for name, lib in libs.items():
            _build._libs[FLASH_BWD] = lib
            print(f"flash_bwd {name} at {what}", file=sys.stderr, flush=True)
            got = call()
            torch.cuda.synchronize()
            share = max(float(((g.float() - w).abs() / lim).max())
                        for g, w, lim in zip(got, want, limits))
            diagnostic = name != "source" and ABLATIONS[FLASH_BWD][name][1]
            if not diagnostic and not share <= 1.0:
                raise AssertionError(f"flash backward variant {name} at {what}: an element "
                                     f"is {share} of its limit")
            rows[name].setdefault("share_of_limit", {})[what] = share
        del want, limits, got
        times = in_turns(libs, FLASH_BWD, call, 10, flush)
        for name, t in times.items():
            rows[name].setdefault("us", {})[what] = t
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return rows


def _log(lib: ctypes.CDLL) -> str:
    """The compiler log (``-Xptxas -v``) written beside a built library."""
    return Path(lib._name).with_suffix(".log").read_text()


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


def bmm_rows(libs: dict, flush, src: str) -> dict:
    """Each batched-product library of ``libs`` (``src`` and its variants),
    loaded in turn as the wrapper's, at BMM_SHAPES: the source held bit for
    bit to the plain version, and every variant that is not diagnostic;
    all timed in turns."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = {name: {} for name in libs}
    try:
        for what, (sa, sb) in BMM_SHAPES.items():
            a = torch.randn(sa, generator=gen, device="cuda")
            b = torch.randn(sb, generator=gen, device="cuda")
            if what.endswith("dY @ B^T"):
                a, b = torch.randn((sb[0], sa[1], sb[2]), generator=gen,
                                   device="cuda"), b.transpose(1, 2)
            for name, lib in libs.items():
                if name == "source" or not ABLATIONS[src][name][1]:
                    _build._libs[BMM] = lib
                    cs.check_bmm(a, b, f"{src} / {name} at {what}")
            times = in_turns(libs, BMM, lambda: bm.batched_matmul_cuda(a, b), 200, flush)
            for name, t in times.items():
                rows[name][f"{what} us"] = t
    finally:
        _build._libs.pop(BMM, None)       # the wrapper's own library again
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
    for kernel, rows in (("flash", flash_rows), ("flash_bwd", flash_bwd_rows),
                         ("scan", scan_rows), ("scan_bwd", scan_bwd_rows),
                         ("bmm", lambda libs, flush: bmm_rows(libs, flush, BMM)),
                         ("bmm_scalar", lambda libs, flush: bmm_rows(libs, flush, BMM_SCALAR))):
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
PARTS = {"flash": (FLASH,), "flash_bwd": (FLASH_BWD,), "scan": (SCAN,),
         "scan_bwd": (SCAN_BWD,), "bmm": (BMM,), "bmm_scalar": (BMM_SCALAR,),
         "parity": (SCAN, FLASH)}


if __name__ == "__main__":
    sys.exit(main())
