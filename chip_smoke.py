#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (the script then exits non-zero):

1. kernels — builds every CUDA source of the port (`nvcc`, sm_90a, one
   process per source, all at once; both flash kernels and the selective
   scan must compile without register spills, and so must the bf16 flash
   backward's hd-64 kernels; the other backward kernels' spill
   counts are printed and reported) and holds each kernel against its
   plain PyTorch version on the card:
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
     limit; the bf16 kernel also at the attention layers of jamba (2,
     4096, 64 / 8, 128), grok (2, 4096, 48 / 8, 128) and llama4 (2, 4096,
     40 / 8, 128, window 8192), where G = 6 and 5 leave the last of a
     block's 128 rows empty, each timed beside its bound, the plain
     version and `is_causal` SDPA; and at Sq != Sk (keys 0..Sk-1 against
     queries 0..Sq-1, the decoder's cross-attention): the bf16 kernel at
     whisper-large-v3's encoder self-attention (16, 1500, 20 / 20, 64),
     cross-attention (16, 448 x 1500) and causal decoder self-attention
     (16, 448), the float32 kernel at the cross shape, both at Sq = 1 x
     1500, ragged 37 x 300 and 300 x 37 (causal, and with window 100,
     where rows have no live key), and the bf16 kernel at hd 128 and 256
     with G = 4, each at its limit above and its L against the plain
     log-sum-exp; the three whisper shapes timed beside their bound, the
     plain version and SDPA (no mask, or `is_causal`), each row with the
     registers a thread and the CTAs an SM of the kernel that ran
     (`sm90_occupancy`: hd <= 64 runs `flash_sm90_hd64_kernel`, which must
     fit the two CTAs an SM it is laid out for; the hd-128 rows too);
   * the RWKV6 wkv recurrence, at the LM path's (2, 40, 4096, 64) (the
     chunked form), with the model's strong decays w = exp(-exp(x)), at a
     ragged T = 1000, at T = 1, 16 and 63 (the recurrent kernel, also
     timed at the decode shape (2, 40, 1, 64) and at a prompt's length,
     (2, 40, 16, 64), beside the launch floors), two halves and a split at
     1001 against the whole, and w = 0 (atol 1e-4; w = 0 must leave
     exactly the last k v^T);
   * Mamba's selective scan (`csrc/selective_scan.cu`, no Pallas
     counterpart: the reference's `lax.scan`) at jamba's prefill (2, 4096,
     16384, 16) with the model's decays (dt from softplus around 0.01), x
     in bf16 and in float32, strong decays (dt up to 5), split at 1001
     against the whole, at a ragged S = 1000, at decode's S = 1 from a
     non-zero state and on both sides of the switch between the kernel's
     decode and chunked forms (S = DECODE_MAX_S and DECODE_MAX_S + 1), y
     and h_T within SCAN_RTOL max(1, max |want|); one
     call must make one device launch (where torch.profiler records the
     call: in this phase it often records nothing, which is reported and
     does not stop the run); timed at the prefill and at decode
     beside the launch floors (decode also after a clean-L2 flush), its
     bound the larger of its bytes, its
     exponentials on the SFUs and its other flops;
   * the flash backward (three launches counted as one, each dtype with
     the L its forward wrote: bf16 in `csrc/flash_attention_bwd_sm90.cu` on
     wgmma, float32 in `csrc/flash_attention_bwd.cu` on mma.sync in
     3xTF32) at the LM path's
     (2, 4096, 8 / 4, 256), window 1024 and causal global, in bf16 and
     float32, and at ragged (1, 1000, 4, 2, 64), G = 8 with window 100,
     hd 120, non-causal hd 128, G = 16, G = 5, hd 128 with window 100 and
     hd 256 at S = 333 with a window edge inside a tile: float32 within
     FLASH_BWD_RTOL_F32 max |want| per gradient, bf16 per element against
     the float32 plain backward of the same inputs (FLASH_RTOL_BF16 |want|
     + FLASH_BWD_ATOL_BF16 max |want|); the forward's L against the plain
     log-sum-exp; timed beside its bound, the plain backward and SDPA's
     backward (band mask and, causal, `is_causal`), and both forwards
     timed with and without writing L; the bf16 kernel also at
     whisper-large-v3's three attention shapes at hd 64 (the encoder
     (16, 1500, 20 / 20), the cross-attention 448 x 1500 and the causal
     decoder (16, 448)), from the L the hd-64 forward writes, through the
     hd-64 kernels (`bwd_sm90_plan`), checked and timed the same way, each
     row with their registers and CTAs an SM; both kernels at
     FLASH_CROSS_CASES' Sq != Sk in both dtypes (rows with no live key
     take P = 1 / Sk on every key); every check also holds two calls bit
     for bit;
   * the wkv backward (`csrc/rwkv6_scan_bwd.cu`, chunk-parallel in time
     from the states the forward stores) at (2, 40, 4096, 64) with the
     model's decays and a non-zero s0 and dS_T, at T = 1000, 1, 63, 64,
     65, hd 16 and 32 and w = 0, every gradient within 1e-4 max(1,
     max |want|); timed as the train path calls it (states from the
     forward) and with the forward's states pass, and the wkv forward
     timed with and without storing the states;
   * the selective scan's backward (`csrc/selective_scan_bwd.cu`: each
     8-step span's states and exponentials recomputed into registers from
     the state the forward kernel stores there, then walked backward with
     each exponential reused; a second launch sums the per-block partials
     of dB, dC, dA, dD in a fixed order) at jamba's (2, 4096, 16384, 16)
     with x bf16 and float32, the model's and strong decays and non-zero h0
     and dh_T, at S = 1000, 1, 4, 5 (either side of the decode form), 15,
     16, 17 (of the forward's 16-step chunk) and 63, 64, 65: every
     gradient within SCAN_BWD_RTOL max(1, max |want|) of the plain
     backward, dx in bf16 per element against the float32 plain dx within
     FLASH_RTOL_BF16 |want| more, two calls bit for bit; timed at the main
     shape from the forward's states beside its bound (bytes, one
     exponential a state a step, SCAN_BWD_FLOPS_PER_STATE flops) and the
     plain backward, and again with Bm / Cm as slices of the train path's
     (B, S, TRAIN_DT_RANK + 32) projection (the same gradients, bit for
     bit); the forward timed storing the states;
   * the shapes only the baselines' and the paper's paths give the
     kernels: the flat strategies' masked mean (cluster_agg at C = 1,
     zero-weight rows holding NaN) at (100, 6570) and at Table II's
     (20, 17226) and (20, 23076), BFLN's cluster means there at C = 2 / 5 /
     7, all bit for bit; the fingerprint of those (20, N) rows at every
     forced cluster size, on and off the 16-byte grid, bit for bit; the
     Pearson matrix of (20, 64) prototypes within 1e-5, exactly symmetric;
   * the mesh path's shapes: the fingerprint of one shard's rows, (25,
     6570) at S = 4, (34, 6570) at S = 3 and (4, 6570) a flush at S = 4,
     at every forced cluster size, and cluster_agg at the padded cohort's
     (102, 6570) with two zero-weight rows holding NaN, bit for bit against
     the plain version and, sliced to 100, against the (100, 6570) call on
     the real rows; timed beside the bound (cluster_agg beside
     `torch.matmul` too);
   * the fixed-order batched product (`csrc/batched_matmul.cu`, no Pallas
     counterpart: the client-stacked products the reference leaves to
     XLA) bit for bit against its plain version at ExperimentSpec()'s
     forward (100 x (16 x 64) @ (64 x 64), (64 x 32), (32 x 10)) and the
     eval round's three products over the shared batch ((1024 x 64) @ 100
     x (64 x 64), then 100 x (1024 x 64) @ (64 x 32) and (1024 x 32) @ (32
     x 10)), each product's backward forms through transposed views (and
     an expanded gradient), 25 and 34 of the 100 clients equal to their
     rows of the whole call, FedProto's class sums, ragged tiles, K = 1,
     signed zeros and `BatchedMatmulFn`'s gradients; timed at those six
     shapes and the training shapes' backward forms beside both bounds
     (the FMA rate and half of it, which this arithmetic can reach), the
     plain version, `torch.bmm` / `torch.matmul` (cuBLAS) and the kernel's
     first design (`csrc/batched_matmul_scalar.cu`) in turns;
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
   pass `verify_bank` and answer mixed-cluster requests.  The batched
   product's launches a round are reported, and the same spec runs four
   more times in turns with the client-stacked products through cuBLAS
   and through the kernel (`bmm_route_compare`: round and local-training
   p50 of each route, information).
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
7. obs — the port's flight recorder at the defaults on the card, sync
   and async, each run three ways, twice each in turns (OBS_ORDER):
   untraced (a host clock around each span, no wait for the card), traced
   (`ObsSpec(enabled=True)`, trace and Chrome export; every span waits for
   its kernels), traced without `block_until_ready`, and RoundTimer's
   drained spans.  All end on the same digests; every trace
   line passes the port's `validate_trace_lines`, its sha256 is the
   manifest's, every name is registered in `obs/names.py`, and the runs
   report no `compile` event (every library was loaded before them); each
   kernel of the path launched.  The p50 of every `round.*`, `flush.*`
   and `step.*` span is set beside RoundTimer's drained p50, of this phase
   and of the train and async phases; the phase fails if a traced `round.step` /
   `flush.step` p50 is below OBS_STEP_FLOOR of the drained one.  Then a
   traced 2-round run in a fresh process (its `compile` events must name
   exactly the cluster_agg, fingerprint and Pearson sources, once each),
   a run with `profile_dir` (its `torch_trace.json` must hold those three
   kernels' events), and `core.aggregation.paa_round` on the card against
   the CPU on well-separated clients (labels equal, Pearson within 1e-5,
   prototypes and new params within PAA_ATOL, one Pearson launch).
8. paper — the port's Table II campaign at `table2_accuracy.main()`'s
   defaults (synth10 and synth100, beta 0.1 / 0.3 / 0.5, bfln-2 / 5 / 7,
   fedavg, fedprox, fedproto, fedhkd, 12 rounds of 20 clients, MLP
   64-128-64-C) and `fig2_rewards.main()` on the card, each run's wall and
   accuracy, Fig 2's reward-size correlation and spread; every BFLN run
   must keep its chain valid and its ledger conserved, and the launches
   must be those of the runs' rounds.  One cell (synth10, 0.1, bfln-5)
   again on the host CPU: accuracy within PAPER_ACC_TOL, rewards equal in
   every round whose labels agree.  The paper's orderings are recorded,
   not gated.
9. serve — the port's serving path at the default model width
   (MLP 64-64-32-10, N = 6570 params) for n = 1000 clients in K = 5
   clusters: three commit blocks whose cohort digests come through the
   kernel (one freerider copying a peer's digest in each, refused by
   `verify_round`), `serve()` (snapshot -> release block -> verify ->
   engine), an explicit `verify_bank`, 64 mixed-cluster requests on a
   virtual clock with full-bucket, deadline and drain flushes, a tampered
   bank refused by `verify_bank` and `ServingEngine`.  The fingerprint
   kernel's launch count is reset just before this phase and must be > 0
   after it.
10. lm — the LM zoo's inference path at full width, depth cut: gemma3-4b
   (6 layers: five SWA-1024 and one global), rwkv6-3b (4 layers),
   jamba-1.5-large-398b (4 layers: mamba + FFN, mamba + MoE, mamba + FFN,
   attention + MoE), grok-1-314b (2 layers, MoE) and
   llama4-maverick-400b-a17b (2 layers: dense, then MoE with a shared
   expert, both window 8192), bf16 weights from `init_params(seed)`.  Per
   configuration: `make_eval_step` at B = 2, S = 4096 (loss, wall, peak
   memory) and `greedy_generate` at B = 2, a 16-token prompt, 16 new
   tokens (wall per token), each with every kernel's launch count reset
   just before and read just after (bf16 flash: one per attention layer a
   forward, 0 in decode; wkv and the selective scan: one per rwkv / mamba
   layer a forward and a decode step); `decode_step` over 32 tokens
   against `forward` on them (relative max error <= DECODE_RTOL, the
   reference's contract; 64 tokens are under every expert's 128-slot
   floor, so the forward drops none); and the configuration in float32
   at B = 1, S = 128 — one period at full width, or `reduced()` for the
   Mamba and MoE ones — on the card (kernels; the path `lm_fp32`, where
   the float32 flash kernel runs, its counts read around the card's
   forward) against the host CPU (plain versions) within CARD_CPU_RTOL.
   Then whisper-large-v3 at its full 32 + 32 layers (`whisper_run`): eval
   at (16, 448) with (16, 1500, 1280) bf16 frames (loss, wall, tokens/s,
   peak memory), `warm_cache` (the encoder once, every layer's cross K/V),
   16 + 16 tokens of `decode_step`, launches asserted (bf16 flash 96 a
   forward: 32 encoder, 32 decoder and 32 cross; 32 in `warm_cache`; 0 a
   decode step), decode vs forward within DECODE_RTOL, and `reduced()` in
   float32 card vs CPU (4 float32 flash launches: 2 encoder, 1 self, 1
   cross).  For llama4 (2 layers) and jamba (4 layers), from the same
   weights, the expert-parallel MoE (`lm_ep_run`: `sharding_mode="ep_tp"`
   under a (4, 1) and a (2, 2) mesh of `mesh_devices`, the expert tables
   placed as views): both paths' dropped choices at the configuration's
   capacity factor (reported), the eval's wall, tokens/s and peak memory,
   and at a capacity factor where neither path drops (found from the
   routers' loads) the cross-entropy against the dense eval within
   CARD_CPU_RTOL and the logits within it at model = 1 (within
   DECODE_RTOL at model > 1, where the bf16 F-partials are rounded before
   the psum, as in the reference); the `reduced()` float32 forward
   expert-parallel vs dense on the card within CARD_CPU_RTOL; each
   member's expert bytes; the `reduced()` float32 train step through ep_tp
   card vs CPU, then (`placed_tables_checks`) one AdamW step on the placed
   tables and on the same tables whole, PLACED_DECODE_TOKENS tokens of
   `greedy_generate` from each trained tree and a `save_trainer_state` /
   `restore_trainer_state` round trip of the placed one, tokens and
   restored trees (whole tables, parameters and moments) equal to the
   whole tree's bit for bit.
11. lm_train — the LM zoo's training path for gemma3-4b and rwkv6-3b
   at the same widths and depths and jamba-1.5-large-398b at one layer
   (mamba + dense SwiGLU FFN at d_model 8192, d_inner 16384;
   LM_TRAIN_CONFIGS), bf16, `remat` on as the full configs set it:
   LM_TRAIN_STEPS steps of `make_train_step` with AdamW at a constant
   LM_TRAIN_LR on one fixed (2, 4096) batch, every kernel's launch count
   reset just before and read just after (a gemma3 step: the bf16 flash
   forward 12 times, 6 and 6 recomputed, and its backward 6 times; an
   rwkv6 step: the wkv forward 8 times and its backward 4 times; a jamba
   step: the scan forward and its backward once each, its one layer a
   remainder of the 8-layer period, which remat does not wrap); every loss
   finite and the last below the first; step wall p50 (drained), tokens/s
   and peak memory.  Then one float32 step at (1, 128) on the card (the
   path `lm_train_fp32`) against the host CPU from the same weights — one
   period at full width, or `reduced()` for jamba, grok-1-314b and
   llama4-maverick-400b-a17b (the last two only in this step: their MoE
   and float32 flash backwards; jamba's period: 7 scan backwards, 4-expert
   MoE, one flash backward) — the loss within TRAIN_LOSS_RTOL, every
   gradient leaf within TRAIN_GRAD_RTOL max(1, max |g_cpu|), the launches
   asserted.  Then whisper-large-v3 at full width and WHISPER_TRAIN_LAYERS
   encoder and decoder layers (`whisper_train`): LM_TRAIN_STEPS AdamW
   steps on the eval cell's (16, 448) batch with (16, 1500, 1280) bf16
   frames (a step: bf16 flash 2 x (32 self + 32 cross) + 32 encoder
   forwards, 96 backwards, the cross-attention's at Sq != Sk), losses
   falling, peak memory, tokens/s, and its `reduced()` float32 step card
   vs CPU with frames.

12. mesh (run between resume and obs) — the client-sharded mesh at
   ExperimentSpec()'s defaults, over `cuda:0..S-1` when the machine has S
   cards, else S shards on cuda:0 (printed).  First `mesh_invariance`, a
   gate: local training must give each client the same bits in one call
   of 100 clients as in calls of 25 or 34 (each product of a step through
   the fixed-order batched-product kernel, each reduction the strategies
   add, BFLN's prototype mean, each leaf's gradient, each strategy's
   `local_train`, the eval forward): every count 0 (cuBLAS's layer-2
   forward, which the path no longer launches, is counted beside it as
   information).  Then, each on the card and the CPU (`card_and_cpu`),
   each arena checked shard by shard (n_padded / S rows, on its device)
   and each bit-identical to the train / async phases' shards=1 card run
   (digests, every block hash, the arena's bytes): BFLN sync at S = 4
   sharded (launches: 4 fingerprint, 1 Pearson, 1 cluster_agg a round),
   at S = 3 (1000 rows pad to 1002, the cohort to 102), at S = 4
   replicated, FedBuff at S = 4; a crash at RESUME_CRASH resumed to the
   S = 4 run's digests and arena bytes; and `serve()` from the S = 4 run
   (verified, 12 requests, its bank equal to shards=1's).  Round / flush
   p50 and p99 beside shards=1's (information: S shards on one card
   serialise their launches).

Prints the card's name and power limit (`nvidia-smi`), one JSON line
`{"kernels": [...]}` with each kernel's launches on its main path (and per
path: train, train_fedavg, train_fedprox, train_fedproto, train_fedhkd,
async, faults, resume, mesh, mesh_sharded_padded, mesh_replicated,
mesh_async, mesh_resume, mesh_serve, obs, paper, serve, lm_forward, lm_decode,
lm_warm_cache, lm_fp32, lm_train, lm_train_fp32; the four backward
kernels' main paths are lm_train and lm_train_fp32, the batched
product's train, with its launches a round and the route comparison),
error, times, bound and the two launch floors (the fingerprint and
cluster_agg entries with their `async_shape` and mesh rows, rwkv6 and
selective_scan with their `decode_shape` row, bf16 flash with its
`lm_hd128_shapes` and `whisper_shapes`, both flash entries with their Sq
!= Sk checks, the bf16 flash backward with its `whisper_shapes` and the
hd-64 kernels' ptxas registers), one JSON
line each
`{"train": {...}}`, `{"strategies": {...}}`, `{"async": {...}}`,
`{"faults": {...}}`, `{"resume": {...}}`, `{"mesh": {...}}`, `{"obs": {...}}`,
`{"paper": {...}}`,
`{"serve": {...}}`, `{"lm": {...}}`, `{"lm_train": {...}}`, and last
`{"ok": true, "device":
{...}}`.  Without CUDA
it exits non-zero and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
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
    DataSpec,
    ExperimentSpec,
    FaultSpec,
    InjectedCrash,
    MeshSpec,
    ObsSpec,
    TrainSpec,
    run,
)
from repro_torch.api.registry import build_strategy  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import aggregation as core_agg  # noqa: E402
from repro_torch.core.baselines import ModelBundle  # noqa: E402
from repro_torch.core.engine import RoundEngine  # noqa: E402
from repro_torch.core import prototypes as prototypes_mod  # noqa: E402
from repro_torch.core.prototypes import classwise_prototypes, client_prototypes  # noqa: E402
from repro_torch.core.fl import local_train  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import batched_matmul as bm  # noqa: E402
from repro_torch.data.lm import batch_stream, make_token_stream  # noqa: E402
from repro_torch.checkpoint.io import restore_trainer_state, save_trainer_state  # noqa: E402
from repro_torch.interop import place_expert_tables  # noqa: E402
from repro_torch.launch.mesh import make_model_mesh, use_mesh  # noqa: E402
from repro_torch.kernels import cluster_agg as ca  # noqa: E402
from repro_torch.kernels import fingerprint as fp  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import pearson as pe  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wk  # noqa: E402
from repro_torch.kernels import selective_scan as sc  # noqa: E402
from repro_torch.models import classifier as clf  # noqa: E402
from repro_torch.models import decode as lmdec  # noqa: E402
from repro_torch.models import lm as lmsteps  # noqa: E402
from repro_torch.models import transformer as lmt  # noqa: E402
from repro_torch.models.moe import moe_capacity, router_topk  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    ALL_NAMES,
    PORT_SPAN_NAMES,
    file_sha256,
    validate_trace_lines,
)
from repro_torch.obs.names import is_registered  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.paper import common as paper_common  # noqa: E402
from repro_torch.paper import fig2_rewards, table2_accuracy  # noqa: E402
from repro_torch.runtime.arena import ArenaLayout, ParamArena  # noqa: E402
from repro_torch.sim.population import ClientPopulation  # noqa: E402
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
from repro_torch.utils.tree import tree_leaves, tree_map, tree_sq_norm  # noqa: E402

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
# the Mamba and MoE configurations in eval and decode.  jamba at 4 layers:
# mamba + FFN, mamba + MoE, mamba + FFN, attention + MoE (45 GB of bf16
# weights; one 8-layer period is 89 GB)
LM_INFER_CONFIGS = (("jamba-1.5-large-398b", 4), ("grok-1-314b", 2),
                    ("llama4-maverick-400b-a17b", 2))
# lm_train at full width: LM_CONFIGS and jamba at one layer (mamba + dense
# SwiGLU FFN, 1.56 G parameters: bf16 weights and gradients and float32
# AdamW moments about 19 GB; its MoE layer 1 would add 19 GB of weights and
# 77 GB of moments, so the MoE models' training at full width waits for a
# mesh, ROADMAP item 6).  One layer is below jamba's 8-layer period, so it
# is a remainder layer, which neither the reference nor the port wraps in
# remat: its scan runs once a step forward, once backward
LM_TRAIN_CONFIGS = LM_CONFIGS + (("jamba-1.5-large-398b", 1),)
# the float32 train step card vs CPU alone (at `reduced()`, fp32_config):
# grok's and llama4's MoE and float32 flash backwards
LM_TRAIN_FP32_ONLY = ("grok-1-314b", "llama4-maverick-400b-a17b")
# the selective scan against its plain version, y and h_T: |got - want| <=
# SCAN_RTOL max(1, max |want|) (float32 sums in another order; the kernel's
# expf and torch.exp differ by an ulp or two)
SCAN_RTOL = 1e-5
# its exponentials, one a state a step, on the special-function units: 16 a
# clock an SM, 132 SMs at the H100 SXM's 1.98 GHz boost clock (NVIDIA's H100
# white paper); and its float32 flops a state a step beside the exp (dt A,
# the FMA of h dA + (dt x) B and its product, the FMA of h C)
SFU_OPS_PER_S = 16 * 132 * 1.98e9
SCAN_FLOPS_PER_STATE = 6
# jamba's Mamba prefill: (B, S, d_inner, d_state)
SCAN_SHAPE = (2, 4096, 16384, 16)
# jamba's dt_rank: the train path's Bm / Cm are column slices of a (B, S,
# TRAIN_DT_RANK + 32) projection (models/mamba.py::_selective_terms)
TRAIN_DT_RANK = ARCHS["jamba-1.5-large-398b"].mamba_dt_rank
# the scan's backward kernel against its plain backward: every gradient
# within SCAN_BWD_RTOL max(1, max |want|) (float32 sums of up to 16384
# channels and 8192 steps in other orders), dx in bf16 per element within
# FLASH_RTOL_BF16 |want| more (one rounding) against the float32 plain dx
SCAN_BWD_RTOL = 1e-4
# the gradient's float32 flops a state a step beside its one exponential:
# the state recomputed (the FMA and the product (dt x) B), g carried (an
# FMA and the product g a), g h_{t-1} a_t (2), dA, u and the sum over n of
# ddt (an FMA each), dB's and dC's terms and sums (4)
SCAN_BWD_FLOPS_PER_STATE = 18
# the bf16 flash kernel at the attention layers of LM_INFER_CONFIGS, all at
# head_dim 128: (B, S, Hq, Hkv, hd), window
FLASH_LM_SHAPES = {"jamba (2, 4096, 64, 8, 128) G = 8": ((2, 4096, 64, 8, 128), 0),
                   "grok (2, 4096, 48, 8, 128) G = 6": ((2, 4096, 48, 8, 128), 0),
                   "llama4 (2, 4096, 40, 8, 128) G = 5 window 8192":
                       ((2, 4096, 40, 8, 128), 8192)}
# whisper-large-v3's attention at the lm phase's (WHISPER_BATCH,
# WHISPER_TOKENS) over 1500 frames, bf16, head_dim 64: (B, Sq, Sk, Hq, Hkv,
# hd), causal.  The encoder's and the cross-attention's keys outnumber the
# decoder's queries: Sq != Sk
FLASH_WHISPER_SHAPES = {
    "whisper encoder self (16, 1500, 20 / 20, 64)": ((16, 1500, 1500, 20, 20, 64), False),
    "whisper cross (16, 448 x 1500, 20 / 20, 64)": ((16, 448, 1500, 20, 20, 64), False),
    "whisper decoder self (16, 448, 20 / 20, 64) causal": ((16, 448, 448, 20, 20, 64),
                                                           True)}
# both forward kernels at Sq != Sk off whisper's shapes (the backward
# kernels at each in both dtypes): (B, Sq, Sk, Hq, Hkv, hd), causal, window,
# the forward's dtypes checked.  Sk = 1500 = 11 x 128 + 92 and 37 / 300
# leave kv tiles part-empty; at 300 x 37 with window 100 the rows from 136
# on have no live key (the plain version's mean of v); hd 128 and 256 are
# the narrow kernel at two 64-wide chunks and the wide template
FLASH_CROSS_CASES = {
    "Sq = 1 x Sk = 1500 (2, 20 / 20, 64)": ((2, 1, 1500, 20, 20, 64), False, 0,
                                           ("bf16", "fp32")),
    "ragged (1, 37 x 300, 4 / 4, 64) non-causal": ((1, 37, 300, 4, 4, 64), False, 0,
                                                   ("bf16", "fp32")),
    "(1, 300 x 37, 4 / 4, 64) causal": ((1, 300, 37, 4, 4, 64), True, 0, ("bf16",)),
    "(1, 300 x 37, 4 / 4, 64) causal window 100": ((1, 300, 37, 4, 4, 64), True, 100,
                                                   ("bf16", "fp32")),
    "hd 128 G = 4 (1, 200 x 700, 8 / 2, 128)": ((1, 200, 700, 8, 2, 128), False, 0,
                                                ("bf16",)),
    "hd 256 G = 4 (1, 200 x 700, 8 / 2, 256) causal": ((1, 200, 700, 8, 2, 256), True, 0,
                                                       ("bf16",)),
    "hd 256 (1, 500 x 130, 4 / 1, 256) window 100": ((1, 500, 130, 4, 1, 256), True, 100,
                                                     ("bf16",)),
}
# whisper-large-v3 in the lm phase at 32 + 32 layers, no cut: teams
# transcribing 30-second segments (1500 frames of the stub frontend, bf16)
# in batches of 16, the decoder at its 448 positions
WHISPER = "whisper-large-v3"
WHISPER_BATCH, WHISPER_TOKENS = 16, 448
# whisper-large-v3 trained in the lm_train phase at its full depth, 32 encoder
# and 32 decoder layers, on the eval cell's batch, at Whisper large's
# published peak learning rate (arXiv:2212.04356, Table 17): at
# LM_TRAIN_LR = 1e-3 the 64 layers' loss falls for seven steps and jumps at
# the eighth (11.11 -> 8.79 -> 14.47), while at 4 + 4 layers the hd-64
# kernels, the template and the plain backward give the same curve
# (PERF.md)
WHISPER_TRAIN_LAYERS, WHISPER_TRAIN_LR = 32, 1.75e-4
# the flash kernels keep O, S and P in registers: a spill serialises them;
# the selective scan keeps its states in registers at 64 a thread (four
# blocks an SM), its backward a span's 8 states and exponentials at up to
# 128: a spill puts local-memory traffic in every step
NO_SPILL_SOURCES = ("flash_attention_sm90.cu", "flash_attention.cu", "selective_scan.cu",
                    "selective_scan_bwd.cu")
# the other backward kernels' sources: their spills are printed and reported, not gated
BACKWARD_SOURCES = ("flash_attention_bwd_sm90.cu", "flash_attention_bwd.cu",
                    "rwkv6_scan_bwd.cu")
# ... but for the bf16 backward's hd-64 kernels, which keep S^T, dP^T, P^T and
# dS^T in two terms, and dV and dK (dQ) in registers: gated like the forwards
NO_SPILL_KERNELS = {"flash_attention_bwd_sm90.cu": ("dkdv_hd64_kernel", "dq_hd64_kernel")}
# the flash backward against its plain version: float32 inputs within
# FLASH_BWD_RTOL_F32 max |want| per gradient; bf16 inputs per element against
# the float32 plain backward of the same inputs (the same bf16 output O),
# |got - want| <= FLASH_RTOL_BF16 |want| + FLASH_BWD_ATOL_BF16 max |want|
FLASH_BWD_RTOL_F32 = 1e-4
FLASH_BWD_ATOL_BF16 = 1e-3
# the gradient's products per live (q, k) pair: S, dP, dV, dQ, dK, 2 hd each
FLASH_BWD_FLOPS_PER_PAIR_HD = 10
# the wkv gradient's flops per step and (b, h): the state recomputed, dS
# carried, dr, dk, dv, dw (2 hd^2 each)
WKV_BWD_FLOPS_PER_STATE = 12
# lm_train: AdamW at a constant lr over one fixed batch, LM_TRAIN_STEPS steps
LM_TRAIN_STEPS, LM_TRAIN_LR = 8, 1e-3
# the float32 one-period train step, card vs CPU: the loss at rtol 1e-4,
# every gradient leaf within 1e-3 max(1, max |g_cpu|) (float32 sums in other
# orders through a full-width backward; a masking or indexing fault moves
# gradients by O(1))
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
LM_BATCH, LM_SEQ = 2, 4096              # train_4k's sequence length
PROMPT, NEW_TOKENS, PARITY_TOKENS = 16, 16, 32
# the expert-parallel MoE at full width (lm_ep): each configuration's
# (data, model) mesh, its members on mesh_devices; the capacity factor that
# lets neither path drop is searched in at most EP_CF_ROUNDS runs
EP_MESHES = {"llama4-maverick-400b-a17b": (4, 1), "jamba-1.5-large-398b": (2, 2)}
EP_CF_ROUNDS = 4
# tokens decoded from the `reduced()` float32 tables placed and trained one
# AdamW step through ep_tp (`placed_tables_checks`)
PLACED_DECODE_TOKENS = 4
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
# torch.profiler captures of one call, each checked by a marker kernel; a
# capture that missed it is taken again after a pause of CAPTURE_PAUSE_S
# times the tries so far (a run on the card once recorded nothing at all in
# three captures in a row)
CAPTURE_TRIES, CAPTURE_PAUSE_S = 8, 0.25
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
# a traced round.step (flush.step) p50 below this share of the drained one
# times the launches, not the step: its span did not wait for the card
OBS_STEP_FLOOR = 0.5
# each mode's runs in the obs phase, in turns: untraced (a host clock, no
# wait), traced (spans wait for the card), traced without the waits, and
# RoundTimer's drained spans again (the host's speed drifts between phases)
OBS_ORDER = ("untraced", "traced", "traced_no_wait", "drained", "drained",
             "traced_no_wait", "traced", "untraced")
# the fresh process whose traced run reports the kernel libraries it loads:
# argv = src path, trace path
OBS_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.api import ExperimentSpec, ObsSpec, TrainSpec, run
run(ExperimentSpec(train=TrainSpec(rounds=2),
                   obs=ObsSpec(enabled=True, trace_path=sys.argv[2])))
"""
# the kernel libraries a sync BFLN run loads, and their kernels' names
TRAIN_SOURCES = {"batched_matmul.cu": "batched_matmul_kernel",
                 "cluster_agg.cu": "cluster_agg_kernel",
                 "fingerprint.cu": "fingerprint_kernel", "pearson.cu": "pearson_kernel"}
# paa_round on the card vs the CPU: the Pearson matrix at the reference's
# tolerance, the prototypes and the new params at the float32 sums' 1e-6
PAA_ATOL = 1e-6
# the mesh phase: ExperimentSpec() over MESH_SHARDS shards, and over
# MESH_PAD_SHARDS, where 1000 rows pad to 1002 and a cohort of 100 to 102
MESH_SHARDS, MESH_PAD_SHARDS = 4, 3
# the shards=1 card runs of the train and async phases, which the mesh phase
# holds its runs against: digests, block hashes, arena bytes, bank, walls
ONE_SHARD: dict = {}
# each kernel: its module and the module's launch counter
KERNELS = {"fingerprint": (fp, "launches"), "cluster_agg": (ca, "launches"),
           "pearson": (pe, "launches"), "flash_attention_bf16": (fa, "launches_bf16"),
           "flash_attention_fp32": (fa, "launches"), "rwkv6": (wk, "launches"),
           "flash_attention_bwd_bf16": (fa, "launches_bwd_bf16"),
           "flash_attention_bwd_fp32": (fa, "launches_bwd"),
           "rwkv6_bwd": (wk, "launches_bwd"), "selective_scan": (sc, "launches"),
           "selective_scan_bwd": (sc, "launches_bwd"), "batched_matmul": (bm, "launches")}


# the batched product launches with every training step, prototype and eval
# forward a run takes; an expected count of SOME asks for at least one
# launch, and the count is reported
SOME = None


def launches_match(launches: dict[str, int], want: dict) -> bool:
    """Every kernel's count as ``want`` says: exactly, or > 0 for SOME."""
    return all(launches[k] > 0 if want[k] is SOME else launches[k] == want[k]
               for k in KERNELS)


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


def check_no_spills() -> dict:
    """Both flash kernels keep O, S and P in registers (241 of them at
    head_dim 256 in the bf16 kernel), the selective scan its states at 64
    a thread, its backward a span's states and exponentials: ptxas must
    compile every instance of each without spilling, or their products
    serialise on local memory.  Returns each source's spill stores per
    instance (all 0)."""
    out = {}
    for source in NO_SPILL_SOURCES:
        log = _build.library_path(source).with_suffix(".log").read_text()
        out[source] = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        if not out[source] or any(out[source]):
            raise AssertionError(f"{source}: ptxas spill stores {out[source]}")
        print(f"{source}: {len(out[source])} instances, no spills", flush=True)
    return out


def check_no_spill_kernels() -> dict:
    """The kernels of NO_SPILL_KERNELS: ptxas must compile each without a
    spill store.  Returns each one's registers and spill stores."""
    out = {}
    for source, names in NO_SPILL_KERNELS.items():
        entries = ptxas_entries(_build.library_path(source).with_suffix(".log").read_text())
        for name in names:
            if name not in entries or entries[name]["spill_stores"] != 0:
                raise AssertionError(f"{source}: {name} ptxas {entries.get(name)}")
            out[name] = entries[name]
            print(f"{source}: {name} {entries[name]['registers']} registers, no spills",
                  flush=True)
    return out


def ptxas_entries(log: str) -> dict[str, dict]:
    """Each kernel of a compiler log (``-Xptxas -v``): its registers a
    thread and spill stores, by the kernel's name with its template
    arguments (``flash_sm90_narrow_kernel<1>``; the mangled name where it
    has none)."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        name = mangled
        for m in re.finditer(r"(?=(\d+))", mangled):     # a length prefix at any digit
            at = m.start() + len(m.group(1))
            ident = mangled[at:at + int(m.group(1))]
            rest = mangled[at + len(ident):]
            if ident.endswith("kernel") and rest[:1] in ("I", "E"):
                args = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
                name = ident + ("<" + ", ".join(re.findall(r"L[a-z](\d+)E", args.group(1)))
                                + ">" if args else "")
                break
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores", block)
        out[name] = {"registers": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spills.group(1)) if spills else None}
    return out


def report_spills() -> dict:
    """The backward kernels' ptxas spill stores per instance, printed and
    returned (reported, not gated)."""
    out = {}
    for source in BACKWARD_SOURCES:
        log = _build.library_path(source).with_suffix(".log").read_text()
        out[source] = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"{source}: {len(out[source])} instances, spill stores {out[source]}",
              flush=True)
    return out


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


def with_clocks(fn):
    """``fn()``'s result, and the SM clock (MHz) and power draw (W) that
    `nvidia-smi` sampled every 20 ms while it ran: min, median, max."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "20", "-i", "0"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.1)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    finally:
        smi.terminate()
        lines, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in ln.split(",")] for ln in lines.splitlines()
            if ln.count(",") == 1 and "N/A" not in ln]
    summary = {}
    for i, key in enumerate(("sm_clock_mhz", "power_w")):
        vals = sorted(r[i] for r in rows)
        summary[key] = ({"min": vals[0], "median": vals[len(vals) // 2], "max": vals[-1],
                         "samples": len(vals)} if vals else None)
    return out, summary


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


class CaptureError(AssertionError):
    """torch.profiler recorded nothing usable of a call in CAPTURE_TRIES
    captures."""


def device_kernels(fn, marker: bool = True) -> list[str]:
    """The device activities (kernels, copies, fills) of one call of
    ``fn``, by name, one entry each (torch.profiler).  Each capture also
    records one marker kernel launched just before the call
    (``torch.cuda._sleep``, PyTorch's ``spin_kernel``); a capture without
    it recorded nothing of the device (seen once on the card: a capture of
    no activity at all) and is taken again, at most CAPTURE_TRIES times.
    The marker is not among the names returned.  With ``marker=False``,
    for a call whose kernels the autograd engine launches from its own
    thread (captures of such calls on the card held the call's kernels but
    not the marker), no marker is launched and a capture that recorded any
    device activity is taken."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tries in range(CAPTURE_TRIES):
        time.sleep(CAPTURE_PAUSE_S * tries)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if marker:
                torch.cuda._sleep(1)
            fn(None)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA for _ in range(e.count)]
        if not marker and names:
            return names
        spin = [n for n in names if "spin_kernel" in n]
        if spin:
            names.remove(spin[0])
            return names
    wanted = "marker kernel" if marker else "device activity"
    raise CaptureError(f"torch.profiler recorded no {wanted} in {CAPTURE_TRIES} "
                       f"captures: {names}")


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

    event = observe = set_gauge = compile_delta = inc


class HostTimer(RoundTimer):
    """A recorder that times every span on the host clock and waits for
    nothing: an untraced run's rounds as its caller sees them."""

    def span(self, name: str, **attrs):
        return _HostSpan(self.spans.setdefault(name, []))


class _HostSpan:
    def __init__(self, sink):
        self.sink = sink

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.sink.append((time.perf_counter() - self.t0) * 1e3)
        return False


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
    want = dict({k: 0 for k in KERNELS}, fingerprint=nonempty + 1,
                cluster_agg=nonempty, pearson=nonempty, batched_matmul=SOME)
    if not launches_match(launches, want):
        raise AssertionError(f"train-path launches {launches}, expected {want}")
    acc = m["final_accuracy"]
    if not 0.0 < acc <= 1.0:
        raise AssertionError(f"final accuracy {acc}")
    ONE_SHARD["sync"] = one_shard_record(result, timer.spans["round.total"])
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
    ONE_SHARD["sync"]["bank"] = bank_record(fe.engine.bank)
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
            "step_parity": parity, "served_requests": len(done),
            "batched_matmul_launches_a_round": launches["batched_matmul"] / m["rounds_run"],
            "bmm_route": bmm_route_compare(dev)}


def bmm_route_compare(dev) -> dict:
    """ExperimentSpec() on the card with the client-stacked products through
    the fixed-order kernel (the path) and through cuBLAS (`torch.matmul`,
    the route before the kernel), in turns cuBLAS, kernel, kernel, cuBLAS:
    each run's round p50 and `step.local_train` p50 (drained spans), and
    whether the two routes' event logs agree.  Information: the kernel is
    there for bit identity, not for speed."""
    out: dict = {"order": [], "round_ms_p50": [], "local_train_ms_p50": []}
    logs = set()
    for route in ("cublas", "kernel", "kernel", "cublas"):
        timer = RoundTimer()
        with contextlib.ExitStack() as stack:
            if route == "cublas":
                for mod in (clf, prototypes_mod):
                    stack.enter_context(mock.patch.object(mod, "batched_matmul",
                                                          torch.matmul))
            res = run(ExperimentSpec(), device=dev, obs=timer)
            torch.cuda.synchronize()
        logs.add(res.manifest["event_log_digest"])
        out["order"].append(route)
        out["round_ms_p50"].append(float(np.median(timer.spans["round.total"])))
        out["local_train_ms_p50"].append(float(np.median(timer.spans["step.local_train"])))
    for key in ("round_ms_p50", "local_train_ms_p50"):
        for route in ("cublas", "kernel"):
            out[f"{key}_{route}"] = float(np.mean(
                [v for r, v in zip(out["order"], out[key]) if r == route]))
    out["event_logs_equal"] = len(logs) == 1
    return out


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
                cluster_agg=0 if name == "fedproto" else nonempty, batched_matmul=SOME)
    if not launches_match(launches, want):
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
    """``spec`` through ``run`` on the card (``dev``: one device, or the
    mesh's device list), its launches counted and its spans timed, then on
    the host CPU (a mesh's shards all on the host): equal event logs, the chain valid
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
    if any(d.type != "cuda" for d in card.sim.arena.devices):
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
    want.update(fingerprint=flushes + 1, cluster_agg=flushes, batched_matmul=SOME)
    if not launches_match(launches, want):
        raise AssertionError(f"async-path launches {launches}, expected {want}")
    flush_ms = timer.spans["flush.total"]
    ONE_SHARD["async"] = one_shard_record(card, flush_ms)
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


def one_shard_record(result, walls_ms) -> dict:
    """What the mesh phase holds a run at S shards against: the manifest's
    digests, every block's (round, hash) in order, the real arena rows'
    sha256, the balances and the round (flush) walls of a shards=1 run."""
    return {"digests": digests(result.manifest),
            "blocks": [(b.round_idx, b.block_hash())
                       for b in result.sim.trainer.chain.blocks],
            "arena_sha256": hashlib.sha256(
                result.sim.arena.host_rows().tobytes()).hexdigest(),
            "balances": result.report.balances.copy(),
            "final_accuracy": result.manifest["final_accuracy"],
            "walls_ms": list(walls_ms)}


def bank_record(bank) -> dict:
    return {"sha256": hashlib.sha256(bank.data.cpu().numpy().tobytes()).hexdigest(),
            "digests": [r.digest for r in bank.releases], "root": bank.root}


def mesh_devices(shards: int) -> tuple[list[str], str]:
    """``cuda:0..S-1`` when the machine has S cards, else S shards on cuda:0."""
    if torch.cuda.device_count() >= shards:
        return [f"cuda:{j}" for j in range(shards)], f"cuda:0..{shards - 1}"
    return ["cuda:0"] * shards, f"{shards} shards on cuda:0"


def check_mesh_arena(arena, shards: int, what: str) -> None:
    """No shard tensor holds more than n_padded / S rows; shard j lies on
    the mesh's device j.  Read off the shard tensors themselves."""
    rows = -(-arena.n_clients // shards)
    if len(arena.shards) != shards or any(
            t.shape != (rows, arena.n_params) or t.device != torch.device(d)
            for t, d in zip(arena.shards, arena.devices, strict=True)):
        raise AssertionError(f"{what}: shards {[tuple(t.shape) for t in arena.shards]} "
                             f"on {[str(t.device) for t in arena.shards]}, expected "
                             f"{shards} x ({rows}, {arena.n_params})")


def differing(fn, n: int, m: int = 100) -> int:
    """Elements where ``fn`` over m clients in one call and in calls of n differ."""
    whole = fn(slice(0, m))
    parts = torch.cat([fn(slice(a, min(a + n, m))) for a in range(0, m, n)])
    return int((whole != parts).sum())


def mesh_invariance(dev) -> dict:
    """Does the card give each client the same bits however many clients
    one call trains?  At ExperimentSpec()'s widths (64 -> 64 -> 32 -> 10,
    batch 16) for 100 clients: each product a step launches (forward, the
    weight gradient A^T dY and the input gradient dY B^T, each through the
    fixed-order batched-product kernel as autograd calls it), the bias
    gradient's sum, the log-softmax backward, the per-client reductions the
    strategies add (cross-entropy's mean over the batch, FedProx's squared
    norm, FedProto's class prototypes) and BFLN's partial (the prototype
    mean over the probe batch), each in one call against 4 calls of 25
    (differing elements); each leaf's gradient of one step; each strategy's
    `local_train` against 4 calls of 25 and 3 calls of 34 (the last padded
    with 2 zero-data slots on row 0, as the engine pads); and the eval
    forward.  Every count must be 0: it is the mesh phase's gate.  cuBLAS's
    layer-2 forward (`torch.matmul`, which the path no longer launches) is
    counted beside it as information: it is what made the port's sharded
    runs differ before (ROADMAP.md section 3)."""
    pop = ClientPopulation.from_spec(
        ExperimentSpec(data=DataSpec(n_clients=200)).population_spec(), dev)
    t = TrainSpec()
    mcfg = clf.MLPConfig(in_dim=pop.in_dim, hidden=t.hidden, rep_dim=t.rep_dim,
                         num_classes=pop.num_classes)
    bundle = ModelBundle(functools.partial(clf.apply_batched, mcfg),
                         functools.partial(clf.embed_batched, mcfg), pop.num_classes)
    opt = topt.adam(t.lr)
    params = clf.init_stacked(mcfg, torch.Generator().manual_seed(SEED), 100,
                              same_init=False, device=dev)
    cx, cy = pop.cohort_data(np.arange(100) * 2)
    x, y = cx[:, 0], cy[:, 0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn((100, x.shape[1], t.hidden[0]), generator=gen, device=dev)
    g2 = torch.randn((100, x.shape[1], t.rep_dim), generator=gen, device=dev)
    gl = torch.randn((100, x.shape[1], pop.num_classes), generator=gen, device=dev)
    reps = clf.embed_batched(mcfg, params, x)
    prod = bm.batched_matmul_cuda
    h1 = torch.relu(prod(x, params["w0"]) + params["b0"][:, None, :])
    logits = clf.apply_batched(mcfg, params, x)

    def sub(s):
        return {k: v[s] for k, v in params.items()}
    ops = {"forward x @ w0": lambda s: prod(x[s], params["w0"][s]),
           "weight gradient x^T @ g": lambda s: prod(x[s].transpose(1, 2), g[s]),
           "forward h1 @ w1": lambda s: prod(h1[s], params["w1"][s]),
           "weight gradient h1^T @ g": lambda s: prod(h1[s].transpose(1, 2), g2[s]),
           "input gradient g @ w1^T": lambda s: prod(g2[s], params["w1"][s].transpose(1, 2)),
           "bias gradient (sum over the batch)": lambda s: g[s].sum(dim=1),
           "head forward reps @ w_head": lambda s: prod(reps[s], params["w_head"][s]),
           "head weight gradient reps^T @ g": lambda s: prod(reps[s].transpose(1, 2), gl[s]),
           "head input gradient g @ w_head^T": lambda s: prod(
               gl[s], params["w_head"][s].transpose(1, 2)),
           "log-softmax backward": lambda s: log_softmax_backward(gl[s], gl[s]),
           "cross-entropy mean over the batch": lambda s: -torch.take_along_dim(
               F.log_softmax(logits[s], dim=-1), y[s][..., None].long(), dim=-1)[..., 0]
           .mean(dim=-1),
           "squared norm of each client's params (FedProx)": lambda s: tree_sq_norm(sub(s)),
           "class prototypes (FedProto, FedHKD)": lambda s: classwise_prototypes(
               bundle.embed_fn, sub(s), x[s], y[s], pop.num_classes)[0],
           "prototype mean over the probe batch (BFLN's partial)": lambda s:
               client_prototypes(bundle.embed_fn, sub(s), pop.probe)}
    ops = {name: differing(fn, 25) for name, fn in ops.items()}
    cublas = differing(lambda s: torch.matmul(h1[s], params["w1"][s]), 25)

    def grads(s):
        p = {k: v[s].detach().requires_grad_(True) for k, v in params.items()}
        logp = F.log_softmax(clf.apply_batched(mcfg, p, x[s]), dim=-1)
        loss = -torch.take_along_dim(logp, y[s][..., None].long(), dim=-1)[..., 0]
        loss.mean(dim=-1).sum().backward()
        return {k: v.grad for k, v in p.items()}
    whole = grads(slice(0, 100))
    parts = [grads(slice(a, a + 25)) for a in range(0, 100, 25)]
    step = {k: int((torch.cat([q[k] for q in parts]) != whole[k]).sum()) for k in whole}

    def pad0(v, pad):
        return torch.cat([v, v.new_zeros((pad,) + v.shape[1:])]) if pad else v
    train = {}
    for name in ("bfln",) + BASELINES:
        strat = build_strategy(name, bundle, probe=pop.probe, n_clusters=t.n_clusters)
        extras = strat.round_extras(params, cx, cy)

        def trained(a, m, pad=0):
            sl = slice(a, a + m)
            p = {k: torch.cat([v[sl], v[:1].expand(pad, *v.shape[1:])])
                 for k, v in params.items()}
            e = extras if strat.shared_extras else tree_map(
                lambda q: pad0(q[sl], pad), extras)
            r = local_train(strat.local_loss, opt, p, opt.init(p), pad0(cx[sl], pad),
                            pad0(cy[sl], pad), e, t.local_epochs,
                            shared_extras=strat.shared_extras)
            return torch.cat([layout_rows(r.params)[:m], r.mean_loss[:m, None]], dim=1)
        for split in ((25,) * 4, (34, 34, 32)):
            starts = np.cumsum((0,) + split[:-1])
            got = torch.cat([trained(a, m, max(split) - m) for a, m in zip(starts, split)])
            train[f"{name} {split}"] = int((got != trained(0, 100)).sum())
    ex = pop.test_x[:1024]
    evals = differing(lambda s: bundle.apply_fn({k: v[s] for k, v in params.items()}, ex), 25)
    invariant = not any(ops.values()) and not any(step.values()) \
        and not any(train.values()) and evals == 0
    return {"widths": [pop.in_dim, *t.hidden, t.rep_dim, pop.num_classes],
            "batch": int(x.shape[1]), "clients": 100,
            "differing_elements": {"ops, 4 calls of 25": ops,
                                   "one step's gradients, 4 calls of 25": step,
                                   "local_train (params and loss)": train,
                                   "eval forward, 4 calls of 25": evals},
            "cublas_forward_h1_w1_differing_elements": cublas,
            "invariant": invariant}


def log_softmax_backward(z: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    z = z.detach().requires_grad_(True)
    return torch.autograd.grad(F.log_softmax(z, dim=-1), z, grad_outputs=grad)[0]


def layout_rows(params) -> torch.Tensor:
    return ArenaLayout.from_stacked(params).flatten(params)


def mesh_run(spec: ExperimentSpec, what: str, one: dict, want: dict,
             gate_bits: bool, gate_balances: bool):
    """``spec`` (a mesh) on the card over ``mesh_devices`` and on the host
    CPU (``card_and_cpu``), each arena checked shard by shard, its launches
    against ``want``; the card run against the shards=1 card run ``one``:
    the same event log and a final accuracy within ACC_TOL always, the
    digests, every block hash and the arena's bytes bit for bit if
    ``gate_bits`` (else reported, with the first round whose block
    differs).  Returns the card result and the row."""
    shards = spec.mesh.shards
    devices, placed = mesh_devices(shards)
    out = card_and_cpu(spec, devices, what, gate_balances=gate_balances)
    card, cpu, timer = out["card"], out["cpu"], out["timer"]
    for res, where in ((card, "card"), (cpu, "CPU")):
        check_mesh_arena(res.sim.arena, shards, f"{what} ({where})")
    if not launches_match(out["launches"], want):
        raise AssertionError(f"{what}: launches {out['launches']}, expected {want}")
    m = card.manifest
    if m["event_log_digest"] != one["digests"]["event_log_digest"]:
        raise AssertionError(f"{what}: the event log differs from the shards=1 run's")
    acc_diff = abs(m["final_accuracy"] - one["final_accuracy"])
    if acc_diff > ACC_TOL:
        raise AssertionError(f"{what}: final accuracy {m['final_accuracy']} vs "
                             f"shards=1 {one['final_accuracy']}")
    blocks = [(b.round_idx, b.block_hash()) for b in card.sim.trainer.chain.blocks]
    first = next((ra for (ra, ha), (_, hb) in zip(blocks, one["blocks"]) if ha != hb),
                 None)
    hashes_equal = first is None and len(blocks) == len(one["blocks"])
    arena_equal = hashlib.sha256(card.sim.arena.host_rows().tobytes()).hexdigest() \
        == one["arena_sha256"]
    same = hashes_equal and arena_equal and digests(m) == one["digests"]
    if gate_bits and not same:
        raise AssertionError(f"{what}: not bit-identical to shards=1 (block hashes "
                             f"equal {hashes_equal}, first differing round {first}, "
                             f"arena equal {arena_equal})")
    unit = "flush" if spec.train.mode == "async" else "round"
    walls = timer.spans[f"{unit}.total"]
    eng = card.sim.engine
    return card, {
        "devices": devices, "placement": placed, "shards": shards,
        "cohort_mode": eng.cohort_mode, "cohort_shards": eng.cohort_shards,
        "n_padded": card.sim.arena.n_padded,
        "rows_per_shard": card.sim.arena.rows_per_shard,
        "per_device_bytes": card.sim.arena.per_device_bytes(),
        "launches": out["launches"], "launches_expected": want,
        "gated_bit_identical": gate_bits,
        "bit_identical_to_one_shard": same, "block_hashes_equal": hashes_equal,
        "first_round_differs": first, "arena_equal_one_shard": arena_equal,
        "balances_max_abs_diff_one_shard": float(np.abs(
            card.report.balances - one["balances"]).max()),
        "final_accuracy_one_shard": one["final_accuracy"],
        "final_accuracy_diff_one_shard": acc_diff,
        f"{unit}_ms_p50": float(np.median(walls)),
        f"{unit}_ms_p99": float(np.percentile(walls, 99)),
        f"{unit}_ms_p50_one_shard": float(np.median(one["walls_ms"])),
        f"{unit}_ms_p99_one_shard": float(np.percentile(one["walls_ms"], 99)),
        "phase_ms_p50": {k: float(np.median(v)) for k, v in timer.spans.items()},
        **out["summary"]}


def mesh_phase(dev, res: dict) -> dict:
    """The client-sharded mesh at ExperimentSpec()'s defaults.  First the
    card's batch invariance (`mesh_invariance`): every count must be 0.
    Then on the card over `mesh_devices`, each also on the host CPU and
    each bit-identical to the train / async phases' shards=1 card run
    (digests, every block hash, the arena's bytes, balances and final
    accuracy with them): BFLN sync at MESH_SHARDS sharded (4 fingerprint, 1
    Pearson and 1 cluster-agg launches a round), at MESH_PAD_SHARDS (1000
    rows pad to 1002, the cohort to 102: two zero-weight slots) and at
    MESH_SHARDS replicated (the one-device step on the lead); FedBuff at
    MESH_SHARDS (each flush's 16 rows 4 a shard); a crash by exception at
    RESUME_CRASH resumed to the uninterrupted MESH_SHARDS run's digests and
    arena bytes; and `serve()` from that run (verified, 12 requests
    answered, its bank equal to the train phase's).  Round and flush p50 /
    p99 beside shards=1's are information: S shards on one card serialise
    their launches."""
    inv = mesh_invariance(dev)
    if not inv["invariant"]:
        raise AssertionError(f"mesh: local training on the card is not batch-invariant: "
                             f"{inv['differing_elements']}")
    sync, asyn = ONE_SHARD["sync"], ONE_SHARD["async"]
    rounds = len(sync["blocks"]) - 1              # the non-empty rounds
    flushes = len(asyn["blocks"]) - 1

    def want(fingerprint, cluster_agg, pearson):
        return dict({k: 0 for k in KERNELS}, fingerprint=fingerprint,
                    cluster_agg=cluster_agg, pearson=pearson, batched_matmul=SOME)
    out: dict = {"invariance": inv, "gate": "bit identity to shards=1"}
    s, p = MESH_SHARDS, MESH_PAD_SHARDS
    card4, out["sharded"] = mesh_run(
        ExperimentSpec(mesh=MeshSpec(shards=s)), f"mesh/sharded{s}", sync,
        want(rounds * s + 1, rounds, rounds), gate_bits=True, gate_balances=False)
    _, out["sharded_padded"] = mesh_run(
        ExperimentSpec(mesh=MeshSpec(shards=p)), f"mesh/sharded{p}", sync,
        want(rounds * p + 1, rounds, rounds), gate_bits=True, gate_balances=False)
    _, out["replicated"] = mesh_run(
        ExperimentSpec(mesh=MeshSpec(shards=s, cohort="replicated")),
        f"mesh/replicated{s}", sync, want(rounds + 1, rounds, rounds),
        gate_bits=True, gate_balances=False)
    _, out["async"] = mesh_run(
        ExperimentSpec(train=TrainSpec(mode="async"), mesh=MeshSpec(shards=s)),
        f"mesh/async{s}", asyn, want(flushes * s + 1, flushes, 0),
        gate_bits=True, gate_balances=True)

    # crash and resume on the mesh: the uninterrupted run's digests and bytes
    base = ExperimentSpec(mesh=MeshSpec(shards=s))
    devices, _ = mesh_devices(s)
    root = tempfile.mkdtemp(prefix="bfln-mesh-resume-")
    try:
        ck = CheckpointSpec(interval=RESUME_INTERVAL, dir=root)
        reset_launches()
        try:
            run(dataclasses.replace(base, checkpoint=ck, faults=FaultSpec(
                crash_round=RESUME_CRASH, crash_phase="post_checkpoint",
                crash_mode="exception")), device=devices)
        except InjectedCrash:
            pass
        else:
            raise AssertionError("mesh/resume: no crash")
        resumed = run(dataclasses.replace(base, checkpoint=ck), device=devices,
                      resume_from=root)
        torch.cuda.synchronize()
        resume_launches = read_launches()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check_mesh_arena(resumed.sim.arena, s, "mesh/resume")
    rm = resumed.manifest
    arena_equal = resumed.sim.arena.host_rows().tobytes() == card4.sim.arena.host_rows().tobytes()
    if rm["resume_step"] != RESUME_CRASH or digests(rm) != digests(card4.manifest) \
            or not arena_equal:
        raise AssertionError(f"mesh/resume: step {rm['resume_step']}, digests "
                             f"{digests(rm)} vs {digests(card4.manifest)}, arena "
                             f"equal {arena_equal}")
    out["resume"] = {"shards": s, "resume_step": rm["resume_step"],
                     "digests_equal_uninterrupted": True,
                     "arena_equal_uninterrupted": True,
                     "snapshot_bytes": rm["checkpoint_bytes"],
                     "launches": resume_launches}

    # serve from the S-shard run: the bank from the real rows read to the host
    reset_launches()
    fe = serve(card4)
    verify_bank(fe.engine.bank, card4.sim.trainer.chain)
    rng = np.random.default_rng(SEED + 4)
    for i in range(12):
        fe.submit(i % card4.spec.train.n_clusters,
                  rng.standard_normal(card4.sim.mcfg.in_dim).astype(np.float32))
    fe.drain()
    done = fe.take_completed()
    if len(done) != 12 or any(d.status != "ok" or not np.isfinite(d.logits).all()
                              for d in done):
        raise AssertionError("mesh/serve: serve(result) did not answer every request")
    bank = bank_record(fe.engine.bank)
    bank_equal = bank["sha256"] == sync["bank"]["sha256"] \
        and bank["digests"] == sync["bank"]["digests"]
    if not bank_equal:
        raise AssertionError("mesh/serve: the bank differs from the shards=1 run's")
    out["serve"] = {"shards": s, "bank_device": str(fe.engine.bank.data.device),
                    "bank_bytes_equal_one_shard": bank_equal,
                    "served_requests": len(done), "launches": read_launches()}
    print(f"mesh: {out['sharded']['placement']}, bit-identical to one shard, round p50 "
          f"{out['sharded']['round_ms_p50']:.3f} ms at S = {s} vs "
          f"{out['sharded']['round_ms_p50_one_shard']:.3f} ms at S = 1", flush=True)
    return out


# the fixed-order batched product at ExperimentSpec()'s widths: the forward's
# three products a client (16-row batch) over the 100-client cohort, and the
# eval forward's three over the shared 1024-example batch (the first with a
# shared, batch stride 0)
BMM_SHAPES = {"layer 0 (100, 16, 64) @ (100, 64, 64)": ((100, 16, 64), (100, 64, 64)),
              "layer 1 (100, 16, 64) @ (100, 64, 32)": ((100, 16, 64), (100, 64, 32)),
              "head (100, 16, 32) @ (100, 32, 10)": ((100, 16, 32), (100, 32, 10)),
              "eval (1024, 64) shared @ (100, 64, 64)": ((1024, 64), (100, 64, 64)),
              "eval layer 1 (100, 1024, 64) @ (100, 64, 32)":
                  ((100, 1024, 64), (100, 64, 32)),
              "eval head (100, 1024, 32) @ (100, 32, 10)": ((100, 1024, 32), (100, 32, 10))}
# the kernel's first design (one output column a thread), timed beside it
BMM_PREVIOUS = "batched_matmul_scalar.cu"


def check_bmm(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    """The kernel against its plain version on the same operands, bit for
    bit (NaN-free inputs); returns the differing elements, which must be 0."""
    got, want = bm.batched_matmul_cuda(a, b), bm.batched_matmul_plain(a, b)
    if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                  want.view(torch.int32)):
        n = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"batched_matmul kernel {what}: {n} elements differ "
                             "from the plain version")
    return 0


def batched_matmul_phase(dev) -> dict:
    """The fixed-order batched product (`csrc/batched_matmul.cu`, no Pallas
    counterpart) bit for bit against its plain version: at BMM_SHAPES, each
    product's backward forms as autograd gives them (dY @ B^T and A^T @ dY
    through transposed views, dY an expanded zero-stride gradient too), at
    25 and 34 of the 100 clients (each client's rows equal to the whole
    call's), FedProto's class sums (one-hot^T (m, 10, 16) @ reps), ragged
    shapes off every tile (M 17, K 33, N 70), K = 1, and signed zeros;
    `BatchedMatmulFn`'s gradients against the plain backward.  Timed at
    BMM_SHAPES, and the training shapes' backward forms on their
    transposed views, beside both bounds (operations at the FMA rate, and
    at half of it: this arithmetic issues a multiply and an add), the
    plain version, `torch.bmm` / `torch.matmul` (cuBLAS, what the path
    launched before) on the same operands and the kernel's first design
    (BMM_PREVIOUS, loaded in turns as the wrapper's library)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    checks = {}
    for what, (sa, sb) in BMM_SHAPES.items():
        a, b = rnd(*sa), rnd(*sb)
        checks[what] = check_bmm(a, b, what)
        if a.dim() == 3:
            dy = rnd(sb[0], sa[1], sb[2])
            checks[f"{what}: dY @ B^T"] = check_bmm(dy, b.transpose(1, 2), what)
            checks[f"{what}: A^T @ dY"] = check_bmm(a.transpose(1, 2), dy, what)
            checks[f"{what}: A^T @ dY, dY expanded"] = check_bmm(
                a.transpose(1, 2), dy[:1, :1].expand_as(dy), what)
            whole = bm.batched_matmul_cuda(a, b)
            for m in (25, 34):
                part = bm.batched_matmul_cuda(a[:m], b[:m])
                if not torch.equal(part.view(torch.int32), whole[:m].view(torch.int32)):
                    raise AssertionError(f"batched_matmul {what}: {m} clients in one "
                                         "call differ from the same clients in 100")
                checks[f"{what}: {m} clients equal their rows of 100"] = 0
    onehot = F.one_hot(torch.randint(0, 10, (100, 16), generator=gen, device=dev),
                       10).float()
    checks["class sums one-hot^T (100, 10, 16) @ (100, 16, 32)"] = check_bmm(
        onehot.transpose(1, 2), rnd(100, 16, 32), "class sums")
    checks["ragged (3, 17, 33) @ (3, 33, 70)"] = check_bmm(rnd(3, 17, 33), rnd(3, 33, 70),
                                                           "ragged")
    checks["K = 1 (5, 16, 1) @ (5, 1, 10)"] = check_bmm(rnd(5, 16, 1), rnd(5, 1, 10), "K = 1")
    zeros = torch.zeros((2, 16, 8), device=dev)
    zeros[0] = -0.0
    checks["signed zeros"] = check_bmm(zeros, -rnd(2, 8, 16).abs(), "signed zeros")
    a = rnd(20, 16, 64).requires_grad_(True)
    b = rnd(20, 64, 32).requires_grad_(True)
    dy = rnd(20, 16, 32)
    got = torch.autograd.grad(bm.BatchedMatmulFn.apply(a, b), (a, b), dy)
    want = (bm.batched_matmul_plain(dy, b.detach().transpose(1, 2)),
            bm.batched_matmul_plain(a.detach().transpose(1, 2), dy))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("BatchedMatmulFn's gradients != the plain backward")
    checks["BatchedMatmulFn gradients (20, 16, 64) @ (20, 64, 32)"] = 0

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    previous = _build.load(BMM_PREVIOUS)
    current = _build.load("batched_matmul.cu")

    def row(x, y, form):
        """Kernel (and the first design, in turns: K P P K), plain version
        and library call on the same operands; both bounds."""
        m, M, K, N = bm._check(x, y)
        n_bytes = 4 * (x.numel() + y.numel() + m * M * N)
        bound, bound_by = bound_us(n_bytes, 2 * m * M * K * N)
        no_fma, no_fma_by = bound_us(n_bytes, 4 * m * M * K * N)
        times = {"kernel": [], "previous": []}
        check_bmm(x, y, form)
        try:
            for lib in (current, previous, previous, current):
                _build._libs["batched_matmul.cu"] = lib
                times["kernel" if lib is current else "previous"].append(median_us(
                    lambda _: bm.batched_matmul_cuda(x, y), None, 200, flush))
        finally:
            _build._libs["batched_matmul.cu"] = current
        library = (lambda _: torch.bmm(x, y)) if x.dim() == 3 else \
            (lambda _: torch.matmul(x, y))
        return {"a": list(x.shape), "b": list(y.shape), "a_strides": list(x.stride()),
                "b_strides": list(y.stride()), "form": form, "bit_exact": True,
                "kernel_us": float(np.mean(times["kernel"])),
                "kernel_us_in_turns": times["kernel"],
                "previous_kernel_us": float(np.mean(times["previous"])),
                "previous_kernel_us_in_turns": times["previous"],
                "previous_source": f"src/repro_torch/kernels/csrc/{BMM_PREVIOUS}",
                "plain_us": median_us(lambda _: bm.batched_matmul_plain(x, y), None, 20,
                                      flush),
                "library_us": median_us(library, None, 200, flush),
                "library_call": "torch.bmm(a, b)" if x.dim() == 3
                                else "torch.matmul(a, b) (a broadcast)",
                "bound_us": bound, "bound_by": bound_by,
                "bound_no_fma_us": no_fma, "bound_no_fma_by": no_fma_by}

    rows = {}
    for what, (sa, sb) in BMM_SHAPES.items():
        a, b = rnd(*sa), rnd(*sb)
        rows[what] = row(a, b, "a @ b")
        if a.dim() == 3 and sa[1] == 16:    # the training shapes' backward forms
            dy = rnd(sb[0], sa[1], sb[2])
            rows[f"{what}: dY @ B^T"] = row(dy, b.transpose(1, 2), "dY @ B^T")
            rows[f"{what}: A^T @ dY"] = row(a.transpose(1, 2), dy, "A^T @ dY")
    print(f"batched_matmul: {len(checks)} checks bit for bit; " + "; ".join(
        f"{what} {r['kernel_us']:.3f} us (first design {r['previous_kernel_us']:.3f}, "
        f"library {r['library_us']:.3f})" for what, r in rows.items()), flush=True)
    return {"checks": checks, "rows": rows}


def mesh_kernel_phase(dev) -> dict:
    """The kernels at the shapes only the mesh path gives them: the
    fingerprint of one shard's trained rows, (25, 6570) at S = 4, (34,
    6570) at S = 3 and (4, 6570) in a flush at S = 4, bit for bit at every
    forced cluster size on and off the 16-byte grid; the cluster means of
    the padded cohort, (102, 6570) at C = 5 with two zero-weight padding
    rows (label 0, holding NaN), bit for bit against the plain version and,
    sliced to 100, against the (100, 6570) call on the real rows; each
    timed beside its bound, cluster_agg beside torch.matmul too."""
    rng = np.random.default_rng(SEED + 11)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    fp_rows = []
    for m, n in ((25, 6570), (34, 6570), (4, 6570)):
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
        fp_rows.append({"m": m, "n": n, "bit_exact": True, "max_abs_err": err,
                        "cluster": fp.cluster_size(m, n),
                        "kernel_us": median_us(fp.fingerprint_cuda, bits, 200, flush),
                        "plain_us": median_us(fp.fingerprint_plain, bits, 30, flush),
                        "library_us": None, "bound_us": bound, "bound_by": bound_by})

    m, k, n, c = 102, 100, 6570, 5
    rows = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, c, size=m)).to(dev)
    w = torch.from_numpy((rng.random(m) < 0.8).astype(np.float32)).to(dev)
    labels[k:], w[k:], rows[k:] = 0, 0.0, float("nan")
    err = check_agg(rows, labels, w, c, f"({m}, {n}) C={c}, two zero-weight padding rows")
    padded = ca.cluster_mean_rows(rows, labels, c, w)[:k]
    real = ca.cluster_mean_rows(rows[:k].contiguous(), labels[:k], c, w[:k])
    if not torch.equal(padded.view(torch.int32), real.view(torch.int32)):
        raise AssertionError("cluster_agg at (102, 6570) with two zero-weight rows "
                             "!= the (100, 6570) call on the real rows")
    wo, denom = ca.cluster_weights(labels, c, w)
    onehot = (labels[:, None] == torch.arange(c, device=dev)[None, :]).float()
    mix = (onehot / denom[None, :]) @ wo.T
    finite = rows.nan_to_num()          # the library call times the same product
    n_live = int(w.gt(0).sum())
    bound, bound_by = bound_us((n_live * n + m * n + m * c + c) * 4 + m * 8,
                               2 * n_live * n + c * n)
    agg_row = {"m": m, "real_rows": k, "n": n, "clusters": c, "live_rows": n_live,
               "bit_exact": True, "max_abs_err": err, "equals_real_rows_call": True,
               "kernel_us": median_us(lambda _: ca.cluster_agg_cuda(rows, labels, wo, denom),
                                      None, 200, flush),
               "plain_us": median_us(lambda _: ca.cluster_agg_plain(rows, labels, wo, denom),
                                     None, 30, flush),
               "library_us": median_us(lambda _: torch.matmul(mix, finite),
                                       None, 200, flush),
               "bound_us": bound, "bound_by": bound_by}
    return {"fingerprint": fp_rows, "cluster_agg": agg_row}


def trace_records(manifest: dict) -> list[dict]:
    """The run's trace: its sha256 the manifest's ``trace_digest``, every
    line valid under the port's schema, every name registered."""
    path = manifest["trace_path"]
    if file_sha256(path) != manifest["trace_digest"]:
        raise AssertionError(f"obs: {path} does not hash to the manifest's digest")
    lines = open(path).read().splitlines()
    validate_trace_lines(lines)
    recs = [json.loads(line) for line in lines]
    bad = sorted({r["name"] for r in recs[1:]
                  if not is_registered(r["name"], ALL_NAMES | PORT_SPAN_NAMES)})
    if bad:
        raise AssertionError(f"obs: unregistered names in {path}: {bad}")
    return recs


def span_ms(recs: list[dict]) -> dict[str, list[float]]:
    """Wall ms of every ``round.*``, ``flush.*`` and ``step.*`` span, by name."""
    durs: dict[str, list[float]] = {}
    for r in recs:
        if r["kind"] == "span" and r["name"].startswith(("round.", "flush.", "step.")):
            durs.setdefault(r["name"], []).append(r["dur_us"] / 1e3)
    return durs


def traced_mode(mode: str, drained: dict, dev, root: str) -> dict:
    """One mode at the defaults on the card four ways, each run twice in
    turns (OBS_ORDER): untraced (a host clock around each span, no wait
    for the card), traced with ``block_until_ready`` (each span waits for
    its kernels), traced without it, and drained (RoundTimer).  Every run ends on the same
    digests; each trace validates, names only registered names and reports
    no compile (every library was loaded before); each kernel of the path
    launched.  Span p50s pool both runs of a way; the traced step's p50 is
    at least OBS_STEP_FLOOR of the drained one (``drained``: RoundTimer's
    p50s of the same spans)."""
    base = ExperimentSpec(train=TrainSpec(mode=mode))
    total = "round.total" if mode == "sync" else "flush.total"
    step = "round.step" if mode == "sync" else "flush.step"
    used = ("fingerprint", "cluster_agg", "batched_matmul") + (
        ("pearson",) if mode == "sync" else ())
    want = None
    ways: dict[str, dict] = {}
    for i, name in enumerate(OBS_ORDER):
        way = ways.setdefault(name, {"run_wall_s": [], "spans": {}})
        if name in ("untraced", "drained"):
            spec, clock = base, HostTimer() if name == "untraced" else RoundTimer()
        else:
            spec, clock = dataclasses.replace(base, obs=ObsSpec(
                enabled=True, block_until_ready=name == "traced",
                trace_path=os.path.join(root, f"{mode}-{name}-{i}.jsonl"),
                chrome_path=os.path.join(root, f"{mode}-{name}-{i}-chrome.json"))), None
        reset_launches()
        t0 = time.perf_counter()
        res = run(spec, device=dev, obs=clock)
        torch.cuda.synchronize()
        way["run_wall_s"].append(time.perf_counter() - t0)
        launches = read_launches()
        m = res.manifest
        if want is None:
            want = digests(m)
        if digests(m) != want:
            raise AssertionError(f"obs/{mode}/{name}: tracing moved the digests: "
                                 f"{digests(m)} vs {want}")
        if not all(launches[k] for k in used):
            raise AssertionError(f"obs/{mode}/{name}: launches {launches}")
        if clock is not None:
            spans = clock.spans
        else:
            recs = trace_records(m)
            compiles = [r for r in recs if r["kind"] == "event" and r["name"] == "compile"]
            if compiles or m["timing"]["compiles"]:
                raise AssertionError(f"obs/{mode}/{name}: compile events in a run that "
                                     f"loaded no library: {compiles}")
            spans = span_ms(recs)
            way.update(launches=launches, records=len(recs),
                       trace_bytes=os.path.getsize(m["trace_path"]))
        for k, v in spans.items():
            if k.startswith(("round.", "flush.", "step.")):
                way["spans"].setdefault(k, []).extend(v)
    out = {}
    for name, way in ways.items():
        spans = way.pop("spans")
        out[name] = dict(way, rounds=len(spans[total]),
                         round_ms_p50=float(np.median(spans[total])),
                         round_ms_p99=float(np.percentile(spans[total], 99)),
                         span_ms_p50={k: float(np.median(v)) for k, v in sorted(spans.items())})
    traced = out["traced"]["span_ms_p50"]
    out["digests_equal"] = True
    out["drained_span_ms_p50"] = {k: v for k, v in drained.items() if k in traced}
    out["traced_over_drained"] = {k: traced[k] / v
                                  for k, v in out["drained_span_ms_p50"].items()}
    out["traced_over_drained_in_turn"] = {
        k: traced[k] / v for k, v in out["drained"]["span_ms_p50"].items() if k in traced}
    if not traced[step] >= OBS_STEP_FLOOR * drained[step]:
        raise AssertionError(f"obs/{mode}: traced {step} p50 {traced[step]} ms is below "
                             f"{OBS_STEP_FLOOR} x the drained {drained[step]} ms: the "
                             "span times the launches, not the step")
    out["traced_over_untraced_round"] = (out["traced"]["round_ms_p50"]
                                         / out["untraced"]["round_ms_p50"])
    out["wait_cost_round_ms_p50"] = (out["traced"]["round_ms_p50"]
                                     - out["traced_no_wait"]["round_ms_p50"])
    return out


def child_compile_events(root: str) -> dict:
    """A traced 2-round run in a fresh process: its compile events name
    exactly the kernel libraries a sync run loads, each once."""
    trace = os.path.join(root, "child.jsonl")
    src = str(Path(__file__).resolve().parent / "src")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", OBS_CHILD, src, trace],
                          capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    if proc.returncode:
        raise AssertionError(f"obs: the traced child exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    lines = open(trace).read().splitlines()
    validate_trace_lines(lines)
    recs = [json.loads(line) for line in lines]
    entries = [r["attrs"]["entry"] for r in recs
               if r["kind"] == "event" and r["name"] == "compile"]
    counted = [r["value"] for r in recs if r["kind"] == "counter" and r["name"] == "compiles"]
    if sorted(entries) != sorted(TRAIN_SOURCES) or counted != [len(TRAIN_SOURCES)]:
        raise AssertionError(f"obs: the child's compile events {entries} (compiles "
                             f"{counted}), expected {sorted(TRAIN_SOURCES)} once each")
    return {"entries": entries, "compiles": counted[0],
            "rounds": sorted({r["round"] for r in recs
                              if r["kind"] == "event" and r["name"] == "compile"},
                             key=str),
            "child_wall_s": time.perf_counter() - t0}


def profile_dir_kernels(dev, root: str) -> dict:
    """A traced 2-round run with ``profile_dir``: its ``torch_trace.json``
    must hold the card's events of the fingerprint, Pearson and
    cluster_agg kernels.  A capture that recorded no device activity at all
    (seen once on the card) is taken again, at most CAPTURE_TRIES times."""
    for tries in range(1, CAPTURE_TRIES + 1):
        prof = os.path.join(root, f"prof{tries}")
        spec = ExperimentSpec(train=TrainSpec(rounds=2), obs=ObsSpec(
            enabled=True, trace_path=os.path.join(root, f"prof{tries}.jsonl"),
            profile_dir=prof))
        run(spec, device=dev)
        path = os.path.join(prof, "torch_trace.json")
        events = json.load(open(path))["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        if kernels:
            break
    found = {src: sum(name in k for k in kernels) for src, name in TRAIN_SOURCES.items()}
    if not all(found.values()):
        raise AssertionError(f"obs: {path} holds no kernel event for "
                             f"{[s for s, n in found.items() if not n]}")
    return {"kernel_events": len(kernels), "by_source": found, "tries": tries,
            "trace_bytes": os.path.getsize(path)}


def paa_round_check(dev) -> dict:
    """``core.aggregation.paa_round`` on the card against the CPU on
    well-separated clients (100 MLPs 64-64-32-10 around 5 models, the
    arrival mask as weights): labels equal, the Pearson matrix within
    PEARSON_TOL, prototypes and new params within PAA_ATOL; one Pearson
    launch."""
    mcfg = clf.MLPConfig(in_dim=64, hidden=(64,), rep_dim=32, num_classes=10)
    m, c = 100, 5
    gen = torch.Generator().manual_seed(SEED + 9)
    centers = clf.init_stacked(mcfg, gen, c, same_init=False, device="cpu")
    layout = ArenaLayout.from_stacked(centers)
    rng = np.random.default_rng(SEED + 9)
    noise = torch.from_numpy(rng.standard_normal((m, layout.n_params)).astype(np.float32))
    stacked = layout.unflatten(layout.flatten(centers)[torch.arange(m) % c] + 0.002 * noise)
    probe = torch.from_numpy(rng.standard_normal((32, mcfg.in_dim)).astype(np.float32))
    weights = torch.from_numpy((rng.random(m) < 0.8).astype(np.float32))
    embed = functools.partial(clf.embed_stacked, mcfg)
    before = pe.launches
    card = core_agg.paa_round(embed, tree_map(lambda x: x.to(dev), stacked), probe.to(dev),
                              c, weights.to(dev))
    torch.cuda.synchronize()
    launched = pe.launches - before
    cpu = core_agg.paa_round(embed, stacked, probe, c, weights)
    labels = card.labels.cpu()
    if not torch.equal(labels, cpu.labels) or len(set(labels.tolist())) != c \
            or launched != 1:
        raise AssertionError(f"paa_round labels card {labels.tolist()} vs CPU "
                             f"{cpu.labels.tolist()}, Pearson launches {launched}")
    corr_err = float((card.corr.cpu() - cpu.corr).abs().max())
    proto_err = float((card.prototypes.cpu() - cpu.prototypes).abs().max())
    param_err = max(float((card.new_stacked_params[k].cpu() - v).abs().max())
                    for k, v in cpu.new_stacked_params.items())
    if not (corr_err <= PEARSON_TOL and proto_err <= PAA_ATOL and param_err <= PAA_ATOL):
        raise AssertionError(f"paa_round card vs CPU: corr {corr_err}, prototypes "
                             f"{proto_err}, new params {param_err}")
    return {"m": m, "n_clusters": c, "n_params": layout.n_params, "labels_equal": True,
            "cluster_sizes": card.cluster_sizes.cpu().tolist(),
            "pearson_launches": launched, "corr_max_abs": corr_err,
            "corr_tol": PEARSON_TOL, "prototypes_max_abs": proto_err,
            "new_params_max_abs": param_err, "tol": PAA_ATOL}


def obs_phase(dev, res: dict) -> dict:
    """The port's flight recorder on the card: each mode untraced and
    traced (``traced_mode``, against the drained span times of the train
    and async phases), the compile events of a fresh process, a
    ``profile_dir`` run's kernel events, and ``paa_round`` card vs CPU.
    Traces lie in a ``tempfile.mkdtemp()`` directory removed afterwards."""
    root = tempfile.mkdtemp(prefix="bfln-obs-")
    try:
        out = {"sync": traced_mode("sync", res["train"]["phase_ms_p50"], dev, root),
               "async": traced_mode("async", res["async"]["phase_ms_p50"], dev, root),
               "compile_events": child_compile_events(root),
               "profile_dir": profile_dir_kernels(dev, root),
               "paa_round": paa_round_check(dev)}
        # the last traced run of each mode
        out["launches"] = {k: out["sync"]["traced"]["launches"][k]
                           + out["async"]["traced"]["launches"][k] for k in KERNELS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


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
    want = dict({k: 0 for k in KERNELS}, batched_matmul=SOME)
    for rec in runs:
        if rec["strategy"] == "bfln":
            for k in ("cluster_agg", "pearson", "fingerprint"):
                want[k] += rec["rounds"]
        elif rec["strategy"] != "fedproto":
            want["cluster_agg"] += rec["rounds"]
    if not launches_match(launches, want):
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

    event = observe = set_gauge = compile_delta = inc


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


def qkv(rng, B: int, S: int, Hq: int, Hkv: int, hd: int, dtype, dev, Sk: int | None = None):
    """q (B, S, Hq, hd), k and v (B, Sk, Hkv, hd) (Sk = S unless given),
    standard normal."""
    Sk = S if Sk is None else Sk
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(dev, dtype)
                 for shape in ((B, S, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))


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


def live_pairs(S: int, causal: bool, window: int, Sk: int | None = None) -> int:
    """(query, key) pairs the mask keeps for one (batch, head): queries
    0..S-1 against keys 0..Sk-1 (Sk = S unless given)."""
    Sk = S if Sk is None else Sk
    q = np.arange(S)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(S, dtype=np.int64)
    hi = np.minimum(q, Sk - 1) if causal else np.full(S, Sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def check_flash_lse(q, k, v, causal: bool, window: int, what: str) -> dict:
    """check_flash, then the L the kernel writes with ``return_lse`` against
    the plain log-sum-exp: within FLASH_TOL_F32 max(1, max |L|) over the
    rows with a live key, and within FLASH_TOL_F32 |L| where the mask
    empties a row (its L is then the masked score, -1e30 log2(e))."""
    out = check_flash(q, k, v, causal, window, what)
    _, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
    want = fa.attention_lse_plain(q, k, causal=causal, window=window)
    live = want > 0.5 * fa.NEG_INF * fa.LOG2E
    err = float((lse - want)[live].abs().max())
    dead = int((~live).sum())
    dead_err = float(((lse - want)[~live] / want[~live]).abs().max()) if dead else 0.0
    top = max(1.0, float(want[live].abs().max()))
    if not (err <= FLASH_TOL_F32 * top and dead_err <= FLASH_TOL_F32):
        raise AssertionError(f"flash forward L on {what}: max abs error {err} (limit "
                             f"{FLASH_TOL_F32 * top}), {dead} rows without a live key "
                             f"at rel err {dead_err}")
    return dict(out, lse_max_abs_err=err, lse_rows_without_live_key=dead,
                lse_rel_err_without_live_key=dead_err)


def sdpa_backend(fn, marker: bool = True) -> dict:
    """The device kernels of one call of ``fn`` (torch.profiler), and the
    SDPA backend their names show.  The backend only labels a library time,
    which CUDA events measure; where the profiler recorded nothing usable
    the label says so and the run goes on."""
    try:
        names = sorted(set(device_kernels(fn, marker)))
    except CaptureError as err:
        print(f"SDPA backend not recorded: {err}", file=sys.stderr, flush=True)
        return {"backend": "not recorded", "kernels": [], "capture_error": str(err)}
    low = " ".join(names).lower()
    # cuDNN's, PyTorch's flash (flash_fwd / flash_bwd), memory-efficient
    # (fmha_cutlass) or, failing those, the math path (matmuls and a softmax)
    backend = ("cudnn" if "cudnn" in low
               else "flash" if "flash_fwd" in low or "flash_bwd" in low
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
                # the train path's call: the same kernel also writing L
                "kernel_lse_us": median_us(lambda _: fa.flash_attention_cuda(
                    qd, kd, vd, causal=True, window=window, return_lse=True), None, 10, flush),
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


def flash_whisper_phase(dev) -> tuple[dict, dict]:
    """Both flash kernels at Sq != Sk (the decoder's cross-attention over
    the encoder's frames): the bf16 kernel at whisper-large-v3's three
    attention shapes (FLASH_WHISPER_SHAPES), the float32 kernel at the
    cross shape, and both at FLASH_CROSS_CASES, each held against the plain
    version per element as check_flash does and its L against the plain
    log-sum-exp (check_flash_lse); the three whisper shapes timed beside
    their bound, the plain version and SDPA (no mask, or `is_causal`)."""
    rng = np.random.default_rng(SEED + 11)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows, checks = {}, {}
    for what, ((B, Sq, Sk, Hq, Hkv, hd), causal) in FLASH_WHISPER_SHAPES.items():
        q, k, v = qkv(rng, B, Sq, Hq, Hkv, hd, torch.bfloat16, dev, Sk=Sk)
        check = checks[f"{what} bf16"] = check_flash_lse(q, k, v, causal, 0, what)
        if Sq != Sk:
            checks[f"{what} fp32"] = check_flash_lse(
                *(t.float() for t in (q, k, v)), causal, 0, f"{what} fp32")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(_):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        n_ops = 4 * hd * B * Hq * live_pairs(Sq, causal, 0, Sk)     # q.k and p.v
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e6, n_ops / BF16_OPS_PER_S * 1e6
        rows[what] = dict(
            check, **fa.sm90_occupancy(hd), shape=[B, Sq, Sk, Hq, Hkv, hd], dtype="bfloat16",
            causal=causal,
            kernel_us=median_us(lambda _: fa.flash_attention_cuda(
                q, k, v, causal=causal), None, 20, flush),
            plain_us=median_us(lambda _: fa.attention_plain(
                q, k, v, causal=causal), None, 3, flush),
            library_us=median_us(sdpa, None, 20, flush),
            library_call=f"F.scaled_dot_product_attention(is_causal={causal})",
            library_backend=sdpa_backend(sdpa),
            bound_us=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", flop=n_ops,
            bytes=n_bytes)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    for what, (shape, causal, window, dtypes) in FLASH_CROSS_CASES.items():
        B, Sq, Sk, Hq, Hkv, hd = shape
        args = qkv(rng, B, Sq, Hq, Hkv, hd, torch.float32, dev, Sk=Sk)
        for dt in dtypes:
            typed = args if dt == "fp32" else tuple(t.to(torch.bfloat16) for t in args)
            checks[f"{what} {dt}"] = check_flash_lse(*typed, causal, window, f"{what} {dt}")
    return rows, checks


def flash_lm_phase(dev) -> dict:
    """The bf16 flash kernel at the attention shapes of LM_INFER_CONFIGS
    (head_dim 128; G = 8, 6 and 5, the last two not dividing the kernel's
    128 rows a block), element by element against the float32 plain
    version as in the main check; timed beside its bound, the plain
    version and SDPA (`is_causal`: llama4's window 8192 covers S)."""
    rng = np.random.default_rng(SEED + 10)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for what, ((B, S, Hq, Hkv, hd), window) in FLASH_LM_SHAPES.items():
        q, k, v = qkv(rng, B, S, Hq, Hkv, hd, torch.bfloat16, dev)
        check = check_flash(q, k, v, True, window, what)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def causal_sdpa(_):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        n_ops = 4 * hd * B * Hq * live_pairs(S, True, window)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e6, n_ops / BF16_OPS_PER_S * 1e6
        rows[what] = dict(
            check, **fa.sm90_occupancy(hd), shape=[B, S, Hq, Hkv, hd], dtype="bfloat16",
            window=window,
            kernel_us=median_us(lambda _: fa.flash_attention_cuda(
                q, k, v, causal=True, window=window), None, 10, flush),
            plain_us=median_us(lambda _: fa.attention_plain(
                q, k, v, causal=True, window=window), None, 3, flush),
            library_us=median_us(causal_sdpa, None, 10, flush),
            library_call="F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
            library_backend=sdpa_backend(causal_sdpa),
            bound_us=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", flop=n_ops)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def scan_inputs(gen, B: int, S: int, di: int, dev, *, strong: bool = False,
                h0_scale: float = 0.0, x_dtype=torch.bfloat16, dt_rank: int = 8):
    """The scan's inputs as the Mamba mixer gives them: dt = softplus(z -
    4.6) with z standard normal (around 0.01, the init's dt_bias), or with
    ``strong`` uniform over (0, 5) (exp(dt A) down to exp(-80)); x standard
    normal in ``x_dtype``; Bm and Cm column slices of one (B, S, dt_rank +
    32) projection (the train path's layout at TRAIN_DT_RANK); A =
    -exp(A_log) at the init's A_log (-1 .. -16 a channel); D = 1; h0
    ``h0_scale`` standard normal."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    dt = (torch.rand((B, S, di), generator=gen, device=dev) * 5.0 if strong
          else torch.logaddexp(randn(B, S, di) - 4.6, torch.zeros((), device=dev)))
    proj = randn(B, S, dt_rank + 32)
    A = -torch.arange(1, 17, dtype=torch.float32, device=dev).expand(di, 16).contiguous()
    return (dt, randn(B, S, di).to(x_dtype), proj[..., dt_rank:dt_rank + 16],
            proj[..., dt_rank + 16:], A, torch.ones(di, device=dev),
            h0_scale * randn(B, di, 16))


def scan_err(got, want, what: str) -> float:
    """The larger of y's and h_T's max |got - want|, each of which must be
    within SCAN_RTOL max(1, max |want|)."""
    errs = []
    for a, b in zip(got, want):
        err, scale = float((a - b).abs().max()), max(1.0, float(b.abs().max()))
        if not err <= SCAN_RTOL * scale:
            raise AssertionError(f"selective scan kernel on {what}: max abs error "
                                 f"{err} > {SCAN_RTOL} * {scale}")
        errs.append(err)
    return max(errs)


def scan_bound_us(args) -> tuple[float, str, dict]:
    """Least time for the scan on ``args``: each input read once and each
    output written once over the memory rate, its exponentials over the
    SFUs' rate, its other float32 flops over the CUDA cores' rate."""
    dt, x, Bm, Cm, A, D, h0 = args
    B, S, di = dt.shape
    N = A.shape[1]
    n_bytes = (dt.numel() * 4 + x.numel() * x.element_size() + 2 * B * S * N * 4
               + (A.numel() + D.numel()) * 4 + 2 * h0.numel() * 4 + B * S * di * 4)
    terms = {"bytes_us": n_bytes / HBM_BYTES_PER_S * 1e6,
             "exp_us": B * S * di * N / SFU_OPS_PER_S * 1e6,
             "flops_us": B * S * di * N * SCAN_FLOPS_PER_STATE / ALU32_OPS_PER_S * 1e6}
    bound = max(terms.values())
    return bound, ("bytes" if terms["bytes_us"] >= bound else "operations"), \
        dict(terms, bytes=n_bytes, exps=B * S * di * N)


def scan_phase(dev, floors: dict) -> tuple[dict, dict]:
    """The selective-scan kernel against its plain version at jamba's
    prefill SCAN_SHAPE (x in bf16 and in float32, the model's decays and
    strong ones), split at 1001 against the whole, at a ragged S = 1000,
    on both sides of the kernel's decode-form switch and at decode's S = 1
    from a non-zero state; one call must make one
    device launch where the profiler records it; times at the prefill and
    at decode beside this run's launch floors."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    B, S, di, _ = SCAN_SHAPE
    main = scan_inputs(gen, B, S, di, dev)
    full = sc.selective_scan_cuda(*main)
    checks = {"main (2, 4096, 16384, 16)": scan_err(full, sc.selective_scan_plain(*main),
                                                     "main")}
    dt, x, Bm, Cm, A, D, h0 = main
    y1, h1 = sc.selective_scan_cuda(dt[:, :1001], x[:, :1001], Bm[:, :1001],
                                    Cm[:, :1001], A, D, h0)
    y2, h2 = sc.selective_scan_cuda(dt[:, 1001:], x[:, 1001:], Bm[:, 1001:],
                                    Cm[:, 1001:], A, D, h1)
    checks["split at 1001 vs the whole"] = scan_err((torch.cat([y1, y2], 1), h2), full,
                                                    "split at 1001")
    del full, y1, y2
    cases = {"main strong decays": dict(S=S, strong=True),
             "main x float32": dict(S=S, x_dtype=torch.float32),
             "ragged S = 1000 strong decays, h0": dict(S=1000, strong=True, h0_scale=1.0),
             # the last S of the kernel's decode form and the first of its
             # chunked form
             f"switch S = {sc.DECODE_MAX_S} decode form, h0":
                 dict(S=sc.DECODE_MAX_S, strong=True, h0_scale=1.0),
             f"switch S = {sc.DECODE_MAX_S + 1} chunked form, h0":
                 dict(S=sc.DECODE_MAX_S + 1, strong=True, h0_scale=1.0),
             "decode S = 1, h0": dict(S=1, h0_scale=1.0)}
    for what, kw in cases.items():
        args = scan_inputs(gen, B, kw.pop("S"), di, dev, **kw)
        checks[what] = scan_err(sc.selective_scan_cuda(*args),
                                sc.selective_scan_plain(*args), what)
    one = args                          # the last case: decode's S = 1
    # one device launch a call, where torch.profiler records the call: in
    # this phase captures on the card held the kernel without the marker
    # launched before it, or nothing at all, eight times in a row (two runs),
    # so an empty capture is reported and does not stop the run (the launch
    # counter, which chip_smoke.py's paths read, counts in the wrapper)
    try:
        names = device_kernels(lambda _: sc.selective_scan_cuda(*one), marker=False)
    except CaptureError as err:
        print(f"selective_scan device launches not recorded: {err}", file=sys.stderr,
              flush=True)
        names = None
    if names is not None and len(names) != 1:
        raise AssertionError(f"selective_scan_cuda: one call made {len(names)} device "
                             f"launches, expected 1: {names}")

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    bound, bound_by, terms = scan_bound_us(main)
    row = {"shape": list(SCAN_SHAPE), "dtype": "x bfloat16, the rest float32",
           "device_kernels_per_call": "not recorded" if names is None else 1,
           "device_kernel": None if names is None else names[0],
           "kernel_us": median_us(lambda _: sc.selective_scan_cuda(*main), None, 10, flush),
           # as the train path calls it: storing the state each chunk starts from
           "kernel_states_us": median_us(
               lambda _: sc.selective_scan_cuda(*main, return_states=True), None, 10, flush),
           "plain_us": median_us(lambda _: sc.selective_scan_plain(*main), None, 2, flush),
           "library_us": None, "bound_us": bound, "bound_by": bound_by,
           "bound_terms": terms}
    bound, bound_by, terms = scan_bound_us(one)
    row["decode"] = {"shape": [B, 1, di, 16], "dtype": row["dtype"],
                     "kernel_us": median_us(lambda _: sc.selective_scan_cuda(*one), None,
                                            200, flush),
                     # the same after the flush reads L2 rather than writes it:
                     # the dirty lines the write leaves cost write-backs beside
                     # the call's few MB
                     "kernel_clean_l2_us": median_us(lambda _: sc.selective_scan_cuda(*one),
                                                     None, 200, flush, clean_l2=True),
                     "plain_us": median_us(lambda _: sc.selective_scan_plain(*one), None,
                                           50, flush),
                     "library_us": None, "bound_us": bound, "bound_by": bound_by,
                     "bound_terms": terms, "launch_floor_us": floors["empty_us"],
                     "round_trip_floor_us": floors["round_trip_us"]}
    return row, checks


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


def wkv_phase(dev, floors: dict) -> tuple[dict, dict]:
    """The wkv kernels against their plain version at the LM path's shape
    (chunked), with strong decays, at a ragged T = 1000, at T = 1, 16 and
    63 (recurrent), in two halves and split at 1001 (off every chunk
    boundary) against the whole, and at w = 0; times at the main-path
    shape, and the recurrent kernel's at decode (T = 1) and the 16-token
    prompt's length (T = 16) beside the launch floors of this run."""
    rng = np.random.default_rng(SEED + 7)
    B, H, T, hd = LM_BATCH, 40, LM_SEQ, 64                 # rwkv6-3b's heads
    main = wkv_inputs(rng, B, H, T, hd, dev)
    full = wk.rwkv6_cuda(*main)
    checks = {"main (2, 40, 4096, 64)": wkv_err(full, wk.rwkv6_plain(*main), "main")}
    one = wkv_inputs(rng, B, H, 1, hd, dev)
    checks["T = 1 (2, 40, 1, 64)"] = wkv_err(wk.rwkv6_cuda(*one), wk.rwkv6_plain(*one),
                                             "T = 1")
    prompt = wkv_inputs(rng, B, H, PROMPT, hd, dev)
    checks[f"T = {PROMPT} (2, 40, {PROMPT}, 64)"] = wkv_err(
        wk.rwkv6_cuda(*prompt), wk.rwkv6_plain(*prompt), f"T = {PROMPT}")
    short = wkv_inputs(rng, B, H, wk.CHUNK - 1, hd, dev, strong=True)
    checks[f"T = {wk.CHUNK - 1} (2, 40, {wk.CHUNK - 1}, 64) strong decays"] = wkv_err(
        wk.rwkv6_cuda(*short), wk.rwkv6_plain(*short), f"T = {wk.CHUNK - 1}")
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
           # the train path's call: the same kernel also storing each chunk's state
           "kernel_states_us": median_us(lambda _: wk.rwkv6_cuda(*main, return_states=True),
                                         None, 20, flush),
           "plain_us": median_us(lambda _: wk.rwkv6_plain(*main), None, 3, flush),
           "library_us": None,
           "bound_us": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "flop": n_ops}
    # the recurrent kernel: at the decode shape (T = 1, once a layer a
    # token) and at a prompt's length, beside this run's floors
    for key, args in (("decode", one), ("t16", prompt)):
        steps = args[0].shape[2]
        n_bytes = (sum(t.numel() for t in args) + B * H * steps * hd + B * H * hd * hd) * 4
        n_ops = B * H * steps * (WKV_FLOPS_PER_STATE * hd * hd + WKV_FLOPS_PER_CHANNEL * hd)
        bound, bound_by = bound_us(n_bytes, n_ops)
        row[key] = {"shape": [B, H, steps, hd], "dtype": "float32",
                    "kernel_us": median_us(lambda _: wk.rwkv6_cuda(*args), None, 200, flush),
                    "plain_us": median_us(lambda _: wk.rwkv6_plain(*args), None, 50, flush),
                    "library_us": None, "bound_us": bound, "bound_by": bound_by,
                    "bytes": n_bytes, "flop": n_ops,
                    "launch_floor_us": floors["empty_us"],
                    "round_trip_floor_us": floors["round_trip_us"]}
    return row, checks


def check_flash_bwd(q, k, v, dout, causal: bool, window: int, what: str) -> dict:
    """The backward kernel against the plain backward on the same inputs
    (the forward kernel's output O for both, and the kernel takes the L
    its forward wrote, held first against the plain log-sum-exp in log2
    units within FLASH_TOL_F32 max(1, max |L|) over the rows with a live
    key and within FLASH_TOL_F32 |L| over those without): float32 within
    FLASH_BWD_RTOL_F32 max |want|; bf16 per element against the float32
    plain backward, FLASH_RTOL_BF16 |want| + FLASH_BWD_ATOL_BF16 max |want|;
    a second call gives the same bits (no atomics).  Sq and Sk may
    differ."""
    bf16 = q.dtype == torch.bfloat16
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    want_lse = fa.attention_lse_plain(q, k, causal=causal, window=window)
    live = want_lse > 0.5 * fa.NEG_INF * fa.LOG2E
    lse_err = float((lse - want_lse)[live].abs().max())
    dead_err = float(((lse - want_lse)[~live] / want_lse[~live]).abs().max()) \
        if not bool(live.all()) else 0.0
    if not (lse_err <= FLASH_TOL_F32 * max(1.0, float(want_lse[live].abs().max()))
            and dead_err <= FLASH_TOL_F32):
        raise AssertionError(f"flash forward L on {what}: max abs error {lse_err} over "
                             f"the rows with a live key, rel err {dead_err} without")
    del want_lse, live
    got = fa.flash_attention_backward_cuda(q, k, v, out, dout, causal=causal, window=window,
                                           lse=lse)
    want = fa.attention_backward_plain(q.float(), k.float(), v.float(), out.float(),
                                       dout.float(), causal=causal, window=window)
    errs, shares = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.dtype != q.dtype or g.shape != w.shape:
            raise AssertionError(f"flash backward on {what}: {name} {g.dtype} "
                                 f"{tuple(g.shape)}")
        top = float(w.abs().max())
        diff = (g.float() - w).abs()
        limit = (FLASH_RTOL_BF16 * w.abs() + FLASH_BWD_ATOL_BF16 * top) if bf16 \
            else torch.full_like(w, FLASH_BWD_RTOL_F32 * top)
        errs[name], shares[name] = float(diff.max()), float((diff / limit).max())
        if not shares[name] <= 1.0:
            raise AssertionError(f"flash backward kernel vs plain on {what}: {name} is "
                                 f"{shares[name]} of its limit (max abs error "
                                 f"{errs[name]}, max |want| {top})")
    again = fa.flash_attention_backward_cuda(q, k, v, out, dout, causal=causal,
                                             window=window, lse=lse)
    if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
        raise AssertionError(f"flash backward on {what}: two calls differ")
    return {"max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
            "max_share_of_limit": max(shares.values()), "lse_max_abs_err": lse_err,
            "rows_without_live_key": int((lse < 0.5 * fa.NEG_INF * fa.LOG2E).sum()),
            "bit_identical_twice": True,
            "tolerance": ({"rtol": FLASH_RTOL_BF16, "atol_of_max": FLASH_BWD_ATOL_BF16}
                          if bf16 else {"atol_of_max": FLASH_BWD_RTOL_F32})}


# the backward's edge cases, each in float32 and in bf16: (B, S, Hq, Hkv, hd),
# causal, window
FLASH_BWD_CASES = {"ragged (1, 1000, 4, 2, 64)": ((1, 1000, 4, 2, 64), True, 0),
                   "G = 8 (1, 300, 8, 1, 64) window 100": ((1, 300, 8, 1, 64), True, 100),
                   "hd 120 (1, 130, 4, 1, 120)": ((1, 130, 4, 1, 120), True, 0),
                   "non-causal (1, 512, 4, 4, 128)": ((1, 512, 4, 4, 128), False, 0),
                   "G = 16 (1, 200, 16, 1, 64)": ((1, 200, 16, 1, 64), True, 0),
                   "G = 5 (1, 257, 10, 2, 64)": ((1, 257, 10, 2, 64), True, 0),
                   "hd 128 (1, 384, 4, 2, 128) window 100":
                       ((1, 384, 4, 2, 128), True, 100),
                   "hd 256 G = 16 (1, 333, 32, 2, 256) window 77":
                       ((1, 333, 32, 2, 256), True, 77)}


def sdpa_backward(q, k, v, dout, **kwargs):
    """One call: the backward of SDPA (enable_gqa) through torch.autograd,
    its forward run once beforehand; a library time for the table, never a
    path of the port."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kwargs)
    do = dout.transpose(1, 2)

    def call(_):
        return torch.autograd.grad(o, (qt, kt, vt), do, retain_graph=True)
    return call


def flash_bwd_phase(dev) -> tuple[dict, dict]:
    """The flash backward kernel against its plain version at the LM path's
    (2, 4096, 8 / 4, 256), window 1024 and causal global, in bf16 and
    float32, and at the edge cases; times at the main shape, per dtype and
    window, beside the bound, the plain backward and SDPA's backward.  The
    bf16 kernel also at whisper-large-v3's three shapes at hd 64
    (FLASH_WHISPER_SHAPES: the encoder, the cross-attention at Sq != Sk,
    the causal decoder), checked and timed the same way, each row with the
    plan's kernels, their registers and CTAs an SM (`bf16_whisper`), and
    the float32 kernel at the cross-attention shape (`fp32_whisper_cross`);
    both
    kernels at FLASH_CROSS_CASES' Sq != Sk (rows with no live key
    included), each in float32 and bf16."""
    rng = np.random.default_rng(SEED + 8)
    B, S, Hq, Hkv, hd = LM_BATCH, LM_SEQ, 8, 4, 256
    q, k, v = qkv(rng, B, S, Hq, Hkv, hd, torch.bfloat16, dev)
    dout = torch.from_numpy(rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
                            ).to(dev, torch.bfloat16)
    inputs = {"bf16": (q, k, v, dout), "fp32": tuple(t.float() for t in (q, k, v, dout))}
    checks = {}
    for dt, args in inputs.items():
        for window in (1024, 0):
            what = f"main (2, 4096, 8, 4, 256) window {window} {dt}"
            checks[what] = check_flash_bwd(*args, True, window, what)
    for what, (shape, causal, window) in FLASH_BWD_CASES.items():
        q3, k3, v3 = qkv(rng, *shape, torch.float32, dev)
        d3 = torch.from_numpy(rng.standard_normal(tuple(q3.shape)).astype(np.float32)).to(dev)
        checks[what + " fp32"] = check_flash_bwd(q3, k3, v3, d3, causal, window, what)
        checks[what + " bf16"] = check_flash_bwd(
            *(t.to(torch.bfloat16) for t in (q3, k3, v3, d3)), causal, window, what)

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    pos = torch.arange(S, device=dev)
    rows = {}
    for dt, (qd, kd, vd, dd) in inputs.items():
        item = qd.element_size()
        # read q, k, v, O, dO once, write dq, dk, dv once
        n_bytes = (4 * qd.numel() + 4 * kd.numel()) * item
        ops_per_s = (BF16_OPS_PER_S if dt == "bf16"
                     else TF32_OPS_PER_S / TF32_PRODUCTS_PER_FP32)
        rows[dt] = []
        for window in (1024, 0):
            # the train path's call: the backward takes the L its forward wrote
            out, lse = fa.flash_attention_cuda(qd, kd, vd, causal=True, window=window,
                                               return_lse=True)
            band = pos[None, :] <= pos[:, None]
            if window:
                band &= pos[:, None] - pos[None, :] < window
            n_ops = FLASH_BWD_FLOPS_PER_PAIR_HD * hd * B * Hq * live_pairs(S, True, window)
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e6, n_ops / ops_per_s * 1e6
            band_bwd = sdpa_backward(qd, kd, vd, dd, attn_mask=band)
            row = {
                "shape": [B, S, Hq, Hkv, hd], "dtype": str(qd.dtype).removeprefix("torch."),
                "window": window,
                "kernel_us": median_us(lambda _: fa.flash_attention_backward_cuda(
                    qd, kd, vd, out, dd, causal=True, window=window, lse=lse), None, 5,
                    flush),
                "plain_us": median_us(lambda _: fa.attention_backward_plain(
                    qd, kd, vd, out, dd, causal=True, window=window), None, 2, flush),
                "library_us": median_us(band_bwd, None, 5, flush),
                "library_call": "torch.autograd.grad of F.scaled_dot_product_attention"
                                "(band mask, enable_gqa=True)",
                "library_backend": sdpa_backend(band_bwd, marker=False),
                "bound_us": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations", "flop": n_ops,
                "bytes": n_bytes}
            del band_bwd
            if dt == "fp32":
                row["bound_cuda_cores_us"] = max(t_bytes, n_ops / ALU32_OPS_PER_S * 1e6)
            if window == 0:
                causal_bwd = sdpa_backward(qd, kd, vd, dd, is_causal=True)
                row["library_causal_us"] = median_us(causal_bwd, None, 5, flush)
                row["library_causal_call"] = ("torch.autograd.grad of F.scaled_dot_"
                                              "product_attention(is_causal=True, "
                                              "enable_gqa=True)")
                row["library_causal_backend"] = sdpa_backend(causal_bwd, marker=False)
                del causal_bwd
            rows[dt].append(row)
            del out, lse
            torch.cuda.empty_cache()
    # whisper-large-v3's three attention shapes at hd 64 (the encoder, the
    # cross-attention at Sq != Sk, the decoder's causal self-attention),
    # from the L the hd-64 forward writes: the hd-64 backward kernels
    rows["bf16_whisper"] = {}
    for what, ((B, Sq, Sk, Hq, Hkv, hd), causal) in FLASH_WHISPER_SHAPES.items():
        qd, kd, vd = qkv(rng, B, Sq, Hq, Hkv, hd, torch.bfloat16, dev, Sk=Sk)
        dd = torch.from_numpy(rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
                              ).to(dev, torch.bfloat16)
        check = checks[f"{what} bf16"] = check_flash_bwd(qd, kd, vd, dd, causal, 0, what)
        out, lse = fa.flash_attention_cuda(qd, kd, vd, causal=causal, return_lse=True)
        n_bytes = (4 * qd.numel() + 4 * kd.numel()) * qd.element_size()
        n_ops = FLASH_BWD_FLOPS_PER_PAIR_HD * hd * B * Hq * live_pairs(Sq, causal, 0, Sk)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e6, n_ops / BF16_OPS_PER_S * 1e6
        library = sdpa_backward(qd, kd, vd, dd, is_causal=causal)
        rows["bf16_whisper"][what] = dict(
            check, **fa.bwd_sm90_occupancy(hd), shape=[B, Sq, Sk, Hq, Hkv, hd],
            dtype="bfloat16", causal=causal,
            kernel_us=median_us(lambda _: fa.flash_attention_backward_cuda(
                qd, kd, vd, out, dd, causal=causal, lse=lse), None, 10, flush),
            plain_us=median_us(lambda _: fa.attention_backward_plain(
                qd, kd, vd, out, dd, causal=causal), None, 2, flush),
            library_us=median_us(library, None, 10, flush),
            library_call=("torch.autograd.grad of F.scaled_dot_product_attention"
                          f"(is_causal={causal})"),
            library_backend=sdpa_backend(library, marker=False),
            bound_us=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", flop=n_ops,
            bytes=n_bytes)
        del qd, kd, vd, dd, out, lse, library
        torch.cuda.empty_cache()
    # the float32 kernel at whisper's cross-attention shape (the float32
    # step's cross-attention runs it at Sq != Sk)
    what, ((B, Sq, Sk, Hq, Hkv, hd), causal) = next(
        (w, c) for w, c in FLASH_WHISPER_SHAPES.items() if c[0][1] != c[0][2])
    qd, kd, vd = qkv(rng, B, Sq, Hq, Hkv, hd, torch.float32, dev, Sk=Sk)
    dd = torch.from_numpy(rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)).to(dev)
    check = checks[f"{what} fp32"] = check_flash_bwd(qd, kd, vd, dd, causal, 0, what)
    out, lse = fa.flash_attention_cuda(qd, kd, vd, causal=causal, return_lse=True)
    n_bytes = (4 * qd.numel() + 4 * kd.numel()) * qd.element_size()
    n_ops = FLASH_BWD_FLOPS_PER_PAIR_HD * hd * B * Hq * live_pairs(Sq, causal, 0, Sk)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e6
    t_ops = n_ops / (TF32_OPS_PER_S / TF32_PRODUCTS_PER_FP32) * 1e6
    library = sdpa_backward(qd, kd, vd, dd, is_causal=causal)
    rows["fp32_whisper_cross"] = dict(
        check, shape=[B, Sq, Sk, Hq, Hkv, hd], dtype="float32", causal=causal,
        kernel_us=median_us(lambda _: fa.flash_attention_backward_cuda(
            qd, kd, vd, out, dd, causal=causal, lse=lse), None, 5, flush),
        plain_us=median_us(lambda _: fa.attention_backward_plain(
            qd, kd, vd, out, dd, causal=causal), None, 2, flush),
        library_us=median_us(library, None, 5, flush),
        library_call="torch.autograd.grad of F.scaled_dot_product_attention(is_causal=False)",
        library_backend=sdpa_backend(library, marker=False),
        bound_us=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_cuda_cores_us=max(t_bytes, n_ops / ALU32_OPS_PER_S * 1e6), flop=n_ops,
        bytes=n_bytes)
    del qd, kd, vd, dd, out, lse, library
    torch.cuda.empty_cache()
    # both backward kernels at Sq != Sk off whisper's shapes, in both dtypes
    for what, (shape, causal, window, _) in FLASH_CROSS_CASES.items():
        B, Sq, Sk, Hq, Hkv, hd = shape
        q3, k3, v3 = qkv(rng, B, Sq, Hq, Hkv, hd, torch.float32, dev, Sk=Sk)
        d3 = torch.from_numpy(rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)).to(dev)
        checks[f"{what} fp32"] = check_flash_bwd(q3, k3, v3, d3, causal, window, what)
        checks[f"{what} bf16"] = check_flash_bwd(
            *(t.to(torch.bfloat16) for t in (q3, k3, v3, d3)), causal, window, what)
    return rows, checks


def check_wkv_bwd(args, what: str) -> dict:
    """The wkv backward kernel against its plain version: every gradient
    within WKV_TOL max(1, max |want|); the kernel walks from the states its
    forward stored, as on the train path."""
    states = wk.rwkv6_cuda(*args[:6], return_states=True)[2]
    got = wk.rwkv6_backward_cuda(*args, states=states)
    want = wk.rwkv6_backward_plain(*args)
    errs, shares = {}, {}
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        errs[name] = float((g - w).abs().max())
        shares[name] = errs[name] / (WKV_TOL * max(1.0, float(w.abs().max())))
        if not shares[name] <= 1.0:
            raise AssertionError(f"wkv backward kernel on {what}: {name} max abs error "
                                 f"{errs[name]} is {shares[name]} of its limit")
    return {"max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
            "max_share_of_limit": max(shares.values())}


def wkv_bwd_phase(dev) -> tuple[dict, dict]:
    """The wkv backward kernel against its plain version at the LM path's
    (2, 40, 4096, 64) with the model's decays and a non-zero s0 and dS_T, at
    T = 1000, 1, 63, 64 and 65 (either side of one chunk), at hd 16 and 32
    and with w = 0; times at the main shape, with the states from the
    forward as the train path has them, and with the forward's states pass
    (a call without them)."""
    rng = np.random.default_rng(SEED + 9)
    B, H, T, hd = LM_BATCH, 40, LM_SEQ, 64

    def cotangents(shape):
        return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                     for s in (shape, shape[:2] + (shape[3], shape[3])))
    main = (*wkv_inputs(rng, B, H, T, hd, dev, strong=True), *cotangents((B, H, T, hd)))
    checks = {"main (2, 40, 4096, 64), strong decays, s0 and dS_T":
              check_wkv_bwd(main, "main")}
    ragged = (*wkv_inputs(rng, B, H, 1000, hd, dev), *cotangents((B, H, 1000, hd)))
    checks["ragged T = 1000 (2, 40, 1000, 64)"] = check_wkv_bwd(ragged, "T = 1000")
    one = (*wkv_inputs(rng, B, H, 1, hd, dev), *cotangents((B, H, 1, hd)))
    checks["T = 1 (2, 40, 1, 64)"] = check_wkv_bwd(one, "T = 1")
    zero = list(wkv_inputs(rng, 1, 4, 200, hd, dev)) + list(cotangents((1, 4, 200, hd)))
    zero[3].zero_()
    checks["w = 0 (1, 4, 200, 64)"] = check_wkv_bwd(zero, "w = 0")
    for shape in ((2, 40, 63, 64), (2, 40, 64, 64), (2, 40, 65, 64), (1, 3, 130, 16),
                  (1, 3, 77, 32), (2, 4, 4096, 32)):
        what = f"{shape}" + (" strong decays" if shape[3] == 16 else "")
        args = (*wkv_inputs(rng, *shape, dev, strong=shape[3] == 16), *cotangents(shape))
        checks[what] = check_wkv_bwd(args, what)
    states = wk.rwkv6_cuda(*main[:6], return_states=True)[2]

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    seq = B * H * T * hd * 4
    state = B * H * hd * hd * 4
    # read r, k, v, w, dy, u, s0, dS_T once; write dr, dk, dv, dw, du, ds0 once
    n_bytes = 9 * seq + 2 * H * hd * 4 + 3 * state
    n_ops = B * H * T * WKV_BWD_FLOPS_PER_STATE * hd * hd
    bound, bound_by = bound_us(n_bytes, n_ops)
    row = {"shape": [B, H, T, hd], "dtype": "float32",
           "kernel_us": median_us(lambda _: wk.rwkv6_backward_cuda(*main, states=states),
                                  None, 10, flush),
           "plain_us": median_us(lambda _: wk.rwkv6_backward_plain(*main), None, 1, flush),
           "library_us": None, "bound_us": bound, "bound_by": bound_by,
           "bytes": n_bytes, "flop": n_ops}
    return row, checks


def check_scan_bwd(args, what: str) -> dict:
    """The scan's backward kernel against its plain backward: every
    gradient within SCAN_BWD_RTOL max(1, max |want|), dx in bf16 per
    element against the float32 plain dx within FLASH_RTOL_BF16 |want| +
    that limit; the kernel walks from the states its forward stored, as on
    the train path, and a second call gives the same bits."""
    fwd, bwd = args[:7], args[7:]
    states = sc.selective_scan_cuda(*fwd, return_states=True)[2]
    got = sc.selective_scan_backward_cuda(*fwd, *bwd, states=states)
    again = sc.selective_scan_backward_cuda(*fwd, *bwd, states=states)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"scan backward kernel on {what}: two calls differ")
    del again, states
    return scan_bwd_shares(got, scan_bwd_want(args), what)


def scan_bwd_want(args) -> list[torch.Tensor]:
    """The plain backward's gradients of ``args`` (forward inputs, dy,
    dh_T), dx in float32: for bf16 x, that of x's float32 copy."""
    fwd, bwd = args[:7], args[7:]
    want = list(sc.selective_scan_backward_plain(*fwd, *bwd))
    if fwd[1].dtype == torch.bfloat16:
        want[1] = sc.selective_scan_backward_plain(fwd[0], fwd[1].float(), *fwd[2:],
                                                   *bwd)[1]
    return want


def scan_bwd_shares(got, want, what: str) -> dict:
    """Each gradient of ``got`` against ``want`` (scan_bwd_want) within
    SCAN_BWD_RTOL max(1, max |want|), dx in bf16 (``got``'s dtype) per
    element within FLASH_RTOL_BF16 |want| + that limit; raises on one
    outside."""
    bf16 = got[1].dtype == torch.bfloat16
    errs, shares = {}, {}
    for name, g, w in zip(("ddt", "dx", "dBm", "dCm", "dA", "dD", "dh0"), got, want):
        diff = (g.float() - w).abs()
        errs[name] = float(diff.max())
        limit = SCAN_BWD_RTOL * max(1.0, float(w.abs().max()))
        if name == "dx" and bf16:
            shares[name] = float((diff / (FLASH_RTOL_BF16 * w.abs() + limit)).max())
        else:
            shares[name] = errs[name] / limit
        if not shares[name] <= 1.0:
            raise AssertionError(f"scan backward kernel on {what}: {name} max abs error "
                                 f"{errs[name]} is {shares[name]} of its limit")
    return {"max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
            "max_share_of_limit": max(shares.values()),
            "share_of_limit_by_grad": shares}


def scan_bwd_phase(dev, floors: dict) -> tuple[dict, dict]:
    """The scan's backward kernel against its plain backward at jamba's
    prefill SCAN_SHAPE (x bf16 and float32, the model's decays and strong
    ones, non-zero h0 and dh_T), at S = 1000, S = 1 and on both sides of
    the decode form (4, 5), of one 16-step chunk (15, 16, 17) and of 64
    steps (63, 64, 65); times at the main shape with the states from the
    forward, as the train path has them, beside the plain backward, and
    again with Bm / Cm as slices of the train path's (B, S, TRAIN_DT_RANK +
    32) projection (the same gradients bit for bit), sampling the SM clock
    while the main shape is timed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    B, S, di, N = SCAN_SHAPE

    def case(S, **kw):
        args = scan_inputs(gen, B, S, di, dev, h0_scale=1.0, **kw)
        return (*args, torch.randn((B, S, di), generator=gen, device=dev),
                torch.randn((B, di, N), generator=gen, device=dev))
    main = case(S)
    checks = {"main (2, 4096, 16384, 16), h0 and dh_T": check_scan_bwd(main, "main")}
    torch.cuda.empty_cache()
    cases = {"main x float32": dict(S=S, x_dtype=torch.float32),
             "main strong decays": dict(S=S, strong=True),
             "ragged S = 1000 strong decays": dict(S=1000, strong=True),
             "S = 1": dict(S=1)}
    for s in (sc.DECODE_MAX_S, sc.DECODE_MAX_S + 1, sc.CHUNK - 1, sc.CHUNK, sc.CHUNK + 1,
              63, 64, 65):
        cases[f"S = {s} strong decays"] = dict(S=s, strong=True)
    for what, kw in cases.items():
        checks[what] = check_scan_bwd(case(**kw), what)
        torch.cuda.empty_cache()

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    states = sc.selective_scan_cuda(*main[:7], return_states=True)[2]
    x = main[1]
    # the train path's layout: Bm / Cm slices of a (B, S, TRAIN_DT_RANK + 32)
    # projection, the other inputs main's
    proj = torch.randn((B, S, TRAIN_DT_RANK + 2 * N), generator=gen, device=dev)
    proj[..., TRAIN_DT_RANK:TRAIN_DT_RANK + N] = main[2]
    proj[..., TRAIN_DT_RANK + N:] = main[3]
    train = (*main[:2], proj[..., TRAIN_DT_RANK:TRAIN_DT_RANK + N],
             proj[..., TRAIN_DT_RANK + N:], *main[4:])
    # read dt, x, dy, B, C, A, D, h0, dh_T once; write ddt, dx, dB, dC, dA,
    # dD, dh0 once
    seq = B * S * di
    n_bytes = (seq * (4 + 2 * x.element_size() + 4 + 4) + 4 * B * S * N * 4
               + (2 * di * N + 2 * di) * 4 + 3 * B * di * N * 4)
    terms = {"bytes_us": n_bytes / HBM_BYTES_PER_S * 1e6,
             "exp_us": seq * N / SFU_OPS_PER_S * 1e6,
             "flops_us": seq * N * SCAN_BWD_FLOPS_PER_STATE / ALU32_OPS_PER_S * 1e6}
    bound = max(terms.values())
    kernel_us, clocks = with_clocks(lambda: median_us(
        lambda _: sc.selective_scan_backward_cuda(*main, states=states), None, 10, flush))
    row = {"shape": list(SCAN_SHAPE), "dtype": "x bfloat16, the rest float32",
           "kernel_us": kernel_us,
           "clocks_while_timed": clocks,
           "kernel_train_layout_us": median_us(lambda _: sc.selective_scan_backward_cuda(
               *train, states=states), None, 10, flush),
           "train_layout": f"Bm / Cm column slices of a (B, S, {TRAIN_DT_RANK} + 32) "
                           "projection",
           "plain_us": median_us(lambda _: sc.selective_scan_backward_plain(*main), None,
                                 1, flush),
           "library_us": None, "bound_us": bound,
           "bound_by": "bytes" if terms["bytes_us"] >= bound else "operations",
           "bound_terms": dict(terms, bytes=n_bytes, exps=seq * N),
           "states_bytes": states.numel() * 4,
           "launch_floor_us": floors["empty_us"],
           "round_trip_floor_us": floors["round_trip_us"]}
    if not all(torch.equal(a, b) for a, b in zip(
            sc.selective_scan_backward_cuda(*train, states=states),
            sc.selective_scan_backward_cuda(*main, states=states))):
        raise AssertionError("scan backward kernel: the train layout's gradients differ")
    del main, train, proj, states
    torch.cuda.empty_cache()
    return row, checks


def train_launches(cfg, steps: int, dtype: str) -> dict[str, int]:
    """Each kernel's launches in ``steps`` train steps of ``cfg`` (with
    frames where it has an encoder): a mixer's forward kernel once a layer
    (twice for a period's layers under remat: the backward runs the period
    again), its backward kernel once; flash also once a cross-attention
    block (twice under remat, with its decoder layer) and once an encoder
    layer (the encoder runs outside remat), its backward once each."""
    periods = list(cfg.pattern) * cfg.n_periods
    again = 2 if cfg.remat else 1

    def fwd(mixer):
        return steps * (again * sum(s.mixer == mixer for s in periods)
                        + sum(s.mixer == mixer for s in cfg.remainder))
    n = mixer_counts(cfg)
    cross = steps * (again * sum(s.cross_attn for s in periods)
                     + sum(s.cross_attn for s in cfg.remainder))
    return dict({k: 0 for k in KERNELS},
                **{f"flash_attention_{dtype}": fwd("attn") + cross + steps * n["encoder"],
                   f"flash_attention_bwd_{dtype}": steps * (n["attn"] + n["cross"]
                                                            + n["encoder"]),
                   "rwkv6": fwd("rwkv"), "rwkv6_bwd": steps * n["rwkv"],
                   "selective_scan": fwd("mamba"),
                   "selective_scan_bwd": steps * n["mamba"]})


def lm_train_config(cfg, dev) -> dict:
    """LM_TRAIN_STEPS AdamW steps at a constant LM_TRAIN_LR on one fixed
    (LM_BATCH, LM_SEQ) batch, every kernel's launch count reset just before
    and read just after; the losses finite, the last below the first."""
    params = lmt.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = lm_batch(cfg, dev)
    opt = topt.adamw(LM_TRAIN_LR)
    step = lmsteps.make_train_step(cfg, opt)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls = [], []
    reset_launches()
    for _ in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, params, state = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: train losses {losses}")
    steps = LM_TRAIN_STEPS
    want = train_launches(cfg, steps, "bf16")
    if launches != want:
        raise AssertionError(f"{cfg.name}: train launches {launches}, expected {want}")
    p50 = float(np.median(walls))
    del params, state, step
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "param_dtype": cfg.param_dtype, "n_params": n_params, "remat": cfg.remat,
            "layers": mixer_counts(cfg), "remat_periods": cfg.n_periods if cfg.remat else 0,
            "batch": LM_BATCH, "seq": LM_SEQ, "steps": steps, "lr": LM_TRAIN_LR,
            "optimizer": "adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)",
            "losses": losses, "step_wall_s": walls, "step_wall_s_p50": p50,
            "tokens_per_s": LM_BATCH * LM_SEQ / p50, "peak_gb": peak_gb,
            "launches": launches}


def grad_recorder():
    """An optimizer whose update returns the gradients as its state."""
    return topt.Optimizer(init=lambda p: None, update=lambda p, g, s: (p, g))


def train_card_vs_cpu(cfg, dev, ep_mesh: tuple[int, int] | None = None) -> dict:
    """The configuration in float32 (fp32_config: one period at full width,
    or ``reduced()`` for the Mamba and MoE ones and whisper), B = 1, S =
    128 (whisper with its frames from frames_for): one train step's loss
    and gradients on the card (kernels) against the host CPU (plain
    versions), same weights; the card's step is the path
    ``lm_train_fp32``, its launch counts read around it.  With ``ep_mesh``
    (data, model): through ``sharding_mode="ep_tp"`` under a mesh of that
    shape (``mesh_devices`` on the card, the host on the CPU), the expert
    tables placed over it (``place_expert_tables``); every MoE layer must
    take the expert-parallel path, and the gradients of the placed blocks
    are compared block by block."""
    cfg32 = fp32_config(cfg)
    p_dev = lmt.init_params(cfg32, seed=SEED + 1, device=dev)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    p_whole = p_dev
    meshes = (contextlib.nullcontext(), contextlib.nullcontext())
    ep_calls = []
    if ep_mesh is not None:
        cfg32 = dataclasses.replace(cfg32, sharding_mode="ep_tp")
        card_mesh = make_model_mesh(*ep_mesh, mesh_devices(ep_mesh[0] * ep_mesh[1])[0])
        meshes = (card_mesh, make_model_mesh(*ep_mesh, "cpu"))
        p_dev = place_expert_tables(p_dev, meshes[0])
        p_cpu = place_expert_tables(p_cpu, meshes[1])
        meshes = tuple(use_mesh(m) for m in meshes)
        real = lmt.moe_apply_shard_map

        def counted(*args, **kwargs):
            ep_calls.append(1)
            return real(*args, **kwargs)
    gen = torch.Generator().manual_seed(SEED)
    toks = torch.randint(0, cfg32.vocab_size, (1, 129), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    frames = frames_for(cfg32, 1, gen)
    if frames is not None:
        batch["enc_embeds"] = frames
    step = lmsteps.make_train_step(cfg32, grad_recorder())
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if ep_mesh is not None:
            stack.enter_context(mock.patch.object(lmt, "moe_apply_shard_map", counted))
        with meshes[0]:
            reset_launches()
            loss_card, _, g_card = step(p_dev, None,
                                        {k: t.to(dev) for k, t in batch.items()})
            torch.cuda.synchronize()
            launches = read_launches()
        with meshes[1]:
            loss_cpu, _, g_cpu = step(p_cpu, None, batch)
    n_moe = sum(s.moe for s in list(cfg32.pattern) * cfg32.n_periods + list(cfg32.remainder))
    if ep_mesh is not None and len(ep_calls) != 2 * n_moe:
        raise AssertionError(f"{cfg.name}: {len(ep_calls)} expert-parallel MoE calls in "
                             f"the two steps, expected {2 * n_moe}")
    loss_err = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{cfg.name}: card vs CPU train loss rel err {loss_err}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(g_card), tree_leaves(g_cpu))):
        err = float((a.cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))
        if not err <= TRAIN_GRAD_RTOL:
            raise AssertionError(f"{cfg.name}: card vs CPU gradient leaf {i} "
                                 f"{tuple(b.shape)}: {err} of max(1, max |g|)")
        worst = max(worst, err)
    want = train_launches(cfg32, 1, "fp32")
    if launches != want:
        raise AssertionError(f"{cfg.name}: float32 train step launches {launches}, "
                             f"expected {want}")
    placed_checks = None
    if ep_mesh is not None:
        placed_checks = placed_tables_checks(cfg32, card_mesh, p_dev, p_whole,
                                             {k: t.to(dev) for k, t in batch.items()})
    return {"n_layers": cfg32.n_layers, "d_model": cfg32.d_model,
            "placed_tables_after_adamw": placed_checks,
            "reduced": dataclasses.replace(cfg32, sharding_mode=ARCHS[cfg.name].sharding_mode)
            == ARCHS[cfg.name].reduced(), "layers": mixer_counts(cfg32),
            "sharding_mode": cfg32.sharding_mode, "ep_mesh": ep_mesh,
            "ep_moe_calls": len(ep_calls), "shape": [1, 128], "remat": cfg32.remat,
            "loss_card": float(loss_card), "loss_cpu": float(loss_cpu),
            "loss_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL,
            "grad_err_of_max": worst, "grad_rtol": TRAIN_GRAD_RTOL,
            "launches": launches, "wall_s": time.perf_counter() - t0}


def bits_equal(got, want) -> bool:
    """Two trees of the same structure, leaf by leaf: same shape, dtype and
    bits (plain values equal)."""
    g, w = tree_leaves(got), tree_leaves(want)
    return len(g) == len(w) and all(
        (a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b))
        if isinstance(b, torch.Tensor) else a == b for a, b in zip(g, w))


def placed_tables_checks(cfg, mesh, placed, whole, batch) -> dict:
    """One AdamW step on the placed expert tables and on the same tables
    whole, under ``mesh``; then PLACED_DECODE_TOKENS tokens of
    `greedy_generate` from each trained tree (the placed one unplaced once
    under the mesh), and a `save_trainer_state` / `restore_trainer_state`
    round trip of the placed, trained tree (parameters and moments written
    whole): tokens and the restored trees equal the whole tree's bit for
    bit, every table in its whole shape."""
    opt = topt.adamw(1e-3)
    step = lmsteps.make_train_step(cfg, opt)
    with use_mesh(mesh):
        _, p_placed, s_placed = step(placed, opt.init(placed), batch)
        _, p_whole, s_whole = step(whole, opt.init(whole), batch)
        prompt = batch["tokens"][:, :4]
        seq = prompt.shape[1] + PLACED_DECODE_TOKENS
        got = lmsteps.greedy_generate(cfg, p_placed, prompt, PLACED_DECODE_TOKENS, seq)
        want = lmsteps.greedy_generate(cfg, p_whole, prompt, PLACED_DECODE_TOKENS, seq)
        if not torch.equal(got, want):
            raise AssertionError(f"{cfg.name}: tokens decoded from the placed, trained "
                                 f"tables {got.tolist()} != the whole tables' "
                                 f"{want.tolist()}")
        root = tempfile.mkdtemp()
        try:
            path = os.path.join(root, "trainer.ckpt")
            save_trainer_state(path, p_placed, s_placed, 1)
            n_bytes = os.path.getsize(path)
            params, state, _, _ = restore_trainer_state(path, batch["tokens"].device)
        finally:
            shutil.rmtree(root)
    if not (bits_equal(params, p_whole) and bits_equal(state, s_whole)):
        raise AssertionError(f"{cfg.name}: the checkpoint of the placed, trained tables "
                             "does not restore the whole tables' bits")
    tables = [tuple(moe[name].shape) for moe in moe_layers(params)
              for name in ("w_gate", "w_up", "w_down")]
    return {"decoded_tokens": PLACED_DECODE_TOKENS, "tokens_equal": True,
            "checkpoint_bits_equal": True, "checkpoint_bytes": n_bytes,
            "whole_table_shapes": tables}


def whisper_train(dev) -> dict:
    """whisper-large-v3 trained at full width, WHISPER_TRAIN_LAYERS encoder
    and as many decoder layers, bf16 weights from `init_params(seed)`:
    LM_TRAIN_STEPS AdamW steps at a constant WHISPER_TRAIN_LR through
    `make_train_step` on one (WHISPER_BATCH, WHISPER_TOKENS) batch with
    (WHISPER_BATCH, 1500, 1280) bf16 frames from a seed (the eval cell's
    batch); every kernel's launch count reset just before and read just
    after (train_launches: bf16 flash 2 x (self + cross) a decoder layer
    and 1 an encoder layer forward, 3 a layer pair backward, a step); the
    losses finite and the last below the first; peak memory and tokens/s."""
    cfg = dataclasses.replace(ARCHS[WHISPER], n_layers=WHISPER_TRAIN_LAYERS,
                              encoder=dataclasses.replace(ARCHS[WHISPER].encoder,
                                                          n_layers=WHISPER_TRAIN_LAYERS))
    params = lmt.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    stream = make_token_stream(cfg.vocab_size, 4 * WHISPER_BATCH * (WHISPER_TOKENS + 1),
                               seed=SEED)
    x, y = next(batch_stream(stream, WHISPER_BATCH, WHISPER_TOKENS, 1, seed=SEED))
    batch = {"tokens": torch.from_numpy(x).long().to(dev),
             "labels": torch.from_numpy(y).long().to(dev),
             "enc_embeds": frames_for(cfg, WHISPER_BATCH,
                                      torch.Generator(device=dev).manual_seed(SEED))}
    opt = topt.adamw(WHISPER_TRAIN_LR)
    step = lmsteps.make_train_step(cfg, opt)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls = [], []
    reset_launches()
    for _ in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, params, state = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: train losses {losses}")
    want = train_launches(cfg, LM_TRAIN_STEPS, "bf16")
    if launches != want:
        raise AssertionError(f"{cfg.name}: train launches {launches}, expected {want}")
    p50 = float(np.median(walls))
    del params, state, step, batch
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "encoder_layers": cfg.encoder.n_layers,
            "full_depth": cfg.n_layers == ARCHS[WHISPER].n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
            "n_params": n_params, "remat": cfg.remat, "layers": mixer_counts(cfg),
            "frames": cfg.encoder.n_frames, "frame_dtype": "bfloat16",
            "batch": WHISPER_BATCH, "seq": WHISPER_TOKENS, "steps": LM_TRAIN_STEPS,
            "lr": WHISPER_TRAIN_LR,
            "optimizer": "adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)",
            "losses": losses, "step_wall_s": walls, "step_wall_s_p50": p50,
            "tokens_per_s": WHISPER_BATCH * WHISPER_TOKENS / p50, "peak_gb": peak_gb,
            "launches": launches}


def lm_train_phase(dev) -> dict:
    out = {}
    for name, n in LM_TRAIN_CONFIGS:
        cfg = dataclasses.replace(ARCHS[name], n_layers=n)
        out[name] = lm_train_config(cfg, dev)
        out[name]["card_vs_cpu"] = train_card_vs_cpu(cfg, dev)
    out[WHISPER] = whisper_train(dev)
    out[WHISPER]["card_vs_cpu"] = train_card_vs_cpu(ARCHS[WHISPER], dev)
    for name in LM_TRAIN_FP32_ONLY:
        out[name] = {"card_vs_cpu": train_card_vs_cpu(ARCHS[name], dev)}
    return out


def lm_batch(cfg, dev) -> dict:
    """One (B, S) batch of the synthetic Markov token stream."""
    stream = make_token_stream(cfg.vocab_size, 4 * LM_BATCH * (LM_SEQ + 1), seed=SEED)
    x, y = next(batch_stream(stream, LM_BATCH, LM_SEQ, 1, seed=SEED))
    return {"tokens": torch.from_numpy(x).long().to(dev),
            "labels": torch.from_numpy(y).long().to(dev)}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def decode_vs_forward(cfg, params, tokens, enc_embeds=None) -> float:
    """The logits of decode_step over the tokens against forward's, over
    the real vocabulary (the padded columns hold -1e30 in both); with frame
    embeddings, after warm_cache filled the cross K/V from them."""
    B, T = tokens.shape
    with torch.inference_mode():
        ref, _, _ = lmt.forward(cfg, params, tokens=tokens, enc_embeds=enc_embeds)
        cache = lmdec.warm_cache(cfg, params,
                                 lmdec.init_cache(cfg, B, T, device=tokens.device),
                                 enc_embeds=enc_embeds)
        outs = []
        for i in range(T):
            logits, cache = lmdec.decode_step(cfg, params, cache, tokens[:, i:i + 1])
            outs.append(logits)
    V = cfg.vocab_size
    return rel_err(torch.cat(outs, dim=1)[..., :V], ref[..., :V])


def mixer_counts(cfg) -> dict[str, int]:
    """The configuration's layers by mixer (attn, mamba, rwkv), its
    decoder layers with cross-attention, and its encoder's layers."""
    specs = list(cfg.pattern) * cfg.n_periods + list(cfg.remainder)
    n = {m: sum(s.mixer == m for s in specs) for m in ("attn", "mamba", "rwkv")}
    n["cross"] = sum(s.cross_attn for s in specs)
    n["encoder"] = 0 if cfg.encoder is None else cfg.encoder.n_layers
    return n


def flash_per_forward(n: dict[str, int]) -> int:
    """Flash launches of a forward with frames (mixer_counts ``n``): one a
    self-attention layer, a cross-attention block and an encoder layer."""
    return n["attn"] + n["cross"] + n["encoder"]


def frames_for(cfg, B: int, gen: torch.Generator) -> torch.Tensor | None:
    """Frame embeddings (B, n_frames, d_model) of the stub frontend, standard
    normal in the weights' dtype, from ``gen`` on its device; None without
    an encoder."""
    if cfg.encoder is None:
        return None
    x = torch.randn((B, cfg.encoder.n_frames, cfg.d_model), generator=gen,
                    device=gen.device)
    return x.to(cfg.dtype)


def fp32_config(cfg):
    """The float32 configuration of the card-vs-CPU check: one period at
    full width, or ``reduced()`` for LM_INFER_CONFIGS (one jamba period in
    float32 is 179 GB) and whisper (its 32 encoder layers; ``reduced()``
    gives the encoder head_dim 128 and the decoder 32)."""
    if cfg.name == WHISPER or any(cfg.name == name for name, _ in LM_INFER_CONFIGS):
        return ARCHS[cfg.name].reduced()
    return dataclasses.replace(cfg, param_dtype="float32", n_layers=len(cfg.pattern))


def card_vs_cpu(cfg, dev) -> dict:
    """``cfg`` (float32, from fp32_config) at B = 1, S = 128: logits on
    the card (kernels) against the host CPU (plain versions), same weights.
    The card's forward is the path ``lm_fp32``: every kernel's launch count
    is reset just before it and read just after."""
    p_dev = lmt.init_params(cfg, seed=SEED + 1, device=dev)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    gen = torch.Generator().manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)
    frames = frames_for(cfg, 1, gen)
    t0 = time.perf_counter()
    with torch.inference_mode():
        reset_launches()
        card = lmt.forward(cfg, p_dev, tokens=toks.to(dev),
                           enc_embeds=None if frames is None else frames.to(dev))[0]
        torch.cuda.synchronize()
        launches = read_launches()
        cpu = lmt.forward(cfg, p_cpu, tokens=toks, enc_embeds=frames)[0]
    err = rel_err(card, cpu)
    if not err <= CARD_CPU_RTOL:
        raise AssertionError(f"{cfg.name}: card vs CPU logits rel err {err} > {CARD_CPU_RTOL}")
    n = mixer_counts(cfg)
    want = {name: 0 for name in KERNELS}
    want.update(flash_attention_fp32=flash_per_forward(n), rwkv6=n["rwkv"],
                selective_scan=n["mamba"])
    if launches != want:
        raise AssertionError(f"{cfg.name}: float32 forward launches {launches}, "
                             f"expected {want}")
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "reduced": cfg == ARCHS[cfg.name].reduced(), "shape": [1, 128], "rel_err": err,
            "tolerance": CARD_CPU_RTOL, "launches": launches,
            "wall_s": time.perf_counter() - t0}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class MoeLoads:
    """Wraps the transformer's two MoE entries (`moe_apply`, dense, and
    `moe_apply_shard_map`, expert-parallel) and records for each call what
    its router sends each expert (recomputed from the call's own input and
    router, the same products): the most choices an expert takes over all
    tokens and over one of the ``ep`` token shards, and the choices each
    path drops (the dense path past C = capacity, the expert-parallel one
    past C_loc = max(8, capacity // ep) in a shard)."""

    def __init__(self, ep: int):
        self.ep, self.calls = ep, []
        self.real = {"dense": lmt.moe_apply, "ep": lmt.moe_apply_shard_map}

    def record(self, path: str, p: dict, x: torch.Tensor, top_k: int, capacity: int):
        xt = x.reshape(-1, x.shape[-1])
        _, idx = router_topk(xt.float() @ p["router"], top_k)
        E = p["router"].shape[1]
        shard = F.one_hot(idx.reshape(self.ep, -1), E).sum(dim=1)        # (ep, E)
        total = shard.sum(dim=0)
        cap = capacity if path == "dense" else max(8, capacity // self.ep)
        over = (total if path == "dense" else shard) - cap
        self.calls.append({"path": path, "capacity": capacity, "slots": cap,
                           "choices": int(total.sum()), "max_load": int(total.max()),
                           "max_shard_load": int(shard.max()),
                           "dropped": int(over.clamp(min=0).sum())})

    def dense(self, act, p, x, *, top_k, capacity):
        self.record("dense", p, x, top_k, capacity)
        return self.real["dense"](act, p, x, top_k=top_k, capacity=capacity)

    def sharded(self, act, p, x, *, top_k, capacity, **kwargs):
        self.record("ep", p, x, top_k, capacity)
        return self.real["ep"](act, p, x, top_k=top_k, capacity=capacity, **kwargs)

    def patched(self):
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(lmt, "moe_apply", self.dense))
        stack.enter_context(mock.patch.object(lmt, "moe_apply_shard_map", self.sharded))
        return stack


def logits_rel_err(got: torch.Tensor, want: torch.Tensor, vocab: int) -> float:
    """max |got - want| / max |want| over the real vocabulary, a batch row
    at a time on the card."""
    num = den = 0.0
    for g, w in zip(got, want):
        g, w = g[..., :vocab].float(), w[..., :vocab].float()
        num, den = max(num, float((g - w).abs().max())), max(den, float(w.abs().max()))
    return num / den


def lm_ep_run(cfg, params, batch, dev) -> dict:
    """The expert-parallel MoE at full width (`sharding_mode="ep_tp"`),
    from the lm phase's own bf16 weights: the expert tables placed over an
    EP_MESHES mesh on `mesh_devices` (views on one card: no copy), the eval
    step at (LM_BATCH, LM_SEQ).  At the configuration's own capacity
    factor: both paths' dropped choices (reported, not gated), the
    expert-parallel eval's warm wall, tokens/s and peak memory.  Then the
    capacity factor at which neither path drops (from the routers' loads,
    raised until a run drops nothing): the expert-parallel eval's
    cross-entropy (the loss less its aux term: the expert-parallel aux is
    the mean of the shards' losses, not the global one) against the dense
    one within CARD_CPU_RTOL, its logits within CARD_CPU_RTOL at model = 1
    and DECODE_RTOL at model > 1 (the bf16 F-partials rounded before the
    psum, as in the reference), and the `reduced()` float32 forward
    expert-parallel vs dense within CARD_CPU_RTOL.  Every member's
    expert bytes read off the placed blocks; the `reduced()` float32 train
    step through ep_tp card vs CPU (`train_card_vs_cpu`)."""
    data, model = EP_MESHES[cfg.name]
    devices, placement = mesh_devices(data * model)
    mesh = make_model_mesh(data, model, devices)
    placed = place_expert_tables(params, mesh)
    cfg_ep = dataclasses.replace(cfg, sharding_mode="ep_tp")
    T = LM_BATCH * LM_SEQ
    members = [0] * len(mesh.devices)
    table_bytes = 0
    for moe in moe_layers(placed):
        for name in ("w_gate", "w_up", "w_down"):
            for i, blk in enumerate(moe[name]):
                members[i] += blk.numel() * blk.element_size()
                table_bytes += blk.numel() * blk.element_size()

    def both(cf: float) -> dict:
        """Loss, logits and loads of the dense and the expert-parallel eval
        at capacity factor ``cf``."""
        out = {}
        for path, c, p in (("dense", dataclasses.replace(cfg, capacity_factor=cf), params),
                           ("ep", dataclasses.replace(cfg_ep, capacity_factor=cf), placed)):
            loads = MoeLoads(data)
            with loads.patched(), use_mesh(mesh), torch.inference_mode():
                logits, _, aux = lmt.forward(c, p, tokens=batch["tokens"])
            with use_mesh(mesh):
                loss = float(lmsteps.make_eval_step(c)(p, batch))
            if {call["path"] for call in loads.calls} != {path}:
                raise AssertionError(f"{cfg.name}/{path}: MoE calls {loads.calls}")
            out[path] = {"loss": loss, "aux": float(aux), "logits": logits,
                         "loads": loads.calls}
        return out

    own = both(cfg.capacity_factor)
    dropped = {path: sum(c["dropped"] for c in own[path]["loads"]) for path in own}
    del own["dense"]["logits"], own["ep"]["logits"]

    # the expert-parallel eval at the configuration's own capacity factor
    eval_step = lmsteps.make_eval_step(cfg_ep)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with use_mesh(mesh):
        reset_launches()
        loss, cold_s = timed(lambda: eval_step(placed, batch))
        launches = read_launches()
        loss2, warm_s = timed(lambda: eval_step(placed, batch))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n = mixer_counts(cfg)
    want = dict({k: 0 for k in KERNELS}, flash_attention_bf16=n["attn"],
                selective_scan=n["mamba"])
    if launches != want or not np.isfinite(float(loss)):
        raise AssertionError(f"{cfg.name}/ep: loss {float(loss)}, launches {launches} "
                             f"(want {want})")

    # the capacity factor at which neither path drops
    E, k = cfg.n_experts, cfg.moe_top_k
    loads = own["dense"]["loads"] + own["ep"]["loads"]
    for _ in range(EP_CF_ROUNDS):
        need = max(max(c["max_load"], data * c["max_shard_load"]) for c in loads)
        cf = need * E / (T * k)
        run_cf = both(cf)
        loads = run_cf["dense"]["loads"] + run_cf["ep"]["loads"]
        if not any(c["dropped"] for c in loads):
            break
        del run_cf
    else:
        raise AssertionError(f"{cfg.name}: choices still drop after {EP_CF_ROUNDS} "
                             f"capacity factors: {loads}")
    dense, ep = run_cf["dense"], run_cf["ep"]
    logit_err = logits_rel_err(ep["logits"], dense["logits"], cfg.vocab_size)
    # the cross-entropy: the loss less its aux term, which differs by design
    # (the expert-parallel aux is the mean of the token shards' losses)
    nll = {path: r["loss"] - lmsteps.AUX_WEIGHT * r["aux"] for path, r in run_cf.items()}
    loss_err = abs(nll["ep"] - nll["dense"]) / abs(nll["dense"])
    del run_cf, dense["logits"], ep["logits"]
    # at model = 1 the schedule rounds as the dense path does; at model > 1
    # each member's F-partial of the down projection is rounded to bf16
    # before the psum (the reference's einsum and psum in bf16), another
    # order of the bf16 computation: DECODE_RTOL, the reference's contract
    # for that, holds the logits, and ep_vs_dense_fp32 the schedule
    logit_tol = CARD_CPU_RTOL if model == 1 else DECODE_RTOL
    if not (logit_err <= logit_tol and loss_err <= CARD_CPU_RTOL):
        raise AssertionError(f"{cfg.name}: expert-parallel vs dense eval at capacity "
                             f"factor {cf}: logits {logit_err}, cross-entropy {loss_err}")
    del placed
    torch.cuda.empty_cache()
    return {"mesh": {"data": data, "model": model}, "devices": devices,
            "placement": placement, "batch": LM_BATCH, "seq": LM_SEQ,
            "n_experts": E, "top_k": k,
            "capacity_factor": cfg.capacity_factor,
            "capacity": moe_capacity(T, k, E, cfg.capacity_factor),
            "dropped_choices": dropped, "loads": own["dense"]["loads"] + own["ep"]["loads"],
            "loss_dense": own["dense"]["loss"], "loss_ep": own["ep"]["loss"],
            "aux_dense": own["dense"]["aux"], "aux_ep": own["ep"]["aux"],
            "eval": {"loss": float(loss), "loss_second_call": float(loss2),
                     "wall_s_first": cold_s, "wall_s": warm_s,
                     "tokens_per_s": T / warm_s, "peak_gb": peak_gb,
                     "launches": launches},
            "no_drop": {"capacity_factor": cf, "capacity": moe_capacity(T, k, E, cf),
                        "loads": loads, "loss_dense": dense["loss"], "loss_ep": ep["loss"],
                        "aux_dense": dense["aux"], "aux_ep": ep["aux"],
                        "aux_weight": lmsteps.AUX_WEIGHT, "cross_entropy_dense": nll["dense"],
                        "cross_entropy_ep": nll["ep"], "logits_rel_err": logit_err,
                        "logits_tolerance": logit_tol, "cross_entropy_rel_err": loss_err,
                        "cross_entropy_tolerance": CARD_CPU_RTOL},
            "fp32_ep_vs_dense": ep_vs_dense_fp32(cfg, dev, mesh),
            "expert_bytes": {"tables": table_bytes, "per_member": members,
                             "per_member_share": [b / table_bytes for b in members],
                             "members_on": [str(d) for d in mesh.devices]},
            "train_fp32_card_vs_cpu": train_card_vs_cpu(cfg, dev, ep_mesh=(data, model))}


def ep_vs_dense_fp32(cfg, dev, mesh) -> dict:
    """``reduced()`` in float32 at B = 1, S = 128 on the card: the
    expert-parallel forward over ``mesh``'s shape (tables placed) against
    the dense one, at capacity factor n_experts (room for every choice in
    both), logits within CARD_CPU_RTOL."""
    red = ARCHS[cfg.name].reduced()
    cfg32 = dataclasses.replace(red, capacity_factor=float(red.n_experts))
    params = lmt.init_params(cfg32, seed=SEED + 2, device=dev)
    toks = torch.randint(0, cfg32.vocab_size, (1, 128),
                         generator=torch.Generator().manual_seed(SEED)).to(dev)
    with torch.inference_mode(), use_mesh(mesh):
        dense = lmt.forward(cfg32, params, tokens=toks)[0]
        ep = lmt.forward(dataclasses.replace(cfg32, sharding_mode="ep_tp"),
                         place_expert_tables(params, mesh), tokens=toks)[0]
    err = rel_err(ep, dense)
    if not err <= CARD_CPU_RTOL:
        raise AssertionError(f"{cfg.name}: float32 expert-parallel vs dense forward "
                             f"rel err {err}")
    return {"n_layers": cfg32.n_layers, "d_model": cfg32.d_model, "shape": [1, 128],
            "capacity_factor": cfg32.capacity_factor, "logits_rel_err": err,
            "tolerance": CARD_CPU_RTOL}


def moe_layers(tree):
    """Every MoE layer's parameter dict of an LM parameter tree."""
    if isinstance(tree, dict):
        if "router" in tree:
            yield tree
        else:
            for v in tree.values():
                yield from moe_layers(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from moe_layers(v)


def lm_config_run(cfg, dev) -> dict:
    params = lmt.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = lm_batch(cfg, dev)
    n = mixer_counts(cfg)

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
    want_fwd.update(flash_attention_bf16=n["attn"], rwkv6=n["rwkv"],
                    selective_scan=n["mamba"])
    want_dec = dict(want_fwd, flash_attention_bf16=0, rwkv6=n["rwkv"] * steps,
                    selective_scan=n["mamba"] * steps)
    if forward_launches != want_fwd or decode_launches != want_dec:
        raise AssertionError(f"{cfg.name}: launches forward {forward_launches} (want "
                             f"{want_fwd}), decode {decode_launches} (want {want_dec})")

    parity = decode_vs_forward(cfg, params, batch["tokens"][:, :PARITY_TOKENS])
    if not parity <= DECODE_RTOL:
        raise AssertionError(f"{cfg.name}: decode vs forward rel err {parity} > {DECODE_RTOL}")
    ep = lm_ep_run(cfg, params, batch, dev) if cfg.name in EP_MESHES else None
    del params
    torch.cuda.empty_cache()
    return {"lm_ep": ep,"n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "param_dtype": cfg.param_dtype, "n_params": n_params, "layers": n,
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
            "card_vs_cpu": card_vs_cpu(fp32_config(cfg), dev)}


def whisper_run(dev) -> dict:
    """whisper-large-v3 at its full depth and width (32 encoder and 32
    decoder layers, d_model 1280, 20 heads of 64), bf16 weights from
    `init_params(seed)`, bf16 frames from a seed: `make_eval_step` at
    (WHISPER_BATCH, WHISPER_TOKENS) with 1500 frames (loss, wall, tokens/s,
    peak memory); `init_cache`, `warm_cache` (the encoder once and every
    layer's cross K/V, timed), then PROMPT prompt tokens and NEW_TOKENS
    greedy ones through `decode_step` (wall a step); each with every
    kernel's launch count reset just before and read just after (bf16 flash:
    32 encoder + 32 decoder + 32 cross a forward, 32 in warm_cache, 0 a
    decode step); decode_vs_forward over PARITY_TOKENS tokens; and the
    float32 `reduced()` configuration against the CPU (card_vs_cpu)."""
    cfg = ARCHS[WHISPER]
    params = lmt.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    stream = make_token_stream(cfg.vocab_size, 4 * WHISPER_BATCH * (WHISPER_TOKENS + 1),
                               seed=SEED)
    x, y = next(batch_stream(stream, WHISPER_BATCH, WHISPER_TOKENS, 1, seed=SEED))
    frames = frames_for(cfg, WHISPER_BATCH, torch.Generator(device=dev).manual_seed(SEED))
    batch = {"tokens": torch.from_numpy(x).long().to(dev),
             "labels": torch.from_numpy(y).long().to(dev), "enc_embeds": frames}
    n = mixer_counts(cfg)

    eval_step = lmsteps.make_eval_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    loss, eval_cold_s = timed(lambda: eval_step(params, batch))
    forward_launches = read_launches()
    loss2, eval_warm_s = timed(lambda: eval_step(params, batch))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    loss, loss2 = float(loss), float(loss2)
    if not (np.isfinite(loss) and loss > 0.0):
        raise AssertionError(f"{cfg.name}: eval loss {loss}")

    steps = PROMPT + NEW_TOKENS - 1
    with torch.inference_mode():
        cache = lmdec.init_cache(cfg, WHISPER_BATCH, PROMPT + NEW_TOKENS, device=dev)
        reset_launches()
        cache, warm_s = timed(lambda: lmdec.warm_cache(cfg, params, cache,
                                                       enc_embeds=frames))
        warm_launches = read_launches()
        cache_gb = sum(t.numel() * t.element_size() for c in cache["layers"]
                       for name, t in c.items() if name in ("kc", "vc")) / 1e9
        tok, out = batch["tokens"][:, :1], [batch["tokens"][:, :1]]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = lmdec.decode_step(cfg, params, cache, tok)
            tok = (batch["tokens"][:, i + 1:i + 2] if i + 1 < PROMPT
                   else torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1))
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_launches = read_launches()
        toks = torch.cat(out, dim=1)
    del cache
    if toks.shape != (WHISPER_BATCH, PROMPT + NEW_TOKENS) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: decoding gave {tuple(toks.shape)}")

    want_fwd = {name: 0 for name in KERNELS}
    want_fwd["flash_attention_bf16"] = flash_per_forward(n)
    want_warm = dict(want_fwd, flash_attention_bf16=n["encoder"])
    want_dec = dict(want_fwd, flash_attention_bf16=0)
    if (forward_launches, warm_launches, decode_launches) != (want_fwd, want_warm, want_dec):
        raise AssertionError(f"{cfg.name}: launches forward {forward_launches} (want "
                             f"{want_fwd}), warm_cache {warm_launches} (want {want_warm}), "
                             f"decode {decode_launches} (want {want_dec})")

    parity = decode_vs_forward(cfg, params, batch["tokens"][:, :PARITY_TOKENS], frames)
    if not parity <= DECODE_RTOL:
        raise AssertionError(f"{cfg.name}: decode vs forward rel err {parity} > {DECODE_RTOL}")
    del params, batch, frames
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "encoder_layers": cfg.encoder.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
            "n_params": n_params, "layers": n, "frames": cfg.encoder.n_frames,
            "frame_dtype": "bfloat16",
            "eval": {"batch": WHISPER_BATCH, "seq": WHISPER_TOKENS, "loss": loss,
                     "loss_second_call": loss2, "wall_s_first": eval_cold_s,
                     "wall_s": eval_warm_s, "peak_gb": peak_gb,
                     "tokens_per_s": WHISPER_BATCH * WHISPER_TOKENS / eval_warm_s},
            "warm_cache": {"wall_s": warm_s, "cross_kv_gb": cache_gb},
            "generate": {"batch": WHISPER_BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
                         "decode_steps": steps, "tokens": toks[:2].cpu().tolist(),
                         "wall_s": decode_s, "ms_per_step": decode_s / steps * 1e3},
            "launches": {"lm_forward": forward_launches, "lm_warm_cache": warm_launches,
                         "lm_decode": decode_launches},
            "decode_vs_forward": {"tokens": PARITY_TOKENS, "rel_err": parity,
                                  "tolerance": DECODE_RTOL},
            "card_vs_cpu": card_vs_cpu(fp32_config(cfg), dev)}


def lm_phase(dev) -> dict:
    out = {name: lm_config_run(dataclasses.replace(ARCHS[name], n_layers=n), dev)
           for name, n in LM_CONFIGS + LM_INFER_CONFIGS}
    out[WHISPER] = whisper_run(dev)
    return out


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
    gated = check_no_spills()

    res: dict = {"backward_spills": dict(report_spills(), **gated,
                                         kernels=check_no_spill_kernels())}
    t0 = time.perf_counter()
    res["floors"] = launch_floors_us(torch.empty(128 << 20, dtype=torch.uint8,
                                                 device=dev))
    print(f"launch floors {res['floors']}", flush=True)
    res["fp"] = kernel_phase(dev)
    res["agg"] = cluster_agg_phase(dev)
    res["pe"] = pearson_phase(dev)
    res["flash"] = flash_phase(dev)
    res["wkv"] = wkv_phase(dev, res["floors"])
    res["scan"] = scan_phase(dev, res["floors"])
    res["flash_lm"] = flash_lm_phase(dev)
    res["flash_whisper"] = flash_whisper_phase(dev)
    res["flash_bwd"] = flash_bwd_phase(dev)
    res["wkv_bwd"] = wkv_bwd_phase(dev)
    res["scan_bwd"] = scan_bwd_phase(dev, res["floors"])
    res["table2_shapes"] = table2_kernel_phase(dev)
    res["async_shapes"] = async_kernel_phase(dev)
    res["mesh_shapes"] = mesh_kernel_phase(dev)
    res["bmm"] = batched_matmul_phase(dev)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s", flush=True)
    for phase, run_phase in PHASES:
        t0 = time.perf_counter()
        # the obs phase reads the train and async phases' drained span times
        res[phase] = run_phase(dev, res) if phase in ("obs", "mesh") else run_phase(dev)
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
    for path in ("async", "faults", "resume", "obs"):
        by_path[path] = res[path]["launches"]
    # the client-sharded mesh: BFLN sync at MESH_SHARDS (its main path), at
    # MESH_PAD_SHARDS, replicated, FedBuff, a crash resumed, serve
    mesh = res["mesh"]
    by_path["mesh"] = mesh["sharded"]["launches"]
    for path in ("sharded_padded", "replicated", "async", "resume", "serve"):
        by_path[f"mesh_{path}"] = mesh[path]["launches"]
    for path in ("lm_forward", "lm_decode", "lm_warm_cache"):
        by_path[path] = {name: sum(run["launches"].get(path, {}).get(name, 0)
                                   for run in res["lm"].values())
                         for name in KERNELS}
    by_path["lm_fp32"] = {name: sum(run["card_vs_cpu"]["launches"][name]
                                    for run in res["lm"].values())
                          for name in KERNELS}
    by_path["lm_train"] = {name: sum(run["launches"][name]
                                     for run in res["lm_train"].values() if "launches" in run)
                           for name in KERNELS}
    by_path["lm_train_fp32"] = {name: sum(run["card_vs_cpu"]["launches"][name]
                                          for run in res["lm_train"].values())
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
    scan_row, scan_checks = res["scan"]
    scan_bwd_row, scan_bwd_checks = res["scan_bwd"]
    cohort = shapes[2]                  # (100, 6570): the train path's rows

    whisper_rows, whisper_checks = res["flash_whisper"]

    def flash(dt, source, main_path, tolerance, **extra):
        checks = {w: c for w, c in {**flash_checks, **whisper_checks}.items()
                  if w.endswith(dt)}
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
                     ms_writing_lse=us_to_ms(flash_rows[dt][0], "kernel_lse_us"),
                     shapes=flash_rows[dt], checks=checks, **extra)

    flash_bwd_rows, flash_bwd_checks = res["flash_bwd"]
    wkv_bwd_row, wkv_bwd_checks = res["wkv_bwd"]
    spills = res["backward_spills"]

    def flash_bwd(dt, main_path, tolerance, **extra):
        checks = {w: c for w, c in flash_bwd_checks.items() if w.endswith(dt)}
        main = max(c["max_abs_err"] for w, c in checks.items() if w.startswith("main"))
        row, causal = flash_bwd_rows[dt]
        # the main-path row is window 1024: five of gemma3's six layers
        source = "flash_attention_bwd_sm90.cu" if dt == "bf16" else "flash_attention_bwd.cu"
        return entry(f"flash_attention_bwd_{dt}", source,
                     "src/repro/kernels/flash_attention.py:80", main_path, row, main,
                     tolerance, shape=[2, 4096, 8, 4, 256], dtype=row["dtype"], window=1024,
                     no_pallas_counterpart="the gradient of the kernel at `replaces`: the "
                                           "reference differentiates its jnp attention",
                     library_call=row["library_call"],
                     library_backend=row["library_backend"],
                     library_causal_ms=us_to_ms(causal, "library_causal_us"),
                     library_causal_backend=causal.get("library_causal_backend"),
                     bound_cuda_cores_ms=us_to_ms(row, "bound_cuda_cores_us"),
                     ptxas_spill_stores=spills[source],
                     shapes=flash_bwd_rows[dt], checks=checks, **extra)

    # the shapes only the baselines' and the paper's paths give the kernels
    new = res["table2_shapes"]
    bmm_main = res["bmm"]["rows"][next(iter(BMM_SHAPES))]
    return [
        entry("fingerprint", "fingerprint.cu", "src/repro/kernels/fingerprint.py:102",
              "train", cohort, fp_err, 0, bit_exact=True, shape=[100, 6570],
              cluster=cohort["cluster"], shapes=shapes,
              paper_shapes=new["fingerprint"],
              async_shape=dict(res["async_shapes"]["fingerprint"],
                               launches_async=by_path["async"]["fingerprint"]),
              # one shard's rows: (25, .) at S = 4, (34, .) at S = 3, (4, .) a flush
              mesh_shapes=[dict(row, ms=row["kernel_us"] / 1e3,
                                plain_ms=row["plain_us"] / 1e3,
                                bound_ms=row["bound_us"] / 1e3, library_ms=None)
                           for row in res["mesh_shapes"]["fingerprint"]]),
        entry("cluster_agg", "cluster_agg.cu", "src/repro/kernels/cluster_agg.py:43",
              "train", agg_row, agg_row["max_abs_err"], 0, bit_exact=True,
              shape=[100, 6570], dtype="float32", library_call="torch.matmul(mix, rows)",
              masked_mean_shapes=new["cluster_agg"],
              async_shape=dict(res["async_shapes"]["cluster_agg"],
                               launches_async=by_path["async"]["cluster_agg"]),
              # the padded cohort at S = 3: two zero-weight rows
              mesh_shape=dict(res["mesh_shapes"]["cluster_agg"],
                              ms=res["mesh_shapes"]["cluster_agg"]["kernel_us"] / 1e3,
                              plain_ms=res["mesh_shapes"]["cluster_agg"]["plain_us"] / 1e3,
                              bound_ms=res["mesh_shapes"]["cluster_agg"]["bound_us"] / 1e3,
                              library_ms=res["mesh_shapes"]["cluster_agg"]["library_us"]
                              / 1e3, launches_mesh_sharded_padded=by_path[
                                  "mesh_sharded_padded"]["cluster_agg"]),
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
               "against": "float32 plain version, per element"},
              ms_causal=us_to_ms(flash_rows["bf16"][1], "kernel_us"),
              # the attention layers of jamba, grok and llama4 (head_dim 128)
              lm_hd128_shapes={what: dict(row, ms=row["kernel_us"] / 1e3,
                                          plain_ms=row["plain_us"] / 1e3,
                                          bound_ms=row["bound_us"] / 1e3,
                                          library_ms=row["library_us"] / 1e3)
                               for what, row in res["flash_lm"].items()},
              # whisper-large-v3's three attention shapes (Sq != Sk in two),
              # each launched 32 times a forward; warm_cache runs the encoder
              whisper_shapes={what: dict(row, ms=row["kernel_us"] / 1e3,
                                         plain_ms=row["plain_us"] / 1e3,
                                         bound_ms=row["bound_us"] / 1e3,
                                         library_ms=row["library_us"] / 1e3)
                              for what, row in whisper_rows.items()},
              whisper_launches=res["lm"][WHISPER]["launches"]),
        flash("fp32", "flash_attention.cu", "lm_fp32",
              {"rtol": 0.0, "atol": FLASH_TOL_F32, "against": "plain version"}),
        entry("rwkv6", "rwkv6_scan.cu", "src/repro/kernels/rwkv6_scan.py:45",
              "lm_forward", wkv_row, wkv_checks["main (2, 40, 4096, 64)"], WKV_TOL,
              shape=[2, 40, 4096, 64], dtype="float32", checks=wkv_checks,
              ms_storing_states=us_to_ms(wkv_row, "kernel_states_us"),
              decode_shape={"launches_lm_decode": by_path["lm_decode"]["rwkv6"],
                            "max_abs_err": wkv_checks["T = 1 (2, 40, 1, 64)"],
                            "ms": us_to_ms(wkv_row["decode"], "kernel_us"),
                            "plain_ms": us_to_ms(wkv_row["decode"], "plain_us"),
                            "bound_ms": us_to_ms(wkv_row["decode"], "bound_us"),
                            "bound_by": wkv_row["decode"]["bound_by"],
                            "library_ms": None, "row": wkv_row["decode"],
                            "t16": wkv_row["t16"]}),
        flash_bwd("bf16", "lm_train",
                  {"rtol": FLASH_RTOL_BF16, "atol_of_max": FLASH_BWD_ATOL_BF16,
                   "against": "float32 plain backward, per element"},
                  # whisper-large-v3's three attention shapes at hd 64 (the
                  # hd-64 kernels, bwd_sm90_plan), 32 launches each a train
                  # step at full depth
                  whisper_shapes={what: dict(row, ms=row["kernel_us"] / 1e3,
                                             plain_ms=row["plain_us"] / 1e3,
                                             bound_ms=row["bound_us"] / 1e3,
                                             library_ms=row["library_us"] / 1e3)
                                  for what, row in flash_bwd_rows["bf16_whisper"].items()},
                  hd64_kernels_ptxas=spills["kernels"],
                  whisper_train_launches=res["lm_train"][WHISPER]["launches"]),
        flash_bwd("fp32", "lm_train_fp32",
                  {"atol_of_max": FLASH_BWD_RTOL_F32, "against": "plain backward"},
                  whisper_cross_shape=dict(
                      flash_bwd_rows["fp32_whisper_cross"],
                      ms=flash_bwd_rows["fp32_whisper_cross"]["kernel_us"] / 1e3,
                      plain_ms=flash_bwd_rows["fp32_whisper_cross"]["plain_us"] / 1e3,
                      bound_ms=flash_bwd_rows["fp32_whisper_cross"]["bound_us"] / 1e3,
                      library_ms=flash_bwd_rows["fp32_whisper_cross"]["library_us"] / 1e3)),
        entry("rwkv6_bwd", "rwkv6_scan_bwd.cu", "src/repro/kernels/rwkv6_scan.py:45",
              "lm_train", wkv_bwd_row,
              wkv_bwd_checks["main (2, 40, 4096, 64), strong decays, s0 and dS_T"][
                  "max_abs_err"],
              {"atol_of_max_or_1": WKV_TOL, "against": "plain backward"},
              shape=[2, 40, 4096, 64], dtype="float32", checks=wkv_bwd_checks,
              no_pallas_counterpart="the gradient of the kernel at `replaces`: the "
                                    "reference differentiates its lax.scan",
              library_none_because="no one PyTorch call computes the wkv gradient",
              ptxas_spill_stores=spills["rwkv6_scan_bwd.cu"]),
        entry("selective_scan", "selective_scan.cu", "src/repro/models/mamba.py:75",
              "lm_forward", scan_row, scan_checks["main (2, 4096, 16384, 16)"],
              {"atol_of_max_or_1": SCAN_RTOL, "against": "plain version"},
              shape=list(SCAN_SHAPE), dtype=scan_row["dtype"], checks=scan_checks,
              no_pallas_counterpart="the reference's lax.scan over time "
                                    "(mamba.py:68-77) and its decode step (:103-106)",
              library_none_because="no one PyTorch call computes the selective scan",
              bound_terms=scan_row["bound_terms"],
              ms_storing_states=us_to_ms(scan_row, "kernel_states_us"),
              device_kernels_per_call=scan_row["device_kernels_per_call"],
              decode_shape={"launches_lm_decode": by_path["lm_decode"]["selective_scan"],
                            "max_abs_err": scan_checks["decode S = 1, h0"],
                            "ms": us_to_ms(scan_row["decode"], "kernel_us"),
                            "ms_clean_l2": us_to_ms(scan_row["decode"], "kernel_clean_l2_us"),
                            "plain_ms": us_to_ms(scan_row["decode"], "plain_us"),
                            "bound_ms": us_to_ms(scan_row["decode"], "bound_us"),
                            "bound_by": scan_row["decode"]["bound_by"],
                            "library_ms": None, "row": scan_row["decode"]}),
        entry("selective_scan_bwd", "selective_scan_bwd.cu", "src/repro/models/mamba.py:75",
              "lm_train", scan_bwd_row,
              scan_bwd_checks["main (2, 4096, 16384, 16), h0 and dh_T"]["max_abs_err"],
              {"atol_of_max_or_1": SCAN_BWD_RTOL,
               "dx_bf16_rtol": FLASH_RTOL_BF16, "against": "plain backward"},
              shape=list(SCAN_SHAPE), dtype=scan_bwd_row["dtype"], checks=scan_bwd_checks,
              no_pallas_counterpart="the gradient of the reference's lax.scan "
                                    "(mamba.py:68-77), which it differentiates by autodiff",
              library_none_because="no one PyTorch call computes the selective scan's "
                                   "gradient",
              bound_terms=scan_bwd_row["bound_terms"],
              states_bytes=scan_bwd_row["states_bytes"],
              ms_train_layout=us_to_ms(scan_bwd_row, "kernel_train_layout_us"),
              clocks_while_timed=scan_bwd_row["clocks_while_timed"],
              train_layout=scan_bwd_row["train_layout"],
              ptxas_spill_stores=spills["selective_scan_bwd.cu"]),
        entry("batched_matmul", "batched_matmul.cu", "src/repro/models/classifier.py:44",
              "train", bmm_main, 0, 0, bit_exact=True, shape=[[100, 16, 64], [100, 64, 64]],
              dtype="float32", library_call=bmm_main["library_call"],
              no_pallas_counterpart="the client-stacked products of local training, "
                                    "prototypes and eval, which the reference leaves to "
                                    "XLA (classifier.py:44 vmapped over the cohort); a "
                                    "fixed summation order makes them batch-invariant",
              launches_a_round_train=res["train"]["batched_matmul_launches_a_round"],
              bound_no_fma_ms=bmm_main["bound_no_fma_us"] / 1e3,
              previous_ms=bmm_main["previous_kernel_us"] / 1e3,
              previous_source=bmm_main["previous_source"],
              shapes={what: dict(row, ms=row["kernel_us"] / 1e3,
                                 plain_ms=row["plain_us"] / 1e3,
                                 bound_ms=row["bound_us"] / 1e3,
                                 bound_no_fma_ms=row["bound_no_fma_us"] / 1e3,
                                 previous_ms=row["previous_kernel_us"] / 1e3,
                                 library_ms=row["library_us"] / 1e3)
                      for what, row in res["bmm"]["rows"].items()},
              checks=res["bmm"]["checks"], route_compare=res["train"]["bmm_route"]),
    ]


PHASES = (("train", train_phase), ("strategies", strategies_phase),
          ("async", async_phase), ("faults", faults_phase),
          ("resume", resume_phase), ("mesh", mesh_phase), ("obs", obs_phase),
          ("paper", paper_phase),
          ("serve", serve_phase), ("lm", lm_phase), ("lm_train", lm_train_phase))


if __name__ == "__main__":
    sys.exit(main())
