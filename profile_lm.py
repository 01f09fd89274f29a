#!/usr/bin/env python3
"""Profile the port's LM paths on one NVIDIA GPU with torch.profiler.

    python3 profile_lm.py

For each configuration of `chip_smoke.py`'s lm phase — gemma3-4b cut to 6
layers, rwkv6-3b cut to 4, jamba-1.5-large-398b cut to 4, grok-1-314b
and llama4-maverick-400b-a17b cut to 2, full width, bf16 weights from
`init_params(seed)` — for jamba-1.5-large-398b cut to 1 layer (the
depth its lm_train phase trains: the train path alone), and for
whisper-large-v3 at its full 32 + 32 layers (at chip_smoke's WHISPER_BATCH
x WHISPER_TOKENS, with (16, 1500, 1280) bf16 frames from a seed), runs one
unprofiled eval step and one unprofiled `greedy_generate` (start-up:
cuBLAS handles, kernel loads), then profiles, with CPU and CUDA
activities:

* ``eval``: one `make_eval_step` call at B = 2, S = 4096 (the forward and
  the float32 log-softmax loss), whisper's at (16, 448) with its frames;
* ``warm_cache`` (whisper): one `decode.warm_cache` call (the encoder and
  every layer's cross K/V);
* ``decode``: DECODE_STEPS `decode_step` calls at B = 2 (whisper: 16)
  against a cache already holding PROMPT tokens (one token each, as
  `greedy_generate` runs them; whisper's cache warmed first);
* ``train`` (gemma3-4b, rwkv6-3b, jamba at one layer and whisper at 32 +
  32: the MoE models' weights and AdamW state do not fit one card): one
  `make_train_step` call at B = 2, S = 4096 (whisper: its eval batch with
  the frames; AdamW at a constant TRAIN_LR, whisper at chip_smoke's
  WHISPER_TRAIN_LR; the forward, its recompute
  under remat, the backward through the flash / wkv / selective-scan
  backward kernels, the update), after one unprofiled step.

Prints the card's name and power limit, per configuration and path the top
device activities by device time, and one JSON line ``{"profile_lm":
{...}}``: per configuration and path the wall time (per step for decode),
the summed device time, the device busy share (device time over wall; one
stream, so nothing overlaps), the number of device activities, and the
device time by group — the port's flash-attention kernels (bf16 tensor
cores and float32), their backward kernels, the wkv kernels and their
backward kernels, the selective-scan kernel and its backward kernels, the
MoE dispatch (every
kernel launched inside `moe_apply` other than its expert products:
routing, top-k, the slot cumsum, the scatter and the weighted gather;
`moe_apply` runs under a `record_function` range here, which the port's
code does not open), matrix products (cuBLAS), and the rest — and each
of the port's own kernels by name (the backward's launches apart).
Each path also reports the SM clock and power draw that `nvidia-smi`
sampled every 20 ms while it ran (`chip_smoke.with_clocks`).  The
profiler's own cost is in the wall time.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import decode as lmdec  # noqa: E402
from repro_torch.models import lm as lmsteps  # noqa: E402
from repro_torch.models import transformer as lmt  # noqa: E402

SEED = 0
# (name, layers, the paths profiled)
ALL_PATHS, INFER_PATHS = ("eval", "decode", "train"), ("eval", "decode")
CONFIGS = (("gemma3-4b", 6, ALL_PATHS), ("rwkv6-3b", 4, ALL_PATHS),
           ("jamba-1.5-large-398b", 4, INFER_PATHS), ("grok-1-314b", 2, INFER_PATHS),
           ("llama4-maverick-400b-a17b", 2, INFER_PATHS),
           ("jamba-1.5-large-398b", 1, ("train",)),
           (cs.WHISPER, 32, ("eval", "warm_cache", "decode", "train")))
BATCH, SEQ = 2, 4096
PROMPT, DECODE_STEPS = 16, 8
TRAIN_LR = 1e-3
# the backward kernels: flash (delta, dK / dV, dQ of
# csrc/flash_attention_bwd_sm90.cu for bf16, the hd-64 pair among them, and
# csrc/flash_attention_bwd.cu for float32), and the wkv's one chunk-parallel
# kernel
GROUPS = (("flash_attention backward kernels", ("delta_kernel", "dkdv_kernel<",
                                                "dq_kernel<", "dkdv_hd64_kernel",
                                                "dq_hd64_kernel")),
          ("rwkv6 wkv backward kernels", ("bwd_chunk_kernel<",)),
          # csrc/selective_scan_bwd.cu's walk and its fixed-order sum
          ("selective scan backward kernels", ("scan_bwd_kernel<",
                                               "scan_bwd_reduce_kernel")),
          ("flash_attention kernels", ("flash_kernel", "flash_sm90_kernel",
                                       "flash_sm90_narrow_kernel", "flash_sm90_hd64_kernel")),
          ("rwkv6 wkv kernels", ("wkv_kernel", "wkv_chunk_kernel")),
          # csrc/selective_scan.cu's chunked and decode forms
          ("selective scan kernel", ("scan_chunked_kernel", "scan_decode_kernel")),
          ("matmul (cuBLAS)", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "splitk")))
MOE_RANGE, MOE_GROUP = "moe_apply", "MoE dispatch (routing, scatter, gather)"


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def moe_ranged():
    """``moe_apply`` under a ``record_function`` range, in the two modules
    that call it, for the profiled run; undone by the returned function."""
    from repro_torch.models import moe as lmmoe
    plain = lmmoe.moe_apply

    def ranged(*args, **kwargs):
        with torch.profiler.record_function(MOE_RANGE):
            return plain(*args, **kwargs)
    for mod in (lmt, lmdec):
        mod.moe_apply = ranged

    def undo():
        for mod in (lmt, lmdec):
            mod.moe_apply = plain
    return undo


def range_device_ms(prof, name: str) -> dict[str, float]:
    """Device ms by group of the kernels launched inside every ``name``
    range (the kernels the profiler ties to the CPU ops under it)."""
    out: dict[str, float] = {}

    def walk(e):
        for k in e.kernels:
            g = group_of(k.name)
            out[g] = out.get(g, 0.0) + k.duration / 1e3
        for ch in e.cpu_children:
            walk(ch)
    for e in prof.events():
        if e.name == name and e.device_type == DeviceType.CPU:
            walk(e)
    return out


def profiled(fn, steps: int) -> dict:
    """Run ``fn`` ``steps`` times under the profiler; wall and device time
    per step, busy share, top activities, device time by group, and each
    of the port's own kernels (every launch of its groups) by name."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        def run():
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        wall_ms, clocks = cs.with_clocks(run)
    # the MoE range also shows on the device timeline (an annotation, not work)
    device = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.key != MOE_RANGE),
                    key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    groups: dict[str, float] = {}
    for e in device:
        g = group_of(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / steps
    # the MoE dispatch: what moe_apply launched outside cuBLAS, taken out of "other"
    moe = range_device_ms(prof, MOE_RANGE)
    dispatch = sum(ms for g, ms in moe.items() if g != "matmul (cuBLAS)") / steps
    if moe:
        groups[MOE_GROUP] = dispatch
        groups["other"] = groups.get("other", 0.0) - dispatch
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps, "clocks": clocks,
            "device_ms_per_step": device_ms / steps,
            "device_busy_share": device_ms / wall_ms,
            "device_activities_per_step": sum(e.count for e in device) / steps,
            "device_ms_by_group": groups,
            "top_device": [{"name": e.key[:120], "calls": e.count / steps,
                            "device_ms_per_step": e.self_device_time_total / 1e3 / steps}
                           for e in device[:12]],
            "port_kernels": [{"name": e.key[:120], "calls": e.count / steps,
                              "device_ms_per_step": e.self_device_time_total / 1e3 / steps}
                             for e in device
                             if group_of(e.key) not in ("other", "matmul (cuBLAS)")]}


def profile_config(name: str, n_layers: int, paths: tuple, dev) -> dict:
    cfg = dataclasses.replace(ARCHS[name], n_layers=n_layers)
    params = lmt.init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, T = (cs.WHISPER_BATCH, cs.WHISPER_TOKENS) if cfg.encoder else (BATCH, SEQ)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen, device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    frames = cs.frames_for(cfg, B, gen)
    if frames is not None:
        batch["enc_embeds"] = frames
    out = {}
    if "eval" in paths:
        eval_step = lmsteps.make_eval_step(cfg)
        eval_step(params, batch)                               # start-up
        lmsteps.greedy_generate(cfg, params, tokens[:, :PROMPT], DECODE_STEPS,
                                PROMPT + DECODE_STEPS)
        out["eval"] = profiled(lambda: eval_step(params, batch), 1)

    if "warm_cache" in paths:
        cache = lmdec.init_cache(cfg, B, PROMPT + DECODE_STEPS, device=dev)
        with torch.inference_mode():
            out["warm_cache"] = profiled(
                lambda: lmdec.warm_cache(cfg, params, cache, enc_embeds=frames), 1)
        del cache

    if "decode" in paths:
        serve = lmsteps.make_serve_step(cfg)
        cache = lmdec.init_cache(cfg, B, PROMPT + DECODE_STEPS, device=dev)
        with torch.inference_mode():
            cache = lmdec.warm_cache(cfg, params, cache, enc_embeds=frames)
        for i in range(PROMPT):
            _, cache = serve(params, cache, tokens[:, i:i + 1])
        state = {"cache": cache, "pos": PROMPT}

        def one_token():
            i = state["pos"]
            _, state["cache"] = serve(params, state["cache"], tokens[:, i:i + 1])
            state["pos"] = i + 1
        out["decode"] = profiled(one_token, DECODE_STEPS)
        del cache, state
    if "train" not in paths:
        del params
        torch.cuda.empty_cache()
        return out

    opt = optim.adamw(cs.WHISPER_TRAIN_LR if cfg.encoder else TRAIN_LR)
    train = {"step": lmsteps.make_train_step(cfg, opt), "params": params,
             "opt_state": opt.init(params)}
    del params

    def one_step():
        _, train["params"], train["opt_state"] = train["step"](
            train["params"], train["opt_state"], batch)
    one_step()                                                 # start-up
    out["train"] = profiled(one_step, 1)
    del train
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lm: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = {}
    undo = moe_ranged()
    for name, n_layers, paths in CONFIGS:
        # jamba's train path at one layer has a key of its own
        key = name if "eval" in paths else f"{name} ({n_layers} layer)"
        result[key] = profile_config(name, n_layers, paths, dev)
        for path, r in result[key].items():
            print(f"\n{key} {path}: wall {r['wall_ms_per_step']:.3f} ms/step, device "
                  f"{r['device_ms_per_step']:.3f} ms/step ({r['device_busy_share']:.1%} busy)")
            for e in r["top_device"]:
                print(f"  {e['name'][:90]:<90} {e['calls']:>6.1f} {e['device_ms_per_step']:>9.3f}")
    undo()
    print(json.dumps({"profile_lm": {"device": torch.cuda.get_device_name(0),
                                     "batch": BATCH, "seq": SEQ, "prompt": PROMPT,
                                     "configs": result}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
