#!/usr/bin/env python3
"""Profile the port's BFLN sync rounds on one NVIDIA GPU with torch.profiler.

    python3 profile_round.py

Builds the default experiment (`repro_torch.api.ExperimentSpec()`: n = 1000
clients, cohort 100, MLP 64-64-32-10, 5 clusters) on the card, runs
WARMUP_ROUNDS rounds unprofiled (start-up: CUDA handles, workspaces, kernel
loads), then profiles ROUNDS more with CPU and CUDA activities.  Every span
of the run's ``obs`` recorder becomes a profiler range of the same name:
the simulator's phases (``round.step``, ``round.chain``, ...), the chain's
(``chain.*``) and the stages of ``RoundEngine.sync_step`` (``step.gather``,
``step.local_train``, ``step.prototypes``, ``step.pearson``,
``step.embedding``, ``step.kmeans``, ``step.cluster_mean``,
``step.fingerprint``, ``step.scatter``), so each phase's host time and the
device time of the kernels it launched come out side by side.

Prints the card's name and power limit, the top device activities
(kernels, copies) by device time, the top operators by host time, and one
JSON line ``{"profile": {...}}``: wall time per round, device busy share
(summed device time over the profiled wall; one stream, so nothing
overlaps), and per phase its host and device milliseconds per round.  The
profiler's own cost is in the wall time.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.api import ExperimentSpec  # noqa: E402
from repro_torch.sim.driver import SimulatedFederation  # noqa: E402
from repro_torch.sim.population import ClientPopulation  # noqa: E402


ROUNDS = 8           # profiled rounds
WARMUP_ROUNDS = 3    # unprofiled rounds first
PHASE_PREFIXES = ("round.", "chain.", "step.")


class ProfilerRanges:
    """A recorder for the simulator's ``obs`` hook that turns every span
    into a profiler range of the same name."""

    enabled = False

    def span(self, name: str, **attrs):
        return _Range(name)

    def inc(self, *args, **kwargs) -> None:
        pass

    event = observe = set_gauge = inc


class _Range:
    def __init__(self, name: str):
        self.range = record_function(name)

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.range.__exit__(*exc)
        return False


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_round: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    dev = torch.device("cuda", 0)
    spec = ExperimentSpec()
    sim = SimulatedFederation(
        ClientPopulation.from_spec(spec.population_spec(), dev), spec,
        device=dev, obs=ProfilerRanges())
    for r in range(WARMUP_ROUNDS):
        sim._run_sync_round(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(WARMUP_ROUNDS, WARMUP_ROUNDS + ROUNDS):
            sim._run_sync_round(r)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # A profiler range appears twice: as a host event, and as a device-side
    # annotation spanning its kernels.  Device time is the kernels' and
    # copies' own; a phase's device time is that of the work it launched.
    rows = prof.key_averages()
    device = sorted((e for e in rows if e.device_type == DeviceType.CUDA
                     and not e.key.startswith(PHASE_PREFIXES)),
                    key=lambda e: -e.self_device_time_total)
    host = [e for e in rows if e.device_type == DeviceType.CPU]
    ops = sorted((e for e in host if not e.key.startswith(PHASE_PREFIXES)),
                 key=lambda e: -e.self_cpu_time_total)
    device_us = sum(e.self_device_time_total for e in device)
    n = ROUNDS
    print(f"\n{'device activity':<90} {'calls':>7} {'device us/round':>16}")
    for e in device[:20]:
        print(f"{e.key[:90]:<90} {e.count:>7} {e.self_device_time_total / n:>16.1f}")
    print(f"\n{'operator':<40} {'calls':>7} {'host us/round':>14} {'device us/round':>16}")
    for e in ops[:20]:
        print(f"{e.key[:40]:<40} {e.count:>7} {e.self_cpu_time_total / n:>14.1f} "
              f"{e.device_time_total / n:>16.1f}")
    phases = {e.key: {"host_ms_per_round": e.cpu_time_total / n / 1e3,
                      "device_ms_per_round": e.device_time_total / n / 1e3,
                      "calls": e.count}
              for e in host if e.key.startswith(PHASE_PREFIXES)}
    print(json.dumps({"profile": {
        "device": torch.cuda.get_device_name(0), "rounds": n,
        "warmup_rounds": WARMUP_ROUNDS,
        "wall_ms_per_round": wall_ms / n,
        "device_ms_per_round": device_us / n / 1e3,
        "device_busy_share": device_us / 1e3 / wall_ms,
        "device_activities_per_round": sum(e.count for e in device) / n,
        "phases": phases,
        "top_device": [{"name": e.key, "calls": e.count,
                        "device_us_per_round": e.self_device_time_total / n}
                       for e in device[:10]]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
