"""`run(spec) -> ExperimentResult` — the one way to run an experiment.

Port of ``repro.api.runner``.  Builds the population from ``spec.data`` on
the run's device, drives the simulator through the round engine and
returns the report with a *manifest*: a flat, JSON-able record stamped with
the spec's ``config_digest`` (the reference's manifest, without its
``engine_compile_counts``: nothing compiles here).

It runs every registered strategy through the engine, on one device or
over a client mesh (``spec.mesh.shards`` S > 1, cohort ``"sharded"`` or
``"replicated"``: S shards on the host with ``device="cpu"``, on
``cuda:0..S-1``, or on a sequence of S devices), in sync rounds or async
FedBuff flushes, with any fault schedule, with checkpoints and
``resume_from``, and with the flight recorder (``spec.obs``: the trace
file, its digest and the timing readout in the manifest, as the
reference's).  A run at S shards ends with the one-shard run's digests,
on the CPU and on the card (``repro_torch.core.engine``).
``run`` refuses the legacy driver (``engine=False``) and the XLA-only mesh
settings (``platform``, ``x64``, ``xla_flags``) with
``NotImplementedError``: both are deliberately not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any

from repro_torch.api.spec import ExperimentSpec, MeshSpec
from repro_torch.device import resolve_device
from repro_torch.obs import console_summary, write_chrome_trace, write_jsonl
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.sim.driver import SimReport, SimulatedFederation, one_device
from repro_torch.sim.population import ClientPopulation


def event_log_digest(event_log) -> str:
    """SHA-256 over the full (virtual-time, kind, client) event stream —
    the same as the reference's for the same seed and spec."""
    return hashlib.sha256(
        json.dumps(event_log, sort_keys=False).encode()).hexdigest()


@dataclass
class ExperimentResult:
    spec: ExperimentSpec
    report: SimReport
    manifest: dict[str, Any] = field(default_factory=dict)
    # the live simulator: the trained arena, the chain and the virtual
    # clock, so `repro_torch.serve.serve(result)` can serve the run
    sim: Any = field(default=None, repr=False, compare=False)

    def summary(self) -> str:
        m = self.manifest
        line = (f"[{m['strategy']}/{m['mode']}] {self.report.summary()} "
                f"config_digest={m['config_digest'][:12]}")
        t = m.get("timing")
        if t:
            unit = "flush" if m.get("mode") == "async" else "round"
            line += (f"\n  timing: {unit} p50={t.get('round_ms_p50', 0):.1f}ms"
                     f" p99={t.get('round_ms_p99', 0):.1f}ms")
            if "chain_overhead_pct" in t:
                line += f" chain={t['chain_overhead_pct']:.1f}%"
            line += f" compiles={t.get('compiles', 0)}"
        return line


def build_manifest(spec: ExperimentSpec, sim: SimulatedFederation,
                   report: SimReport) -> dict[str, Any]:
    """The reproducibility record: config digest first, then everything a
    replay must reproduce."""
    manifest: dict[str, Any] = {
        "config_digest": spec.config_digest(),
        "strategy": spec.train.strategy,
        "mode": spec.train.mode,
        "sampler": spec.train.sampler,
        "engine": spec.engine,
        "mesh_shards": spec.mesh.shards,
        "seed": spec.seed,
        "n_clients": sim.pop.n_clients,
        "rounds_run": len(report.history),
        "event_log_digest": event_log_digest(report.event_log),
        "block_hashes_digest": hashlib.sha256("".join(
            b.block_hash() for b in sim.trainer.chain.blocks
        ).encode()).hexdigest(),
        "n_blocks": report.n_blocks,
        "chain_valid": report.chain_valid,
        "ledger_conserved": report.ledger_conserved,
        "balances_digest": hashlib.sha256(
            report.balances.tobytes()).hexdigest(),
        "final_accuracy": report.final_accuracy,
    }
    if sim.ckpt is not None:
        manifest["checkpoints_written"] = sim._ckpt_written
        manifest["checkpoint_bytes"] = sim._ckpt_bytes
    if sim._resumed_from is not None:
        manifest["resumed_from"] = sim._resumed_from[0]
        manifest["resume_step"] = sim._resumed_from[1]
    return manifest


def format_manifest(manifest: dict[str, Any]) -> str:
    return "\n".join(f"  {k}: {v}" for k, v in manifest.items())


def check_supported(spec: ExperimentSpec) -> None:
    """Refuse what the port does not run: ``engine=False`` and the mesh's
    XLA-only settings (``platform``, ``x64``, ``xla_flags``), all
    deliberately not ported (ROADMAP §1).  ``mesh.shards`` and
    ``mesh.cohort`` run."""
    if not spec.engine:
        raise NotImplementedError(
            "engine=False (the reference's legacy oracle driver) is "
            "deliberately not ported (ROADMAP §1 \"Deliberately not "
            "ported\"): the port's engine is held against the reference's "
            "engine instead")
    mesh = dataclasses.replace(spec.mesh, shards=MeshSpec().shards,
                               cohort=MeshSpec().cohort)
    if mesh != MeshSpec():
        raise NotImplementedError(
            f"mesh platform/x64/xla_flags {mesh} are XLA runtime settings, "
            "deliberately not ported (ROADMAP §1 \"Deliberately not "
            "ported\"): the port picks its devices through run(device=...) "
            "and runs in float32")


def run(spec: ExperimentSpec, population: ClientPopulation | None = None, *,
        device=None, obs=None, resume_from: str | None = None
        ) -> ExperimentResult:
    """Run one experiment end to end on ``device`` (``None`` means the
    card; without CUDA that raises).  With ``spec.mesh.shards`` S > 1,
    ``device`` is ``"cpu"`` (S shards on the host), ``None`` / ``"cuda"``
    (``cuda:0..S-1``) or a sequence of S devices
    (``repro_torch.launch.mesh.make_client_mesh``); the population lives
    on the first.  ``population`` may be passed to reuse
    one already built from this spec on this device.  ``obs`` is an
    optional recorder for the round's phase spans (``SimulatedFederation``)
    when ``spec.obs`` is off; with it on, the run's own ``FlightRecorder``
    writes the trace and stamps its digest and timing into the manifest,
    and ``spec.obs.profile_dir`` wraps the run in ``torch.profiler``.

    ``resume_from`` restores a snapshot written by ``spec.checkpoint`` (a
    file, or a checkpoint directory whose newest readable snapshot is used)
    and continues the run from that boundary.  The snapshot's stamped
    ``resume_digest`` must equal the spec's — obs/checkpoint/faults are
    free to differ, so a crashed run can be resumed with its fault schedule
    cleared — and the resumed run ends with the uninterrupted run's
    manifest digests.
    """
    check_supported(spec)
    if spec.mesh.shards > 1:
        lead = make_client_mesh(spec.mesh.shards, device).lead
    else:
        device = lead = resolve_device(one_device(device))
    if population is None:
        population = ClientPopulation.from_spec(spec.population_spec(), lead)
    elif population.spec != spec.population_spec():
        raise ValueError(
            "supplied population was built from a different PopulationSpec "
            "than spec.data/spec.seed would rebuild")
    sim = SimulatedFederation(population, spec, device=device, obs=obs)
    profile_dir = spec.obs.profile_dir if spec.obs.enabled else None
    with _profiled(profile_dir, lead):
        report = sim.run(resume_from=resume_from)
    manifest = build_manifest(spec, sim, report)
    if spec.obs.enabled:
        _emit_trace(spec, sim, manifest)
    return ExperimentResult(spec, report, manifest, sim=sim)


@contextlib.contextmanager
def _profiled(profile_dir: str | None, device):
    """``torch.profiler`` around the run — host activity, and the card's
    when the run is on CUDA — written to ``profile_dir/torch_trace.json``:
    the counterpart of the reference's ``jax.profiler.trace``."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "torch_trace.json"))


def _emit_trace(spec: ExperimentSpec, sim: SimulatedFederation,
                manifest: dict[str, Any]) -> None:
    """Flush the flight recorder's sinks and stamp the trace digest into the
    manifest.  Strictly post-run: nothing here can perturb the simulation
    it describes."""
    obs = sim.obs
    meta = {k: manifest[k] for k in
            ("config_digest", "strategy", "mode", "engine", "mesh_shards",
             "seed", "n_clients", "rounds_run")}
    digest = write_jsonl(spec.obs.trace_path, meta, obs.records, obs.metrics)
    manifest["trace_path"] = spec.obs.trace_path
    manifest["trace_digest"] = digest
    manifest["timing"] = obs.timing_summary()
    if spec.obs.chrome_path is not None:
        write_chrome_trace(spec.obs.chrome_path, obs.records)
        manifest["chrome_trace_path"] = spec.obs.chrome_path
    if spec.obs.console:
        print(console_summary(
            obs.metrics, title=f"trace {spec.train.strategy}/"
            f"{spec.train.mode} -> {spec.obs.trace_path}"))
