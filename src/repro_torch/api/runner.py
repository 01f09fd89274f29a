"""`run(spec) -> ExperimentResult` — the one way to run an experiment.

Port of ``repro.api.runner``.  Builds the population from ``spec.data`` on
the run's device, drives the simulator through the round engine and
returns the report with a *manifest*: a flat, JSON-able record stamped with
the spec's ``config_digest`` (the reference's manifest, without its
``engine_compile_counts``: nothing compiles here).

It runs every registered strategy through the engine on one device, in
sync rounds or async FedBuff flushes, with any fault schedule and with
checkpoints and ``resume_from``; ``run`` refuses anything else (the flight
recorder, the legacy driver, the mesh) with ``NotImplementedError`` naming
the ROADMAP queue item that brings it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any

from repro_torch.api.spec import ExperimentSpec, MeshSpec, ObsSpec
from repro_torch.device import resolve_device
from repro_torch.sim.driver import SimReport, SimulatedFederation
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
        return (f"[{m['strategy']}/{m['mode']}] {self.report.summary()} "
                f"config_digest={m['config_digest'][:12]}")


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


def check_supported(spec: ExperimentSpec) -> None:
    """Refuse what the port does not run, naming the ROADMAP queue item
    (§1 "Modules to port") that brings it: the flight recorder (a
    non-default ``obs``), ``engine=False`` and anything but the defaults in
    ``mesh`` (past ``shards``, which has its own message)."""
    if not spec.engine:
        raise NotImplementedError(
            "engine=False (the reference's legacy oracle driver) is not "
            "ported (ROADMAP queue 1 item 3 ports the engine paths only)")
    if spec.mesh.shards > 1:
        raise NotImplementedError(
            f"mesh shards={spec.mesh.shards} is not ported yet (ROADMAP "
            "queue 1 item 6: multi-GPU)")
    if spec.obs != ObsSpec():
        raise NotImplementedError(
            f"obs={spec.obs} is not ported yet (ROADMAP queue 1 item 5b: the "
            "flight recorder, obs/{metrics,names,schema,sinks}.py)")
    mesh = dataclasses.replace(spec.mesh, shards=MeshSpec().shards)
    if mesh != MeshSpec():
        raise NotImplementedError(
            f"mesh cohort/platform/x64/xla_flags {mesh} are not ported yet "
            "(ROADMAP queue 1 item 6: multi-GPU; the port runs one card in "
            "float32)")


def run(spec: ExperimentSpec, population: ClientPopulation | None = None, *,
        device=None, obs=None, resume_from: str | None = None
        ) -> ExperimentResult:
    """Run one experiment end to end on ``device`` (``None`` means the
    card; without CUDA that raises).  ``population`` may be passed to reuse
    one already built from this spec on this device.  ``obs`` is an
    optional recorder for the round's phase spans (``SimulatedFederation``).

    ``resume_from`` restores a snapshot written by ``spec.checkpoint`` (a
    file, or a checkpoint directory whose newest readable snapshot is used)
    and continues the run from that boundary.  The snapshot's stamped
    ``resume_digest`` must equal the spec's — obs/checkpoint/faults are
    free to differ, so a crashed run can be resumed with its fault schedule
    cleared — and the resumed run ends with the uninterrupted run's
    manifest digests.
    """
    check_supported(spec)
    device = resolve_device(device)
    if population is None:
        population = ClientPopulation.from_spec(spec.population_spec(), device)
    elif population.spec != spec.population_spec():
        raise ValueError(
            "supplied population was built from a different PopulationSpec "
            "than spec.data/spec.seed would rebuild")
    sim = SimulatedFederation(population, spec, device=device, obs=obs)
    report = sim.run(resume_from=resume_from)
    return ExperimentResult(spec, report, build_manifest(spec, sim, report),
                            sim=sim)
