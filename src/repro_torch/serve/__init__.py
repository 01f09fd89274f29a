"""`repro_torch.serve` — chain-verified personalized serving tier.

Port of ``repro.serve``.  Turns a finished run into a serving stack for
BFLN's end product, the K cluster-personalized models:

    frontend = serve(result)               # snapshot -> release -> verify
    rid = frontend.submit(cluster_id=2, x=features)
    frontend.drain()
    [done] = frontend.take_completed()

Pieces: :func:`snapshot` extracts the fixed-shape model bank from the
arena, fingerprints it with the Hopper kernel and mints a release block;
:class:`ServingEngine` answers mixed-cluster batches in one forward after
:func:`verify_bank`'s refuse-to-serve provenance gate;
:class:`ServeFrontend` adds deterministic size-bucketed micro-batching on
an injected clock.
"""
from repro_torch.obs import NULL_RECORDER
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.frontend import (  # noqa: F401
    Completion,
    ServeConfig,
    ServeFrontend,
)
from repro_torch.serve.snapshot import (  # noqa: F401
    ModelBank,
    ModelRelease,
    ProvenanceError,
    bank_digests,
    latest_release,
    load_bank,
    publish_release,
    snapshot,
    tampered,
    verify_bank,
)


def serve(source, *, config: ServeConfig | None = None, clock=None,
          obs=None) -> ServeFrontend:
    """One call from a finished run to a verified serving frontend.

    Snapshot the run's population into a model bank, publish its release
    block, verify every model's provenance against the chain head, and wire
    the batched engine behind a frontend driven by the run's own virtual
    clock (override with ``clock``).
    """
    sim = getattr(source, "sim", source)
    if obs is None:
        obs = getattr(sim, "obs", None) or NULL_RECORDER
    bank = snapshot(source, obs=obs)
    engine = ServingEngine(bank, sim.trainer.chain, obs=obs)
    return ServeFrontend(engine, config or ServeConfig(),
                         clock=clock if clock is not None else sim.clock,
                         obs=obs)
