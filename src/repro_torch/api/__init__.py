"""`repro_torch.api` — the declarative experiment surface.

    from repro_torch.api import ExperimentSpec, run
    from repro_torch.serve import serve

    result = run(ExperimentSpec())          # BFLN sync rounds on the card
    frontend = serve(result)                # chain-verified serving tier

Port of ``repro.api`` on one device: one spec runs any registered
strategy (BFLN, FedAvg, FedProx, FedProto, FedHKD, or one registered with
:func:`register_strategy`) through the round engine, in sync rounds or
async FedBuff flushes, under any ``FaultSpec``, with checkpoints and
``run(spec, resume_from=...)``.
``load_packed_clients`` and ``make_mlp_bundle`` set up the paper's
full-participation runs (``repro_torch.paper``).
"""
from repro_torch.api.registry import (  # noqa: F401
    build_strategy,
    register_strategy,
    strategy_names,
)
from repro_torch.api.runner import (  # noqa: F401
    ExperimentResult,
    build_manifest,
    event_log_digest,
    run,
)
from repro_torch.api.setup import (  # noqa: F401
    PackedClients,
    load_packed_clients,
    make_mlp_bundle,
)
from repro_torch.api.spec import (  # noqa: F401
    AsyncSpec,
    ChainSpec,
    CheckpointSpec,
    DataSpec,
    EvalSpec,
    ExperimentSpec,
    FaultSpec,
    MeshSpec,
    ObsSpec,
    TrainSpec,
)
from repro_torch.checkpoint import CheckpointError  # noqa: F401
from repro_torch.faults import InjectedCrash  # noqa: F401
