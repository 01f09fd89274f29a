"""`ExperimentSpec` — one declarative description of a BFLN experiment.

Port of ``repro.api.spec``: the same nine sections — ``data`` (the
population), ``train`` (the round loop), ``async_`` (FedBuff), ``eval``,
``chain`` (incentives), ``mesh``, ``obs``, ``checkpoint``, ``faults`` — and
``engine`` / ``seed``, with the reference's field names, defaults and
validation, so the defaults describe the paper's main path: BFLN, sync,
n = 1000, cohort 10%, 20 rounds, MLP ``hidden=(64,)`` / ``rep_dim=32``, 5
clusters, ``synth10``.  The sections this slice does not run are carried as
data (``repro_torch.{faults,obs,checkpoint}.spec`` are copies of the
reference's), and ``run`` refuses their non-default values.

Every spec round-trips through JSON and hashes to a ``config_digest`` (all
sections but ``obs`` and ``checkpoint``) and a ``resume_digest`` (also
without ``faults``), equal to the reference's digests of the same spec, so
a port run's manifest matches the reference's.  ``from_flat`` takes the
reference's flat ``SimConfig`` knobs; the flat view itself
(``sim_config``, ``SimConfig``) is the reference's deprecated shim and is
not ported.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Mapping

from repro_torch.checkpoint.spec import CheckpointSpec
from repro_torch.faults.spec import FaultSpec
from repro_torch.obs.spec import ObsSpec


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_frac(name: str, value: float, *, lo: float = 0.0, hi: float = 1.0,
                lo_open: bool = False) -> None:
    ok = (value > lo if lo_open else value >= lo) and value <= hi
    _check(ok, f"{name} must be in {'(' if lo_open else '['}{lo}, {hi}], "
               f"got {value!r}")


@dataclass(frozen=True)
class DataSpec:
    """The virtual client population (mirrors ``PopulationSpec``)."""
    n_clients: int = 1000
    dataset: str = "synth10"
    beta: float = 0.3                 # Dirichlet label-skew concentration
    n_batches: int = 1
    batch_size: int = 16
    availability: float = 0.85
    dropout_rate: float = 0.03
    straggler_frac: float = 0.10
    straggler_slowdown: float = 8.0
    byzantine_frac: float = 0.0
    base_latency: float = 10.0
    latency_sigma: float = 0.25
    psi: int = 32                     # probe-batch size for PAA

    def __post_init__(self):
        _check(self.n_clients >= 1, f"n_clients must be >= 1, got {self.n_clients}")
        for f in ("n_batches", "batch_size", "psi"):
            _check(getattr(self, f) >= 1, f"{f} must be >= 1, got {getattr(self, f)}")
        _check(self.beta > 0, f"beta must be > 0, got {self.beta}")
        _check_frac("availability", self.availability, lo_open=True)
        for f in ("dropout_rate", "straggler_frac", "byzantine_frac"):
            _check_frac(f, getattr(self, f))
        _check(self.straggler_slowdown >= 1.0,
               f"straggler_slowdown must be >= 1, got {self.straggler_slowdown}")
        _check(self.base_latency > 0, f"base_latency must be > 0, got {self.base_latency}")


@dataclass(frozen=True)
class TrainSpec:
    """The round loop: which strategy runs, over whom, for how long."""
    strategy: str = "bfln"
    strategy_params: Mapping[str, Any] = field(default_factory=dict)
    rounds: int = 20
    sample_frac: float = 0.10
    n_clusters: int = 5
    local_epochs: int = 1
    lr: float = 1e-3
    deadline: float = 30.0            # virtual seconds per block slot (sync)
    sampler: str = "uniform"
    mode: str = "sync"                # "sync" | "async"
    hidden: tuple[int, ...] = (64,)   # MLP widths of the trained model
    rep_dim: int = 32

    def __post_init__(self):
        # checked lazily against the registry, so a strategy registered by
        # a user is accepted
        from repro_torch.api.registry import strategy_names
        from repro_torch.sim.sampler import SAMPLERS
        _check(self.strategy in strategy_names(),
               f"unknown strategy {self.strategy!r}; "
               f"registered: {strategy_names()}")
        _check(self.mode in ("sync", "async"),
               f"mode must be 'sync' or 'async', got {self.mode!r}")
        _check(self.sampler in SAMPLERS,
               f"unknown sampler {self.sampler!r}; options: {sorted(SAMPLERS)}")
        _check_frac("sample_frac", self.sample_frac, lo_open=True)
        for f in ("rounds", "n_clusters", "local_epochs"):
            _check(getattr(self, f) >= 1, f"{f} must be >= 1, got {getattr(self, f)}")
        _check(self.lr > 0, f"lr must be > 0, got {self.lr}")
        _check(self.deadline > 0, f"deadline must be > 0, got {self.deadline}")
        _check(self.rep_dim >= 1, f"rep_dim must be >= 1, got {self.rep_dim}")
        _check(len(self.hidden) >= 1 and all(h >= 1 for h in self.hidden),
               f"hidden must be a non-empty tuple of widths, got {self.hidden!r}")


@dataclass(frozen=True)
class AsyncSpec:
    """FedBuff buffered aggregation knobs (``mode='async'`` only)."""
    buffer_size: int = 16             # flush threshold K
    staleness_alpha: float = 0.5      # w(s) = (1+s)^-alpha
    server_lr: float = 1.0            # global += lr · merged delta
    concurrency: int = 64             # target in-flight clients

    def __post_init__(self):
        _check(self.buffer_size >= 1, f"buffer_size must be >= 1, got {self.buffer_size}")
        _check(self.concurrency >= 1, f"concurrency must be >= 1, got {self.concurrency}")
        _check(self.staleness_alpha >= 0,
               f"staleness_alpha must be >= 0, got {self.staleness_alpha}")
        _check(self.server_lr > 0, f"server_lr must be > 0, got {self.server_lr}")


@dataclass(frozen=True)
class EvalSpec:
    every: int = 5                    # 0 = only final eval
    clients: int = 128                # population sub-sample for evaluation
    examples: int = 1024              # shared-test sub-sample for evaluation

    def __post_init__(self):
        _check(self.every >= 0, f"every must be >= 0, got {self.every}")
        _check(self.clients >= 1, f"clients must be >= 1, got {self.clients}")
        _check(self.examples >= 1, f"examples must be >= 1, got {self.examples}")


@dataclass(frozen=True)
class ChainSpec:
    """Blockchain incentives (paper Table I)."""
    total_reward: float = 20.0
    rho: float = 2.0
    initial_stake: float = 5.0

    def __post_init__(self):
        _check(self.total_reward >= 0, f"total_reward must be >= 0, got {self.total_reward}")
        _check(self.rho >= 0, f"rho must be >= 0, got {self.rho}")
        _check(self.initial_stake >= 0, f"initial_stake must be >= 0, got {self.initial_stake}")


#: Cohort-axis execution modes for the mesh round engine.
COHORT_MODES = ("sharded", "replicated")


@dataclass(frozen=True)
class MeshSpec:
    """Client-axis device mesh for the row-sharded parameter arena.

    ``cohort`` picks how the per-round cohort runs on that mesh
    (``"sharded"``: each device trains its slice; ``"replicated"``: the
    lead device trains the whole cohort).  ``platform`` / ``x64`` /
    ``xla_flags`` are the reference's process-level JAX runtime knobs
    (``""`` lets JAX pick the platform); ``run`` refuses anything but
    their defaults, and takes the mesh's devices from its ``device``.
    """
    shards: int = 1
    cohort: str = "sharded"           # "sharded" | "replicated"
    platform: str = ""                # "" = let the reference pick
    x64: bool = False                 # float64 in the reference
    xla_flags: tuple[str, ...] = ()   # the reference's extra XLA_FLAGS

    def __post_init__(self):
        _check(isinstance(self.shards, int) and self.shards >= 1,
               f"mesh shards must be an int >= 1, got {self.shards!r}")
        _check(self.cohort in COHORT_MODES,
               f"mesh cohort must be one of {COHORT_MODES}, "
               f"got {self.cohort!r}")
        _check(isinstance(self.platform, str),
               f"mesh platform must be a string, got {self.platform!r}")
        _check(isinstance(self.x64, bool),
               f"mesh x64 must be a bool, got {self.x64!r}")
        _check(isinstance(self.xla_flags, tuple)
               and all(isinstance(f, str) and f for f in self.xla_flags),
               f"mesh xla_flags must be a tuple of non-empty strings, "
               f"got {self.xla_flags!r}")


_SUB_SPECS = {"data": DataSpec, "train": TrainSpec, "async_": AsyncSpec,
              "eval": EvalSpec, "chain": ChainSpec, "mesh": MeshSpec,
              "obs": ObsSpec, "checkpoint": CheckpointSpec,
              "faults": FaultSpec}

#: The reference's flat ``SimConfig`` knobs -> (section, field).  Every
#: flat default equals its section's, so a knob left out takes the default.
_FLAT_KNOBS = {
    **{f: ("train", f) for f in ("strategy", "strategy_params", "rounds",
                                 "sample_frac", "n_clusters", "local_epochs",
                                 "lr", "deadline", "sampler", "mode",
                                 "hidden", "rep_dim")},
    **{f: ("async_", f) for f in ("buffer_size", "staleness_alpha",
                                  "server_lr", "concurrency")},
    "eval_every": ("eval", "every"), "eval_clients": ("eval", "clients"),
    "eval_examples": ("eval", "examples"),
    **{f: ("chain", f) for f in ("total_reward", "rho", "initial_stake")},
    "mesh_shards": ("mesh", "shards"), "mesh_cohort": ("mesh", "cohort"),
}

#: FaultSpec round-list fields normalised list -> tuple on JSON load.
_FAULT_TUPLE_FIELDS = ("producer_fail_rounds", "bad_block_rounds",
                       "drop_commit_rounds", "delay_commit_rounds")


@dataclass(frozen=True)
class ExperimentSpec:
    """One experiment, declaratively: ``run(spec) -> ExperimentResult``."""
    data: DataSpec = field(default_factory=DataSpec)
    train: TrainSpec = field(default_factory=TrainSpec)
    async_: AsyncSpec = field(default_factory=AsyncSpec)
    eval: EvalSpec = field(default_factory=EvalSpec)
    chain: ChainSpec = field(default_factory=ChainSpec)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    obs: ObsSpec = field(default_factory=ObsSpec)   # flight recorder (off)
    checkpoint: CheckpointSpec = field(         # snapshot/resume (off)
        default_factory=CheckpointSpec)
    faults: FaultSpec = field(default_factory=FaultSpec)  # injection (off)
    engine: bool = True               # arena-backed round engine
    seed: int = 0

    def __post_init__(self):
        _check(self.mesh.shards == 1 or self.engine,
               "mesh shards > 1 requires engine=True (the legacy oracle "
               "driver is single-device only)")

    def population_spec(self):
        """The ``PopulationSpec`` this experiment's population uses."""
        from repro_torch.sim.population import PopulationSpec
        return PopulationSpec(**dataclasses.asdict(self.data), seed=self.seed)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["train"]["hidden"] = list(self.train.hidden)
        d["train"]["strategy_params"] = dict(self.train.strategy_params)
        d["mesh"]["xla_flags"] = list(self.mesh.xla_flags)
        for f in _FAULT_TUPLE_FIELDS:
            d["faults"][f] = list(getattr(self.faults, f))
        return d

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        if "async" in d:                      # alias for the keyword-escaped
            d["async_"] = d.pop("async")      # field name
        unknown = set(d) - set(_SUB_SPECS) - {"engine", "seed"}
        if unknown:
            raise ValueError(
                f"unknown spec section(s) {sorted(unknown)}; expected "
                f"{sorted(_SUB_SPECS)} + ['engine', 'seed']")
        kw: dict[str, Any] = {}
        for name, sub_cls in _SUB_SPECS.items():
            sub = dict(d.get(name, {}))
            if name == "train" and "hidden" in sub:
                sub["hidden"] = tuple(sub["hidden"])
            if name == "mesh" and "xla_flags" in sub:
                sub["xla_flags"] = tuple(sub["xla_flags"])
            if name == "faults":
                for f in _FAULT_TUPLE_FIELDS:
                    if f in sub:
                        sub[f] = tuple(sub[f])
            kw[name] = sub_cls(**sub)
        for name in ("engine", "seed"):
            if name in d:
                kw[name] = d[name]
        return cls(**kw)

    @classmethod
    def from_flat(cls, data: DataSpec | None = None, **flat) -> "ExperimentSpec":
        """Build a nested spec from the reference's flat ``SimConfig``-style
        knobs (``rounds=``, ``buffer_size=``, ``eval_every=``, ``engine=``,
        ``seed=``, ...) — the migration path for flat CLIs."""
        sections: dict[str, dict] = {}
        top = {k: flat.pop(k) for k in ("engine", "seed") if k in flat}
        unknown = set(flat) - set(_FLAT_KNOBS)
        if unknown:
            raise TypeError(f"unknown flat knob(s) {sorted(unknown)}")
        for knob, value in flat.items():
            section, name = _FLAT_KNOBS[knob]
            if name == "hidden":
                value = tuple(value)
            elif name == "strategy_params":
                value = dict(value)
            sections.setdefault(section, {})[name] = value
        return cls(data=data if data is not None else DataSpec(),
                   **{s: _SUB_SPECS[s](**kw) for s, kw in sections.items()},
                   **top)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def _digest(self, *dropped: str) -> str:
        d = self.to_dict()
        for section in dropped:
            d.pop(section)
        return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()

    def config_digest(self) -> str:
        """Stable SHA-256 over the canonical JSON form without ``obs`` and
        ``checkpoint`` (out of band: they never change the trajectory) — the
        reproducibility stamp every run manifest carries."""
        return self._digest("obs", "checkpoint")

    def resume_digest(self) -> str:
        """The experiment identity a checkpoint binds to: ``config_digest``
        without ``faults`` as well, so a crashed run can resume with its
        fault schedule cleared."""
        return self._digest("obs", "checkpoint", "faults")
