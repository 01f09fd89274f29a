"""`ExperimentSpec` — one declarative description of a BFLN experiment.

Port of ``repro.api.spec`` with the sections this slice runs: ``data``
(the population), ``train`` (the round loop), ``eval``, ``chain``
(incentives), ``mesh`` (only ``shards``), ``engine`` and ``seed``.  Field
names, defaults and validation are the reference's, so the defaults
describe the paper's main path: BFLN, sync, n = 1000, cohort 10%, 20
rounds, MLP ``hidden=(64,)`` / ``rep_dim=32``, 5 clusters, ``synth10``.
The reference's other sections (``async_``, ``obs``, ``checkpoint``,
``faults``) come with later slices; ``from_dict`` refuses them by name.

Every spec round-trips through JSON and hashes to a ``config_digest``.  The
port's digest covers only the port's sections, so it differs from the
reference's digest of the same experiment.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Mapping


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
        from repro_torch.api.registry import KNOWN_STRATEGIES
        from repro_torch.sim.sampler import SAMPLERS
        _check(self.strategy in KNOWN_STRATEGIES,
               f"unknown strategy {self.strategy!r}; known: {list(KNOWN_STRATEGIES)}")
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


@dataclass(frozen=True)
class MeshSpec:
    """Client-axis device mesh: ``shards`` devices (one, in this slice)."""
    shards: int = 1

    def __post_init__(self):
        _check(isinstance(self.shards, int) and self.shards >= 1,
               f"mesh shards must be an int >= 1, got {self.shards!r}")


_SUB_SPECS = {"data": DataSpec, "train": TrainSpec, "eval": EvalSpec,
              "chain": ChainSpec, "mesh": MeshSpec}


@dataclass(frozen=True)
class ExperimentSpec:
    """One experiment, declaratively: ``run(spec) -> ExperimentResult``."""
    data: DataSpec = field(default_factory=DataSpec)
    train: TrainSpec = field(default_factory=TrainSpec)
    eval: EvalSpec = field(default_factory=EvalSpec)
    chain: ChainSpec = field(default_factory=ChainSpec)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    engine: bool = True               # arena-backed round engine
    seed: int = 0

    def population_spec(self):
        """The ``PopulationSpec`` this experiment's population uses."""
        from repro_torch.sim.population import PopulationSpec
        return PopulationSpec(**dataclasses.asdict(self.data), seed=self.seed)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["train"]["hidden"] = list(self.train.hidden)
        d["train"]["strategy_params"] = dict(self.train.strategy_params)
        return d

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        unknown = set(d) - set(_SUB_SPECS) - {"engine", "seed"}
        if unknown:
            raise ValueError(
                f"unknown spec section(s) {sorted(unknown)}; the port takes "
                f"{sorted(_SUB_SPECS)} + ['engine', 'seed']")
        kw: dict[str, Any] = {}
        for name, sub_cls in _SUB_SPECS.items():
            sub = dict(d.get(name, {}))
            if name == "train" and "hidden" in sub:
                sub["hidden"] = tuple(sub["hidden"])
            kw[name] = sub_cls(**sub)
        for name in ("engine", "seed"):
            if name in d:
                kw[name] = d[name]
        return cls(**kw)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def config_digest(self) -> str:
        """Stable SHA-256 over the canonical JSON form — the reproducibility
        stamp every run manifest carries."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()
