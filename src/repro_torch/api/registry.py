"""String-keyed strategy registry: the one place strategies are looked up.

Port of ``repro.api.registry``.  Every federated strategy — BFLN and the
paper's four Table II baselines — registers a *builder* under a short name,
with the signature

    builder(bundle, *, probe, n_clusters, **params) -> Strategy

where ``params`` are strategy-specific hyper-parameters (e.g. FedProx
``mu``).  ``TrainSpec.strategy`` is validated against this registry, so a
strategy registered by a user runs through ``run(spec)`` too.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Protocol

from repro_torch.core.baselines import STRATEGY_FACTORIES, Strategy, make_bfln


class StrategyBuilder(Protocol):
    def __call__(self, bundle, *, probe, n_clusters, **params) -> Strategy: ...


_REGISTRY: dict[str, StrategyBuilder] = {}


def register_strategy(name: str, builder: StrategyBuilder,
                      overwrite: bool = False) -> None:
    """Register ``builder`` under ``name`` (ValueError on silent collision)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"strategy {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = builder


def strategy_names() -> list[str]:
    return sorted(_REGISTRY)


def build_strategy(name: str, bundle, *, probe=None, n_clusters: int = 5,
                   **params) -> Strategy:
    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"registered: {strategy_names()}") from None
    return builder(bundle, probe=probe, n_clusters=n_clusters, **params)


def _bfln(bundle, *, probe, n_clusters, **params):
    if probe is None:
        raise ValueError("bfln needs a PAA probe batch (probe=...)")
    if n_clusters < 1:
        raise ValueError(f"bfln needs n_clusters >= 1, got {n_clusters}")
    return make_bfln(bundle, probe, n_clusters, **params)


def _plain(make: Callable) -> StrategyBuilder:
    def builder(bundle, *, probe=None, n_clusters=0, **params):
        return make(bundle, **params)
    return builder


register_strategy("bfln", _bfln)
# the probe-less baselines come straight from the factory table in
# repro_torch.core.baselines
for _name, _make in STRATEGY_FACTORIES.items():
    register_strategy(_name, _plain(_make))
