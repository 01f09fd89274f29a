"""String-keyed strategy registry: the one place strategies are looked up.

Port of ``repro.api.registry``.  A builder has the signature

    builder(bundle, *, probe, n_clusters, **params) -> Strategy

The port registers ``bfln``.  The reference's four Table II baselines are
known names whose builders come with a later slice (ROADMAP queue 1 item
4): asking for one raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Protocol

from repro_torch.core.baselines import Strategy, make_bfln

#: Every strategy the reference registers; the port builds those in
#: ``_REGISTRY``.
KNOWN_STRATEGIES = ("bfln", "fedavg", "fedhkd", "fedproto", "fedprox")


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
    builder = _REGISTRY.get(name)
    if builder is None:
        if name in KNOWN_STRATEGIES:
            raise NotImplementedError(
                f"strategy {name!r} is not ported yet (ROADMAP queue 1 item "
                f"4: the other strategies); the port runs {strategy_names()}")
        raise ValueError(f"unknown strategy {name!r}; "
                         f"registered: {strategy_names()}")
    return builder(bundle, probe=probe, n_clusters=n_clusters, **params)


def _bfln(bundle, *, probe, n_clusters, **params):
    if probe is None:
        raise ValueError("bfln needs a PAA probe batch (probe=...)")
    if n_clusters < 1:
        raise ValueError(f"bfln needs n_clusters >= 1, got {n_clusters}")
    return make_bfln(bundle, probe, n_clusters, **params)


register_strategy("bfln", _bfln)
