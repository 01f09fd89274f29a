"""Virtual client populations over the non-IID partitions.

Port of ``repro.sim.population``: each virtual client owns a Dirichlet
label-skew shard plus a behavioural profile (latency multiplier,
availability, dropout probability, Byzantine flag).  The numpy build is the
reference's call for call, so the same spec gives the same arrays; the
training data, the shared test split and the probe batch then move to the
run's device as tensors (labels as int64).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.data import (
    dirichlet_partition,
    make_classification_dataset,
    pack_clients,
    sample_probe_batch,
)
from repro_torch.device import resolve_device
from repro_torch.sim.clock import LatencyModel, make_speed_profile


@dataclass(frozen=True)
class PopulationSpec:
    n_clients: int = 1000
    dataset: str = "synth10"
    beta: float = 0.3                 # Dirichlet label-skew concentration
    n_batches: int = 1
    batch_size: int = 16
    availability: float = 0.85        # mean per-round online probability
    dropout_rate: float = 0.03        # mean mid-round death probability
    straggler_frac: float = 0.10
    straggler_slowdown: float = 8.0
    byzantine_frac: float = 0.0
    base_latency: float = 10.0        # virtual seconds, 1x-speed local round
    latency_sigma: float = 0.25
    psi: int = 32                     # probe-batch size for PAA
    seed: int = 0


@dataclass
class ClientPopulation:
    """Materialised population: data shards on the device + behaviour
    profiles and latency on the host."""

    spec: PopulationSpec
    cx: torch.Tensor                  # (n, n_batches, B, ...) train
    cy: torch.Tensor                  # (n, n_batches, B) int64
    tx: np.ndarray                    # (n, n_test, ...) per-client local test
    ty: np.ndarray                    # (n, n_test)
    test_x: torch.Tensor              # shared global test split
    test_y: torch.Tensor              # int64
    probe: torch.Tensor               # (psi, ...) PAA probe batch
    num_classes: int
    in_dim: int
    availability: np.ndarray          # (n,) per-client online probability
    dropout: np.ndarray               # (n,) per-client mid-round death prob
    byzantine: np.ndarray             # (n,) bool
    latency: LatencyModel = field(repr=False)

    @property
    def n_clients(self) -> int:
        return self.spec.n_clients

    @property
    def device(self) -> torch.device:
        return self.cx.device

    @classmethod
    def from_spec(cls, spec: PopulationSpec, device=None) -> "ClientPopulation":
        device = resolve_device(device)
        rng = np.random.default_rng(spec.seed)
        (xt, yt), (xe, ye) = make_classification_dataset(spec.dataset,
                                                         seed=spec.seed)
        parts = dirichlet_partition(yt, spec.n_clients, spec.beta,
                                    seed=spec.seed)
        cx, cy, tx, ty = pack_clients(xt, yt, parts, n_batches=spec.n_batches,
                                      batch_size=spec.batch_size,
                                      seed=spec.seed)
        probe = sample_probe_batch(xt, yt, category=0, psi=spec.psi,
                                   seed=spec.seed)

        n = spec.n_clients
        # per-client behaviour, jittered around the spec means
        avail = np.clip(rng.normal(spec.availability, 0.08, size=n), 0.05, 1.0)
        drop = np.clip(rng.normal(spec.dropout_rate, spec.dropout_rate / 2,
                                  size=n), 0.0, 0.9)
        byz = np.zeros(n, dtype=bool)
        n_byz = int(round(spec.byzantine_frac * n))
        if n_byz:
            byz[rng.choice(n, size=n_byz, replace=False)] = True

        speed = make_speed_profile(n, spec.straggler_frac,
                                   spec.straggler_slowdown, rng)
        latency = LatencyModel(speed, spec.base_latency, spec.latency_sigma,
                               np.random.default_rng(spec.seed + 1))

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

        return cls(
            spec=spec,
            cx=dev(cx, torch.float32), cy=dev(cy, torch.long), tx=tx, ty=ty,
            test_x=dev(xe, torch.float32), test_y=dev(ye, torch.long),
            probe=dev(probe, torch.float32),
            num_classes=int(yt.max()) + 1, in_dim=int(xt.shape[1]),
            availability=avail, dropout=drop, byzantine=byz,
            latency=latency,
        )

    # ------------------------------------------------------------------ #

    def online_clients(self, rng: np.random.Generator) -> np.ndarray:
        """Ids of clients online at a round boundary (availability draw)."""
        return np.flatnonzero(rng.random(self.n_clients) < self.availability)

    def cohort_data(self, cohort: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Stacked (k, n_batches, B, ...) train data for a sampled cohort."""
        idx = torch.as_tensor(np.asarray(cohort), dtype=torch.long,
                              device=self.device)
        return self.cx.index_select(0, idx), self.cy.index_select(0, idx)
