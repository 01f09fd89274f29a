"""Shared experiment wiring: dataset packing and the model bundle.

Port of ``repro.api.setup``: partition a dataset into rectangular client
shards, sample the PAA probe batch, build the MLP ``ModelBundle`` — the
set-up every full-participation run (``repro_torch.paper``) needs.  The
numpy build is the reference's call for call, so the same arguments give
the same arrays; the training data, the shared test split and the probe
then move to ``device`` as tensors (labels as int64).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.baselines import ModelBundle
from repro_torch.data import (
    dirichlet_partition,
    make_classification_dataset,
    pack_clients,
    sample_probe_batch,
)
from repro_torch.device import resolve_device
from repro_torch.models import classifier as clf


class PackedClients(NamedTuple):
    """A partitioned classification dataset, stacked for the trainer."""
    cx: torch.Tensor         # (n, n_batches, B, D) train
    cy: torch.Tensor         # (n, n_batches, B) int64
    tx: np.ndarray           # (n, n_test, D) per-client local test
    ty: np.ndarray           # (n, n_test)
    test_x: torch.Tensor     # shared global test split
    test_y: torch.Tensor     # int64
    probe: torch.Tensor      # (psi, D) PAA probe batch
    num_classes: int
    in_dim: int


def load_packed_clients(dataset: str, n_clients: int, bias: float, *,
                        n_batches: int = 4, batch_size: int = 64,
                        psi: int = 32, probe_category: int = 0,
                        seed: int = 0, device=None) -> PackedClients:
    """Dirichlet-partition ``dataset`` into ``n_clients`` rectangular shards
    plus the shared test split and the PAA probe batch, on ``device``
    (``None`` means the card)."""
    device = resolve_device(device)
    (xt, yt), (xe, ye) = make_classification_dataset(dataset, seed=seed)
    parts = dirichlet_partition(yt, n_clients, bias, seed=seed)
    cx, cy, tx, ty = pack_clients(xt, yt, parts, n_batches=n_batches,
                                  batch_size=batch_size, seed=seed)
    probe = sample_probe_batch(xt, yt, category=probe_category, psi=psi,
                               seed=seed)

    def to_device(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    return PackedClients(
        cx=to_device(cx), cy=to_device(cy, torch.int64), tx=tx, ty=ty,
        test_x=to_device(xe), test_y=to_device(ye, torch.int64),
        probe=to_device(probe),
        num_classes=int(yt.max()) + 1, in_dim=int(xt.shape[1]))


def make_mlp_bundle(in_dim: int, num_classes: int, *,
                    hidden: tuple[int, ...] = (128,), rep_dim: int = 64,
                    ) -> tuple[clf.MLPConfig, ModelBundle]:
    """The FL classifier as (architecture config, bundle of its stacked
    training forwards)."""
    cfg = clf.MLPConfig(in_dim=in_dim, hidden=tuple(hidden), rep_dim=rep_dim,
                        num_classes=num_classes)
    bundle = ModelBundle(functools.partial(clf.apply_batched, cfg),
                         functools.partial(clf.embed_batched, cfg), num_classes)
    return cfg, bundle
