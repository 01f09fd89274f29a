"""One federated training run of the paper's protocol (port of
``benchmarks/common.py::run_fl``): every client trains every round
(``FederatedTrainer.init`` / ``run_round``), BFLN with the chain."""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.api import build_strategy, load_packed_clients, make_mlp_bundle
from repro_torch.core.fl import evaluate
from repro_torch.core.round import FederatedTrainer
from repro_torch.device import resolve_device
from repro_torch.models import classifier as clf
from repro_torch.optim import adam

#: where the drivers write by default: the repo's git-ignored chiprun_out/
OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out"


def run_fl(dataset: str, bias: float, strategy: str, *, n_clients: int = 20,
           rounds: int = 12, local_epochs: int = 2, n_batches: int = 4,
           batch_size: int = 64, n_clusters: int = 5, seed: int = 0,
           psi: int = 32, device=None) -> tuple[FederatedTrainer, float]:
    """One federated training run on ``device`` (``None`` means the card);
    returns (trainer, personalised accuracy: the mean over clients of each
    client's model on its own local test split)."""
    device = resolve_device(device)
    data = load_packed_clients(dataset, n_clients, bias, n_batches=n_batches,
                               batch_size=batch_size, psi=psi, seed=seed,
                               device=device)
    cfg, bundle = make_mlp_bundle(data.in_dim, data.num_classes)
    sp = clf.init_stacked(cfg, torch.Generator().manual_seed(seed), n_clients,
                          device=device)

    strat = build_strategy(strategy, bundle, probe=data.probe,
                           n_clusters=n_clusters)
    tr = FederatedTrainer(bundle, strat, adam(1e-3), local_epochs=local_epochs,
                          n_clusters=n_clusters, use_chain=(strategy == "bfln"))

    p, o = tr.init(sp)
    for r in range(rounds):
        p, o, _ = tr.run_round(r, p, o, data.cx, data.cy, data.test_x,
                               data.test_y)

    tx = torch.from_numpy(data.tx).to(device)
    ty = torch.from_numpy(data.ty).to(device, torch.int64)
    return tr, float(evaluate(bundle.apply_fn, p, tx, ty).mean())
