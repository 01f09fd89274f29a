"""The paper's own technique at pod scale, on one card.

Port of ``repro.launch.fl_target``.  "Cluster-parallel federated
aggregation": 64 federated clients each fine-tune an 83,886,080-parameter
MLP tower (1024 -> 8192 -> 8192 -> 1024); one PAA round (the prototype
forward of every client on the shared probe batch -> Pearson matrix ->
spectral clustering -> cluster-masked parameter mean) runs through
``core.aggregation.paa_round``.  The 64 stacked towers are 21.47 GB of
float32, which one H100 (80 GB) holds whole.

The Pearson matrix goes through the port's Pearson kernel on a CUDA tensor
(``core.pearson.pearson_matrix``); the cluster mean is
``core.aggregation.cluster_mean_params`` with ``cfg.agg_method``, as in the
reference.  The three products of :func:`embed_fn` are plain large float32
products, which the reference computes outside any Pallas kernel, so they
stay ``torch.matmul``.

Not ported: ``stacked_param_pspecs`` and ``build``, which lay the round
out over a 512-chip GSPMD mesh for ``repro.launch.dryrun``.
:func:`round_cost` keeps the dry-run's analytic terms
(``repro/launch/dryrun.py:55-60``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.aggregation import paa_round
from repro_torch.device import resolve_device

LEAVES = ("w0", "w1", "w2")


@dataclass(frozen=True)
class FLTargetConfig:
    n_clients: int = 64
    in_dim: int = 1024
    hidden: int = 8192
    rep_dim: int = 1024
    psi: int = 64            # probe batch size (paper's psi)
    n_clusters: int = 8
    agg_method: str = "mix"  # "mix" (baseline) | "two_step"
    # ~ in*h + h*h + h*rep ~ 84M params per client at the defaults


def _leaf_dims(cfg: FLTargetConfig) -> dict[str, tuple[int, int]]:
    return {"w0": (cfg.in_dim, cfg.hidden), "w1": (cfg.hidden, cfg.hidden),
            "w2": (cfg.hidden, cfg.rep_dim)}


def init_client_params(cfg: FLTargetConfig, generator: torch.Generator,
                       device=None) -> dict:
    """One client's tower: each (a, b) leaf ``normal * (1 / a) ** 0.5`` in
    float32, drawn from ``generator`` (which lies on ``device``; ``None``
    means the card)."""
    device = resolve_device(device)
    return {k: torch.randn((a, b), generator=generator, device=device,
                           dtype=torch.float32) * (1 / a) ** 0.5
            for k, (a, b) in _leaf_dims(cfg).items()}


def embed_fn(stacked_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Every client's representation of the probe batch:
    ``x (psi, in_dim)`` -> ``(m, psi, rep_dim)``."""
    h = torch.relu(torch.matmul(x, stacked_params["w0"]))
    h = torch.relu(torch.matmul(h, stacked_params["w1"]))
    return torch.tanh(torch.matmul(h, stacked_params["w2"]))


def stacked_param_shapes(cfg: FLTargetConfig) -> dict[str, torch.Size]:
    """Each stacked leaf's shape, ``(n_clients, a, b)``, without allocating
    (the reference's ``stacked_param_specs``)."""
    return {k: torch.Size((cfg.n_clients, a, b)) for k, (a, b) in _leaf_dims(cfg).items()}


def fl_round_step(cfg: FLTargetConfig, stacked_params: dict, probe: torch.Tensor):
    """One PAA aggregation round on the device the tensors lie on; returns
    (new stacked params, labels, cluster sizes)."""
    res = paa_round(embed_fn, stacked_params, probe, cfg.n_clusters,
                    agg_method=cfg.agg_method)
    return res.new_stacked_params, res.labels, res.cluster_sizes


def round_cost(cfg: FLTargetConfig) -> dict[str, int]:
    """The round's analytic cost: ``n_params`` a client, the prototype
    forward ``fwd = 2 m psi N_p``, the mixing product ``mixmm = 2 m^2 N_p``,
    their sum ``flops_total``, and ``hbm_bytes``, the stacked float32 params
    read once and written once."""
    n_params = cfg.in_dim * cfg.hidden + cfg.hidden ** 2 + cfg.hidden * cfg.rep_dim
    fwd = 2 * cfg.n_clients * cfg.psi * n_params
    mixmm = 2 * cfg.n_clients ** 2 * n_params
    return {"n_params": n_params, "fwd": fwd, "mixmm": mixmm,
            "flops_total": fwd + mixmm, "hbm_bytes": cfg.n_clients * n_params * 4 * 2}
