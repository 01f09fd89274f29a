"""Federated strategies as the round engine consumes them: BFLN.

Port of the BFLN part of ``repro.core.baselines`` (``ModelBundle``,
``Strategy``, ``CohortAggOut``, ``compose_cohort``, ``make_bfln``).  A
:class:`Strategy` is a bundle of plain functions over client-stacked dicts
of tensors:

    local_loss(stacked_params, x, y) -> (m,)           # each client's loss
    aggregate_cohort(stacked_params, rows, cx, cy, arrived_w, obs) -> CohortAggOut

``aggregate_cohort`` is composed, as in the reference, from a per-slot
partial stage (BFLN: prototypes) and a combine stage (BFLN: Pearson,
spectral clustering, cluster means) by :func:`compose_cohort`.  It gets
the trained models twice: as the stacked dict (for the forward passes)
and as the engine's flat (k, N) arena rows, which the cluster means run
on directly and return — one kernel call, no re-flattening.  ``obs`` is
the engine's recorder; each stage is one span (``step.prototypes``,
``step.pearson``, ``step.embedding``, ``step.kmeans``,
``step.cluster_mean``).

``arrived_w`` is the (k,) 0/1 float arrival mask: slots that missed the
round keep their slot but carry zero aggregation weight.  The four Table II
baselines, and the per-client server payloads (``round_extras``) they
need, come with a later slice (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.pearson import pearson_affinity, pearson_matrix
from repro_torch.core.prototypes import client_prototypes
from repro_torch.core.spectral import kmeans, spectral_embedding
from repro_torch.kernels.cluster_agg import cluster_mean_rows
from repro_torch.obs import NULL_RECORDER

Pytree = Any


class ModelBundle(NamedTuple):
    """The model as the FL layer sees it: stacked params and a batch
    ``(m, B, ...)`` (or one shared ``(B, ...)``) -> ``(m, B, ...)``."""
    apply_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]   # -> logits
    embed_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]   # -> representations
    num_classes: int


class CohortAggOut(NamedTuple):
    """Engine-facing aggregation output (all fixed-shape)."""
    rows: torch.Tensor           # (k, N) per-slot aggregated arena rows
    labels: torch.Tensor         # (k,) cluster assignment
    corr: torch.Tensor           # (k, k) affinity for CACC


class Strategy(NamedTuple):
    name: str
    local_loss: Callable[[Pytree, torch.Tensor, torch.Tensor], torch.Tensor]
    aggregate_cohort: Callable[..., CohortAggOut]


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch axis (the last axis of ``y``):
    ``(m, B, C)``, ``(m, B)`` -> ``(m,)`` (a scalar for one client)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, y[..., None].long(), dim=-1)[..., 0].mean(dim=-1)


def compose_cohort(partial_fn: Callable, combine_fn: Callable) -> Callable:
    """The one-shot ``aggregate_cohort`` from the two stages."""

    def aggregate_cohort(stacked_params, rows, cx, cy, arrived_w,
                         obs=NULL_RECORDER):
        part = partial_fn(stacked_params, cx, cy, arrived_w, obs)
        return combine_fn(rows, part, arrived_w, obs)

    return aggregate_cohort


def make_bfln(model: ModelBundle, probe_x: torch.Tensor, n_clusters: int,
              kmeans_iters: int = 25) -> Strategy:
    """BFLN (this paper): plain cross-entropy locally; PAA clustered
    aggregation on the server, with the probe batch of psi same-category
    samples (§IV-B)."""

    def local_loss(stacked_params, x, y):
        return _xent(model.apply_fn(stacked_params, x), y)

    def cohort_partial(stacked_params, cx, cy, arrived_w, obs):
        # per-slot prototypes (k, D): the only cross-slot input of the combine
        with obs.span("step.prototypes"):
            return client_prototypes(model.embed_fn, stacked_params, probe_x)

    def cohort_combine(rows, protos, arrived_w, obs):
        # PAA with the arrival mask as aggregation weights: Pearson kernel ->
        # spectral clustering -> cluster-aggregation kernel on the flat rows
        with obs.span("step.pearson"):
            corr = pearson_matrix(protos)
        with obs.span("step.embedding"):
            emb = spectral_embedding(pearson_affinity(corr), n_clusters)
        with obs.span("step.kmeans"):
            labels, _ = kmeans(emb, n_clusters, kmeans_iters)
        with obs.span("step.cluster_mean"):
            new_rows = cluster_mean_rows(rows, labels, n_clusters, arrived_w)
        return CohortAggOut(new_rows, labels, corr)

    return Strategy("bfln", local_loss,
                    compose_cohort(cohort_partial, cohort_combine))
