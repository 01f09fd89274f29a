"""Federated strategies: the paper's four Table II baselines and BFLN.

Port of ``repro.core.baselines``.  A :class:`Strategy` is a bundle of plain
functions over client-stacked dicts of tensors:

    round_extras(stacked_params, cx, cy) -> extras     # what the server ships
    local_loss(stacked_params, x, y, extras) -> (m,)   # each client's loss
    aggregate(stacked_params, cx, cy, obs) -> AggOut   # full participation
    aggregate_cohort(stacked_params, rows, cx, cy, arrived_w, obs) -> CohortAggOut
    cohort_partial(stacked_params, cx, cy, arrived_w, obs) -> partial
    cohort_combine(rows, partial, arrived_w, k, obs) -> CohortAggOut

``extras`` carries the client axis unless ``shared_extras`` (FedProx's
anchor, one payload for every client; ``repro_torch.core.fl``).

``aggregate_cohort`` is the round engine's stage, composed as in the
reference from a per-slot partial stage (BFLN: prototypes) and a combine
stage by :func:`compose_cohort`.  The combine takes the count ``k`` of
real slots among its ``m >= k`` rows: the sharded engine pads the cohort
to a multiple of its shards, and the padding slots (zero arrival weight)
must reach neither Pearson nor k-means, nor the outputs, which are sliced
to ``k``.  It gets the trained models twice: as the
stacked dict (for the forward passes) and as the engine's flat (k, N) arena
rows, which the means run on directly and return.  ``arrived_w`` is the
(k,) 0/1 float arrival mask: slots that missed the round keep their slot
but carry zero aggregation weight.  Every strategy also returns the (k,)
cluster labels and (k, k) affinity for the chain's CACC consensus; the flat
strategies report the single-cluster view (zeros, identity).  ``obs`` is
the engine's recorder; each stage that does work is one span
(``step.prototypes``, ``step.pearson``, ``step.embedding``,
``step.kmeans``, ``step.cluster_mean``).

``aggregate`` (the full-participation trainer's, ``core.round``) is
``aggregate_cohort`` with an all-ones mask over the flattened params.  It
therefore sums in the engine's fixed tree order, where the reference's
``aggregate`` takes ``jnp.mean`` (flat strategies) or ``paa_round``'s
two-step ``tensordot`` (BFLN): the port's ``run_round`` params agree with
the reference's within float tolerance, not in every bit.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.pearson import pearson_affinity, pearson_matrix
from repro_torch.core.prototypes import classwise_prototypes, client_prototypes
from repro_torch.core.spectral import kmeans, spectral_embedding
from repro_torch.kernels.cluster_agg import cluster_mean_rows
from repro_torch.obs import NULL_RECORDER
from repro_torch.runtime.arena import ArenaLayout
from repro_torch.utils.tree import tree_map, tree_sq_norm, tree_sub

Pytree = Any


class ModelBundle(NamedTuple):
    """The model as the FL layer sees it: stacked params and a batch
    ``(m, B, ...)`` (or one shared ``(B, ...)``) -> ``(m, B, ...)``."""
    apply_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]   # -> logits
    embed_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]   # -> representations
    num_classes: int


class AggOut(NamedTuple):
    """Full-participation aggregation output (``FederatedTrainer``)."""
    stacked_params: Pytree
    labels: torch.Tensor | None = None          # cluster assignment (BFLN only)
    cluster_sizes: torch.Tensor | None = None   # (C,) (BFLN only)
    corr: torch.Tensor | None = None            # Pearson matrix (BFLN only)


class CohortAggOut(NamedTuple):
    """Engine-facing aggregation output (all fixed-shape)."""
    rows: torch.Tensor           # (k, N) per-slot aggregated arena rows
    labels: torch.Tensor         # (k,) cluster assignment (zeros if unclustered)
    corr: torch.Tensor           # (k, k) affinity for CACC (eye if unclustered)


class Strategy(NamedTuple):
    name: str
    round_extras: Callable[[Pytree, torch.Tensor, torch.Tensor], Any]
    local_loss: Callable[[Pytree, torch.Tensor, torch.Tensor, Any], torch.Tensor]
    aggregate: Callable[..., AggOut]
    aggregate_cohort: Callable[..., CohortAggOut] | None = None
    # True: round_extras returns ONE payload shared by every client (no
    # client axis); it broadcasts against the stacked params in the loss
    shared_extras: bool = False
    cohort_partial: Callable[..., Any] | None = None
    cohort_combine: Callable[..., CohortAggOut] | None = None


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch axis (the last axis of ``y``):
    ``(m, B, C)``, ``(m, B)`` -> ``(m,)`` (a scalar for one client)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, y[..., None].long(), dim=-1)[..., 0].mean(dim=-1)


def _flatten_batches(cx: torch.Tensor, cy: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, nb, B, ...) -> (m, nb*B, ...)."""
    m = cx.shape[0]
    return cx.reshape(m, -1, *cx.shape[3:]), cy.reshape(m, -1)


def _count_weighted_sum(values: torch.Tensor, counts: torch.Tensor
                        ) -> torch.Tensor:
    """Per-class payload (m, K, ...) averaged over the cohort, each client
    weighted by its share of the class, ``counts / max(sum_m counts, 1)``
    -> (K, ...)."""
    w = counts / torch.clamp(counts.sum(dim=0, keepdim=True), min=1.0)
    w = w.reshape(w.shape + (1,) * (values.dim() - 2))
    return (values * w).sum(dim=0)


def compose_cohort(partial_fn: Callable, combine_fn: Callable) -> Callable:
    """The one-shot ``aggregate_cohort`` from the two stages."""

    def aggregate_cohort(stacked_params, rows, cx, cy, arrived_w,
                         obs=NULL_RECORDER):
        part = partial_fn(stacked_params, cx, cy, arrived_w, obs)
        return combine_fn(rows, part, arrived_w, rows.shape[0], obs)

    return aggregate_cohort


def aggregate_all(aggregate_cohort: Callable, n_clusters: int | None = None
                  ) -> Callable:
    """The full-participation ``aggregate``: ``aggregate_cohort`` over the
    flattened params with every slot arrived.  With ``n_clusters`` (BFLN)
    the output carries the labels, the cluster sizes and the affinity."""

    def aggregate(stacked_params, cx, cy, obs=NULL_RECORDER) -> AggOut:
        layout = ArenaLayout.from_stacked(stacked_params)
        rows = layout.flatten(stacked_params)
        ones = torch.ones(rows.shape[0], dtype=torch.float32, device=rows.device)
        out = aggregate_cohort(stacked_params, rows, cx, cy, ones, obs)
        params = layout.unflatten(out.rows)
        if n_clusters is None:
            return AggOut(params)
        sizes = torch.bincount(out.labels, minlength=n_clusters)
        return AggOut(params, out.labels, sizes, out.corr)

    return aggregate


def _no_extras(stacked_params, cx, cy):
    return torch.zeros(cx.shape[0], dtype=torch.float32, device=cx.device)


def _no_partial(stacked_params, cx, cy, arrived_w, obs):
    """The partial stage of strategies whose combine needs only the trained
    rows (the flat strategies)."""
    return None


def _single_cluster_view(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """CACC inputs for unclustered strategies over ``k`` slots: one
    cluster, identity affinity."""
    return (torch.zeros(k, dtype=torch.long, device=device),
            torch.eye(k, dtype=torch.float32, device=device))


def _real(x: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` (real) slots of ``x``; ``x`` itself when it has no
    padding slots."""
    return x if x.shape[0] == k else x[:k]


def masked_mean_rows(rows: torch.Tensor, arrived_w: torch.Tensor) -> torch.Tensor:
    """FedAvg under partial participation: the arrival-weighted mean of the
    (k, N) rows, given to every slot — one ``cluster_mean_rows`` call with
    one cluster and every label 0 (one launch of ``csrc/cluster_agg.cu`` on
    a CUDA tensor, the plain version on a CPU tensor).

    This is the reference's ``_tree_masked_mean`` bit for bit.  Its
    numerator is the where-guarded tree ``masked_tree_sum(x, w)``; the
    kernel's, with every label 0, is the tree of ``where(w·1 > 0, w·1·x,
    +0.0)``, the same tree of the same terms (``w·1`` is ``w``).  Its
    denominator is ``max(tree_sum(w), 1.0)``, the kernel's
    ``max(tree_sum(w·1), 1e-9)``: equal whenever a slot arrived (the sum is
    then at least 1), and the driver never calls the step on an empty
    round."""
    labels = torch.zeros(rows.shape[0], dtype=torch.long, device=rows.device)
    return cluster_mean_rows(rows, labels, 1, arrived_w)


def _mean_combine(rows, partial, arrived_w, k, obs=NULL_RECORDER):
    # the masked mean over all m slots (padding slots weigh 0 and add
    # exactly +0.0), given to the k real ones
    with obs.span("step.cluster_mean"):
        new_rows = _real(masked_mean_rows(rows, arrived_w), k)
        if obs.enabled:
            obs.ready(new_rows)
    return CohortAggOut(new_rows, *_single_cluster_view(k, rows.device))


def _flat_strategy(name: str, round_extras: Callable, local_loss: Callable,
                   combine: Callable, shared_extras: bool = False) -> Strategy:
    aggregate_cohort = compose_cohort(_no_partial, combine)
    return Strategy(name, round_extras, local_loss, aggregate_all(aggregate_cohort),
                    aggregate_cohort, shared_extras=shared_extras,
                    cohort_partial=_no_partial, cohort_combine=combine)


# --------------------------------------------------------------------------- #
# FedAvg (McMahan et al., 2017)
# --------------------------------------------------------------------------- #

def make_fedavg(model: ModelBundle) -> Strategy:
    def local_loss(stacked_params, x, y, extras):
        return _xent(model.apply_fn(stacked_params, x), y)

    return _flat_strategy("fedavg", _no_extras, local_loss, _mean_combine)


# --------------------------------------------------------------------------- #
# FedProx (Li et al., 2018): CE + (mu/2)‖w − w_global‖²
# --------------------------------------------------------------------------- #

def make_fedprox(model: ModelBundle, mu: float = 0.01) -> Strategy:
    def round_extras(stacked_params, cx, cy):
        # ONE anchor for every client: the cohort mean over all k gathered
        # slots before training, arrived or not, detached
        with torch.no_grad():
            return tree_map(lambda x: x.mean(dim=0), stacked_params)

    def local_loss(stacked_params, x, y, anchor):
        ce = _xent(model.apply_fn(stacked_params, x), y)
        return ce + 0.5 * mu * tree_sq_norm(tree_sub(stacked_params, anchor))

    return _flat_strategy("fedprox", round_extras, local_loss, _mean_combine,
                          shared_extras=True)


# --------------------------------------------------------------------------- #
# FedProto (Tan et al., 2022): only class prototypes are shared; models stay
# personal.  Local objective: CE + lambda ‖proto_c(batch) − global_proto_c‖².
# --------------------------------------------------------------------------- #

def make_fedproto(model: ModelBundle, lam: float = 1.0) -> Strategy:
    K = model.num_classes

    def round_extras(stacked_params, cx, cy):
        with torch.no_grad():
            protos, counts = classwise_prototypes(
                model.embed_fn, stacked_params, *_flatten_batches(cx, cy), K)
            global_protos = _count_weighted_sum(protos, counts)       # (K, R)
        return global_protos.expand((cx.shape[0],) + global_protos.shape)

    def local_loss(stacked_params, x, y, global_protos):
        ce = _xent(model.apply_fn(stacked_params, x), y)
        # the batch's own class prototypes, inside the autograd graph
        protos, counts = classwise_prototypes(model.embed_fn, stacked_params,
                                              x, y, K)
        mask = (counts > 0).float()                                   # (m, K)
        d = (protos - global_protos).square().sum(dim=-1)             # (m, K)
        align = (d * mask).sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1.0)
        return ce + lam * align

    def combine(rows, partial, arrived_w, k, obs=NULL_RECORDER):
        # personal models: every slot keeps its freshly trained row (the
        # engine's scatter mask drops the rows that did not arrive)
        return CohortAggOut(_real(rows, k), *_single_cluster_view(k, rows.device))

    return _flat_strategy("fedproto", round_extras, local_loss, combine)


# --------------------------------------------------------------------------- #
# FedHKD (Chen & Vikalo, 2023): clients ship per-class mean representations
# AND mean soft predictions; the server aggregates both and clients distil
# against them.  Built on FedAvg model averaging.
# --------------------------------------------------------------------------- #

def make_fedhkd(model: ModelBundle, lam_rep: float = 0.05,
                lam_soft: float = 0.05, temp: float = 2.0) -> Strategy:
    K = model.num_classes

    def round_extras(stacked_params, cx, cy):
        fx, fy = _flatten_batches(cx, cy)
        with torch.no_grad():
            protos, counts = classwise_prototypes(model.embed_fn, stacked_params,
                                                  fx, fy, K)
            soft = F.softmax(model.apply_fn(stacked_params, fx) / temp, dim=-1)
            onehot = F.one_hot(fy.long(), K).to(soft.dtype)           # (m, B, K)
            # once on the lead over the k real slots (round_extras is never
            # sharded), so a batch-dependent cuBLAS kernel moves no replay
            soft_per_class = torch.matmul(onehot.transpose(1, 2), soft) \
                / torch.clamp(counts, min=1.0)[..., None]             # (m, K, K)
            H = _count_weighted_sum(protos, counts)                   # (K, R)
            Q = _count_weighted_sum(soft_per_class, counts)           # (K, K)
        m = cx.shape[0]
        return H.expand((m,) + H.shape), Q.expand((m,) + Q.shape)

    def local_loss(stacked_params, x, y, extras):
        H, Q = extras                                 # (m, K, R), (m, K, K)
        logits = model.apply_fn(stacked_params, x)
        ce = _xent(logits, y)
        reps = model.embed_fn(stacked_params, x)                      # (m, B, R)
        # H[y] and Q[y] gathered from each client's own payload
        idx = y.long()[..., None]                                     # (m, B, 1)
        rep_loss = (reps - torch.take_along_dim(H, idx, dim=1)).square() \
            .sum(dim=-1).mean(dim=-1)
        logp = F.log_softmax(logits / temp, dim=-1)
        q = torch.clamp(torch.take_along_dim(Q, idx, dim=1), min=1e-8)
        kd = (q * (torch.log(q) - logp)).sum(dim=-1).mean(dim=-1)
        return ce + lam_rep * rep_loss + lam_soft * kd

    return _flat_strategy("fedhkd", round_extras, local_loss, _mean_combine)


# --------------------------------------------------------------------------- #
# BFLN (this paper): plain CE locally; PAA clustered aggregation server-side.
# --------------------------------------------------------------------------- #

def make_bfln(model: ModelBundle, probe_x: torch.Tensor, n_clusters: int,
              kmeans_iters: int = 25) -> Strategy:
    """BFLN (this paper): plain cross-entropy locally; PAA clustered
    aggregation on the server, with the probe batch of psi same-category
    samples (§IV-B)."""

    def local_loss(stacked_params, x, y, extras):
        return _xent(model.apply_fn(stacked_params, x), y)

    def cohort_partial(stacked_params, cx, cy, arrived_w, obs):
        # per-slot prototypes (k, D): the only cross-slot input of the combine
        with obs.span("step.prototypes"):
            # on a mesh each shard's params lie on their own device
            probe = probe_x.to(cx.device)
            protos = client_prototypes(model.embed_fn, stacked_params, probe)
            if obs.enabled:
                obs.ready(protos)
            return protos

    def cohort_combine(rows, protos, arrived_w, k, obs=NULL_RECORDER):
        # PAA with the arrival mask as aggregation weights: Pearson kernel ->
        # spectral clustering on the k REAL slots -> cluster-aggregation
        # kernel over all m >= k rows, whose padding slots carry weight 0
        # (and label 0) and so add exactly +0.0; the output sliced to k
        m = rows.shape[0]
        with obs.span("step.pearson"):
            corr = pearson_matrix(_real(protos, k))
            if obs.enabled:
                obs.ready(corr)
        with obs.span("step.embedding"):
            emb = spectral_embedding(pearson_affinity(corr), n_clusters)
            if obs.enabled:
                obs.ready(emb)
        with obs.span("step.kmeans"):
            labels, _ = kmeans(emb, n_clusters, kmeans_iters)
            if obs.enabled:
                obs.ready(labels)
        with obs.span("step.cluster_mean"):
            labels_m = labels if m == k else torch.cat(
                [labels, labels.new_zeros(m - k)])
            new_rows = _real(cluster_mean_rows(rows, labels_m, n_clusters,
                                               arrived_w), k)
            if obs.enabled:
                obs.ready(new_rows)
        return CohortAggOut(new_rows, labels, corr)

    aggregate_cohort = compose_cohort(cohort_partial, cohort_combine)
    return Strategy("bfln", _no_extras, local_loss,
                    aggregate_all(aggregate_cohort, n_clusters), aggregate_cohort,
                    cohort_partial=cohort_partial, cohort_combine=cohort_combine)


STRATEGY_FACTORIES = {
    "fedavg": make_fedavg,
    "fedprox": make_fedprox,
    "fedproto": make_fedproto,
    "fedhkd": make_fedhkd,
}
