"""Federated local training over a client-stacked cohort.

Port of ``repro.core.fl``.  The reference vmaps one client's training over
the cohort and scans its steps; here the client axis is written out: every
parameter leaf is ``(m, ...)``, the data ``x (m, n_batches, B, ...)`` and
``y (m, n_batches, B)``, and the step loop is a Python loop over
``epochs x n_batches``.

The loss function returns each client's own mean loss, ``(m,)``.  The step
differentiates their SUM: client c's loss depends on client c's parameters
only, so the gradient of the sum with respect to client c's leaves is
exactly client c's gradient — one backward pass trains the whole cohort.

``extras`` is the strategy's server payload for the round (FedProx's
anchor, FedProto's / FedHKD's global prototypes).  Per-client extras carry
the client axis and reach the loss as they are; a shared payload
(``shared_extras``) has no client axis and broadcasts against the stacked
params.  Extras are constants of every step: they never require grad.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.optim import Optimizer
from repro_torch.utils.tree import tree_leaves, tree_map

Pytree = Any
# loss_fn(stacked_params, x (m, B, ...), y (m, B), extras) -> (m,) per-client loss
LossFn = Callable[[Pytree, torch.Tensor, torch.Tensor, Any], torch.Tensor]


class LocalTrainResult(NamedTuple):
    params: Pytree             # stacked (m, ...)
    opt_state: Pytree
    mean_loss: torch.Tensor    # (m,)


def local_train(loss_fn: LossFn, opt: Optimizer, stacked_params: Pytree,
                stacked_opt_state: Pytree, x: torch.Tensor, y: torch.Tensor,
                extras: Any, epochs: int, shared_extras: bool = False
                ) -> LocalTrainResult:
    """``epochs`` passes of minibatch training on every client at once;
    returns the trained params (detached), the optimizer state and each
    client's mean loss over its steps.  ``extras`` as in the module
    docstring: with ``shared_extras`` False every leaf must carry the
    client axis."""
    nb, m = x.shape[1], x.shape[0]
    extras = tree_map(torch.Tensor.detach, extras)
    if not shared_extras and any(e.shape[:1] != (m,) for e in tree_leaves(extras)):
        raise ValueError(f"per-client extras need the client axis ({m},)")
    params, opt_state = stacked_params, stacked_opt_state
    losses = []
    for idx in range(epochs * nb):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            per_client = loss_fn(p, x[:, idx % nb], y[:, idx % nb], extras)
            per_client.sum().backward()
        params, opt_state = opt.update(tree_map(torch.Tensor.detach, p),
                                       tree_map(lambda t: t.grad, p),
                                       opt_state)
        losses.append(per_client.detach())
    return LocalTrainResult(params, opt_state, torch.stack(losses).mean(dim=0))


def evaluate(predict_fn: Callable, stacked_params: Pytree, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Per-client accuracy on per-client data: ``x (m, n, ...)``,
    ``y (m, n)`` -> ``(m,)`` (``run_fl``'s personalised accuracy)."""
    logits = predict_fn(stacked_params, x)                  # (m, n, C)
    return (torch.argmax(logits, dim=-1) == y).float().mean(dim=1)


def _accuracies(predict_fn: Callable, stacked_params: Pytree,
                x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(m,) accuracy of every stacked model on ONE shared batch."""
    logits = predict_fn(stacked_params, x)                  # (m, B, C)
    return (torch.argmax(logits, dim=-1) == y[None, :]).float().mean(dim=1)


def masked_global_evaluate(predict_fn: Callable, stacked_params: Pytree,
                           x: torch.Tensor, y: torch.Tensor,
                           mask: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape, arrival-masked mean client accuracy on the shared batch:
    ``(masked mean accuracy, per-client accuracies)``."""
    accs = _accuracies(predict_fn, stacked_params, x, y)
    w = mask.float()
    return (accs * w).sum() / torch.clamp(w.sum(), min=1.0), accs


def global_evaluate(predict_fn: Callable, stacked_params: Pytree,
                    x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean accuracy of each client's personalized model on the *shared*
    test set (the paper's Table II metric is mean client accuracy)."""
    return _accuracies(predict_fn, stacked_params, x, y).mean()
