"""Optimizers over (nested) dicts and lists of tensors.

Port of ``repro.optim.optimizers``: the same functional surface,
``opt.init(params) -> state`` and ``opt.update(params, grads, state) ->
(params, state)``, for ``sgd``, ``momentum``, ``adam`` and ``adamw``, and
``clip_by_global_norm``.  Every walk visits dict keys in sorted order, the
order ``jax.tree`` visits them.  Moments are float32; the step count is a
plain int (for the FL layer's client-stacked leaves it is shared by the
cohort: every client of a round takes the same number of steps).

``lr`` is a float or a schedule (``repro_torch.optim.schedules``), called
with the step before the increment.  A float becomes a float32 0-dim tensor
once, as ``jnp.asarray(lr, float32)`` rounds it; every update multiplies by
that tensor.  Arithmetic follows the reference op for op: Adam's two moment
updates, then the bias corrections ``1 - b ** step`` in float32, then
``p - (eta * ((m / bc1) / (sqrt(v / bc2) + eps) [+ wd * p])).to(p.dtype)``.
Nothing divides a Python float by a tensor (PyTorch computes that as a
reciprocal and a multiply: two roundings where JAX divides once).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

Pytree = Any
Schedule = Callable[[int], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree], tuple[Pytree, Pytree]]


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    eta = torch.tensor(lr, dtype=torch.float32)
    return lambda step: eta


def _f32(x: float) -> torch.Tensor:
    """A float32 0-dim CPU tensor, which PyTorch broadcasts onto any
    device as a scalar."""
    return torch.tensor(x, dtype=torch.float32)


def _bias_correction(beta: float, step: int) -> torch.Tensor:
    """``1 - beta ** step`` in float32."""
    return 1 - _f32(beta) ** _f32(float(step))


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def clip_by_global_norm(grads: Pytree, max_norm: float) -> Pytree:
    """Scale every leaf by ``min(1, max_norm / max(|g|, 1e-12))``, |g| the
    float32 norm over all leaves, summed leaf by leaf in the reference's
    leaf order (a Python sum, as the reference's)."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.minimum(_f32(1.0).to(gnorm.device),
                          _f32(max_norm).to(gnorm.device)
                          / torch.maximum(gnorm, _f32(1e-12).to(gnorm.device)))
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0}

    def update(params, grads, state):
        step = state["step"]
        eta = sched(step)
        new = tree_map(lambda p, g: p - eta.to(p.dtype) * g.to(p.dtype), params, grads)
        return new, {"step": step + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0, "mu": tree_map(_zeros_f32, params)}

    def update(params, grads, state):
        step, mu = state["step"], state["mu"]
        eta = sched(step)
        mu = tree_map(lambda m, g: beta * m + g.float(), mu, grads)
        d = tree_map(lambda m, g: beta * m + g.float(), mu, grads) if nesterov else mu
        new = tree_map(lambda p, di: p - (eta * di).to(p.dtype), params, d)
        return new, {"step": step + 1, "mu": mu}

    return Optimizer(init, update)


def _adam_core(lr, b1: float, b2: float, eps: float, weight_decay: float) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0, "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    def update(params, grads, state):
        step = state["step"] + 1
        eta = sched(step - 1)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1 = _bias_correction(b1, step)
        bc2 = _bias_correction(b2, step)

        def leaf(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return p - (eta * upd).to(p.dtype)

        return tree_map(leaf, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay)
