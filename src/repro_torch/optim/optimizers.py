"""Adam over client-stacked dicts of tensors.

Port of ``repro.optim.optimizers`` (``Optimizer``, ``adam``): the same
functional surface, ``opt.init(params) -> state`` and
``opt.update(params, grads, state) -> (params, state)``.  Every leaf carries
the leading client axis, so one elementwise update steps every client of a
cohort at once (the reference vmaps the same update over that axis).  The
moments are float32; the step count is a plain int shared by the cohort
(every client of a round takes the same number of steps).

Arithmetic follows the reference op for op: both moment updates, then the
bias corrections ``1 - b ** step`` computed in float32, then
``p - lr * (m / bc1) / (sqrt(v / bc2) + eps)``.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_map

Pytree = Any


class Optimizer(NamedTuple):
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree], tuple[Pytree, Pytree]]


def _bias_correction(beta: float, step: int) -> torch.Tensor:
    """``1 - beta ** step`` in float32 (a 0-dim CPU tensor, which PyTorch
    broadcasts onto any device as a scalar)."""
    b = torch.tensor(beta, dtype=torch.float32)
    return 1 - b ** torch.tensor(float(step), dtype=torch.float32)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(params, grads, state):
        step = state["step"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1 = _bias_correction(b1, step)
        bc2 = _bias_correction(b2, step)

        def leaf(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            return p - (lr * upd).to(p.dtype)

        return tree_map(leaf, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
