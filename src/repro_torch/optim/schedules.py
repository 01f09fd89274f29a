"""Learning-rate schedules: pure functions of an int step.

Port of ``repro.optim.schedules``.  Each returns a float32 0-dim tensor
computed in float32 as the jnp code computes it: the step cast to float32,
divisions of float32 tensors by Python ints (exact divisors), and for the
warm-up both branches computed and then one selected, as ``jnp.where``
does.  ``torch.cos`` and ``jnp.cos`` may differ by an ulp.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float):
    eta = torch.tensor(lr, dtype=torch.float32)
    return lambda step: eta


def cosine_decay_schedule(lr: float, decay_steps: int, alpha: float = 0.0):
    pi = torch.tensor(math.pi, dtype=torch.float32)

    def sched(step):
        t = torch.clamp(_step(step) / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(pi * t))
        return lr * ((1 - alpha) * cos + alpha)

    return sched


def warmup_cosine_schedule(lr: float, warmup_steps: int, decay_steps: int,
                           alpha: float = 0.0):
    cos = cosine_decay_schedule(lr, max(decay_steps - warmup_steps, 1), alpha)

    def sched(step):
        step = _step(step)
        warm = lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return sched
