"""Small classifier used for the paper's FL experiments (CIFAR-scale stand-in).

Port of ``repro.models.classifier``: plain functions over a dict of tensors.
``embed`` returns the penultimate representation (the vector PAA prototypes
are built from); ``apply`` adds the decision head.

Serving (``embed`` / ``apply`` / ``*_stacked``): every product goes through
:func:`matmul_fixed_order`: elementwise products summed over the
contraction axis in one fixed pairwise tree.  A row's output bits then
depend on that row and its model alone — not on the batch size, the number
of stacked models, or which kernel a GEMM library would pick for the shape.
So the fused multi-model serving forward equals routing each request alone
through :func:`apply`, bit for bit, on the CPU and on the card
(``torch.matmul`` on the CPU sums a single row in another order than a
batch, and cuBLAS picks kernels by shape).  The reference leaves its
products to XLA; both agree to float32 rounding.

Training, prototypes and evaluation (``*_batched``) take the batched
product ``kernels.ops.batched_matmul`` instead (the fixed tree would
materialise an (m, B, i, j) product: 1.6 GB for a 100-client cohort's eval
batch).  They need batch invariance too: a cohort sharded over S devices
trains each client in a call of k / S clients and must replay the
one-device run bit for bit.  On the card every product, forward and
backward, goes through the hand-written kernel, which sums each element
over the contraction axis in one fixed order whatever the batch count
(cuBLAS picks its kernel by it); on the CPU ``torch.matmul`` is
batch-invariant already and stays.  The reference leaves these products to
XLA outside any Pallas kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import batched_matmul

Pytree = Any


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 64
    hidden: tuple[int, ...] = (128, 128)
    rep_dim: int = 64         # representation (prototype) dimension
    num_classes: int = 10


def param_shapes(cfg: MLPConfig) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter of one model."""
    dims = (cfg.in_dim, *cfg.hidden, cfg.rep_dim)
    shapes = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"w{i}"] = (a, b)
        shapes[f"b{i}"] = (b,)
    shapes["w_head"] = (cfg.rep_dim, cfg.num_classes)
    shapes["b_head"] = (cfg.num_classes,)
    return shapes


def init_mlp(cfg: MLPConfig, generator: torch.Generator, device=None
             ) -> dict[str, torch.Tensor]:
    """He-scaled normal weights, zero biases, drawn from ``generator`` (a
    CPU generator, so the values do not depend on the device)."""
    device = resolve_device(device)
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name.startswith("b"):
            params[name] = torch.zeros(shape, dtype=torch.float32)
        else:
            scale = (1.0 if name == "w_head" else 2.0) / shape[0]
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=torch.float32) * scale ** 0.5
    return {k: v.to(device) for k, v in params.items()}


def matmul_fixed_order(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h (..., B, i) @ w (..., i, j) -> (..., B, j)`` with broadcasting
    leading axes, each output summed over ``i`` in a fixed pairwise tree
    (an odd level is padded with +0.0, which adds nothing)."""
    p = h.unsqueeze(-1) * w.unsqueeze(-3)                  # (..., B, i, j)
    while p.shape[-2] > 1:
        if p.shape[-2] % 2:
            p = torch.cat([p, torch.zeros_like(p[..., :1, :])], dim=-2)
        p = p[..., 0::2, :] + p[..., 1::2, :]
    return p[..., 0, :]


def embed(cfg: MLPConfig, params: Pytree, x: torch.Tensor) -> torch.Tensor:
    """Representation layer: (B, in_dim) -> (B, rep_dim)."""
    h = x
    n_hidden = len(cfg.hidden) + 1
    for i in range(n_hidden):
        h = matmul_fixed_order(h, params[f"w{i}"]) + params[f"b{i}"]
        if i < n_hidden - 1:
            h = torch.relu(h)
    return torch.tanh(h)   # bounded reps keep Pearson well-conditioned


def apply(cfg: MLPConfig, params: Pytree, x: torch.Tensor) -> torch.Tensor:
    """Full model: (B, in_dim) -> (B, num_classes) logits."""
    return (matmul_fixed_order(embed(cfg, params, x), params["w_head"])
            + params["b_head"])


def embed_stacked(cfg: MLPConfig, stacked_params: Pytree, x: torch.Tensor
                  ) -> torch.Tensor:
    """All m models' representations on ONE shared batch:
    (B, in_dim) -> (m, B, rep_dim).  Row for row the same bits as
    :func:`embed` with that model's params."""
    h = x
    n_hidden = len(cfg.hidden) + 1
    for i in range(n_hidden):
        h = matmul_fixed_order(h, stacked_params[f"w{i}"])     # (m, B, d)
        h = h + stacked_params[f"b{i}"][:, None, :]
        if i < n_hidden - 1:
            h = torch.relu(h)
    return torch.tanh(h)


def apply_stacked(cfg: MLPConfig, stacked_params: Pytree, x: torch.Tensor
                  ) -> torch.Tensor:
    """All models' logits on one shared batch: (m, B, num_classes)."""
    reps = embed_stacked(cfg, stacked_params, x)
    logits = matmul_fixed_order(reps, stacked_params["w_head"])
    return logits + stacked_params["b_head"][:, None, :]


def embed_batched(cfg: MLPConfig, stacked_params: Pytree, x: torch.Tensor
                  ) -> torch.Tensor:
    """Training-side representations of m stacked models by
    :func:`~repro_torch.kernels.ops.batched_matmul`: ``x`` is each model's
    own batch ``(m, B, in_dim)`` or one batch shared by all ``(B, in_dim)``;
    returns ``(m, B, rep_dim)``.

    Batch-invariant on both devices: a model's rows have the same bits
    whatever ``m`` (on the card through the fixed-order kernel, forward and
    backward).  Differentiable, so autograd gives every stacked model its
    own gradient.
    """
    h = x
    n_hidden = len(cfg.hidden) + 1
    for i in range(n_hidden):
        h = batched_matmul(h, stacked_params[f"w{i}"])
        h = h + stacked_params[f"b{i}"][:, None, :]
        if i < n_hidden - 1:
            h = torch.relu(h)
    return torch.tanh(h)


def apply_batched(cfg: MLPConfig, stacked_params: Pytree, x: torch.Tensor
                  ) -> torch.Tensor:
    """Training-side logits of m stacked models: ``(m, B, num_classes)``
    (``x`` as in :func:`embed_batched`)."""
    reps = embed_batched(cfg, stacked_params, x)
    logits = batched_matmul(reps, stacked_params["w_head"])
    return logits + stacked_params["b_head"][:, None, :]


def init_stacked(cfg: MLPConfig, generator: torch.Generator, n_clients: int,
                 same_init: bool = True, device=None) -> dict[str, torch.Tensor]:
    """Stacked client params.  FL convention: all clients start from the same
    initialisation (``same_init=True``, as in FedAvg)."""
    device = resolve_device(device)
    if same_init:
        p = init_mlp(cfg, generator, device)
        return {k: v[None].expand((n_clients,) + v.shape).clone()
                for k, v in p.items()}
    models = [init_mlp(cfg, generator, device) for _ in range(n_clients)]
    return {k: torch.stack([p[k] for p in models]) for k in models[0]}
