"""Synthetic classification datasets standing in for CIFAR10/CIFAR100/SVHN.

Copy of ``repro.data.synthetic`` (numpy only): Gaussian
mixture-of-prototypes tasks with the paper's class counts (10 / 100 / 10)
and a difficulty knob (``margin``), passed through a fixed random
nonlinearity.  Everything derives from the seed, so the port and the
reference build the same arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticSpec:
    name: str
    num_classes: int
    dim: int
    margin: float         # class-mean separation (difficulty knob, higher=easier)
    noise: float
    n_train: int
    n_test: int


SPECS = {
    "synth10": SyntheticSpec("synth10", 10, 64, 1.0, 1.0, 20000, 4000),
    "synth100": SyntheticSpec("synth100", 100, 64, 0.8, 1.0, 30000, 6000),
    "synthdigits": SyntheticSpec("synthdigits", 10, 64, 1.8, 1.0, 20000, 4000),
}


def make_classification_dataset(spec: SyntheticSpec | str, seed: int = 0):
    """Returns ((x_train, y_train), (x_test, y_test)) as float32/int32 numpy."""
    if isinstance(spec, str):
        spec = SPECS[spec]
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(spec.num_classes, spec.dim)).astype(np.float32)
    means *= spec.margin / np.linalg.norm(means, axis=1, keepdims=True)
    means *= np.sqrt(spec.dim)
    # fixed random feature warp: x -> 0.5*(x + tanh(Wx)) keeps the task
    # non-linear but well-conditioned
    W = rng.normal(size=(spec.dim, spec.dim)).astype(np.float32) / np.sqrt(spec.dim)

    def sample(n):
        y = rng.integers(0, spec.num_classes, size=n).astype(np.int32)
        x = means[y] + spec.noise * rng.normal(size=(n, spec.dim)).astype(np.float32)
        x = 0.5 * (x + np.tanh(x @ W))
        return x.astype(np.float32), y

    return sample(spec.n_train), sample(spec.n_test)
