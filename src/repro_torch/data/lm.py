"""Synthetic token streams for language-model examples.

Port of ``repro.data.lm`` (numpy only, copied as it is).

A first-order Markov chain with Zipf-distributed stationary mass gives a
non-trivial next-token structure (learnable; loss drops measurably within a
few hundred steps) without any external corpus.
"""
from __future__ import annotations

import numpy as np


def make_token_stream(vocab_size: int, n_tokens: int, seed: int = 0,
                      branching: int = 8) -> np.ndarray:
    """Each token deterministically restricts its successors to ``branching``
    candidates (hash-derived), sampled Zipf-weighted -> learnable bigram task."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, branching + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    # successor table: vocab_size x branching, derived from a hashed congruence
    base = (np.arange(vocab_size, dtype=np.int64)[:, None] * 2654435761
            + np.arange(branching, dtype=np.int64)[None, :] * 40503)
    succ = np.abs(base) % vocab_size

    out = np.empty(n_tokens, dtype=np.int32)
    tok = int(rng.integers(vocab_size))
    choices = rng.choice(branching, size=n_tokens, p=probs)
    for i in range(n_tokens):
        out[i] = tok
        tok = int(succ[tok, choices[i]])
    return out


def batch_stream(tokens: np.ndarray, batch: int, seq_len: int, n_steps: int,
                 seed: int = 0):
    """Yield (tokens, labels) batches of shape (batch, seq_len)."""
    rng = np.random.default_rng(seed)
    max_start = len(tokens) - seq_len - 1
    for _ in range(n_steps):
        starts = rng.integers(0, max_start, size=batch)
        x = np.stack([tokens[s:s + seq_len] for s in starts])
        y = np.stack([tokens[s + 1:s + seq_len + 1] for s in starts])
        yield x, y
