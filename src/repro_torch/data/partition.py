"""Non-IID client partitioning (the paper's 'data label bias' protocol).

Copy of ``repro.data.partition`` (numpy only): ``dirichlet_partition``
draws each class's per-client share from Dir(beta), ``pack_clients``
rectangularises the ragged shards to ``n_batches x batch_size`` examples
plus a local test split, ``sample_probe_batch`` draws PAA's probe batch.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, beta: float,
                        seed: int = 0, min_per_client: int = 2) -> list[np.ndarray]:
    """Returns one index array per client. Every sample is assigned exactly once."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for k in range(n_classes):
        idx = np.flatnonzero(labels == k)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, beta))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            client_idx[cid].extend(part.tolist())
    # guarantee a minimum number of samples per client (steal from the largest)
    sizes = [len(c) for c in client_idx]
    for cid in range(n_clients):
        while len(client_idx[cid]) < min_per_client:
            donor = int(np.argmax([len(c) for c in client_idx]))
            client_idx[cid].append(client_idx[donor].pop())
    return [np.asarray(sorted(c), dtype=np.int64) for c in client_idx]


def pack_clients(
    x: np.ndarray,
    y: np.ndarray,
    parts: list[np.ndarray],
    n_batches: int,
    batch_size: int,
    test_frac: float = 0.2,
    seed: int = 0,
):
    """Rectangularise ragged client shards.

    Returns ``(cx, cy, tx, ty)`` with shapes
    cx (m, n_batches, B, ...), cy (m, n_batches, B),
    tx (m, n_test, ...), ty (m, n_test) — per-client local test split.
    """
    rng = np.random.default_rng(seed)
    m = len(parts)
    need_train = n_batches * batch_size
    n_test = max(int(need_train * test_frac), 8)

    cx = np.zeros((m, need_train) + x.shape[1:], x.dtype)
    cy = np.zeros((m, need_train), y.dtype)
    tx = np.zeros((m, n_test) + x.shape[1:], x.dtype)
    ty = np.zeros((m, n_test), y.dtype)

    for cid, idx in enumerate(parts):
        idx = idx.copy()
        rng.shuffle(idx)
        split = max(int(len(idx) * (1 - test_frac)), 1)
        tr, te = idx[:split], idx[split:] if len(idx) > split else idx[:1]
        tr_sel = rng.choice(tr, size=need_train, replace=len(tr) < need_train)
        te_sel = rng.choice(te, size=n_test, replace=len(te) < n_test)
        cx[cid], cy[cid] = x[tr_sel], y[tr_sel]
        tx[cid], ty[cid] = x[te_sel], y[te_sel]

    cx = cx.reshape(m, n_batches, batch_size, *x.shape[1:])
    cy = cy.reshape(m, n_batches, batch_size)
    return cx, cy, tx, ty


def sample_probe_batch(x: np.ndarray, y: np.ndarray, category: int,
                       psi: int, seed: int = 0) -> np.ndarray:
    """The aggregation client's probe: ψ samples of one category (paper §IV-B)."""
    rng = np.random.default_rng(seed)
    idx = np.flatnonzero(y == category)
    sel = rng.choice(idx, size=psi, replace=len(idx) < psi)
    return x[sel]
