"""Model bank snapshots: trained population -> K verified cluster models.

Port of ``repro.serve.snapshot``.  BFLN's end product is K
cluster-personalized models.  This module extracts them from a finished
run's parameter arena into a fixed-shape ``(K, n_params)`` **model bank**,
fingerprints every bank row with the Hopper digest kernel, and anchors the
release on the run's own blockchain:

  * :func:`snapshot` — the masked per-cluster mean over client rows
    (cluster-c model = FedAvg of every client whose latest chain-recorded
    assignment is c) and the bank's fingerprint residues, on the device the
    arena lives on (a mesh's lead device);
  * :func:`publish_release` — mints a **release block**: one
    ``model_release`` tx per cluster plus the producer's sender-bound
    ``release_commit``, so each served model carries an O(log K) Merkle
    membership proof;
  * :func:`verify_bank` — the refuse-to-serve gate: recompute every bank
    row's fingerprint from the weights actually loaded and check it against
    the chain's **latest** release.  Tampered weights, a tampered digest, a
    wrong cluster id, a wrong release round and a stale root all raise
    :class:`ProvenanceError`.

Banks round-trip through one ``.npz`` file in the reference's format
(:meth:`ModelBank.save` / :func:`load_bank`), so a bank saved by either
package loads in the other.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from repro_torch.blockchain.chain import Block, Blockchain
from repro_torch.blockchain.commit import (
    MODEL_RELEASE_KIND,
    RELEASE_COMMIT_KIND,
    MerkleProof,
    RoundCommitments,
    verify_membership,
)
from repro_torch.blockchain.txpool import Transaction, TxPool
from repro_torch.device import resolve_device
from repro_torch.kernels.fingerprint import (
    fingerprint_rows,
    format_digest,
    residues_numpy,
    row_digests,
)
from repro_torch.models import classifier as clf
from repro_torch.obs import NULL_RECORDER
from repro_torch.runtime.arena import ArenaLayout, bitcast_u32
from repro_torch.utils.tree import tree_index

Pytree = Any


class ProvenanceError(RuntimeError):
    """A served model's chain provenance failed — refuse to load or serve."""


@dataclass(frozen=True)
class ModelRelease:
    """Per-cluster provenance record: the released digest and its Merkle
    membership proof under the release block's commitment root."""
    cluster_id: int
    digest: str
    proof: MerkleProof


@dataclass(frozen=True)
class ModelBank:
    """K cluster-personalized models as one fixed-shape stacked bank, plus
    the chain provenance that makes them servable."""
    mcfg: clf.MLPConfig
    layout: ArenaLayout
    data: torch.Tensor                    # (K, n_params) float32
    releases: tuple[ModelRelease, ...]    # one per cluster, id order
    root: str                             # release commitments' Merkle root
    round_idx: int                        # release round (past last training round)
    block_hash: str                       # hash of the release block

    @property
    def n_models(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_params(self) -> int:
        return int(self.data.shape[1])

    @property
    def nbytes(self) -> int:
        return self.data.numel() * 4

    def model_pytree(self, cluster_id: int) -> Pytree:
        """Cluster ``cluster_id``'s model as a plain (unstacked) dict."""
        return tree_index(self.layout.unflatten(self.data), cluster_id)

    def digests(self) -> list[str]:
        return [r.digest for r in self.releases]

    def save(self, path: str) -> None:
        """One-file ``.npz``: bank matrix + JSON provenance/arch metadata."""
        meta = {
            "mcfg": {"in_dim": self.mcfg.in_dim,
                     "hidden": list(self.mcfg.hidden),
                     "rep_dim": self.mcfg.rep_dim,
                     "num_classes": self.mcfg.num_classes},
            "releases": [
                {"cluster_id": r.cluster_id, "digest": r.digest,
                 "proof": {"leaf": r.proof.leaf,
                           "path": [[sib, side] for sib, side in r.proof.path]}}
                for r in self.releases],
            "root": self.root,
            "round_idx": self.round_idx,
            "block_hash": self.block_hash,
        }
        with open(path, "wb") as f:
            np.savez(f, data=self.data.cpu().numpy(),
                     meta=np.frombuffer(json.dumps(meta, sort_keys=True)
                                        .encode(), dtype=np.uint8))


def mlp_layout(mcfg: clf.MLPConfig) -> ArenaLayout:
    """The arena layout of one ``mcfg`` model, from its shapes alone."""
    return ArenaLayout.from_stacked(
        {k: torch.empty((1,) + s, device="meta")
         for k, s in clf.param_shapes(mcfg).items()})


def load_bank(path: str, chain: Blockchain | None = None, *, device=None,
              obs=NULL_RECORDER) -> ModelBank:
    """Load a saved bank onto ``device``; with ``chain`` given, refuse (raise
    :class:`ProvenanceError`) unless every model verifies against the
    chain's latest release."""
    device = resolve_device(device)
    with np.load(path) as z:
        data = torch.from_numpy(z["data"]).to(device)
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
    mcfg = clf.MLPConfig(in_dim=int(meta["mcfg"]["in_dim"]),
                         hidden=tuple(meta["mcfg"]["hidden"]),
                         rep_dim=int(meta["mcfg"]["rep_dim"]),
                         num_classes=int(meta["mcfg"]["num_classes"]))
    releases = tuple(
        ModelRelease(int(r["cluster_id"]), str(r["digest"]),
                     MerkleProof(str(r["proof"]["leaf"]),
                                 tuple((str(s), str(side))
                                       for s, side in r["proof"]["path"])))
        for r in meta["releases"])
    bank = ModelBank(mcfg=mcfg, layout=mlp_layout(mcfg), data=data,
                     releases=releases, root=str(meta["root"]),
                     round_idx=int(meta["round_idx"]),
                     block_hash=str(meta["block_hash"]))
    if chain is not None:
        verify_bank(bank, chain, obs=obs)
    return bank


# ---------------------------------------------------------------------- #
# extraction
# ---------------------------------------------------------------------- #

def _extract_bank(rows: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor, n_clusters: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape bank extraction + fingerprinting.

    ``rows`` (n, N) client params, ``labels`` (n,) last cluster assignment
    (-1 = never assigned), ``valid`` (n,) 1.0 for real client rows.  A
    cluster with no assigned clients falls back to the mean over all
    labeled clients, and — when nobody was ever labeled — to the mean over
    all valid rows.  Out-of-range labels match no cluster, so -1 rows never
    contribute.
    """
    # the cluster means are a float32 product; TF32 would keep ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    clusters = torch.arange(n_clusters, device=rows.device)
    onehot = (labels[:, None] == clusters[None, :]).to(rows.dtype)
    onehot = onehot * valid[:, None]
    counts = onehot.sum(dim=0)                              # (K,)
    sums = onehot.T @ rows                                  # (K, N)
    labeled = counts.sum()
    labeled_mean = sums.sum(dim=0) / torch.clamp(labeled, min=1.0)
    global_mean = ((rows * valid[:, None]).sum(dim=0)
                   / torch.clamp(valid.sum(), min=1.0))
    fallback = torch.where(labeled > 0, labeled_mean, global_mean)
    bank = torch.where((counts > 0)[:, None],
                       sums / torch.clamp(counts, min=1.0)[:, None],
                       fallback[None, :])
    return bank, fingerprint_rows(bitcast_u32(bank))


def bank_digests(bank_rows: torch.Tensor, n_params: int) -> list[str]:
    """Recompute per-model digests from the actual bank weights."""
    if bank_rows.shape[1] != n_params:
        raise ValueError(f"bank rows have {bank_rows.shape[1]} params, "
                         f"expected {n_params}")
    return row_digests(bank_rows)


# ---------------------------------------------------------------------- #
# release block
# ---------------------------------------------------------------------- #

def publish_release(chain: Blockchain, pool: TxPool, digests: list[str], *,
                    producer: int | None = None,
                    obs=NULL_RECORDER) -> tuple[Block, RoundCommitments]:
    """Mint the release block: per-cluster ``model_release`` txs plus the
    producer's sender-bound ``release_commit`` (senders = cluster ids).

    The release round is ``head.round_idx + 1`` — strictly past every
    training round, so release leaves never collide with a training round's
    commitments.  The producer defaults to the head block's producer.
    """
    round_idx = chain.head.round_idx + 1
    if producer is None:
        producer = chain.head.producer
    for cluster_id, digest in enumerate(digests):
        pool.submit(Transaction(MODEL_RELEASE_KIND, cluster_id, digest,
                                round_idx))
    rc = RoundCommitments(round_idx, tuple(enumerate(digests)))
    pool.submit(Transaction(RELEASE_COMMIT_KIND, producer, rc.to_payload(),
                            round_idx))
    block = chain.pack_block(round_idx, producer, pool)
    obs.inc("serve.releases")
    return block, rc


def latest_release(chain: Blockchain) -> tuple[Block, RoundCommitments] | None:
    """The newest block carrying a release commitment (first ``release_commit``
    from the block's own producer wins, mirroring ``verify_round``)."""
    for block in reversed(chain.blocks):
        for tx in block.transactions:
            if tx.kind == RELEASE_COMMIT_KIND and tx.sender == block.producer:
                return block, RoundCommitments.from_payload(block.round_idx,
                                                            tx.payload)
    return None


# ---------------------------------------------------------------------- #
# the refuse-to-serve gate
# ---------------------------------------------------------------------- #

def verify_bank(bank: ModelBank, chain: Blockchain, *,
                obs=NULL_RECORDER) -> None:
    """Every served model must prove provenance against the chain's LATEST
    release block; anything less raises :class:`ProvenanceError`.

    Checks, in order: a release exists; the bank points at the head release
    (stale banks refuse); roots and release rounds agree; and per model,
    the fingerprint recomputed from the weights *actually in the bank*
    matches the recorded digest AND its Merkle proof places (cluster, round,
    digest) under the on-chain root.
    """
    with obs.span("serve.verify", cat="serve") as sp:
        rel = latest_release(chain)
        if rel is None:
            raise ProvenanceError(
                "refusing to serve: the chain carries no model release — "
                "publish one with publish_release / snapshot()")
        block, rc = rel
        if block.block_hash() != bank.block_hash:
            raise ProvenanceError(
                f"refusing to serve: stale release — bank was released in "
                f"block {bank.block_hash[:12]} (round {bank.round_idx}) but "
                f"the chain's latest release is block "
                f"{block.block_hash()[:12]} (round {block.round_idx})")
        if rc.root != bank.root:
            raise ProvenanceError(
                "refusing to serve: bank's commitment root does not match "
                "the release block's agg record")
        if block.round_idx != bank.round_idx:
            raise ProvenanceError(
                "refusing to serve: bank's release round does not match the "
                "release block")
        digests = bank_digests(bank.data, bank.n_params)
        for c, digest in enumerate(digests):
            r = bank.releases[c]
            if r.cluster_id != c or r.digest != digest:
                raise ProvenanceError(
                    f"refusing to serve model {c}: loaded weights fingerprint "
                    f"to {digest[:12]} but the release records "
                    f"{r.digest[:12]} for cluster {r.cluster_id}")
            if not verify_membership(rc.root, c, bank.round_idx, digest,
                                     r.proof):
                raise ProvenanceError(
                    f"refusing to serve model {c}: Merkle membership proof "
                    f"does not place (cluster={c}, round={bank.round_idx}, "
                    f"digest={digest[:12]}) under the release root")
        sp.set(n_models=bank.n_models, block=block.index)
    obs.inc("serve.verifications")


# ---------------------------------------------------------------------- #
# snapshot: finished run -> verified bank
# ---------------------------------------------------------------------- #

def snapshot(source, *, publish: bool = True, verify: bool = True,
             obs=NULL_RECORDER) -> ModelBank:
    """Extract the K cluster-personalized models from a finished run.

    ``source`` is a finished run (an object with ``.sim``) or the simulation
    itself: it reads ``sim.pop.n_clients``, ``sim.cfg.n_clusters``,
    ``sim.arena`` (or ``sim.params``), ``sim.last_labels``,
    ``sim.trainer.chain`` / ``.pool`` and ``sim.mcfg``.  The bank is built
    on the arena's (lead) device from its real rows read to the host.  With
    ``publish`` the bank's digests are minted into a release block on the
    run's own chain; with ``verify`` the fresh bank must pass
    :func:`verify_bank` before it is returned.
    """
    sim = getattr(source, "sim", source)
    if sim is None or not hasattr(sim, "trainer"):
        raise ValueError(
            "snapshot() needs a finished run: pass the run result (or its "
            "simulation) holding the trained arena, labels and chain")
    with obs.span("serve.snapshot", cat="serve") as sp:
        n = sim.pop.n_clients
        n_clusters = sim.cfg.n_clusters
        if sim.arena is not None:
            # the real rows read to the host (shard by shard on a mesh) and
            # moved to the run's device once, after the run: the same bytes
            # at every mesh width
            layout = sim.arena.layout
            rows = torch.from_numpy(sim.arena.host_rows()[:n]).to(
                sim.arena.devices[0])
        else:
            layout = ArenaLayout.from_stacked(sim.params)
            rows = layout.flatten(sim.params)
        labels = torch.as_tensor(np.asarray(sim.last_labels, dtype=np.int64),
                                 device=rows.device)
        data, residues = _extract_bank(
            rows, labels, torch.ones((n,), dtype=rows.dtype, device=rows.device),
            n_clusters)
        residues = residues_numpy(residues)
        digests = [format_digest(residues[c], layout.n_params)
                   for c in range(n_clusters)]
        sp.set(n_models=n_clusters, n_params=layout.n_params)

    chain = sim.trainer.chain
    if publish:
        block, rc = publish_release(chain, sim.trainer.pool, digests, obs=obs)
    else:
        rel = latest_release(chain)
        if rel is None:
            # no release on chain: return an unanchored bank — verify_bank /
            # ServingEngine will refuse it, which is the point of the gate
            rc = RoundCommitments(chain.head.round_idx + 1,
                                  tuple(enumerate(digests)))
            bank = ModelBank(
                mcfg=sim.mcfg, layout=layout, data=data,
                releases=tuple(ModelRelease(c, d, rc.proof(c))
                               for c, d in enumerate(digests)),
                root=rc.root, round_idx=rc.round_idx, block_hash="")
            if verify:
                verify_bank(bank, chain, obs=obs)
            return bank
        block, rc = rel
    bank = ModelBank(
        mcfg=sim.mcfg, layout=layout, data=data,
        releases=tuple(ModelRelease(c, d, rc.proof(c))
                       for c, d in enumerate(digests)),
        root=rc.root, round_idx=block.round_idx,
        block_hash=block.block_hash())
    if verify:
        verify_bank(bank, chain, obs=obs)
    return bank


def tampered(bank: ModelBank, cluster_id: int, scale: float = 1.0001
             ) -> ModelBank:
    """A copy of ``bank`` with one model's weights perturbed — the
    adversarial fixture for refuse-to-serve tests and demos."""
    data = bank.data.clone()
    data[cluster_id] *= scale
    return replace(bank, data=data)
