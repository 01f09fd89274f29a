"""Deterministic in-process blockchain (paper §IV-C + Fig. 1 steps 2/5/6).

Port of ``repro.blockchain.chain``: the same canonical JSON + SHA-256, so
the same transactions give the same Merkle roots and block hashes as the
reference.  Only :func:`hash_params` changed, to read a dict of tensors.

Permissioned DPoS-style chain: block producers come from CACC's packing queue
(cluster-centroid clients) and take turns; there is no PoW.  Blocks carry two
commitment transaction kinds:

  * ``model_hash``  — a training client commits the fingerprint digest of its
    local model before aggregation (Fig. 1 step 2),
  * ``agg_commit``  — the producer (aggregation client) records a
    **sender-bound** list of the digests it actually aggregated — one entry
    per arrived client — plus a Merkle root over the (sender, round, digest)
    leaves (Fig. 1 step 5; see ``repro_torch.blockchain.commit``).

Consensus (Fig. 1 step 6) — :meth:`Blockchain.verify_round` — rewards client
i iff its committed digest equals the digest the producer recorded *for
sender i*.  The retired ``agg_hash`` transaction kind (bare hash set, no
sender binding) is still parsed so old chains replay and so tests can
demonstrate the hash-copy freeriding attack it permitted.

Everything is deterministic and replayable: hashing is canonical over
strings/JSON, so any validator reproduces identical block hashes.
``hash_params`` (host-side SHA-256 over full param bytes) remains as the
reference digest for tests and the commit-path benchmark baseline; the hot
path uses the device-side batched fingerprint
(`repro_torch.kernels.fingerprint`).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.blockchain.commit import AGG_COMMIT_KIND, RoundCommitments
from repro_torch.blockchain.txpool import Transaction, TxPool
from repro_torch.obs import NULL_RECORDER
from repro_torch.runtime.arena import keystr, leaves_with_keys

Pytree = Any


def hash_params(params: Pytree) -> str:
    """Canonical SHA-256 of a dict of tensors (path-sorted leaf bytes): the
    same keystr paths, dtype names, shapes and bytes the reference hashes."""
    h = hashlib.sha256()
    leaves = [(keystr(k), leaf) for k, leaf in leaves_with_keys(params)]
    for path, leaf in sorted(leaves, key=lambda kv: kv[0]):
        arr = leaf.detach().cpu().numpy()
        h.update(path.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _merkle_root(tx_hashes: list[str]) -> str:
    """Domain-separated pairwise SHA-256 merkle root.

    Leaf and interior hashes live in disjoint domains (RFC-6962 style) and an
    odd node is *promoted* to the next level instead of paired with itself —
    so appending a duplicate of the last transaction always changes the root.
    The retired scheme (bare pairwise hashing, duplicate-last padding) allowed
    the Bitcoin CVE-2012-2459 mutation: ``root([a, b, c]) == root([a, b, c,
    c])``, letting ``validate()`` accept a chain whose block had its last tx
    duplicated.  Old blocks built with that scheme still validate through
    :func:`_legacy_merkle_root`'s explicit-self-pair check.
    """
    if not tx_hashes:
        return hashlib.sha256(b"empty").hexdigest()
    level = [hashlib.sha256(b"leaf:" + h.encode()).hexdigest()
             for h in tx_hashes]
    while len(level) > 1:
        nxt = [hashlib.sha256(b"node:" + (a + b).encode()).hexdigest()
               for a, b in zip(level[::2], level[1::2])]
        if len(level) % 2:
            nxt.append(level[-1])                   # promote, never self-pair
        level = nxt
    return level[0]


def _legacy_merkle_root(tx_hashes: list[str]) -> tuple[str, bool]:
    """The retired duplicate-last-padding root, plus a mutation flag.

    Returns ``(root, mutated)`` where ``mutated`` is True iff some level
    hashes two *explicit* identical adjacent nodes together (Bitcoin's
    CVE-2012-2459 detector): padding self-pairs an odd level's last node
    implicitly, so an honest odd-length block never trips the flag, while
    the duplicated-last-tx mutation — which produces the identical root —
    always does.  Like Bitcoin, the detector cannot tell a mutation from a
    legacy block that *legitimately* carried identical adjacent
    transactions; such duplicates are treated as invalid (a commitment is
    idempotent — re-submitting the identical tx carries no information, and
    in-repo legacy chains never contained one).  Blocks packed after the
    domain separation never consult this fallback, so duplicate txs in NEW
    blocks validate fine."""
    if not tx_hashes:
        return hashlib.sha256(b"empty").hexdigest(), False
    level = list(tx_hashes)
    mutated = False
    while len(level) > 1:
        mutated |= any(level[i] == level[i + 1]
                       for i in range(0, len(level) - 1, 2))
        if len(level) % 2:
            level.append(level[-1])
        level = [hashlib.sha256((a + b).encode()).hexdigest()
                 for a, b in zip(level[::2], level[1::2])]
    return level[0], mutated


@dataclass(frozen=True)
class Block:
    index: int
    round_idx: int
    producer: int                  # client id of the packing (aggregation) client
    prev_hash: str
    merkle_root: str
    transactions: tuple[Transaction, ...]

    def header(self) -> dict:
        return {"index": self.index, "round": self.round_idx,
                "producer": self.producer, "prev": self.prev_hash,
                "merkle": self.merkle_root}

    def block_hash(self) -> str:
        return hashlib.sha256(
            json.dumps(self.header(), sort_keys=True).encode()).hexdigest()


@dataclass
class Blockchain:
    blocks: list[Block] = field(default_factory=list)
    quarantined: list[Block] = field(default_factory=list)  # rejected blocks

    def __post_init__(self):
        if not self.blocks:
            genesis = Block(0, -1, -1, "0" * 64, _merkle_root([]), ())
            self.blocks.append(genesis)
        self.obs = NULL_RECORDER    # recorder (repro_torch.obs), rebindable

    @property
    def head(self) -> Block:
        return self.blocks[-1]

    def block_ok(self, block: Block) -> bool:
        """Structural admission check for a candidate head block: correct
        hash link to the current head and a merkle root that matches its own
        transactions.  This is what :meth:`validate` enforces per link —
        running it at admission time lets a malformed or digest-mismatched
        block be quarantined instead of poisoning the chain."""
        return (block.prev_hash == self.head.block_hash()
                and block.merkle_root == _merkle_root(
                    [t.tx_hash() for t in block.transactions]))

    def pack_block(self, round_idx: int, producer: int, pool: TxPool,
                   faults=None) -> Block:
        """Producer drains the tx pool into a new block (DPoS slot).

        ``faults`` (an injector with ``bad_block(round_idx)``) may inject a digest-mismatched candidate
        first; the admission check rejects it into ``quarantined`` and the
        round continues with an honestly re-packed block — the
        quarantine-and-continue degradation path."""
        with self.obs.span("chain.pack", cat="chain", round=round_idx) as sp:
            txs = tuple(pool.drain())
            if faults is not None and faults.bad_block(round_idx):
                bad = Block(
                    index=len(self.blocks), round_idx=round_idx,
                    producer=producer, prev_hash=self.head.block_hash(),
                    merkle_root=hashlib.sha256(
                        b"corrupt:" + str(round_idx).encode()).hexdigest(),
                    transactions=txs)
                assert not self.block_ok(bad)
                self.quarantined.append(bad)
                self.obs.event("fault.block_quarantined", round=round_idx,
                               block_hash=bad.block_hash())
                self.obs.inc("fault.block_quarantined")
            block = Block(
                index=len(self.blocks),
                round_idx=round_idx,
                producer=producer,
                prev_hash=self.head.block_hash(),
                merkle_root=_merkle_root([t.tx_hash() for t in txs]),
                transactions=txs,
            )
            self.blocks.append(block)
            sp.set(n_tx=len(txs))
        self.obs.inc("chain.blocks")
        self.obs.inc("chain.tx", len(txs))
        return block

    def validate(self) -> bool:
        """Full-chain validation: hash links + merkle roots.

        A block's recorded root must match the domain-separated scheme; a
        block packed before the domain separation (legacy duplicate-last
        padding) is still accepted on its legacy root, but only when the
        legacy computation saw no explicit self-paired nodes — the
        CVE-2012-2459 duplicated-tx mutation reproduces the legacy root yet
        always trips that flag, so the mutated chain is rejected under both
        schemes."""
        with self.obs.span("chain.validate", cat="chain") as sp:
            sp.set(n_blocks=len(self.blocks))
            return self._validate()

    def _validate(self) -> bool:
        for prev, cur in zip(self.blocks, self.blocks[1:]):
            if cur.prev_hash != prev.block_hash():
                return False
            hashes = [t.tx_hash() for t in cur.transactions]
            if cur.merkle_root != _merkle_root(hashes):
                legacy_root, mutated = _legacy_merkle_root(hashes)
                if mutated or cur.merkle_root != legacy_root:
                    return False
        return True

    # ------------------------------------------------------------------ #
    # Consensus verification (Fig. 1 step 6)
    # ------------------------------------------------------------------ #

    def verify_round(self, block: Block, n_clients: int) -> np.ndarray:
        """Boolean mask (n_clients,): client i's committed ``model_hash``
        digest matches the digest the producer's ``agg_commit`` records for
        sender i (identity-bound — copying a peer's digest fails, because
        the producer's entry for the copier holds what the copier actually
        delivered).

        Duplicates resolve first-wins on BOTH sides: a client's first
        ``model_hash`` is the digest the producer actually saw, and only the
        first ``agg_commit`` *sent by the block's producer* is consulted —
        any other sender's record is ignored (a client must not be able to
        front-run the producer and control the round's verification basis).

        Legacy ``agg_hash`` blocks (pre-sender-binding) fall back to the old
        set-membership rule so historic chains replay; new blocks never mix
        the two kinds."""
        with self.obs.span("chain.verify", cat="chain",
                           round=block.round_idx):
            return self._verify_round(block, n_clients)

    def _verify_round(self, block: Block, n_clients: int) -> np.ndarray:
        committed: dict[int, str] = {}
        bound: dict[int, str] | None = None
        legacy: set[str] = set()
        for tx in block.transactions:
            if tx.kind == "model_hash":
                if tx.round_idx != block.round_idx:
                    # a commit delivered late (e.g. a delayed-delivery fault)
                    # lands in a later round's block: it is recorded there
                    # but carries no verification weight — commitments bind
                    # to the round they were made for
                    continue
                # FIRST commit wins — the digest the producer actually saw
                # and aggregated.  Last-wins let a client re-submit after the
                # producer recorded it and be judged against the wrong digest
                # (honest clients punished, or a freerider aligning its late
                # commit with the producer's entry for it).
                committed.setdefault(tx.sender, tx.payload)
            elif tx.kind == AGG_COMMIT_KIND:
                if tx.sender != block.producer:
                    continue            # only the packing producer's record
                                        # counts: a client must not front-run
                                        # the round's verification basis
                if bound is not None:
                    continue            # first agg_commit wins, like commits
                try:
                    commits = RoundCommitments.from_payload(block.round_idx,
                                                            tx.payload)
                except (ValueError, KeyError, TypeError):
                    bound = {}          # malformed record: nobody verifies
                else:
                    # first occurrence wins, matching RoundCommitments.proof
                    bound = {}
                    for s, d in commits.entries:
                        bound.setdefault(s, d)
            elif tx.kind == "agg_hash":
                legacy.update(json.loads(tx.payload))
        ok = np.zeros((n_clients,), dtype=bool)
        for cid, h in committed.items():
            if not 0 <= cid < n_clients:
                continue
            if bound is not None:
                ok[cid] = bound.get(cid) == h
            else:
                ok[cid] = h in legacy
        return ok
