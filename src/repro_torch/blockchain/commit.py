"""Sender-bound model commitments (paper Fig. 1 steps 2/5/6, done right).

Copy of ``repro.blockchain.commit`` (pure ``hashlib``/``json``), so the
port's hashes equal the reference's bit for bit.

The original consensus check (`Blockchain.verify_round` over ``agg_hash``)
tested bare *set membership*: "client i's committed hash appears among the
hashes the producer aggregated".  That is exactly the anti-freeriding check
the paper claims — and it is broken: a freerider that commits a **copy of an
honest peer's hash** is inside the set and gets paid, and duplicate hashes
(two honest clients with identical params) collapse under set semantics.

This module binds every commitment to its sender:

  * a *leaf* is ``SHA-256(sender | round | digest)`` — the digest itself is
    the device-computed fingerprint (`repro_torch.kernels.fingerprint`), so the
    host only ever handles `O(cohort)` digest bytes;
  * the producer's aggregation record is an **ordered per-sender list** —
    one entry per arrived client, duplicates preserved — plus the Merkle
    root over the leaves;
  * verification compares client i's committed digest against the digest
    the producer recorded *for sender i* (copying a peer's digest now fails,
    because the producer's entry for the copier holds the digest of the
    params the copier actually delivered);
  * Merkle membership proofs let any client audit its own inclusion in
    `O(log cohort)` hashes without replaying the block.

Everything is canonical-JSON + SHA-256 over strings, so block hashes stay
deterministic and replayable across runs and validators.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from functools import cached_property

AGG_COMMIT_KIND = "agg_commit"      # sender-bound producer record
MODEL_COMMIT_KIND = "model_hash"    # client-side commitment (Fig. 1 step 2)

# Serving-tier release commitments (repro_torch.serve.snapshot): the "sender" of a
# release entry is a CLUSTER id, not a client id — the released artifact is
# the cluster-personalized model, and the same (sender, round, digest) leaf /
# Merkle-proof machinery gives each served model an O(log K) provenance check
# against the release block.
MODEL_RELEASE_KIND = "model_release"      # one per released cluster model
RELEASE_COMMIT_KIND = "release_commit"    # producer's sender-bound release record


def commitment_leaf(sender: int, round_idx: int, digest: str) -> str:
    """SHA-256 leaf binding (sender, round, digest) — the unit the Merkle
    tree is built over.  Including the round prevents cross-round replay of
    a stale commitment."""
    body = json.dumps({"sender": int(sender), "round": int(round_idx),
                       "digest": digest}, sort_keys=True)
    return hashlib.sha256(body.encode()).hexdigest()


def _parent(a: str, b: str) -> str:
    return hashlib.sha256((a + b).encode()).hexdigest()


@dataclass(frozen=True)
class MerkleProof:
    """Membership proof: sibling hashes bottom-up with their side."""
    leaf: str
    path: tuple[tuple[str, str], ...]   # (sibling_hash, "L" | "R")

    def root(self) -> str:
        h = self.leaf
        for sibling, side in self.path:
            h = _parent(sibling, h) if side == "L" else _parent(h, sibling)
        return h


@dataclass(frozen=True)
class RoundCommitments:
    """The producer's sender-bound aggregation record for one round.

    ``entries`` preserves arrival order and multiplicity — one ``(sender,
    digest)`` pair per client whose update the producer actually aggregated.
    """
    round_idx: int
    entries: tuple[tuple[int, str], ...]

    @cached_property
    def _levels(self) -> list[list[str]]:
        level = [commitment_leaf(s, self.round_idx, d)
                 for s, d in self.entries]
        if not level:
            level = [hashlib.sha256(b"empty").hexdigest()]
        levels = [level]
        while len(level) > 1:
            if len(level) % 2:
                level = level + [level[-1]]
            level = [_parent(a, b) for a, b in zip(level[::2], level[1::2])]
            levels.append(level)
        return levels

    @property
    def root(self) -> str:
        return self._levels[-1][0]

    def digest_for(self, sender: int) -> str | None:
        """The digest the producer recorded for ``sender`` (None if the
        sender's update never reached the producer)."""
        for s, d in self.entries:
            if s == sender:
                return d
        return None

    def proof(self, sender: int) -> MerkleProof:
        """Membership proof for ``sender``'s entry (first occurrence)."""
        idx = next(i for i, (s, _) in enumerate(self.entries) if s == sender)
        leaf = self._levels[0][idx]
        path = []
        for level in self._levels[:-1]:
            level = level + [level[-1]] if len(level) % 2 else level
            sib = idx ^ 1
            path.append((level[sib], "L" if sib < idx else "R"))
            idx //= 2
        return MerkleProof(leaf, tuple(path))

    def to_payload(self) -> str:
        """Canonical JSON payload for the producer's ``agg_commit`` tx."""
        return json.dumps({"root": self.root,
                           "entries": [[s, d] for s, d in self.entries]},
                          sort_keys=True)

    @classmethod
    def from_payload(cls, round_idx: int, payload: str) -> "RoundCommitments":
        body = json.loads(payload)
        rc = cls(round_idx, tuple((int(s), str(d)) for s, d in body["entries"]))
        if rc.root != body["root"]:
            raise ValueError("agg_commit root does not match its entries")
        return rc


def verify_membership(root: str, sender: int, round_idx: int, digest: str,
                      proof: MerkleProof) -> bool:
    """Audit path: does ``proof`` place (sender, round, digest) under
    ``root``?  `O(log cohort)` hashes, no block replay."""
    return (proof.leaf == commitment_leaf(sender, round_idx, digest)
            and proof.root() == root)
