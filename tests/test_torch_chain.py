"""The port's chain (`repro_torch.blockchain`) against the reference: tx
hashes, Merkle roots (current and legacy), block hashes, sender-bound
commitment roots and proofs, `verify_round` decisions and `validate()` are
EXACTLY equal for the same inputs; `hash_params` hashes the same bytes; a
chain carried across as plain records keeps its head hash.

Tolerance: none — everything is SHA-256 over canonical strings."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.blockchain as J  # noqa: E402
import repro.blockchain.chain as jchain  # noqa: E402
import repro_torch.blockchain as T  # noqa: E402
import repro_torch.blockchain.chain as tchain  # noqa: E402
from repro_torch.interop import chain_from_records  # noqa: E402


def _hashes(k):
    return [f"{i:064x}" for i in range(k)]


@pytest.mark.parametrize("k", range(0, 10))
def test_merkle_roots_equal(k):
    hs = _hashes(k)
    assert tchain._merkle_root(hs) == jchain._merkle_root(hs)
    assert tchain._legacy_merkle_root(hs) == jchain._legacy_merkle_root(hs)


def test_tx_hash_equal():
    for args in [("model_hash", 3, "ab" * 12, 0), ("agg_commit", -1, "{}", 7),
                 ("model_release", 0, "", 2)]:
        assert T.Transaction(*args).tx_hash() == J.Transaction(*args).tx_hash()


@pytest.mark.parametrize("k", [1, 2, 5, 8, 13])
def test_round_commitments_equal(k):
    entries = tuple((i * 3 % 17, f"{i:024x}") for i in range(k))
    jr, tr = J.RoundCommitments(4, entries), T.RoundCommitments(4, entries)
    assert tr.root == jr.root
    assert tr.to_payload() == jr.to_payload()
    for s, d in entries:
        tp, jp = tr.proof(s), jr.proof(s)
        assert (tp.leaf, tp.path) == (jp.leaf, jp.path)
        assert T.verify_membership(tr.root, s, 4, d, tp)
        assert not T.verify_membership(tr.root, s, 5, d, tp)
    assert T.commitment_leaf(2, 3, "x") == J.commitment_leaf(2, 3, "x")
    assert T.RoundCommitments.from_payload(4, jr.to_payload()).root == jr.root


def _scenario(M):
    """One chain exercising every verify_round rule, built with module M."""
    chain, pool = M.Blockchain(), M.TxPool()
    decisions = []
    # round 0: honest commits; client 3 freerides on client 1's digest
    digests = {c: f"{c:024x}" for c in range(5)}
    for c in range(5):
        pool.submit(M.Transaction("model_hash", c,
                                  digests[1] if c == 3 else digests[c], 0))
    rc = M.RoundCommitments(0, tuple(digests.items()))
    pool.submit(M.Transaction(M.AGG_COMMIT_KIND, 0, rc.to_payload(), 0))
    decisions.append(chain.verify_round(chain.pack_block(0, 0, pool), 6))
    # round 1: a client front-runs the producer's record, a late commit from
    # round 0, a re-submission (first wins)
    pool.submit(M.Transaction(M.AGG_COMMIT_KIND, 2, M.RoundCommitments(
        1, ((2, "bad"),)).to_payload(), 1))
    pool.submit(M.Transaction("model_hash", 2, "d2", 1))
    pool.submit(M.Transaction("model_hash", 2, "other", 1))
    pool.submit(M.Transaction("model_hash", 4, "d4", 0))
    pool.submit(M.Transaction(M.AGG_COMMIT_KIND, 1, M.RoundCommitments(
        1, ((2, "d2"), (4, "d4"))).to_payload(), 1))
    decisions.append(chain.verify_round(chain.pack_block(1, 1, pool), 6))
    # round 2: a malformed producer record; round 3: legacy agg_hash set
    pool.submit(M.Transaction("model_hash", 0, "d0", 2))
    pool.submit(M.Transaction(M.AGG_COMMIT_KIND, 1, "{not json", 2))
    decisions.append(chain.verify_round(chain.pack_block(2, 1, pool), 6))
    pool.submit(M.Transaction("model_hash", 5, "h5", 3))
    pool.submit(M.Transaction("agg_hash", 1, json.dumps(["h5"]), 3))
    decisions.append(chain.verify_round(chain.pack_block(3, 1, pool), 6))
    return chain, decisions


def test_scenario_block_hashes_and_decisions_equal():
    jc, jd = _scenario(J)
    tc, td = _scenario(T)
    assert [b.block_hash() for b in tc.blocks] == [b.block_hash() for b in jc.blocks]
    assert [b.merkle_root for b in tc.blocks] == [b.merkle_root for b in jc.blocks]
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a, b)
    assert td[0].tolist() == [True, True, True, False, True, False]
    assert tc.validate() and jc.validate()


def test_validate_rejects_the_same_mutations():
    for M in (J, T):
        chain, _ = _scenario(M)
        last = chain.blocks[-1]
        dup = dataclasses.replace(last, transactions=last.transactions
                                  + (last.transactions[-1],))
        chain.blocks[-1] = dup          # duplicated last tx (CVE-2012-2459)
        assert not chain.validate()
        chain.blocks[-1] = dataclasses.replace(last, prev_hash="0" * 64)
        assert not chain.validate()


class _BadBlocks:
    def bad_block(self, round_idx):
        return round_idx == 0


def test_pack_block_fault_hook_quarantines_alike():
    out = []
    for M in (J, T):
        chain, pool = M.Blockchain(), M.TxPool()
        pool.submit(M.Transaction("model_hash", 1, "x", 0))
        chain.pack_block(0, 1, pool, faults=_BadBlocks())
        out.append(([b.block_hash() for b in chain.quarantined],
                    chain.head.block_hash(), chain.validate()))
    assert out[0] == out[1]
    assert len(out[0][0]) == 1 and out[0][2]


def test_hash_params_equal():
    rng = np.random.default_rng(0)
    p = {"w0": rng.standard_normal((4, 3)).astype(np.float32),
         "b": {"c": rng.standard_normal((2,)).astype(np.float32)},
         "a b": np.arange(3, dtype=np.float32)}
    tp = {"w0": torch.from_numpy(p["w0"]), "b": {"c": torch.from_numpy(p["b"]["c"])},
          "a b": torch.from_numpy(p["a b"])}
    jp = {"w0": jnp.asarray(p["w0"]), "b": {"c": jnp.asarray(p["b"]["c"])},
          "a b": jnp.asarray(p["a b"])}
    assert T.hash_params(tp) == J.hash_params(jp)


def test_chain_from_records_keeps_head_hash():
    jc, jd = _scenario(J)
    tc = chain_from_records([dataclasses.asdict(b) for b in jc.blocks])
    assert tc.head.block_hash() == jc.head.block_hash()
    assert tc.validate()
    for block, want in zip(tc.blocks[1:], jd):
        np.testing.assert_array_equal(tc.verify_round(block, 6), want)
    # a new block on the carried chain links like one on the reference chain
    for M, chain in ((J, jc), (T, tc)):
        pool = M.TxPool()
        pool.submit(M.Transaction("model_hash", 0, "z", 4))
        chain.pack_block(4, 0, pool)
    assert tc.head.block_hash() == jc.head.block_hash()
