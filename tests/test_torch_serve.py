"""The serving slice as a whole: a finished reference run (`repro.api.run`)
carried across as plain data — arena rows, layout, labels, chain records —
and served by the port (`repro_torch.serve`).

Held against the reference:
  * bank extraction allclose (atol 1e-6: the cluster means sum in another
    order than XLA's);
  * digests of the reference bank's bytes, the release block's hash and
    root: EXACTLY equal;
  * the forward allclose (atol = rtol = 1e-5: float32, another summation
    order);
  * frontend replay: the same flush boundaries, buckets, reasons and
    completion order.
And the port's own contracts: the refuse-to-serve negatives, fused ==
per-request bit for bit, `.npz` banks loading across packages."""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as api  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.sim.clock import VirtualClock as JaxClock  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.blockchain import TxPool  # noqa: E402
from repro_torch.interop import arena_from_numpy, chain_from_records  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402
from repro_torch.sim import VirtualClock  # noqa: E402

FWD = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def ref():
    """A small reference run, the plain data carried from it BEFORE the
    reference publishes its release, and the reference's own bank."""
    spec = api.ExperimentSpec(
        data=api.DataSpec(n_clients=40),
        train=api.TrainSpec(rounds=2, sample_frac=0.3, n_clusters=3),
        eval=api.EvalSpec(every=0, clients=16, examples=64))
    result = api.run(spec)
    sim = result.sim
    carried = SimpleNamespace(
        n=sim.pop.n_clients, k=sim.cfg.n_clusters,
        rows=np.asarray(jax.device_get(sim.arena.data))[: sim.pop.n_clients],
        paths_shapes=list(zip(sim.arena.layout.paths, sim.arena.layout.shapes)),
        labels=np.asarray(sim.last_labels).copy(),
        records=[dataclasses.asdict(b) for b in sim.trainer.chain.blocks],
        mcfg=dataclasses.asdict(sim.mcfg))
    bank = jserve.snapshot(result)        # publishes the reference release
    return SimpleNamespace(result=result, sim=sim, carried=carried, bank=bank,
                           chain=sim.trainer.chain)


def _source(c):
    """A port-side run object: the attributes `snapshot` reads, rebuilt from
    the carried plain data on the CPU."""
    mcfg = dict(c.mcfg, hidden=tuple(c.mcfg["hidden"]))
    return SimpleNamespace(
        pop=SimpleNamespace(n_clients=c.n), cfg=SimpleNamespace(n_clusters=c.k),
        arena=arena_from_numpy(c.rows, c.paths_shapes, device="cpu"),
        last_labels=c.labels, mcfg=tclf.MLPConfig(**mcfg),
        trainer=SimpleNamespace(chain=chain_from_records(c.records),
                                pool=TxPool()),
        clock=VirtualClock(), obs=None)


@pytest.fixture(scope="module")
def port(ref):
    """The carried run with the port's own release block over the reference
    bank's digests."""
    src = _source(ref.carried)
    block, rc = tserve.publish_release(src.trainer.chain, src.trainer.pool,
                                       ref.bank.digests())
    return SimpleNamespace(src=src, block=block, rc=rc)


@pytest.fixture(scope="module")
def port_bank(ref, port, tmp_path_factory):
    """The reference bank, saved by the reference and loaded (verified) by
    the port against the port's release block."""
    path = str(tmp_path_factory.mktemp("bank") / "ref_bank.npz")
    ref.bank.save(path)
    return tserve.load_bank(path, port.src.trainer.chain, device="cpu")


@pytest.fixture(scope="module")
def engine(port, port_bank):
    return tserve.ServingEngine(port_bank, port.src.trainer.chain)


# --------------------------------------------------------------------- #
# snapshot, digests, release block
# --------------------------------------------------------------------- #

def test_snapshot_bank_allclose_to_reference(ref):
    bank = tserve.snapshot(_source(ref.carried), publish=False, verify=False)
    assert bank.layout.paths == ref.bank.layout.paths
    np.testing.assert_allclose(bank.data.numpy(), np.asarray(ref.bank.data),
                               rtol=0, atol=1e-6)


def test_digests_of_reference_bank_bytes_exact(ref):
    data = torch.from_numpy(np.array(ref.bank.data))
    assert tserve.bank_digests(data, ref.bank.n_params) == ref.bank.digests()


def test_release_block_hash_equals_reference(ref, port):
    assert port.block.block_hash() == ref.bank.block_hash
    assert port.rc.root == ref.bank.root
    assert port.block.round_idx == ref.bank.round_idx
    assert port.src.trainer.chain.head.block_hash() == ref.chain.head.block_hash()
    assert port.src.trainer.chain.validate()


def test_port_snapshot_publishes_and_verifies(ref):
    src = _source(ref.carried)
    bank = tserve.snapshot(src)                  # publish + verify_bank
    head, rc = tserve.latest_release(src.trainer.chain)
    assert head is src.trainer.chain.blocks[-1]
    assert (bank.block_hash, bank.root) == (head.block_hash(), rc.root)
    tserve.ServingEngine(bank, src.trainer.chain)


def test_reference_saved_bank_loads_and_verifies(ref, port_bank):
    assert port_bank.digests() == ref.bank.digests()
    assert port_bank.layout.paths == ref.bank.layout.paths
    np.testing.assert_array_equal(port_bank.data.numpy(),
                                  np.asarray(ref.bank.data))
    # also against the reference chain itself, release block included
    carried = chain_from_records([dataclasses.asdict(b)
                                  for b in ref.chain.blocks])
    tserve.verify_bank(port_bank, carried)


def test_port_saved_bank_loads_in_reference(ref, port_bank, tmp_path):
    path = str(tmp_path / "port_bank.npz")
    port_bank.save(path)
    back = jserve.load_bank(path, ref.chain)     # verifies in the reference
    assert back.digests() == port_bank.digests()


# --------------------------------------------------------------------- #
# the refuse-to-serve gate
# --------------------------------------------------------------------- #

def test_tampered_weights_refused(port, port_bank):
    with pytest.raises(tserve.ProvenanceError, match="fingerprint"):
        tserve.ServingEngine(tserve.tampered(port_bank, 1), port.src.trainer.chain)
    with pytest.raises(tserve.ProvenanceError, match="fingerprint"):
        tserve.verify_bank(tserve.tampered(port_bank, 0), port.src.trainer.chain)


def test_tampered_digest_refused(port, port_bank):
    releases = list(port_bank.releases)
    releases[0] = dataclasses.replace(releases[0], digest="0" * 24)
    bad = dataclasses.replace(port_bank, releases=tuple(releases))
    with pytest.raises(tserve.ProvenanceError):
        tserve.ServingEngine(bad, port.src.trainer.chain)


def test_wrong_round_refused(port, port_bank):
    bad = dataclasses.replace(port_bank, round_idx=port_bank.round_idx - 1)
    with pytest.raises(tserve.ProvenanceError, match="round"):
        tserve.ServingEngine(bad, port.src.trainer.chain)


def test_stale_release_refused(port, port_bank):
    chain = port.src.trainer.chain
    tserve.publish_release(chain, TxPool(), port_bank.digests())
    try:
        with pytest.raises(tserve.ProvenanceError, match="stale"):
            tserve.ServingEngine(port_bank, chain)
    finally:
        chain.blocks.pop()
    assert chain.validate()
    tserve.ServingEngine(port_bank, chain)


def test_no_release_refused(ref):
    src = _source(ref.carried)                   # carried before any release
    with pytest.raises(tserve.ProvenanceError, match="no model release"):
        tserve.snapshot(src, publish=False)
    with pytest.raises(tserve.ProvenanceError):
        tserve.ServingEngine(tserve.snapshot(src, publish=False, verify=False),
                             src.trainer.chain)


def test_engine_requires_chain_unless_opted_out(port_bank):
    with pytest.raises(tserve.ProvenanceError):
        tserve.ServingEngine(port_bank, None)
    tserve.ServingEngine(port_bank, None, verify=False)
    with pytest.raises(ValueError):
        tserve.snapshot(object())


# --------------------------------------------------------------------- #
# the forward
# --------------------------------------------------------------------- #

def _requests(n, seed, in_dim, k):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, in_dim)).astype(np.float32),
            rng.integers(0, k, size=n).astype(np.int32))


def test_forward_allclose_to_reference(ref, engine):
    x, cids = _requests(8, 1, ref.bank.mcfg.in_dim, ref.bank.n_models)
    want = np.asarray(jserve.ServingEngine(ref.bank, ref.chain).forward(x, cids))
    np.testing.assert_allclose(engine.forward(x, cids).numpy(), want, **FWD)


@pytest.mark.parametrize("batch", [1, 4, 8, 32])
def test_fused_bitwise_equals_per_request(engine, batch):
    x, cids = _requests(batch, batch, engine.bank.mcfg.in_dim,
                        engine.bank.n_models)
    out = engine.forward(x, cids)
    oracle = engine.forward_per_request(x, cids)
    assert out.shape == (batch, engine.bank.mcfg.num_classes)
    assert torch.equal(out.view(torch.int32), oracle.view(torch.int32))
    # each row depends on its own (x, cid) only, not on the batch's routing
    for c in range(engine.bank.n_models):
        uniform = engine.forward(x, np.full(batch, c, np.int32))
        rows = np.flatnonzero(cids == c)
        assert torch.equal(out[rows], uniform[rows])


# --------------------------------------------------------------------- #
# the frontend
# --------------------------------------------------------------------- #

class _Log:
    """Duck-typed recorder keeping each flush span's attributes."""

    def __init__(self):
        self.flushes = []

    def span(self, name, **attrs):
        return _Span(self.flushes if name == "serve.flush" else None)

    def inc(self, *a, **k):
        pass

    event = observe = set_gauge = compile_delta = inc


class _Span:
    def __init__(self, sink):
        self.sink, self.attrs = sink, {}

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.sink is not None:
            self.sink.append(self.attrs)
        return False


def _drive(make_frontend, clock, schedule, config):
    log = _Log()
    fe = make_frontend(config, clock, log)
    for t, cid, x in schedule:
        clock.advance_to(t)
        fe.pump()
        fe.submit(cid, x)
    fe.drain()
    return fe.take_completed(), log.flushes


def test_frontend_replay_matches_reference(ref, engine):
    rng = np.random.default_rng(3)
    schedule = [(0.001 * i if i < 15 else 0.02, int(i % 3),
                 rng.standard_normal(ref.bank.mcfg.in_dim).astype(np.float32))
                for i in range(40)]
    jeng = jserve.ServingEngine(ref.bank, ref.chain)
    jcfg = jserve.ServeConfig(buckets=(1, 2, 4, 8), max_wait=0.004)
    tcfg = tserve.ServeConfig(buckets=(1, 2, 4, 8), max_wait=0.004)
    jdone, jflush = _drive(
        lambda cfg, clock, log: jserve.ServeFrontend(jeng, cfg, clock=clock, obs=log),
        JaxClock(), schedule, jcfg)
    tdone, tflush = _drive(
        lambda cfg, clock, log: tserve.ServeFrontend(engine, cfg, clock=clock, obs=log),
        VirtualClock(), schedule, tcfg)
    assert tflush == jflush
    assert {f["reason"] for f in tflush} == {"full", "deadline", "drain"}
    assert [(c.req_id, c.cluster_id, c.status, c.t_arrival, c.t_done)
            for c in tdone] == \
        [(c.req_id, c.cluster_id, c.status, c.t_arrival, c.t_done) for c in jdone]
    np.testing.assert_allclose(np.stack([c.logits for c in tdone]),
                               np.stack([c.logits for c in jdone]), **FWD)
    oracle = engine.forward_per_request(np.stack([x for *_, x in schedule]),
                                        [cid for _, cid, _ in schedule]).numpy()
    for c in tdone:
        np.testing.assert_array_equal(c.logits, oracle[c.req_id])


def test_frontend_overload_and_validation(engine):
    fe = tserve.ServeFrontend(engine, tserve.ServeConfig(
        buckets=(8,), max_wait=1e9, max_pending=4), clock=VirtualClock())
    x = np.zeros(engine.bank.mcfg.in_dim, np.float32)
    for _ in range(6):
        fe.submit(0, x)
    done = fe.take_completed()
    assert [c.status for c in done] == ["rejected"] * 2
    assert all(c.logits is None for c in done)
    fe.drain()
    assert [c.status for c in fe.take_completed()] == ["ok"] * 4
    with pytest.raises(ValueError, match="features"):
        fe.submit(0, np.zeros(engine.bank.mcfg.in_dim + 1, np.float32))
    with pytest.raises(ValueError, match="cluster_id"):
        fe.submit(engine.bank.n_models, x)
    with pytest.raises(ValueError, match="clock"):
        tserve.ServeFrontend(engine, clock=None)
    with pytest.raises(ValueError):
        tserve.ServeConfig(buckets=(4, 2))


def test_serve_entry_point(ref):
    src = _source(ref.carried)
    fe = tserve.serve(src)
    rid = fe.submit(1, np.zeros(src.mcfg.in_dim, np.float32))
    fe.drain()
    [done] = fe.take_completed()
    assert (done.req_id, done.status, done.cluster_id) == (rid, "ok", 1)
    assert done.logits.shape == (src.mcfg.num_classes,)
