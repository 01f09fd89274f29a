"""Fault injection on the port against `repro.faults` and the reference's
faulted runs, on the CPU.

The injector: the same schedule and the same calls give the same draws
(dropped and delayed slots, retry verdicts and latencies) as the
reference's `FaultInjector`, its state round-trips as plain values, and the
no-op injector does nothing.

Each fault class — a failed producer, a bad block, a dropped commit, a
delayed commit, retry of dropped cohort slots, and all of them together —
through `run(spec)` at n = 40 (5 rounds, 30% cohort, 2 clusters, dropout
0.3 so retries fire), the port starting from the reference's initial
population: the event log equals the reference's, and so do the
quarantined rounds, the late commits, the dropouts and every round's
verified fraction; the chain stays valid and the ledger conserved.  In
async mode (all classes at once) the producers and balances are equal too,
as single-cluster CACC makes them independent of the trained bits; the
sync producers come from the Pearson matrix of the trained models, so
they are compared only as the reference's own tests compare them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
import repro.faults as ref_faults  # noqa: E402
from repro.sim import ClientPopulation as JPopulation  # noqa: E402
from repro.sim import SimulatedFederation as JSimulation  # noqa: E402
from repro_torch import api as port_api  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    CRASH_PHASES,
    NULL_INJECTOR,
    FaultInjector,
    FaultSpec,
    InjectedCrash,
)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.sim.driver import SimulatedFederation  # noqa: E402
from repro_torch.sim.population import ClientPopulation  # noqa: E402

CLASSES = {
    "producer_fail": dict(producer_fail_rounds=(1, 2)),
    "bad_block": dict(bad_block_rounds=(1, 3)),
    "drop_commit": dict(drop_commit_rounds=(1, 4), seed=5),
    "delay_commit": dict(delay_commit_rounds=(1,), seed=5),
    "retry": dict(retry=True, retry_max=3, seed=11),
    "all": dict(producer_fail_rounds=(1, 2), bad_block_rounds=(1, 3),
                drop_commit_rounds=(1,), delay_commit_rounds=(2,), retry=True,
                retry_max=3, seed=11),
}


def _spec(api, faults: dict, mode: str = "sync"):
    return api.ExperimentSpec(
        data=api.DataSpec(n_clients=40, n_batches=1, batch_size=16,
                          dropout_rate=0.3),
        train=api.TrainSpec(strategy="bfln", rounds=5, sample_frac=0.3,
                            n_clusters=2, local_epochs=1, mode=mode),
        async_=api.AsyncSpec(buffer_size=4, concurrency=8),
        faults=api.FaultSpec(**faults), seed=3)


def _both(faults: dict, mode: str = "sync"):
    rspec, tspec = _spec(ref_api, faults, mode), _spec(port_api, faults, mode)
    jsim = JSimulation(JPopulation.from_spec(rspec.population_spec()), rspec)
    init = {k: np.array(v) for k, v in jsim.params.items()}
    jrep = jsim.run()
    tsim = SimulatedFederation(
        ClientPopulation.from_spec(tspec.population_spec(), "cpu"), tspec,
        device="cpu")
    tsim.params = params_from_numpy(init, device="cpu")
    return jsim, jrep, tsim, tsim.run()


def _late(chain):
    return [(b.round_idx, tx.sender, tx.round_idx) for b in chain.blocks
            for tx in b.transactions
            if tx.kind == "model_hash" and tx.round_idx != b.round_idx]


def _check_against_reference(jsim, jrep, tsim, trep):
    assert trep.event_log == jrep.event_log
    jc, tc = jsim.trainer.chain, tsim.trainer.chain
    assert [b.round_idx for b in tc.quarantined] == [b.round_idx for b in jc.quarantined]
    assert all(not tc.block_ok(b) for b in tc.quarantined)
    assert _late(tc) == _late(jc)
    assert len(tc.blocks) == len(jc.blocks)
    for a, b in zip(jrep.history, trep.history, strict=True):
        assert (a.n_dropouts, a.n_stragglers, a.verified_frac) == \
            (b.n_dropouts, b.n_stragglers, b.verified_frac)
    assert trep.chain_valid and trep.ledger_conserved


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_each_fault_class_gives_the_references_event_log(name):
    jsim, jrep, tsim, trep = _both(CLASSES[name])
    _check_against_reference(jsim, jrep, tsim, trep)
    hist = trep.history
    if name in ("drop_commit", "delay_commit"):
        assert hist[1].verified_frac < 1.0          # the victim forfeits
    if name == "delay_commit":
        assert _late(tsim.trainer.chain)[0][2] == 1
    if name == "bad_block":
        assert [b.round_idx for b in tsim.trainer.chain.quarantined] == [1, 3]
    if name == "retry":
        plain = port_api.run(_spec(port_api, {}), device="cpu")
        assert len(trep.event_log) > len(plain.report.event_log)   # retries fired


def test_all_fault_classes_in_async_mode_equal_reference():
    jsim, jrep, tsim, trep = _both(CLASSES["all"], mode="async")
    _check_against_reference(jsim, jrep, tsim, trep)
    np.testing.assert_array_equal(trep.balances, jrep.balances)
    assert [h.producer for h in trep.history] == [h.producer for h in jrep.history]
    assert [b.producer for b in tsim.trainer.chain.blocks] == \
        [b.producer for b in jsim.trainer.chain.blocks]


def test_injector_draws_equal_reference():
    spec = dict(drop_commit_rounds=(0, 1, 2), delay_commit_rounds=(1, 2),
                producer_fail_rounds=(2,), bad_block_rounds=(1,), retry=True,
                retry_backoff=1.5, seed=7)
    mine = FaultInjector(FaultSpec(**spec))
    ref = ref_faults.FaultInjector(ref_faults.FaultSpec(**spec))
    for r in range(4):
        for inj in (mine, ref):
            inj.hold_commit(("tx", r))
        assert mine.commit_drop_slot(r, 9) == ref.commit_drop_slot(r, 9)
        assert mine.commit_delay_slot(r, 7) == ref.commit_delay_slot(r, 7)
        assert mine.producer_fails(r) == ref.producer_fails(r)
        assert mine.bad_block(r) == ref.bad_block(r)
        for attempt in (1, 2):
            assert mine.retry_latency(10.0, attempt) == ref.retry_latency(10.0, attempt)
            assert mine.retry_succeeds(0.4) == ref.retry_succeeds(0.4)
    assert mine.release_commits() == ref.release_commits()
    assert mine.release_commits() == []


def test_injector_state_round_trips_as_plain_values():
    from repro_torch.blockchain import Transaction
    spec = FaultSpec(drop_commit_rounds=(0, 1, 2, 3), retry=True, seed=7)
    a = FaultInjector(spec)
    a.commit_drop_slot(0, 9)
    a.retry_latency(10.0, 1)
    a.hold_commit(Transaction("model_hash", 4, "ab" * 32, 1))
    state = a.state_dict()
    assert state["held"] == [("model_hash", 4, "ab" * 32, 1)]
    b = FaultInjector(spec)
    b.load_state(state)
    assert a.commit_drop_slot(1, 9) == b.commit_drop_slot(1, 9)
    assert a.retry_succeeds(0.5) == b.retry_succeeds(0.5)
    assert a.retry_latency(10.0, 2) == b.retry_latency(10.0, 2)
    assert b.release_commits() == a.release_commits() == \
        [Transaction("model_hash", 4, "ab" * 32, 1)]
    b.load_state(None)                        # a fault-free snapshot: no-op


def test_null_injector_is_inert_and_bound_by_default():
    assert not NULL_INJECTOR.enabled and NULL_INJECTOR.state_dict() is None
    assert NULL_INJECTOR.commit_drop_slot(0, 5) == -1
    assert NULL_INJECTOR.release_commits() == []
    NULL_INJECTOR.maybe_crash(0, "round_start")
    NULL_INJECTOR.corrupt_checkpoint("/nonexistent", 0)
    spec = _spec(port_api, {})
    sim = SimulatedFederation(
        ClientPopulation.from_spec(spec.population_spec(), "cpu"), spec,
        device="cpu")
    assert sim.faults is NULL_INJECTOR and sim.trainer.faults is NULL_INJECTOR


def test_crash_fires_once_per_schedule():
    inj = FaultInjector(FaultSpec(crash_round=2, crash_phase="pre_chain"))
    inj.maybe_crash(1, "pre_chain")
    inj.maybe_crash(2, "round_start")
    assert inj.will_crash(2, "pre_chain")
    with pytest.raises(InjectedCrash):
        inj.maybe_crash(2, "pre_chain")
    assert not inj.will_crash(2, "pre_chain")
    inj.maybe_crash(2, "pre_chain")               # already crashed: inert
    assert set(CRASH_PHASES) == {"round_start", "pre_chain", "post_checkpoint"}


def test_faulted_run_replays_itself():
    spec = _spec(port_api, CLASSES["all"])
    a, b = port_api.run(spec, device="cpu"), port_api.run(spec, device="cpu")
    for key in ("event_log_digest", "block_hashes_digest", "balances_digest",
                "final_accuracy"):
        assert a.manifest[key] == b.manifest[key]
