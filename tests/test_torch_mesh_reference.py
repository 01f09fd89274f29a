"""The port's client-sharded mesh against the reference's engine, on the CPU.

The reference's contract (`tests/test_sharded_engine.py`) makes its
shards=1 engine run equal to its own run at S shards, bit for bit.  The
port at S = 4, from the reference's initial population (carried across
with the `params` setter, which splits the rows over the shards), meets
the parity `tests/test_torch_run.py` holds the one-device port to: the same
event log and number of blocks, the chain valid and the ledger conserved
on both, final accuracy within ACC_TOL."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
from repro.sim import ClientPopulation as JPopulation  # noqa: E402
from repro.sim import SimulatedFederation as JSimulation  # noqa: E402
from repro_torch.api import DataSpec, EvalSpec, ExperimentSpec, MeshSpec, TrainSpec  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.sim.driver import SimulatedFederation  # noqa: E402
from repro_torch.sim.population import ClientPopulation  # noqa: E402

ACC_TOL = 0.01          # tests/test_torch_run.py's port-vs-reference tolerance
SMALL = dict(data=dict(n_clients=60),
             train=dict(sample_frac=0.25, rounds=3, hidden=(16,), rep_dim=8),
             eval=dict(every=2, clients=16, examples=256))


@pytest.mark.parametrize("cohort", ["sharded", "replicated"])
def test_port_at_four_shards_against_the_reference(cohort):
    rspec = ref_api.ExperimentSpec(data=ref_api.DataSpec(**SMALL["data"]),
                                   train=ref_api.TrainSpec(**SMALL["train"]),
                                   eval=ref_api.EvalSpec(**SMALL["eval"]))
    jsim = JSimulation(JPopulation.from_spec(rspec.population_spec()), rspec)
    init = {k: np.array(v) for k, v in jsim.params.items()}
    jrep = jsim.run()
    jm = ref_api.build_manifest(rspec, jsim, jrep)
    tspec = ExperimentSpec(data=DataSpec(**SMALL["data"]),
                           train=TrainSpec(**SMALL["train"]),
                           eval=EvalSpec(**SMALL["eval"]),
                           mesh=MeshSpec(shards=4, cohort=cohort))
    tsim = SimulatedFederation(
        ClientPopulation.from_spec(tspec.population_spec(), "cpu"), tspec,
        device="cpu")
    tsim.params = params_from_numpy(init, device="cpu")
    assert [tuple(t.shape) for t in tsim.arena.shards] == [(15, tsim.arena.n_params)] * 4
    np.testing.assert_array_equal(tsim.arena.host_rows(),
                                  np.concatenate([init[k].reshape(60, -1) for k in
                                                  sorted(init)], axis=1))
    trep = tsim.run()
    assert tsim.engine.cohort_mode == cohort
    assert trep.event_log == jrep.event_log
    assert trep.chain_valid and trep.ledger_conserved
    assert jm["chain_valid"] and jm["ledger_conserved"]
    assert trep.n_blocks == jm["n_blocks"]
    assert 0.0 < trep.final_accuracy <= 1.0
    assert abs(trep.final_accuracy - jm["final_accuracy"]) <= ACC_TOL
