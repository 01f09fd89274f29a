"""`repro_torch.api.ExperimentSpec` against `repro.api.ExperimentSpec`: the
same spec hashes to the same `config_digest` and `resume_digest` in both
packages, and either package reads the other's JSON.  A change in any
hashed section moves both digests alike (`faults` only the config digest);
a change in `obs` or `checkpoint` moves neither.  `run()` refuses every
non-default value of a section the port does not run yet (the flight
recorder, the mesh), naming the ROADMAP item that brings it, and accepts
the sections it runs (async, faults, checkpoint)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
import repro_torch.api as port_api  # noqa: E402
from repro_torch.api.runner import check_supported  # noqa: E402

# one changed field in each hashed section (as JSON, for both packages)
HASHED_CHANGES = {
    "default": {},
    "data": {"data": {"n_clients": 500, "beta": 0.5}},
    "train": {"train": {"rounds": 7, "hidden": [32, 16]}},
    "async": {"async": {"buffer_size": 8}},
    "async_": {"async_": {"staleness_alpha": 1.0}},
    "eval": {"eval": {"every": 0}},
    "chain": {"chain": {"rho": 3.0}},
    "mesh-shards": {"mesh": {"shards": 4}},
    "mesh-cohort": {"mesh": {"cohort": "replicated"}},
    "mesh-xla-flags": {"mesh": {"xla_flags": ["--xla_dump_to=x"], "x64": True}},
    "faults": {"faults": {"bad_block_rounds": [2, 5], "retry": True}},
    "engine": {"engine": False},
    "seed": {"seed": 3},
}
OUT_OF_BAND = {
    "obs": {"obs": {"enabled": True, "chrome_path": "t.json"}},
    "checkpoint": {"checkpoint": {"interval": 2, "keep_last": 1}},
}


def _both(d):
    return ref_api.ExperimentSpec.from_dict(d), port_api.ExperimentSpec.from_dict(d)


@pytest.mark.parametrize("case", sorted(HASHED_CHANGES))
def test_digests_agree_across_packages(case):
    ref, port = _both(HASHED_CHANGES[case])
    assert port.config_digest() == ref.config_digest()
    assert port.resume_digest() == ref.resume_digest()
    assert port.to_json() == ref.to_json()
    default = port_api.ExperimentSpec()
    if case != "default":
        assert port.config_digest() != default.config_digest()
        assert (port.resume_digest() == default.resume_digest()) == (case == "faults")


def test_default_digest_is_the_references():
    assert port_api.ExperimentSpec().config_digest() == \
        ref_api.ExperimentSpec().config_digest()


@pytest.mark.parametrize("case", sorted(OUT_OF_BAND))
def test_obs_and_checkpoint_leave_both_digests_unmoved(case):
    ref, port = _both(OUT_OF_BAND[case])
    default = port_api.ExperimentSpec()
    for spec in (ref, port):
        assert spec.config_digest() == default.config_digest()
        assert spec.resume_digest() == default.resume_digest()
    assert port.to_json() == ref.to_json() != default.to_json()


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
@pytest.mark.parametrize("case", ["default", "faults", "mesh-xla-flags", "train"])
def test_json_round_trips_across_packages(case, direction):
    ref, port = _both(HASHED_CHANGES[case] | OUT_OF_BAND["obs"])
    src, dst_cls, want = ((ref, port_api.ExperimentSpec, port)
                          if direction == "ref-to-port"
                          else (port, ref_api.ExperimentSpec, ref))
    got = dst_cls.from_json(src.to_json(indent=2))
    assert got == want
    assert got.config_digest() == src.config_digest()


@pytest.mark.parametrize("d,match", [
    ({"nope": {}}, "unknown spec section"),
    ({"mesh": {"cohort": "both"}}, "mesh cohort"),
    ({"async": {"buffer_size": 0}}, "buffer_size"),
    ({"faults": {"crash_mode": "melt"}}, "crash_mode"),
    ({"faults": {"drop_commit_rounds": [-1]}}, "drop_commit_rounds"),
    ({"obs": {"sample_cap": 4}}, "sample_cap"),
    ({"checkpoint": {"keep_last": 0}}, "keep_last"),
    ({"mesh": {"shards": 2}, "engine": False}, "requires engine=True"),
])
def test_port_validates_like_the_reference(d, match):
    for cls in (ref_api.ExperimentSpec, port_api.ExperimentSpec):
        with pytest.raises(ValueError, match=match):
            cls.from_dict(d)


# a match of None: the port runs this section now, so run() must accept it
REFUSED = {
    "async": (dict(async_=port_api.AsyncSpec(buffer_size=8)), None),
    "faults": (dict(faults=port_api.FaultSpec(retry=True)), None),
    "obs": (dict(obs=port_api.ObsSpec(enabled=True)), "item 5b"),
    "checkpoint": (dict(checkpoint=port_api.CheckpointSpec(interval=1)), None),
    "mesh-cohort": (dict(mesh=port_api.MeshSpec(cohort="replicated")), "item 6"),
    "mesh-platform": (dict(mesh=port_api.MeshSpec(platform="gpu")), "item 6"),
    "mesh-x64": (dict(mesh=port_api.MeshSpec(x64=True)), "item 6"),
    "mesh-xla-flags": (dict(mesh=port_api.MeshSpec(xla_flags=("--x",))), "item 6"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_run_refuses_sections_it_does_not_run(case):
    change, match = REFUSED[case]
    spec = dataclasses.replace(port_api.ExperimentSpec(), **change)
    if match is None:
        check_supported(spec)
        return
    with pytest.raises(NotImplementedError, match=match):
        port_api.run(spec, device="cpu")
