"""The port's analytic cost model (`repro_torch.launch.flops`) against the
reference's (`repro.launch.flops`), on the CPU: for every architecture of
`ARCHS` and its `reduced()` variant, every shape of `SHAPES` that
`shape_applicable` admits, with `swa_skip` off and on, `step_cost`,
`param_counts`, `forward_flops` (prefill and decode) and `state_bytes`
equal the reference's with `==`: the same terms in the same order give the
same Python floats.  `repro.launch.dryrun` is never imported (it forces
512 host devices at import)."""
import pytest

pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402
from repro.launch import flops as jflops  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, shape_applicable  # noqa: E402
from repro_torch.launch import flops  # noqa: E402

CASES = [(arch, reduced, shape, swa_skip)
         for arch in sorted(ARCHS) for reduced in (False, True)
         for shape in sorted(SHAPES) if shape_applicable(arch, shape)[0]
         for swa_skip in (False, True)]


def _configs(arch, reduced):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    return (cfg.reduced(), jcfg.reduced()) if reduced else (cfg, jcfg)


def test_cases_cover_the_references_applicable_shapes():
    want = sorted((a, s) for a in JARCHS for s in JSHAPES if jshape_applicable(a, s)[0])
    assert sorted({(a, s) for a, _, s, _ in CASES}) == want


@pytest.mark.parametrize("arch,reduced,shape,swa_skip", CASES,
                         ids=[f"{a}-{'reduced' if r else 'full'}-{s}-"
                              f"{'swa_skip' if k else 'masked'}" for a, r, s, k in CASES])
def test_cost_model_equals_reference(arch, reduced, shape, swa_skip):
    cfg, jcfg = _configs(arch, reduced)
    got = flops.step_cost(cfg, SHAPES[shape], swa_skip=swa_skip).as_dict()
    want = jflops.step_cost(jcfg, JSHAPES[shape], swa_skip=swa_skip).as_dict()
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
    assert flops.param_counts(cfg) == jflops.param_counts(jcfg)
    B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    for decode in (False, True):
        assert flops.forward_flops(cfg, B, S, decode=decode, swa_skip=swa_skip) \
            == jflops.forward_flops(jcfg, B, S, decode=decode, swa_skip=swa_skip)
    assert flops.state_bytes(cfg, B, S) == jflops.state_bytes(jcfg, B, S)
