"""The reference's framework-neutral replay rules over the port.

`repro.analysis.rules.run_source_rules` with `det-wallclock` (no wall-clock
read in a replay module: `sim/`, `core/`, `blockchain/`, `serve/`,
`checkpoint/state.py`), `det-global-rng` (no draw from numpy's or the
stdlib's global generator) and `tree-order` (no unordered dict iteration
feeding a reduction in `core/baselines.py` or `utils/tree.py`) must find
nothing in `src/repro_torch`: equal event logs and exact resume depend on
all three.  The rules read paths relative to the source root, which is
the port's package directory, so they see its replay modules under the
same names as the reference's.

The reference's rules do not look at torch's generators, so a second scan
holds the port's replay modules to the same contract there: every torch
random draw names its `generator=`, and nothing reseeds the global one."""
import ast
from pathlib import Path

import pytest

from repro.analysis.rules import REPLAY_DIR_PREFIXES, REPLAY_FILES, run_source_rules

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
RULES = ["det-wallclock", "det-global-rng", "tree-order"]
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
               "randint_like", "normal", "bernoulli", "multinomial", "poisson"}
TORCH_RESEEDS = {"manual_seed", "seed", "set_rng_state"}


@pytest.mark.parametrize("rule", RULES)
def test_replay_rules_find_nothing_in_the_port(rule):
    findings = run_source_rules(str(PKG), prefix="src/repro_torch/", rule_ids=[rule])
    assert findings == []


def test_the_rules_see_the_ports_replay_modules():
    rel = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    replay = {r for r in rel if r.startswith(REPLAY_DIR_PREFIXES) or r in REPLAY_FILES}
    assert {"sim/driver.py", "sim/async_agg.py", "core/engine.py", "core/round.py",
            "checkpoint/state.py", "blockchain/chain.py"} <= replay


def _torch_global_rng_calls(tree: ast.AST) -> list[tuple[int, str]]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
            continue
        owner, name = node.func.value, node.func.attr
        is_torch = isinstance(owner, ast.Name) and owner.id == "torch" or (
            isinstance(owner, ast.Attribute) and owner.attr in ("random", "cuda"))
        if not is_torch:
            continue
        keywords = {k.arg for k in node.keywords}
        if name in TORCH_DRAWS and "generator" not in keywords or name in TORCH_RESEEDS:
            out.append((node.lineno, name))
    return out


def test_replay_modules_draw_from_no_global_torch_generator():
    bad = {}
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        if rel.startswith(REPLAY_DIR_PREFIXES) or rel in REPLAY_FILES:
            calls = _torch_global_rng_calls(ast.parse(path.read_text()))
            if calls:
                bad[rel] = calls
    assert bad == {}


def test_the_torch_scan_catches_a_global_draw():
    src = ("import torch\nx = torch.rand(3)\ny = torch.randn(2, generator=g)\n"
           "torch.manual_seed(0)\nz = torch.cuda.manual_seed(1)\n")
    assert _torch_global_rng_calls(ast.parse(src)) == [(2, "rand"), (4, "manual_seed"),
                                                        (5, "manual_seed")]
