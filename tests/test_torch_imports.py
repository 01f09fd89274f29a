"""The port stands alone: `repro_torch` imports neither `jax` nor anything
of `repro` (checked in a fresh interpreter and by an AST scan, with
`chip_smoke.py`, `profile_round.py`, `profile_lm.py` and
`kernel_ablation.py`), and its entry
points run on the card unless the caller asks for the CPU — without CUDA
they raise instead of falling back."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import ExperimentSpec, run  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    arena_from_numpy,
    lm_params_from_numpy,
    params_from_numpy,
)
from repro_torch.kernels import cluster_agg as tagg  # noqa: E402
from repro_torch.kernels import fingerprint as tfp  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import pearson as tpearson  # noqa: E402
from repro_torch.kernels import rwkv6_scan as twkv  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402
from repro_torch.models import decode as tdecode  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve import load_bank  # noqa: E402
from repro_torch.sim.population import ClientPopulation, PopulationSpec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(mods), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 70 and bad.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py", ROOT / "profile_round.py",
                            ROOT / "profile_lm.py", ROOT / "kernel_ablation.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour without CUDA")


def test_default_device_raises_without_cuda(tmp_path):
    _needs_no_cuda()
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = tclf.MLPConfig(in_dim=4, hidden=(3,), rep_dim=2, num_classes=2)
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda:0"),
        lambda: tclf.init_mlp(cfg, torch.Generator()),
        lambda: tclf.init_stacked(cfg, torch.Generator(), 2),
        lambda: params_from_numpy({"w": np.zeros(3, np.float32)}),
        lambda: arena_from_numpy(np.zeros((1, 3), np.float32), [("['w']", (3,))]),
        lambda: load_bank(str(tmp_path / "never-read.npz")),
        lambda: run(ExperimentSpec()),
        lambda: ClientPopulation.from_spec(PopulationSpec(n_clients=4)),
        lambda: tt.init_params(ARCHS["gemma3-4b"].reduced()),
        lambda: tdecode.init_cache(ARCHS["rwkv6-3b"].reduced(), 1, 4),
        lambda: lm_params_from_numpy({"layers": [{"w": np.zeros(3, np.float32)}]}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cuda_kernel_wrapper_never_runs_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfp.fingerprint_cuda(torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpearson.pearson_cuda(torch.zeros((2, 8)))
    labels = torch.zeros((2,), dtype=torch.long)
    wo, denom = tagg.cluster_weights(labels, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tagg.cluster_agg_cuda(torch.zeros((2, 8)), labels, wo, denom)
    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(q, q, q)
    r = torch.zeros((1, 1, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        twkv.rwkv6_cuda(r, r, r, r, torch.zeros((1, 8)), torch.zeros((1, 1, 8, 8)))


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    _needs_no_cuda()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_profile_round_fails_without_cuda():
    _needs_no_cuda()
    out = subprocess.run([sys.executable, str(ROOT / "profile_round.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"profile"' not in out.stdout


def test_profile_lm_fails_without_cuda():
    _needs_no_cuda()
    out = subprocess.run([sys.executable, str(ROOT / "profile_lm.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"profile_lm"' not in out.stdout
