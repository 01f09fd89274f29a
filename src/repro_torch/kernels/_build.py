"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point (no PyTorch headers, so a build takes
seconds, not minutes).  Libraries land in ``build/repro_torch/`` at the root
of the checkout (listed in ``.gitignore``), named by a hash of the sources
and flags: editing a source rebuilds it, an unchanged one loads as built.
:func:`build` starts one ``nvcc`` per stale source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin): "
                       "the port's CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: named by a hash of the source and
    the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: list[str] | None = None) -> None:
    """Compile every stale source (default: all of ``csrc/*.cu``) with one
    ``nvcc`` each, started together.  Raises with the compiler's output if
    any fails; writes each compiler log (``-Xptxas -v``) beside its library."""
    if sources is None:
        sources = sorted(p.name for p in CSRC.glob("*.cu"))
    todo = [(s, library_path(s)) for s in sources if not library_path(s).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for source, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"{source}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load_counts() -> dict[str, int]:
    """``{source: 1}`` for every library this process has loaded — the
    port's counterpart of the reference's jit cache sizes: a source appears
    once its library was first loaded (and built, if stale), which is what
    the flight recorder's ``compile`` events report."""
    return {source: 1 for source in sorted(_libs)}


def load(source: str) -> ctypes.CDLL:
    """The built library of ``csrc/<source>``, building it first if stale."""
    lib = _libs.get(source)
    if lib is None:
        build([source])
        lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
    return lib
