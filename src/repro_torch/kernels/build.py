"""Build and load the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` compiles on its own, with a plain C interface, into
``build/repro_torch/lib<name>.so`` at the root of the checkout, at first
use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/lib<name>.so csrc/<name>.cu

All sources build in parallel (one ``nvcc`` each, started together), in
seconds, because none includes PyTorch's headers; the libraries load with
``ctypes``, pointers and the stream passed as ``c_void_p``.  Fast-math is
never on: the kernels rely on IEEE division and explicit rounding.  A
failed build raises, with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "build_all", "load_library", "load_function"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all() -> dict:
    """Compile every stale ``csrc/*.cu`` in parallel.  Returns
    ``{name: {"seconds": wall, "log": compiler output}}`` for the sources
    it built (empty when all libraries are current)."""
    names = [p.stem for p in sorted(CSRC.glob("*.cu"))]
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if missing or stale."""
    if _stale(name):
        build_all()
    return ctypes.CDLL(str(_lib_path(name)))


@functools.lru_cache(maxsize=None)
def load_function(lib: str, name: str, argtypes: tuple):
    """C function ``name`` of ``lib<lib>.so`` with its ctypes signature set
    (every kernel entry point returns the launch's CUDA error code)."""
    fn = getattr(load_library(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
