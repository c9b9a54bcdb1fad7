"""Build the CUDA kernels with nvcc and load them through ctypes.

Each source under ``csrc/`` compiles into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
libraries go into ``build/`` at the root of the checkout, named by a hash
of the sources and flags, and are built on first use: a later process
reuses them.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# sm_90a: Hopper.  No --use_fast_math, and no fused multiply-add
# contraction, so the kernels round like the plain PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEADERS = ("dvo_common.cuh", "cluster_eval.cuh")

_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, spills, shared memory) of each build made by
# this process, by source name.
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """The nvcc on PATH, else the one under CUDA_HOME (or /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in (f"{name}.cu",) + HEADERS:
        digest.update((CSRC / part).read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all at once (one
    nvcc process each), and return their library paths.  Raises with the
    compiler's output if a build fails."""
    names = list(names)
    paths = {n: _library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    try:
        for n in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failures = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            build_logs[n] = log
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {n}.cu:\n{log}")
            else:
                os.replace(tmp, paths[n])
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
