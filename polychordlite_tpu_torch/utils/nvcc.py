"""Build and load the port's CUDA kernels (``polychordlite_tpu_torch/csrc``).

Each kernel source is compiled on first use by ``nvcc`` for ``sm_90a`` into
a shared library with a plain ``extern "C"`` interface, loaded with
``ctypes``.  Libraries go to ``build/torch_kernels/`` under the repository
root, named by a hash of the sources, the shared headers (``csrc/*.cuh``)
and the flags, so a changed source is rebuilt and an unchanged one is
reused.  :func:`build_all` starts one ``nvcc`` per library at once.  A
build failure raises: nothing falls back to another engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds spent compiling each library in this process (0.0 when reused)
build_seconds: Dict[str, float] = {}
#: nvcc's output (ptxas register and spill report) of each build
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str, sources: Sequence[str]) -> Path:
    """Where ``lib<name>`` built from ``csrc/<sources>`` lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / s for s in sources] + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, sources: Sequence[str]):
    """Start nvcc for ``lib<name>`` unless it is built; returns (so, proc)."""
    so = library_path(name, sources)
    if so.exists():
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in sources)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    proc.tmp = tmp
    return so, proc


def _finish(name: str, so: Path, proc, t0: float) -> ctypes.CDLL:
    if proc is not None:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise RuntimeError(f"nvcc timed out for {name}") from None
        build_log[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        os.replace(proc.tmp, so)
    build_seconds[name] = time.perf_counter() - t0
    _LIBS[name] = ctypes.CDLL(str(so))
    return _LIBS[name]


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile (if needed) and load ``lib<name>`` from ``csrc/<sources>``."""
    if name in _LIBS:
        return _LIBS[name]
    t0 = time.perf_counter()
    return _finish(name, *_start(name, sources), t0)


def build_all(libraries: Dict[str, Sequence[str]]) -> None:
    """Build the libraries ``{name: sources}`` with one ``nvcc`` each, all
    started together, and load them."""
    t0 = time.perf_counter()
    started = {n: _start(n, srcs) for n, srcs in libraries.items() if n not in _LIBS}
    try:
        for n, (so, proc) in started.items():
            _finish(n, so, proc, t0)
    finally:  # after a failure, stop the builds still running
        for _, proc in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()


#: what some CUDA error codes mean for the port's entry points
_ERRORS = {
    720: "the blocks of a cooperative launch cannot all be resident on the "
         "card at once (cudaErrorCooperativeLaunchTooLarge); its grid "
         "barrier would never release",
}


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}"
                           + (f": {_ERRORS[status]}" if status in _ERRORS else ""))
