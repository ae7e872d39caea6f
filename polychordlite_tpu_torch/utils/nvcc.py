"""Build and load the port's CUDA kernels (``polychordlite_tpu_torch/csrc``).

Each kernel source is compiled on first use by ``nvcc`` for ``sm_90a`` into
a shared library with a plain ``extern "C"`` interface, loaded with
``ctypes``.  Libraries go to ``build/torch_kernels/`` under the repository
root, named by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is reused.  A build failure raises: nothing
falls back to another engine.
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


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile (if needed) and load ``lib<name>`` from ``csrc/<sources>``."""
    if name in _LIBS:
        return _LIBS[name]
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)],
            capture_output=True, text=True, timeout=600,
        )
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{build_log[name]}")
        os.replace(tmp, so)
    build_seconds[name] = time.perf_counter() - t0
    _LIBS[name] = ctypes.CDLL(str(so))
    return _LIBS[name]


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
