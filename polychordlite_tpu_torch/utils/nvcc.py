"""Build and load the port's CUDA kernels (``polychordlite_tpu_torch/csrc``).

Each kernel source is compiled on first use by ``nvcc`` for ``sm_90a`` into
a shared library with a plain ``extern "C"`` interface, loaded with
``ctypes``.  Libraries go to ``build/torch_kernels/`` under the repository
root, named by a hash of the sources, the shared headers (``csrc/*.cuh``)
and the flags, so a changed source is rebuilt and an unchanged one is
reused.  :func:`build_all` starts one ``nvcc`` per library at once.  A
build failure raises: nothing falls back to another engine.

A library may also be one of :data:`DEFINES`, its sources compiled with a
macro defined (a second library from one source); the macro is hashed into
its name with the sources.

A library may also take one generated header (the fused route's
likelihood functor, ``ops/fused_like.py``): its text is written to
``build/torch_kernels/gen/<library>/`` as :data:`GENERATED_HEADER`, that
directory goes on the include path, and the text is hashed into the
library's name with the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
GEN_DIR = BUILD_DIR / "gen"
#: the file name a generated header is included by
GENERATED_HEADER = "fused_like.cuh"
#: the shared memory one block may have on sm_90 (227 KB): the bound of the
#: stream bucket and of B2's long kernel (SLICE_SMEM_MAX of
#: ``csrc/slice_common.cuh`` and GS_SMEM_MAX of ``csrc/gram_schmidt.cu``)
SMEM_MAX = 232448
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the macros a library is built with, by name: the ring engine's B1
#: (``csrc/slice_epoch.cu`` under ``RingPolicy``), which the library
#: ``slice_epoch`` does not build, so that its kernels stay what they were;
#: and B3's wide and stream buckets (``csrc/slice_epoch_v5.cu``), a library
#: of their own beside the SLICE_MAXD bucket's ``slice_epoch_v5``
DEFINES: Dict[str, Tuple[str, ...]] = {"slice_epoch_ring": ("SLICE_EPOCH_RING",),
                                       "slice_epoch_v5_wide": ("SLICE_EPOCH_V5_WIDE",)}

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


def library_path(name: str, sources: Sequence[str], header: Optional[str] = None) -> Path:
    """Where ``lib<name>`` built from ``csrc/<sources>`` (and the generated
    ``header`` text, if any) lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + _macros(name)).encode())
    for p in [CSRC / s for s in sources] + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    if header is not None:
        digest.update(GENERATED_HEADER.encode())
        digest.update(header.encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _macros(name: str) -> Tuple[str, ...]:
    """nvcc's ``-D`` flags for library ``name`` (:data:`DEFINES`)."""
    return tuple(f"-D{m}" for m in DEFINES.get(name, ()))


def _start(name: str, sources: Sequence[str], header: Optional[str] = None):
    """Start nvcc for ``lib<name>`` unless it is built; returns (so, proc)."""
    so = library_path(name, sources, header)
    if so.exists():
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    include = []
    if header is not None:
        gen = GEN_DIR / so.stem
        gen.mkdir(parents=True, exist_ok=True)
        # written whole under another name and moved in, as the library is:
        # two processes that lower the same model write the same header, and
        # neither nvcc may read it half written
        part = gen / f"{GENERATED_HEADER}.{os.getpid()}.tmp"
        part.write_text(header)
        os.replace(part, gen / GENERATED_HEADER)
        include = ["-I", str(gen)]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, *_macros(name), *include, "-o", str(tmp),
         *(str(CSRC / s) for s in sources)],
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


def is_loaded(name: str) -> bool:
    """Whether ``lib<name>`` is loaded in this process already."""
    return name in _LIBS


def load(name: str, sources: Sequence[str], header: Optional[str] = None) -> ctypes.CDLL:
    """Compile (if needed) and load ``lib<name>`` from ``csrc/<sources>``
    and the generated ``header`` text."""
    if name in _LIBS:
        return _LIBS[name]
    t0 = time.perf_counter()
    return _finish(name, *_start(name, sources, header), t0)


def build_all(libraries: Dict[str, Sequence[str]],
              headers: Optional[Dict[str, str]] = None) -> None:
    """Build the libraries ``{name: sources}`` (with the generated header
    ``headers[name]``, where given) with one ``nvcc`` each, all started
    together, and load them."""
    headers = headers or {}
    t0 = time.perf_counter()
    started = {n: _start(n, srcs, headers.get(n)) for n, srcs in libraries.items()
               if n not in _LIBS}
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
