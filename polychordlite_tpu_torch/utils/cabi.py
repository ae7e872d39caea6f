"""Build the port's C ABI (``polychordlite_tpu_torch/cabi``) with ``gcc`` and
``g++`` at first use, into ``build/cabi/`` under the repository root
(gitignored), as ``utils/nvcc.py`` builds the CUDA kernels.

Two ways to reach the shim ``cabi/capi.c``, which imports
``polychordlite_tpu_torch.capi``:

* **embedded** — a C or C++ program links the shim and libpython and
  starts its own interpreter (``capi``: ``libpolychordlite_tpu_torch.so``;
  ``cpp``: ``libpolychordlite_tpu_torch_cpp.so``, the C++ layer
  ``cabi/polychord_cpp.cpp`` over it; ``cc_example``: the shipped
  ``examples/cc/gaussian_cc.cpp``, compiled unchanged against
  ``cabi/polychord.hpp``).  The program needs :func:`embedded_env`'s
  ``PYTHONPATH`` to reach the package, torch and numpy.
* **in process** — :func:`build_in_process` links the shim with a C or
  C++ driver into a shared object without libpython, for a running Python
  to load with ``ctypes.PyDLL`` (which holds the GIL across the call: the
  shim calls the Python API) and call a driver function of.

The link flags are the running interpreter's own (``sysconfig``: its
include directory, ``LIBDIR`` and ``-lpythonX.Y -ldl -lm``, what
``python3-config --embed --ldflags`` gives for it).  A product is rebuilt
when a hash of its sources and command changes.  A failed compile raises.

``python -m polychordlite_tpu_torch.utils.cabi capi|cpp|cc_example`` builds
one product and prints its path (the Makefile's ``capi_torch``,
``cpp_torch`` and ``cc_example_torch`` targets call it).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Dict, List, Sequence

CABI = Path(__file__).resolve().parent.parent / "cabi"
ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build" / "cabi"
EXAMPLE = ROOT / "examples" / "cc" / "gaussian_cc.cpp"
#: the products of the embedded mode and their file names
PRODUCTS = {"capi": "libpolychordlite_tpu_torch.so", "cpp": "libpolychordlite_tpu_torch_cpp.so",
            "cc_example": "gaussian_cc"}


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: the C ABI is built with gcc and g++")
    return found


def python_include() -> str:
    return sysconfig.get_paths()["include"]


def python_ldflags() -> List[str]:
    """The running interpreter's embedding link flags."""
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{ver}", "-ldl", "-lm"]


def embedding_possible() -> bool:
    """Whether a program can embed this interpreter: gcc and g++ are
    there, and so are ``Python.h`` and a shared libpython of this
    interpreter's version."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    lib = sysconfig.get_config_var("LDLIBRARY") or ""
    return (shutil.which("gcc") is not None and shutil.which("g++") is not None
            and os.path.exists(os.path.join(python_include(), "Python.h"))
            and bool(sysconfig.get_config_var("Py_ENABLE_SHARED"))
            and lib.endswith(".so") and os.path.exists(os.path.join(libdir, lib)))


def embedded_env(env: Dict[str, str] = None) -> Dict[str, str]:
    """``env`` (the process's by default) with ``PYTHONPATH`` reaching the
    repository and this interpreter's site-packages, for an embedded
    interpreter, whose own paths are its installation's."""
    env = dict(os.environ if env is None else env)
    site = [p for p in sys.path if p.endswith(("site-packages", "dist-packages"))]
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + site + [env.get("PYTHONPATH", "")])
    return env


def _run_steps(out: Path, steps: Sequence[Sequence[str]], inputs: Sequence[Path]) -> Path:
    """Run the compile ``steps`` for ``out`` unless a stamp beside it holds
    the hash of ``inputs`` and the steps."""
    digest = hashlib.sha256(repr([list(s) for s in steps]).encode())
    for p in inputs:
        digest.update(p.read_bytes())
    stamp = out.with_name(out.name + ".hash")
    if out.exists() and stamp.exists() and stamp.read_text() == digest.hexdigest():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for cmd in steps:
        proc = subprocess.run(list(cmd), capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"the C ABI build failed: {' '.join(cmd)}\n{proc.stderr}")
    stamp.write_text(digest.hexdigest())
    return out


def commands(target: str) -> List[List[str]]:
    """The compile commands of an embedded-mode product (:data:`PRODUCTS`),
    each one's own prerequisites included."""
    gcc, gxx = _tool("gcc"), _tool("g++")
    inc, ld = f"-I{python_include()}", python_ldflags()
    lib = BUILD_DIR / PRODUCTS[target]
    obj = BUILD_DIR / "capi.o"
    if target == "capi":
        return [[gcc, "-O2", "-shared", "-fPIC", inc, "-o", str(lib), str(CABI / "capi.c"), *ld]]
    cpp = [[gcc, "-O2", "-c", "-fPIC", inc, "-o", str(obj), str(CABI / "capi.c")],
           [gxx, "-O2", "-shared", "-fPIC", f"-I{CABI}", inc, "-o",
            str(BUILD_DIR / PRODUCTS["cpp"]), str(CABI / "polychord_cpp.cpp"), str(obj), *ld]]
    if target == "cpp":
        return cpp
    if target == "cc_example":
        return cpp + [[gxx, "-O2", f"-I{CABI}", "-o", str(lib), str(EXAMPLE), f"-L{BUILD_DIR}",
                       "-lpolychordlite_tpu_torch_cpp", f"-Wl,-rpath,{BUILD_DIR}", *ld]]
    raise ValueError(f"unknown C ABI product {target!r}; have {tuple(PRODUCTS)}")


def build(target: str) -> Path:
    """Build an embedded-mode product (:data:`PRODUCTS`) if needed; its path."""
    inputs = [CABI / n for n in ("capi.c", "capi.h", "polychord.hpp", "polychord_cpp.cpp")]
    if target == "cc_example":
        inputs.append(EXAMPLE)
    return _run_steps(BUILD_DIR / PRODUCTS[target], commands(target), inputs)


def build_in_process(name: str, drivers: Sequence[Path], cpp: bool = False,
                     defines: Sequence[str] = ()) -> Path:
    """``build/cabi/lib<name>.so``: the shim (with the C++ layer if
    ``cpp``) and the ``drivers`` sources, linked without libpython, for
    ``ctypes.PyDLL`` in a running interpreter; ``defines`` are ``-D``
    flags for the drivers (``main=...`` renames a program's entry)."""
    gcc, gxx = _tool("gcc"), _tool("g++")
    inc = f"-I{python_include()}"
    out = BUILD_DIR / f"lib{name}.so"
    obj = BUILD_DIR / f"{name}_capi.o"
    drivers = [Path(d) for d in drivers]
    steps = [[gcc, "-O2", "-c", "-fPIC", inc, "-o", str(obj), str(CABI / "capi.c")],
             [gxx if cpp else gcc, "-O2", "-shared", "-fPIC", f"-I{CABI}", inc,
              *(f"-D{d}" for d in defines), "-o", str(out),
              *([str(CABI / "polychord_cpp.cpp")] if cpp else []), *map(str, drivers), str(obj)]]
    inputs = [CABI / n for n in ("capi.c", "capi.h", "polychord.hpp", "polychord_cpp.cpp")]
    return _run_steps(out, steps, inputs + drivers)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1 or args[0] not in PRODUCTS:
        print(f"usage: python -m polychordlite_tpu_torch.utils.cabi {{{','.join(PRODUCTS)}}}",
              file=sys.stderr)
        return 2
    for cmd in commands(args[0]):
        print(" ".join(cmd))
    print(build(args[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
