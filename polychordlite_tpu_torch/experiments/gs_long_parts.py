"""Where B2's long path spends its time: the long kernel timed whole and
with one of its two parts left out, on the card.

    python -m polychordlite_tpu_torch.experiments.gs_long_parts [variant ...]

Builds ``csrc/gram_schmidt.cu`` as it is (``whole``) and in copies with
one change each (one nvcc per copy, started together): ``products_only``
drops the panel steps (``gsl_panel``), ``panels_only`` drops the two
products of each pass (``gsl_coefficients``, ``gsl_update``),
``panels_in_scratch`` runs the panel steps in the scratch instead of
shared memory, ``bounds_4`` caps the kernel at 128 registers
(``__launch_bounds__(128, 4)``).  Times each at the geometries of
``chip_smoke.py``'s ``GS_LONG`` (CUDA events), with ptxas's registers and
spills and the resident warps an SM; the copies that compute the whole
function are also held bitwise to the plain version on four chains.  Prints
one JSON line per geometry.  The copies that drop a part compute nothing
useful: they only say what the rest costs.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PRODUCTS = ("gsl_coefficients<T>(wb, cb, ring, dim, ld, j0, pe);\n"
            "                gsl_update<T>(wb, cb, ring, dim, ld, j0, pe);")
PANEL = "gsl_panel<T>(wb, ring, cs, dim, ld, j0, pe, panel_in_smem != 0);"
BOUNDS = "__launch_bounds__(GSL_THREADS)"
VARIANTS = {
    "whole": (),
    "products_only": ((PANEL, ""),),
    "panels_only": ((PRODUCTS, ""),),
    "panels_in_scratch": (("#define GSL_PANEL_SMEM (96 * 1024)", "#define GSL_PANEL_SMEM 0"),),
    "bounds_4": ((BOUNDS, "__launch_bounds__(GSL_THREADS, 4)"),),
}
#: (NB, dim, B, dtype name, repetitions timed)
GEOMETRIES = ((2, 160, 512, "float32", 5), (5, 160, 256, "float32", 5),
              (2, 256, 512, "float32", 3), (2, 512, 512, "float32", 2),
              (2, 160, 512, "float64", 3))


def build(name: str, out: str):
    """nvcc of ``gram_schmidt.cu`` with variant ``name``'s changes, in
    ``out/name``; returns (name, return code, nvcc's output)."""
    sys.path.insert(0, HERE)
    from polychordlite_tpu_torch.utils import nvcc

    csrc = os.path.join(HERE, "polychordlite_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "gram_schmidt.cu")).read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} is not in gram_schmidt.cu")
        src = src.replace(old, new)
    d = os.path.join(out, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), d)
    with open(os.path.join(d, "gram_schmidt.cu"), "w") as f:
        f.write(src)
    p = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
                        os.path.join(d, "gram_schmidt.cu")], capture_output=True, text=True)
    return name, p.returncode, p.stdout + p.stderr


def registers(log: str) -> dict:
    """ptxas's registers and spill stores of the long kernel, by type."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m[1]
        elif entry and "gram_schmidt_long_kernel" in entry:
            t = "float64" if "Id" in entry else "float32"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[f"{t}_registers"] = int(m[1])
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                out[f"{t}_spill_bytes"] = int(m[1])
    return out


def main(names=None) -> None:
    import torch

    sys.path.insert(0, HERE)
    from polychordlite_tpu_torch.ops import pallas_dirs

    if not torch.cuda.is_available():
        raise SystemExit("gs_long_parts times the kernel on the card: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = tempfile.mkdtemp(prefix="gs_long_parts_")
    names = list(names or VARIANTS)
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda n: build(n, out), names))
    libs = {}
    for name, rc, log in built:
        if rc:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        for entry in ("gram_schmidt_f32", "gram_schmidt_f64"):
            getattr(lib, entry).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
        lib.gram_schmidt_long_resident_warps.argtypes = [ctypes.c_int] * 2
        lib.gram_schmidt_scratch_values.argtypes = [ctypes.c_int] * 4
        lib.gram_schmidt_scratch_values.restype = ctypes.c_longlong
        libs[name] = (lib, registers(log))
    print(json.dumps({"card": card, "ptxas": {n: r for n, (_, r) in libs.items()}}), flush=True)
    dev = torch.device("cuda")

    def launch(lib, g, q, scratch):
        NB, dim, _, B = g.shape
        entry = lib.gram_schmidt_f32 if g.dtype == torch.float32 else lib.gram_schmidt_f64
        status = entry(g.data_ptr(), q.data_ptr(), scratch.data_ptr(), NB, dim, B,
                       torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"launch failed with CUDA error {status}")

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    for NB, dim, B, dt_name, reps in GEOMETRIES:
        dt = getattr(torch, dt_name)
        g = torch.randn((NB, dim, dim, B), generator=torch.Generator(dev).manual_seed(dim),
                        device=dev, dtype=dt)
        q = torch.empty_like(g)
        lib0 = next(iter(libs.values()))[0]
        scratch = torch.empty(lib0.gram_schmidt_scratch_values(NB, dim, B, g.element_size()),
                              dtype=dt, device=dev)
        want = pallas_dirs.gram_schmidt_plain(g[..., :4].contiguous())
        row = {"shape": [NB, dim, dim, B], "dtype": dt_name}
        for name, (lib, _) in libs.items():
            rec = {"ms": ms(lambda: launch(lib, g, q, scratch), reps),  # noqa: B023
                   "resident_warps": lib.gram_schmidt_long_resident_warps(dim, g.element_size())}
            if name in ("whole", "panels_in_scratch", "bounds_4"):
                launch(lib, g, q, scratch)
                rec["bitwise_plain"] = bool(torch.equal(q[..., :4], want))
            row[name] = rec
        print(json.dumps(row), flush=True)
        del g, q, scratch
    shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
