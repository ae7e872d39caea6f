"""B2 at dims 33 to 128 timed on the card: the parent's wide kernel, this
tree's, and the long path forced down from dim 33, in turns.

    python -m polychordlite_tpu_torch.experiments.gs_wide_times PARENT [variant ...]

``PARENT`` is a directory holding another checkout's
``polychordlite_tpu_torch/csrc`` (for instance ``git archive HEAD~ | tar -x
-C build/parent``, made before the call: the card's copy of the repository
has no git).  Builds ``csrc/gram_schmidt.cu`` as each variant (one nvcc
each, started together): ``parent`` (the other checkout's source, with an
occupancy probe appended), ``tree`` (this checkout's), ``long33`` (this
checkout's with the long path's dispatch and scratch lowered from dim 128
to dim 32: blocked CGS2, four warps a basis, from dim 33), ``w1`` ..
``w8`` (this checkout's with the wide kernel's bases a block fixed at 1, 2,
4 or 8 wherever they fit, in place of its rule) and ``kc<n>`` (this
checkout's with the wide kernel's coefficients a chunk fixed at n).  Times each at
:data:`GEOMETRIES` by CUDA events, the variants in turns (forward, then
backward, :data:`ROUNDS` times), beside one batched ``torch.linalg.qr`` of
the same bases; prints ptxas's registers and spills of every wide and long
kernel, and per geometry the resident warps an SM of each variant, each
one's largest difference from its own plain order on a few chains (the
long order for ``long33``, this tree's ``gram_schmidt_plain`` for the
others; the parent is held to QtQ = I only) and the bound (bytes once
over 3.35 TB/s or the operations over 67 TFLOP/s in float32, 34 in
float64, the larger).  One JSON line per geometry.
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
#: the long path's dispatch and scratch size, lowered from GS_MAXD_WIDE to GS_MAXD
LONG33 = (("    if (dim > GS_MAXD_WIDE)\n        return gram_schmidt_long(",
           "    if (dim > GS_MAXD)\n        return gram_schmidt_long("),
          ("    if (dim <= GS_MAXD_WIDE) return 0;", "    if (dim <= GS_MAXD) return 0;"))
#: the wide kernel's rule for its bases a block, replaced by the most that
#: fit up to n (``w<n>``)
WIDE_RULE = "score[x] >= 0.85 * best"
#: the wide kernel's coefficients a chunk, fixed in both types (``kc<n>``;
#: csrc/gram_schmidt_wide.cuh)
WIDE_CHUNK = "static constexpr int KC = sizeof(T) == 4 ? 32 : 16;"
#: the parent's wide kernel (one warp a block, dim^2 values of shared memory):
#: its resident warps an SM
PARENT_PROBE = r"""
extern "C" int gs_wide_times_parent_warps(int dim, int bytes) {
    int blocks = 0;
    const int smem = bytes * dim * dim;
    if (bytes == 8) {
        cudaFuncSetAttribute((const void*)gram_schmidt_wide_kernel<double>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gram_schmidt_wide_kernel<double>,
                                                      32, smem);
    } else {
        cudaFuncSetAttribute((const void*)gram_schmidt_wide_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gram_schmidt_wide_kernel<float>,
                                                      32, smem);
    }
    return blocks;
}
"""
#: (NB, dim, B, dtype name, launches timed)
GEOMETRIES = ((2, 40, 128, "float64", 20), (2, 64, 256, "float32", 20),
              (2, 64, 512, "float32", 20), (2, 64, 512, "float64", 10),
              (2, 40, 512, "float32", 20), (2, 128, 512, "float32", 5),
              (5, 64, 8192, "float32", 3))
ROUNDS = 2
#: the chains held to the plain version
CHECK_CHAINS = 4
HBM_BYTES_PER_S, F32_FLOPS_PER_S, F64_FLOPS_PER_S = 3.35e12, 67e12, 34e12


def variant_source(name: str, parent: str) -> str:
    """The text of ``gram_schmidt.cu`` as variant ``name``."""
    root = parent if name == "parent" else HERE
    src = open(os.path.join(root, "polychordlite_tpu_torch", "csrc", "gram_schmidt.cu")).read()
    if name == "parent":
        return src + PARENT_PROBE
    patches = ()
    if name == "long33":
        patches = LONG33
    elif re.fullmatch(r"w\d", name):
        patches = ((WIDE_RULE, f"(1 << x) <= {name[1]}"),)
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} is not in gram_schmidt.cu")
        src = src.replace(old, new)
    return src


def header_source(name: str, parent: str, header: str) -> str:
    """The text of ``csrc/<header>`` as variant ``name``."""
    root = parent if name == "parent" else HERE
    src = open(os.path.join(root, "polychordlite_tpu_torch", "csrc", header)).read()
    if re.fullmatch(r"kc\d+", name) and header == "gram_schmidt_wide.cuh":
        if WIDE_CHUNK not in src:
            raise RuntimeError(f"{name}: {WIDE_CHUNK!r} is not in {header}")
        src = src.replace(WIDE_CHUNK, f"static constexpr int KC = {name[2:]};")
    return src


def build(name: str, parent: str, out: str):
    """nvcc of variant ``name`` in ``out/name``; returns (name, return code,
    nvcc's output)."""
    sys.path.insert(0, HERE)
    from polychordlite_tpu_torch.utils import nvcc

    root = parent if name == "parent" else HERE
    csrc = os.path.join(root, "polychordlite_tpu_torch", "csrc")
    d = os.path.join(out, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            with open(os.path.join(d, f), "w") as out_f:
                out_f.write(header_source(name, parent, f))
    with open(os.path.join(d, "gram_schmidt.cu"), "w") as f:
        f.write(variant_source(name, parent))
    p = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
                        os.path.join(d, "gram_schmidt.cu")], capture_output=True, text=True)
    return name, p.returncode, p.stdout + p.stderr


def registers(log: str) -> dict:
    """ptxas's registers, stack frame and spill stores of the wide and long
    kernels."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m[1]
        elif entry and re.search(r"gram_schmidt_(wide|long)_kernel", entry):
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(entry, {})["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes stack frame", line)
            if m:
                out.setdefault(entry, {})["stack_bytes"] = int(m[1])
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                out.setdefault(entry, {})["spill_bytes"] = int(m[1])
    return out


def gram_schmidt_flops(NB: int, D: int, B: int) -> int:
    """Operations of CGS2 on NB B bases of D vectors (``chip_smoke.py``'s count)."""
    return NB * B * (2 * sum(4 * D * k for k in range(D)) + D * (3 * D + 1))


def main(parent: str, names=None) -> None:
    import torch

    sys.path.insert(0, HERE)
    from polychordlite_tpu_torch.ops import pallas_dirs

    if not torch.cuda.is_available():
        raise SystemExit("gs_wide_times times the kernels on the card: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = tempfile.mkdtemp(prefix="gs_wide_times_")
    names = list(names or ("parent", "tree", "long33"))
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda n: build(n, parent, out), names))
    libs = {}
    for name, rc, log in built:
        if rc:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        for entry in ("gram_schmidt_f32", "gram_schmidt_f64"):
            getattr(lib, entry).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
        lib.gram_schmidt_scratch_values.argtypes = [ctypes.c_int] * 4
        lib.gram_schmidt_scratch_values.restype = ctypes.c_longlong
        libs[name] = (lib, registers(log))
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "ptxas": {n: r for n, (_, r) in libs.items()}}), flush=True)
    dev = torch.device("cuda")

    def resident_warps(name, lib, NB, dim, nbytes, B):
        if name == "parent":
            lib.gs_wide_times_parent_warps.argtypes = [ctypes.c_int] * 2
            return lib.gs_wide_times_parent_warps(dim, nbytes)
        if name == "long33":
            lib.gram_schmidt_long_resident_warps.argtypes = [ctypes.c_int] * 2
            return lib.gram_schmidt_long_resident_warps(dim, nbytes)
        lib.gram_schmidt_wide_blocks.argtypes = [ctypes.c_int] * 4
        nw, blocks = divmod(lib.gram_schmidt_wide_blocks(NB, dim, B, nbytes), 100)
        return {"bases_a_block": nw, "warps": nw * blocks}

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
        n_scratch = max(lib.gram_schmidt_scratch_values(NB, dim, B, g.element_size())
                        for lib, _ in libs.values())
        scratch = torch.empty(max(n_scratch, 1), dtype=dt, device=dev)
        few = g[..., :CHECK_CHAINS].contiguous()
        plain = {"tree": pallas_dirs.gram_schmidt_plain(few),
                 "long33": pallas_dirs._gram_schmidt_long_plain(few)}
        row = {"shape": [NB, dim, dim, B], "dtype": dt_name, "ms": {n: [] for n in libs}}
        for name, (lib, _) in libs.items():
            qf = torch.empty_like(few)
            launch(lib, few, qf, scratch)
            launch(lib, g, q, scratch)
            torch.cuda.synchronize()
            eye = torch.eye(dim, device=dev, dtype=dt)[None, :, :, None]
            want = None if name == "parent" else plain["long33" if name == "long33" else "tree"]
            row[name] = {
                "resident_warps": resident_warps(name, lib, NB, dim, g.element_size(), B),
                "orth_err": (torch.einsum("nikb,nijb->nkjb", q, q) - eye).abs().max().item(),
                "max_abs_diff_plain": None if want is None else (qf - want).abs().max().item(),
                "chains_bitwise_first": bool(torch.equal(q[..., :CHECK_CHAINS], qf))}
        order = list(libs)
        for _ in range(ROUNDS):
            for name in order + order[::-1]:
                row["ms"][name].append(ms(lambda: launch(libs[name][0], g, q, scratch),  # noqa: B023
                                          reps))
        mats = g.permute(0, 3, 1, 2).reshape(-1, dim, dim).contiguous()
        row["qr_ms"] = ms(lambda: torch.linalg.qr(mats), 1)  # noqa: B023
        rate = F32_FLOPS_PER_S if dt == torch.float32 else F64_FLOPS_PER_S
        t_bytes = 2 * g.element_size() * g.numel() / HBM_BYTES_PER_S * 1e3
        t_ops = gram_schmidt_flops(NB, dim, B) / rate * 1e3
        row["bound_ms"], row["bound_by"] = max((t_bytes, "bytes"), (t_ops, "operations"))
        print(json.dumps(row), flush=True)
        del g, q, scratch, mats
    shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2:])
