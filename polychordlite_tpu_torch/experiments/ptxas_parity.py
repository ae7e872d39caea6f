"""ptxas's report of every kernel of this checkout against another
checkout's: a change to a kernel template that must leave the old
instantiations as they were is held to their registers, stack frames,
spills and shared memory, kernel by kernel.

    python polychordlite_tpu_torch/experiments/ptxas_parity.py <other checkout> [out dir]

Compiles, with the port's nvcc flags (``utils/nvcc.py``), one nvcc each and
eight at a time, the functor libraries ``slice_epoch.cu`` (and its ring
build), ``slice_epoch_v2.cu``, ``slice_epoch_v3.cu`` and
``slice_epoch_v5.cu`` and B2's ``gram_schmidt.cu`` of both checkouts (and this one's B3 wide and stream
library, ``SLICE_EPOCH_V5_WIDE``, whose kernels are all added), and each
one's ``slice_epoch_fused.cu`` with the B1 and ring headers that its own
``ops/fused_like.py`` generates for a per-point torch Gaussian at D = 20
(G = 16), 64 and 160 (G = 32).  Prints one JSON line: whether the generated
headers are the same text in both, each build's exit code, and per library
the kernels of the other checkout, those missing here and those whose
report differs (with the first few names), and apart those of the D <= 32
instantiations (a functor of the SLICE_MAXD bucket, ``...LikeILi32EE``, B2's
thread-per-basis kernel, or a fused library generated at D <= 32, with both
reports' lines), with
``n_differ_d32`` their sum over every library.  Kernels this checkout adds are counted and listed apart.
Needs nvcc; touches no card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LIBRARIES = (("slice_epoch", "slice_epoch.cu", ()),
             ("slice_epoch_ring", "slice_epoch.cu", ("SLICE_EPOCH_RING",)),
             ("slice_epoch_v2", "slice_epoch_v2.cu", ()),
             ("slice_epoch_v3", "slice_epoch_v3.cu", ()),
             ("slice_epoch_v5", "slice_epoch_v5.cu", ()),
             ("gram_schmidt", "gram_schmidt.cu", ()))
#: libraries of this checkout that the other may not build (B3's wide and
#: stream buckets): reported as added
THIS_ONLY = (("slice_epoch_v5_wide", "slice_epoch_v5.cu", ("SLICE_EPOCH_V5_WIDE",)),)
FUSED = ((20, 16), (64, 32), (160, 32))


def in_d32(library: str, kernel: str) -> bool:
    """Whether ``kernel`` of ``library`` is a D <= 32 instantiation: a
    functor of the SLICE_MAXD bucket, B2's thread-per-basis kernel (dims 1
    to 32), or any kernel of a fused library generated at D <= 32
    (``fused_d20``, ``fused_ring_d20``)."""
    m = re.match(r"fused(?:_ring)?_d(\d+)$", library)
    if m:
        return int(m[1]) <= 32
    return re.search(r"LikeILi32EE|gram_schmidt_kernelI", kernel) is not None

_HEADERS = r"""
import json, math, sys
sys.path.insert(0, sys.argv[1])
import torch
from polychordlite_tpu_torch.ops import fused_like
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.priors import identity_prior

def like(theta):
    D = theta.shape[-1]
    return (-0.5 * torch.sum(((theta - 0.5) / 0.1) ** 2)
            - D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)))

out = {}
for D, G in json.loads(sys.argv[2]):
    low = fused_like.lowering(make_batched_calculator(identity_prior, like, D, 0, device="cpu"))
    out[f"fused_d{D}"] = low.source(G)
    out[f"fused_ring_d{D}"] = low.source(G, ring=True)
print(json.dumps(out))
"""


def nvcc_flags():
    sys.path.insert(0, HERE)
    from polychordlite_tpu_torch.utils import nvcc

    return nvcc._nvcc(), list(nvcc.NVCC_FLAGS)


def headers(root: str) -> dict:
    """The generated B1 and ring headers of ``root``'s own lowering."""
    out = subprocess.run([sys.executable, "-c", _HEADERS, root, json.dumps(FUSED)],
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out)


def kernels(log: str) -> dict:
    """{kernel: its ptxas lines after the name} from ``-Xptxas -v``'s report."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m[1]
            out[entry] = []
            continue
        if entry and re.search(r"bytes stack frame|Used \d+ registers", line):
            out[entry].append(line.split(":", 1)[-1].strip())
    return out


def main(other: str, out_dir: str = None) -> dict:
    nvcc_bin, flags = nvcc_flags()
    out_dir = out_dir or tempfile.mkdtemp(prefix="ptxas_parity_")
    roots = {"this": HERE, "other": os.path.abspath(other)}
    gen = {tag: headers(root) for tag, root in roots.items()}
    jobs = []
    for tag, root in roots.items():
        csrc = os.path.join(root, "polychordlite_tpu_torch", "csrc")
        jobs += [(tag, name, os.path.join(csrc, src), defines, None)
                 for name, src, defines in LIBRARIES + (THIS_ONLY if tag == "this" else ())]
        jobs += [(tag, name, os.path.join(csrc, "slice_epoch_fused.cu"), (), text)
                 for name, text in gen[tag].items()]

    def build(job):
        tag, name, src, defines, header = job
        d = os.path.join(out_dir, tag, name)
        os.makedirs(d, exist_ok=True)
        inc = []
        if header is not None:
            with open(os.path.join(d, "fused_like.cuh"), "w") as f:
                f.write(header)
            inc = ["-I", d]
        p = subprocess.run([nvcc_bin, *flags, *[f"-D{m}" for m in defines], *inc, "-o",
                            os.path.join(d, "lib.so"), src], capture_output=True, text=True)
        return (tag, name), p.returncode, p.stdout + p.stderr

    with ThreadPoolExecutor(8) as ex:
        built = {key: (rc, log) for key, rc, log in ex.map(build, jobs)}
    report = {"other": roots["other"],
              "headers_same": {k: gen["this"][k] == gen["other"][k] for k in gen["this"]},
              "build_rc": {"/".join(k): rc for k, (rc, _) in built.items()}, "libraries": {}}
    for (tag, name), (_, log) in built.items():
        if tag != "this":
            continue
        here = kernels(log)
        there = kernels(built["other", name][1]) if ("other", name) in built else {}
        common = sorted(set(here) & set(there))
        differ = [k for k in common if here[k] != there[k]]
        d32 = [k for k in differ if in_d32(name, k)]
        report["libraries"][name] = {
            "other_kernels": len(there), "missing_here": sorted(set(there) - set(here)),
            "n_differ": len(differ), "differ": differ[:5],
            "n_d32": sum(in_d32(name, k) for k in common), "n_differ_d32": len(d32),
            "differ_d32": d32,
            "d32_lines": {k: {"this": here[k], "other": there[k]} for k in d32},
            "added_here": len(set(here) - set(there)),
            "added": {k: here[k] for k in sorted(set(here) - set(there))}}
    report["n_differ_d32"] = sum(v["n_differ_d32"] for v in report["libraries"].values())
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main(*sys.argv[1:])
