"""Where B1's micro-step spends its time in the wide and stream buckets
(D > 32): B1's functor kernel and the fused route timed whole and with
parts of the likelihood evaluation left out, on the card.

    PYTHONPATH=<checkout> python \
        <checkout of the tree>/polychordlite_tpu_torch/experiments/b1_bucket_parts.py \
        [tag [variant ...]]

The template is the one of the package found first on ``sys.path`` (its
``csrc/``, as ``utils/nvcc.py`` finds it), so one script times a tree and
its parent: run it with each checkout on the path.  It builds copies of
that ``csrc/`` in a temporary directory, one per variant (one nvcc per
library, all started together), each with the changes of :data:`VARIANTS`
for the form the template has (:data:`FORMS`):

* ``whole``: the template as it is;
* ``no_combine``: the combine returns a constant below every bound, so the
  terms are still made (and staged, where the form stages them) but never
  combined;
* ``term_only``: also nothing staged: each lane only adds up the terms it
  made, a sum that the result depends on (so the compiler keeps the terms)
  but that never changes it;
* ``machine_only``: no likelihood at all, the constant at once: the hash,
  the state machine, the loads and the advance.

Every variant also records, in place of nlike, the micro-steps of each
repeat (``SliceState::it``), so that a variant is priced per micro-step:
the constant logL rejects every probe, so its repeats run two initial
probes and ``max_shrink`` shrinks (the variants run at ``max_shrink`` =
:data:`SHRINK`, near a whole repeat's count).  A variant without the
combine computes nothing useful: it only says what the rest costs.

At D = 64, 160, 256 and 512, with B 512 and R 2 D, on the inputs of
``bench_geometry.slice_inputs`` (seed 1), each variant of B1 (the zoo
Gaussian) and of the fused route (a per-point torch Gaussian, sigma 0.1 at
0.5, lowered by the package's ``ops/fused_like.py``) is timed over a few
launches after a warm-up (CUDA events); ``us_per_step`` is its ms over the
most micro-steps any chain took (one chain a warp, about one warp a
scheduler, so the slowest chain sets the time).  The variants' libraries
take the place of the package's own through ``nvcc``'s table of loaded
libraries, so the package's wrappers launch them.  Prints one JSON line
per D, after one line with the card and ptxas's registers of each build.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

#: the constant logL of the variants that leave the combine out: below any
#: bound and below logzero, so every probe is rejected
CONST = "Real(-3.0e38)"
#: micro-steps a repeat of a constant variant takes: 2 + SHRINK
SHRINK = 5
#: (D, launches timed): B 512, R 2 D
SHAPES = ((64, 10), (160, 10), (256, 5), (512, 3))
B = 512

# ---- the patches, by the form of the template's like_eval above D = 32
#: every variant: the records' nlike is the repeat's micro-steps
COUNT = (("if (g == 0) write_repeat(a, r, b, Real(0), L.logzero, s.cnt);",
          "if (g == 0) write_repeat(a, r, b, Real(0), L.logzero, (int)s.it);"),
         ("if (g == 0) write_repeat(a, r, b, t, logL, s.cnt);",
          "if (g == 0) write_repeat(a, r, b, t, logL, (int)s.it);"))


def machine(line: str):
    """machine_only's patch: return the constant after ``line``, a
    statement of the G-lane like_eval before its first warp operation."""
    return (line, f"{line}    if (D > 0) return {CONST};\n")


#: the index-order template: every lane combines the staged row in index order
INDEX_STREAM_TERMS = """        bool inside = true;
        __syncwarp();  // the previous micro-step's combine has read the row
        for (int d = L.g; d < D; d += G) {
            Real o[NT] = {};
            L.like.term(
                probe_theta(x0[d], n[d], t, L.like.prior.a[d], L.like.prior.s[d], inside), d, o);
#pragma unroll
            for (int j = 0; j < NT; ++j) L.terms[j * D + d] = o[j];
        }
        inside = (__ballot_sync(0xffffffffu, inside) & L.mask) == L.mask;
        __syncwarp();
        return like_result(L.like.combine(StreamTerms<Real>{L.terms, D}, D), inside,
                           L.logzero);"""
INDEX_STREAM_KEEP = f"""        bool inside = true;
        Real keep = Real(0);
        for (int d = L.g; d < D; d += G) {{
            Real o[NT] = {{}};
            L.like.term(
                probe_theta(x0[d], n[d], t, L.like.prior.a[d], L.like.prior.s[d], inside), d, o);
            keep = rn_add(keep, o[0]);
        }}
        inside = (__ballot_sync(0xffffffffu, inside) & L.mask) == L.mask;
        return like_result(keep != keep ? keep : {CONST}, inside, L.logzero);"""
INDEX_WIDE_STAGE = """        __shared__ Real staged[32 / G][NT * MAXD + 1];
        Real* row = staged[(threadIdx.x & 31) / G];
        __syncwarp();  // the previous micro-step's combine has read the row
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int d = L.g + k * G;
            if (d < D) {
#pragma unroll
                for (int j = 0; j < NT; ++j) row[j * MAXD + d] = own[j][k];
            }
        }
        __syncwarp();
        return like_result(L.like.combine(StagedTerms<MAXD, Real>{row}, D), inside,
                           L.logzero);"""
INDEX_WIDE_KEEP = f"""        Real keep = Real(0);
#pragma unroll
        for (int k = 0; k < K; ++k) keep = rn_add(keep, own[0][k]);
        return like_result(keep != keep ? keep : {CONST}, inside, L.logzero);"""
INDEX = {
    "no_combine": (("L.like.combine(StreamTerms<Real>{L.terms, D}, D)", CONST),
                   ("L.like.combine(StagedTerms<MAXD, Real>{row}, D)", CONST)),
    "term_only": ((INDEX_STREAM_TERMS, INDEX_STREAM_KEEP), (INDEX_WIDE_STAGE, INDEX_WIDE_KEEP)),
    "machine_only": (machine("    constexpr int NT = Like::NT, MAXD = Like::MAXD;\n"),),
}

#: the lane-order template: each lane folds its own terms, then a butterfly.
#: Nothing is staged, so term_only is no_combine: the stream bucket still
#: stores its terms in the lane's entries of the rows, and the 128 bucket's
#: terms are kept alive by a sum as term_only's are above
LANES_NO_COMBINE = (
    ("L.like.combine(LaneRows<Real, NT>{L.terms, L.g, D}, D)", CONST),
    ("L.like.combine(LaneRegs<Real, NT, K>{own, L.g, D, row, MAXD}, D)",
     "[&] {\n            Real keep = Real(0);\n#pragma unroll\n"
     "            for (int k = 0; k < K; ++k) keep = rn_add(keep, own[0][k]);\n"
     f"            return keep != keep ? keep : {CONST};\n        }}()"))
LANES = {
    "no_combine": LANES_NO_COMBINE,
    "term_only": LANES_NO_COMBINE,
    "machine_only": (machine("    constexpr bool STAGED = staged_terms<Like>::value;\n"),),
}

#: the form of a template, told by a line only it has
FORMS = {"index": ("L.like.combine(StagedTerms<MAXD, Real>{row}, D)", INDEX),
         "lanes": ("L.like.combine(LaneRows<Real, NT>{L.terms, L.g, D}, D)", LANES)}
VARIANTS = ("whole", "no_combine", "term_only", "machine_only")


def form_of(src: str) -> str:
    """The form of the template ``src`` (slice_epoch.cuh's text)."""
    found = [name for name, (marker, _) in FORMS.items() if marker in src]
    if len(found) != 1:
        raise RuntimeError(f"slice_epoch.cuh is of no one known form (found {found})")
    return found[0]


def patches(src: str, variant: str):
    """The (old, new) replacements of ``variant`` on the template ``src``."""
    return COUNT + (() if variant == "whole" else FORMS[form_of(src)][1][variant])


def patched(src: str, variant: str) -> str:
    """``src`` with ``variant``'s replacements; each old text must be in it
    exactly once."""
    for old, new in patches(src, variant):
        n = src.count(old)
        if n != 1:
            raise RuntimeError(f"{variant}: {old[:60]!r}... is in slice_epoch.cuh {n} times")
        src = src.replace(old, new)
    return src


def build(csrc: str, out: str, variant: str, headers: dict):
    """nvcc of ``slice_epoch.cu`` and of ``slice_epoch_fused.cu`` for each
    generated header ``{D: text}`` from a copy of ``csrc`` with
    ``variant``'s changes, in ``out/variant``; returns
    (variant, {library: (return code, nvcc's output)})."""
    from polychordlite_tpu_torch.utils import nvcc

    d = os.path.join(out, variant)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(csrc, f), d)
    with open(os.path.join(csrc, "slice_epoch.cuh")) as f:
        src = patched(f.read(), variant)
    with open(os.path.join(d, "slice_epoch.cuh"), "w") as f:
        f.write(src)
    jobs = [("slice_epoch", os.path.join(d, "slice_epoch.cu"), [])]
    for D, text in headers.items():
        gen = os.path.join(d, f"gen{D}")
        os.makedirs(gen, exist_ok=True)
        with open(os.path.join(gen, nvcc.GENERATED_HEADER), "w") as f:
            f.write(text)
        jobs.append((f"fused{D}", os.path.join(d, "slice_epoch_fused.cu"), ["-I", gen]))

    def one(job):
        name, source, inc = job
        p = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, *inc, "-o",
                            os.path.join(d, f"lib{name}.so"), source],
                           capture_output=True, text=True)
        return name, (p.returncode, p.stdout + p.stderr)

    with ThreadPoolExecutor(len(jobs)) as ex:
        return variant, dict(ex.map(one, jobs))


def registers(log: str) -> dict:
    """ptxas's registers of the Gaussian's (or the fused functor's) G = 32
    kernels above D = 32, by bucket."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m[1]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and ("12GaussianLikeILi0E" in entry or "12GaussianLikeILi128E" in entry
                            or "FusedLike" in entry) and "V4Policy" in entry:
            key = ("stream" if "Li0" in entry else "wide" if "Li128" in entry else "fused")
            out.setdefault(key, int(m[1]))
    return out


def per_point_gaussian(theta):
    import torch

    D = theta.shape[-1]
    return (-0.5 * torch.sum(((theta - 0.5) / 0.1) ** 2)
            - D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)))


def main(tag="tree", *names):
    # absolute imports: the package is the one first on the path
    import torch

    import polychordlite_tpu_torch
    from polychordlite_tpu_torch.experiments.bench_geometry import (
        device_label,
        slice_inputs,
        study_device,
    )
    from polychordlite_tpu_torch.ops import fused_like, pallas_slice_v4
    from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
    from polychordlite_tpu_torch.priors import identity_prior
    from polychordlite_tpu_torch.utils import nvcc

    dev = study_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    names = list(names or VARIANTS)
    fused = {}
    for D, _ in SHAPES:
        pp = make_batched_calculator(identity_prior, per_point_gaussian, D, 0, device=dev)
        fused[D] = (pp, fused_like.lowering(pp))
    headers = {D: low.source(32) for D, (_, low) in fused.items()}
    csrc = str(nvcc.CSRC)
    with open(os.path.join(csrc, "slice_epoch.cuh")) as f:
        form = form_of(f.read())
    out = tempfile.mkdtemp(prefix="b1_bucket_parts_")
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(ex.map(lambda v: build(csrc, out, v, headers), names))
    libs = {}
    for v, logs in built.items():
        for lib, (rc, log) in logs.items():
            if rc:
                raise RuntimeError(f"nvcc failed for {v}/{lib}:\n{log}")
        libs[v] = {lib: ctypes.CDLL(os.path.join(out, v, f"lib{lib}.so")) for lib in logs}
    print(json.dumps({"study": "b1_bucket_parts", "tree": tag, "form": form, "card": card,
                      "device": device_label(dev),
                      "package": polychordlite_tpu_torch.__path__[0],
                      "registers": {v: {lib: registers(log) for lib, (_, log) in logs.items()}
                                    for v, logs in built.items()}}), flush=True)

    def timed(fn, reps):
        res = fn()
        torch.cuda.synchronize(dev)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(dev)
        return res, start.elapsed_time(stop) / reps

    for D, reps in SHAPES:
        R = 2 * D
        calc, cfg, kw, args = slice_inputs(dev, B, R, D, seed=1)
        pp, low = fused[D]
        row = {"D": D, "B": B, "R": R}
        for v in names:
            c = cfg if v == "whole" else cfg._replace(max_shrink=SHRINK)
            nvcc._LIBS["slice_epoch"] = libs[v]["slice_epoch"]
            nvcc._LIBS[low.library_name(32)] = libs[v][f"fused{D}"]
            for route, fn in (
                    ("B1", lambda: pallas_slice_v4.slice_epoch(calc, c, kw, *args)),  # noqa: B023
                    ("fused",
                     lambda: pallas_slice_v4.slice_epoch_fused(pp, c, kw, *args))):  # noqa: B023
                (_, _, steps), ms = timed(fn, reps)
                chain = steps.to(torch.int64).sum(dim=1)
                row[f"{route}/{v}"] = {"ms": ms, "steps_max": int(chain.max()),
                                       "steps_mean": float(chain.double().mean()),
                                       "us_per_step": 1e3 * ms / max(int(chain.max()), 1)}
        print(json.dumps(row), flush=True)
    for name in ("slice_epoch", *(low.library_name(32) for _, low in fused.values())):
        nvcc._LIBS.pop(name, None)
    shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
