"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel libraries from ``polychordlite_tpu_torch/csrc``
(one ``nvcc`` each, started together; ptxas registers, stack and spills
reported), checks each kernel against its plain torch version on the card
(B2 Gram-Schmidt, bitwise, at the bench and gaussian.ini shapes; B1 v4 at
every group size G of lanes per chain, B3 v5, B4 v3, B5
v2 at four geometries, B1 also against its G = 1 form; E1, the counted
v4, in the ``lane_efficiency`` study), measures what B1's micro-step costs
(``measure_first``: E7's ``body20`` with an IEEE division and with the
hash, B1 at every G at the gaussian.ini, 4-D and 8-D zoo, bench and 4x
bench geometries, and the SASS of B1's Gaussian instantiations from
``cuobjdump``), holds B1's route for a likelihood evaluated in torch
(``slice_step``: the kernel ``csrc/slice_step.cu`` replayed from a CUDA
graph) bitwise against the plain engine and B1 at gaussian.ini's shape, the
bench and D = 40, with 1, 7 and 32 rounds per replay, and times it beside
both, then drives the port's paths and checks what comes out and
which kernels ran (each path with every launch count set to 0 just before
it):

* ``run_gaussian_ini``: ``run()`` on the 20-D Gaussian of
  ``ini/gaussian.ini`` (nlive 500, num_repeats 40, no clustering), engine
  ``"cuda"`` (the v4 kernel, at the G that ``choose_group`` picks, which
  must be > 1) and the Gram-Schmidt kernel;
* ``run_gaussian_shells_ini``: ``python3 -m polychordlite_tpu_torch`` on a
  copy of ``ini/gaussian_shells.ini`` (2-D, two shells, clustering, nlive
  500, num_repeats 10) with only ``base_dir`` and a fixed ``seed`` added;
  the fresh process starts with every launch count at 0 and writes the
  launches of its run into its ``.metrics.jsonl``;
* ``run_gaussian_shells_v5``: the same settings through
  ``run(..., engine="cuda5")`` (the speculative-packet kernel), which must
  give the CLI run's result bit for bit;
* ``run_zoo_inis``: the nine other analytic inis of ``ini/`` at their
  shipped settings (``base_dir`` and ``seed`` added) through
  ``inidriver.run_ini`` on the default device, and ``ini/eggbox.ini``
  through ``python3 -m polychordlite_tpu_torch``; each logZ within 3 sigma
  of its oracle (:data:`ZOO_ORACLES`);
* ``run_himmelblau_ab``: ``ini/himmelblau.ini`` through
  ``run(engine="cuda3")`` (B4), bitwise the ``run_zoo_inis`` run, and
  ``run(engine="cuda2")`` (B5), within 3 sigma of -log 100;

* ``run_gaussian_ini_torch``: gaussian.ini's settings through ``run()`` with
  its likelihood written as a plain batched torch function (no device
  form): the traced route ``csrc/slice_step.cu`` and B2, within 3 sigma of
  0, its dead/s beside the functor run's;
* ``run_quickstart_torch``: the reference quickstart written per point in
  torch (4-D, sigma 0.1, ``UniformPrior(-1, 1)``, one derived r^2, nlive
  200, clustering on) through ``run()``: the traced route and B2 (never B1),
  within 3 sigma of -4 log 2, the r^2 column in the chains;
* ``run_gaussian_prior``: a 5-D Gaussian likelihood N(0, 0.5^2) under a
  ``GaussianPrior(1, 1)``, within 3 sigma of its closed-form evidence;

then the structure-cost studies of ``polychordlite_tpu_torch.experiments``,
each kernel first held against its plain version on the card:

* ``lockstep_waste``: E3, the counted v2 kernel (bitwise B5 and its plain
  version at three geometries), and its study at the bench geometry;
* ``v3_iters``: E2, v3's grid steps as a cooperative kernel with their body
  counts (bitwise B4, B1 and its plain version; the skeleton one body per
  step), its study (real and skeleton, beside B4), and the numpy
  simulation's projected lane efficiencies beside E1's and E3's;
* ``grid_overhead``: E6, the grid-step skeleton, variants A-F and B one
  launch per step;
* ``while_cost``: E7, the loop-body cost of every body, beside B1's time
  per micro-step;
* ``proto_epoch``: E4, the whole-epoch prototype (bitwise its plain version
  at B=1024/R=8 and at its full size, B=8192/R=100), its study, and its
  time per lane iteration beside B1's per micro-step in the same call;
* ``proto_repeat``: E5, the one-repeat prototype (bitwise its plain version
  at nb=2 and nb=8 blocks of 1,024 chains, and over a chain of launches),
  its time per launch from a captured CUDA graph of 20 launches back to
  back, and its study (one repeat, then 100 launches back to back).

Each phase prints one JSON line; the line before the last lists the
kernels with their times, bounds (from this run's shapes and step counts)
and launches on the paths, and the last line is ``{"ok": true, "device": ...}``.  Any failed
phase exits non-zero without that line.  Without a CUDA device, or without
the package beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")
SEED = 20250101
BENCH = dict(B=8192, R=100, D=20)        # the slice bench geometry
BENCH_X4 = dict(B=32768, R=100, D=20)    # ... at four times the chains
SMALL = dict(B=1024, R=8, D=20)
INI = dict(nDims=20, nDerived=2, nlive=500, num_repeats=40)  # ini/gaussian.ini
# what run() gives the kernel on ini/gaussian.ini: B = nlive rounded to 8
# logical lanes, padded to 512 physical lanes (parallel/mesh.py)
RUN = dict(B=512, R=40, D=20, B_valid=504)
# ... and on ini/gaussian_shells.ini (nlive 500, num_repeats 10, 2-D)
SHELLS = dict(B=512, R=10, D=2, B_valid=504)
# ... and on the zoo's 4-D inis (half_gaussian, pyramidal, twin_gaussian:
# num_repeats 20) and its 8-D random_gaussian.ini (num_repeats 40)
ZOO_D4 = dict(B=512, R=20, D=4, B_valid=504)
ZOO_D8 = dict(B=512, R=40, D=8, B_valid=504)
# ... and a 40-D model, beyond B1's SLICE_MAXD, on the traced route
TRACED_D40 = dict(B=512, R=40, D=40, B_valid=504)
SHELLS_LOGZ = -math.log(60.0)  # normalised shells over the [-6,6] x [-2.5,2.5] box
LIBRARIES = {
    "gram_schmidt": ["gram_schmidt.cu"],
    "slice_epoch": ["slice_epoch.cu"],
    "slice_epoch_v5": ["slice_epoch_v5.cu"],
    "slice_epoch_v3": ["slice_epoch_v3.cu"],
    "slice_epoch_v2": ["slice_epoch_v2.cu"],
    "slice_epoch_v3_instr": ["slice_epoch_v3_instr.cu"],
    "probes": ["probes.cu"],
    "prototypes": ["prototypes.cu"],
    "slice_step": ["slice_step.cu"],
}
#: the analytic inis' evidence oracles: (logZ, its sigma or None for an exact
#: value, where it comes from).  The JAX values are the JAX package's CPU runs
#: at the same settings and seed, from ``scripts/zoo_reference_logz.py``
#: (JAX 0.9.0); each run here must land within 3 combined sigma.  The same
#: script checked the four analytic values: gaussian_shell -4.9942 +- 0.0829,
#: himmelblau -4.5747 +- 0.0956, half_gaussian +0.0755 +- 0.0925, pyramidal
#: -0.1074 +- 0.0870.
ZOO_ORACLES = {
    "gaussian_shell": (-math.log(144.0), None, "normalised shell in a 12 x 12 box"),
    "himmelblau": (-math.log(100.0), None, "normalised, 10 x 10 box"),
    "half_gaussian": (0.0, None, "normalised"),
    "pyramidal": (0.0, None, "normalised"),
    "eggbox": (-4.068568333227493, 0.06926281283625953, "JAX package, CPU"),
    "rastrigin": (-4.601151046710499, 0.11321131723081969, "JAX package, CPU"),
    "rosenbrock": (-5.0304313247996255, 0.10651320969831203, "JAX package, CPU"),
    "twin_gaussian": (-2.236031473448633, 0.10162701830093217, "JAX package, CPU"),
    "random_gaussian": (-0.15459852089235782, 0.08891872190328032, "JAX package, CPU"),
}
# H100 SXM peaks (NVIDIA datasheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if os.path.isdir(OUT):  # the whole record, beyond the end of the output
        with open(os.path.join(OUT, "chip_smoke.jsonl"), "a") as f:
            f.write(line + "\n")


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn()`` from a captured CUDA graph of
    ``launches`` calls back to back, replayed ``reps`` times: no host work
    between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * launches)


def sass_report(so: str, keep: str):
    """From ``cuobjdump`` on the library ``so``: per kernel of B1's Gaussian
    (by G, and the counted form), the SASS ``CALL`` instructions, the
    instructions in all and the registers, stack and local bytes; the SASS
    of those kernels goes to ``keep``.  None when there is no cuobjdump."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=600).stdout
    usage = subprocess.run([tool, "-res-usage", so], capture_output=True, text=True,
                           timeout=600).stdout
    res = {m[0]: {"registers": int(m[1]), "stack": int(m[2]), "local": int(m[3])}
           for m in re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
                               usage)}
    out, kept = {}, []
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        m = re.search(r"slice_epoch_kernel.*12GaussianLikeLi(\d+)ELb([01])E", name)
        if not m:
            continue
        tag = f"G={m[1]}" + (" counted" if m[2] == "1" else "")
        out[tag] = {"calls": len(re.findall(r"\bCALL\b", block)),
                    "instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/", block)),
                    **res.get(name, {})}
        kept.append(f"==== {tag} {name}\n{block}")
    with open(keep, "w") as f:
        f.write("\n".join(kept))
    return out


def cuda_once(fn):
    """(result, device ms) of one call of ``fn()``, from CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def ini_copy(base: str, name: str) -> str:
    """ini/<name>.ini with base_dir set to ``base`` and a fixed seed added,
    nothing else changed."""
    with open(os.path.join(HERE, "ini", f"{name}.ini")) as f:
        src = f.read()
    if "base_dir = chains" not in src:
        raise AssertionError(f"ini/{name}.ini has no 'base_dir = chains' line")
    src = src.replace("base_dir = chains", f"base_dir = {base}\nseed = {SEED}")
    path = os.path.join(base, f"{name}.ini")
    with open(path, "w") as f:
        f.write(src)
    return path


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slice_epoch_bytes(B: int, R: int, D: int, cube: bool = False, counted: bool = False) -> int:
    """Bytes a slice-epoch kernel must move: x0 (D,B), n-hat (R,D,B), w
    (R,B), bound and valid (B,) read once; t, logL, nlike (R,B) written once
    (and v2's cube (R,D,B), or the counted kernel's B + B/32 counters)."""
    n = D * B + R * D * B + R * B + 2 * B + 3 * R * B
    if cube:
        n += R * D * B
    if counted:
        n += B + -(-B // 32)
    return 4 * n


def gaussian_probe_flops(D: int) -> int:
    """float32 operations of one probe of the Gaussian functor: the probe
    x0 + t n-hat and the prior's affine map (4 per coordinate), (th - mu) /
    sigma and the chi-square add (4 per coordinate), logL and the chord
    position t (about 7) — a division counted as one operation."""
    return 8 * D + 7


def gram_schmidt_flops(NB: int, D: int, B: int) -> int:
    """float32 operations of CGS2 on NB*B bases of D vectors: two passes of
    k dot products and k updates (2D each) for vector k, and a norm and a
    scale per vector (3D + 1)."""
    per = 2 * sum(4 * D * k for k in range(D)) + D * (3 * D + 1)
    return NB * B * per


def ptxas_summary(log: str):
    """Kernels, and the largest registers, stack frame and spill bytes that
    ptxas reports for any of them."""
    import re

    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    stack = [int(m) for m in re.findall(r"(\d+) bytes stack frame", log)]
    spill = [int(a) + int(b) for a, b in
             re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return {"kernels": len(regs), "max_registers": max(regs, default=None),
            "max_stack_bytes": max(stack, default=None),
            "max_spill_bytes": max(spill, default=None)}


def read_metrics(base: str, root: str):
    with open(os.path.join(base, f"{root}.metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f.read().splitlines()]


def shell_evidences(out, base: str, root: str):
    """The local evidences of the retired clusters, grouped by the shell
    (x_1 < 0 or > 0) that each cluster's posterior mass sits on.  Cluster
    files are ranked by local evidence (utils/io.py)."""
    import numpy as np

    lz = np.asarray(out.logZs)
    sides = {-1: [], 1: []}
    for rank, c in enumerate(np.argsort(-lz, kind="stable")):
        path = os.path.join(base, "clusters", f"{root}_{rank + 1}.txt")
        if not (math.isfinite(lz[c]) and lz[c] > -1e29 and os.path.getsize(path)):
            continue
        post = np.loadtxt(path, ndmin=2)
        x = float((post[:, 0] * post[:, 2]).sum() / post[:, 0].sum())
        sides[1 if x > 0 else -1].append(float(lz[c]))
    return lz[np.isfinite(lz) & (lz > -1e29)], sides


def lse(values) -> float:
    m = max(values)
    return m + math.log(sum(math.exp(v - m) for v in values))


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU", 2)
    sys.path.insert(0, HERE)
    try:
        import polychordlite_tpu_torch as pt
        from polychordlite_tpu_torch.experiments import (
            pallas_epoch_v2,
            pallas_slice_repeat,
            prof_grid_overhead,
            prof_lockstep_waste,
            prof_pallas_while,
            prof_v3_iters,
            sim_iter_distribution,
            v3_instr,
        )
        from polychordlite_tpu_torch.experiments.bench_geometry import slice_inputs
        from polychordlite_tpu_torch.inidriver import run_ini
        from polychordlite_tpu_torch.models import gaussian, gaussian_shells, himmelblau
        from polychordlite_tpu_torch.ops import (
            pallas_dirs,
            pallas_slice,
            pallas_slice_v3,
            pallas_slice_v4,
            pallas_slice_v5,
        )
        from polychordlite_tpu_torch.ops.directions import make_directions
        from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
        from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, slice_records_plain
        from polychordlite_tpu_torch.output import PolyChordOutput
        from polychordlite_tpu_torch.priors import (
            BlockPrior,
            GaussianPrior,
            UniformPrior,
            identity_prior,
        )
        from polychordlite_tpu_torch.utils import nvcc
        from polychordlite_tpu_torch.utils.inifile import read_ini
    except ImportError as e:
        fail(f"cannot import the port beside this script ({e})")

    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    label = f"{torch.cuda.get_device_name(0)}, power limit {card.split(',')[-1].strip()}"
    results = {}
    failed = []

    def phase(name):
        def wrap(fn):
            t0 = time.perf_counter()
            try:
                out = fn()
                emit({"phase": name, "ok": True, "card": label,
                      "seconds": time.perf_counter() - t0, **out})
            except Exception as e:  # report every phase, fail at the end
                traceback.print_exc()
                emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"})
                failed.append(name)
            return fn
        return wrap

    # ---- 1. build: one nvcc per library, all started together ------------
    @phase("build")
    def _():
        t0 = time.perf_counter()
        nvcc.build_all(LIBRARIES)
        ptxas = {name: ptxas_summary(log) for name, log in nvcc.build_log.items()}
        with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
            for name, log in nvcc.build_log.items():
                f.write(f"==== {name}\n{log}\n")
        return {"seconds": round(time.perf_counter() - t0, 3),
                "per_library": {k: round(v, 3) for k, v in nvcc.build_seconds.items()},
                "ptxas": ptxas}

    # ---- 2. Gram-Schmidt (B2) against its plain version, bitwise -----------
    @phase("gram_schmidt")
    def _():
        out = {}
        for tag, shape in (("bench", (5, 20, 20, BENCH["B"])), ("gaussian_ini", (2, 20, 20, 512))):
            g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(1), device=dev)
            q_plain = pallas_dirs.gram_schmidt_plain(g)
            q = pallas_dirs.gram_schmidt_lanes(g)
            mism = int((q != q_plain).sum())
            if mism:
                raise AssertionError(f"{tag}: the kernel differs from the plain version in "
                                     f"{mism} entries")
            err = (q - q_plain).abs().max().item()
            qtq = torch.einsum("nikb,nijb->nkjb", q, q)
            orth = (qtq - torch.eye(shape[1], device=dev)[None, :, :, None]).abs().max().item()
            if not (err == 0.0 and orth <= 1e-5):
                raise AssertionError(f"{tag}: max|dq| {err:.3g}, max|QtQ - I| {orth:.3g}")
            # the yardstick: one batched Householder QR of the same bases,
            # (NB*B, D, D) with the vectors as columns; the port never calls it
            mats = g.permute(0, 3, 1, 2).reshape(-1, shape[1], shape[2]).contiguous()
            out[tag] = {
                "shape": list(shape), "max_abs_err": err, "orth_err": orth,
                "mismatches": mism,
                "ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_lanes(g), 20),  # noqa: B023
                "plain_ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_plain(g), 3),  # noqa: B023
                "library_ms": cuda_ms(lambda: torch.linalg.qr(mats), 5),  # noqa: B023
            }
            nb, d, _, b = shape
            out[tag]["bound_ms"], out[tag]["bound_by"] = bound(
                2 * 4 * nb * d * d * b, gram_schmidt_flops(nb, d, b))
        results["gram_schmidt"] = {**out["bench"],
                                   "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    def ball_inputs(B, D, like, gen):
        """Seeds at 0.5 +- 0.05 inside a ball contour of radius 1.5 sigma sqrt(D)."""
        sigma = like.device_form["sigma"]
        x0 = 0.5 + 0.05 * torch.randn((B, D), generator=gen, device=dev)
        r0 = 1.5 * sigma * math.sqrt(D)
        bound = torch.full((B,), like.device_form["norm"] - 0.5 * (r0 / sigma) ** 2, device=dev)
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        return x0, bound, valid, (sigma * torch.eye(D, device=dev)).expand(B, D, D)

    def live_set_inputs(B, D, calc, gen, nlive=INI["nlive"], B_valid=RUN["B_valid"]):
        """As run() feeds the kernel mid-run: seeds are picks from a live set
        of nlive points, each lane's bound is the logL of a live point at or
        below its seed's, the Cholesky is that of the live set's covariance,
        and the lanes past B_valid are invalid, seeded as lane 0."""
        live = (0.5 + 0.06 * torch.randn((nlive, D), generator=gen, device=dev)).clamp(0, 1)
        live_logL = calc(live)[2]
        pick = torch.randint(0, nlive, (B,), generator=gen, device=dev)
        other = torch.randint(0, nlive, (B,), generator=gen, device=dev)
        pick[B_valid:] = pick[0]
        x0 = live[pick]
        bound = torch.minimum(live_logL[pick], live_logL[other])
        valid = torch.arange(B, device=dev) < B_valid
        chol = torch.linalg.cholesky(torch.cov(live.T)).expand(B, D, D)
        return x0, bound, valid, chol

    def shells_inputs(B, calc, gen, nlive=500, B_valid=SHELLS["B_valid"]):
        """As run() feeds the kernels mid-run on gaussian_shells.ini: seeds
        picked from a live set of nlive points on the two shells, each
        lane's bound the logL of a live point at or below its seed's, the
        live set's Cholesky, the lanes past B_valid invalid."""
        ang = 2 * math.pi * torch.rand(nlive, generator=gen, device=dev)
        side = torch.where(torch.rand(nlive, generator=gen, device=dev) < 0.5, -3.5, 3.5)
        rad = 2.0 + 0.1 * torch.randn(nlive, generator=gen, device=dev)
        th = torch.stack([side + rad * torch.cos(ang), rad * torch.sin(ang)], 1)
        lo, span = torch.tensor([-6.0, -2.5], device=dev), torch.tensor([12.0, 5.0], device=dev)
        live = ((th - lo) / span).clamp(0, 1)
        live_logL = calc(live)[2]
        pick = torch.randint(0, nlive, (B,), generator=gen, device=dev)
        other = torch.randint(0, nlive, (B,), generator=gen, device=dev)
        pick[B_valid:] = pick[0]
        bound = torch.minimum(live_logL[pick], live_logL[other])
        valid = torch.arange(B, device=dev) < B_valid
        chol = torch.linalg.cholesky(torch.cov(live.T)).expand(B, 2, 2)
        return live[pick], bound, valid, chol

    shells_ini = os.path.join(HERE, "ini", "gaussian_shells.ini")
    _, shells_blocks, *_ = read_ini(shells_ini)

    def geometry(tag, geo):
        """(calc, cfg, kernel inputs) of one checked geometry."""
        B, R, D = geo["B"], geo["R"], geo["D"]
        gen = torch.Generator(dev).manual_seed(SEED)
        if tag == "shells_ini":
            calc = make_batched_calculator(BlockPrior(shells_blocks, D), gaussian_shells(D), D, 0)
            x0, bound, valid, chol = shells_inputs(B, calc, gen)
        else:
            like = gaussian(D)
            calc = make_batched_calculator(identity_prior, like, D, 2)
            if "B_valid" in geo:
                x0, bound, valid, chol = live_set_inputs(B, D, calc, gen, B_valid=geo["B_valid"])
            else:
                x0, bound, valid, chol = ball_inputs(B, D, like, gen)
        cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
        nh, w, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                                   generator=gen)
        return calc, cfg, (x0, bound, valid, nh, w)

    GEOMETRIES = (("small", SMALL), ("gaussian_ini", RUN), ("bench", BENCH),
                  ("shells_ini", SHELLS))
    GROUPS = pallas_slice_v4.GROUPS
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def mismatches(got, want):
        return {k: int((a != b).sum()) for k, a, b in zip(("t", "logL", "nlike"), got, want)}

    def decisions(tag, pairs):
        """Mismatch counts of (name, got, want) triples; raises on any."""
        mism = {name: int((a != b).sum()) for name, a, b in pairs}
        if any(mism.values()):
            raise AssertionError(f"{tag}: {mism}")
        return mism

    # ---- 3. what B1's micro-step costs (the redesign's step 0) --------------
    @phase("measure_first")
    def _():
        w = prof_pallas_while
        S, n = w.SIZES["S"], w.SIZES["n"]
        x = 0.2 + 0.6 * torch.rand((S, w.LANE), generator=torch.Generator(dev).manual_seed(SEED),
                                   device=dev)
        zeros = torch.zeros((S, w.LANE), device=dev)
        bodies = {}
        for v in ("body20", "body20_div", "body20_hash"):
            decisions(f"E7 {v} differs from its plain version",
                      [(v, w.while_loop(v, x, 2000), w.while_loop_plain(v, x, 2000))])
            ms = cuda_ms(lambda v=v: w.while_loop(v, zeros, n), 3)
            bodies[v] = {"ms": ms, "us_per_iter": ms * 1e3 / n}
        by_group = {}
        kw = (0x01234567, 0x89ABCDEF)
        for tag, geo in (("gaussian_ini", RUN), ("zoo_d4", ZOO_D4), ("zoo_d8", ZOO_D8),
                         ("bench", BENCH), ("bench_x4", BENCH_X4)):
            calc, cfg, args = geometry(tag, geo)
            one = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, group=1)
            for G in GROUPS:
                decisions(f"{tag}: B1 at G={G} differs from G=1", [
                    (f"{k}_G{G}", a, b) for k, a, b in zip(
                        ("t", "logL", "nlike"),
                        pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, group=G), one)])
            lane_max = int(pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *args)[3].max())
            ms = {G: cuda_ms(lambda G=G: pallas_slice_v4.slice_epoch(  # noqa: B023
                calc, cfg, kw, *args, group=G), 5) for G in GROUPS}  # noqa: B023
            B, D = geo["B"], geo["D"]
            by_group[tag] = {
                "B": B, "R": geo["R"], "D": D, "evals": int(one[2].sum()),
                "lane_steps_max": lane_max, "chosen_group": pallas_slice_v4.choose_group(B, D, n_sm),
                "ms_by_group": ms, "us_per_micro_step_by_group":
                    {G: t * 1e3 / lane_max for G, t in ms.items()},
                "best_group": min(ms, key=ms.get)}
        x4 = by_group["bench_x4"]["ms_by_group"][1] / by_group["bench"]["ms_by_group"][1]
        sass = sass_report(str(nvcc.library_path("slice_epoch", LIBRARIES["slice_epoch"])),
                           os.path.join(OUT, "slice_epoch_gaussian.sass"))
        results["measure_first"] = {"bodies": bodies, "b1_by_group": by_group}
        return {"n_sm": n_sm, "bodies": bodies,
                "body20_div_minus_body20_us": bodies["body20_div"]["us_per_iter"]
                - bodies["body20"]["us_per_iter"],
                "body20_hash_minus_body20_us": bodies["body20_hash"]["us_per_iter"]
                - bodies["body20"]["us_per_iter"],
                "b1_by_group": by_group, "b1_g1_x4_chains_time_ratio": x4,
                "sass": sass if sass is not None else "cuobjdump not found on this machine"}

    # ---- 4. slice epoch (B1) at every G against the plain torch engine -----
    @phase("slice_epoch")
    def _():
        out = {}
        for tag, geo in GEOMETRIES:
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc, cfg, args = geometry(tag, geo)
            pallas_slice_v4.validate_functor(calc, cfg, dev)
            kw = (0x01234567, 0x89ABCDEF)
            valid = args[2]
            t, l, n = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            want, plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                lambda p: calc(p)[2], cfg, kw, *args))  # noqa: B023
            tp, lp, n_p = want
            one = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, group=1)
            mism = {"default_vs_plain": mismatches((t, l, n), want),
                    "default_vs_G1": mismatches((t, l, n), one)}
            for G in GROUPS:
                mism[f"G{G}_vs_plain"] = mismatches(
                    pallas_slice_v4.slice_epoch(calc, cfg, kw, *args, group=G), want)
            if any(v for m in mism.values() for v in m.values()):
                raise AssertionError(f"{tag}: kernel and plain engine differ {mism}")
            err = max((t - tp).abs().max().item(), (l - lp).abs().max().item())
            evals = int(n.sum())
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            g1_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(  # noqa: B023
                calc, cfg, kw, *args, group=1), 5)  # noqa: B023
            out[tag] = {
                "B": B, "R": R, "D": D, "valid_lanes": int(valid.sum()),
                "group": pallas_slice_v4.choose_group(B, D, n_sm),
                "evals": evals, "max_abs_err": err, "mismatches": mism,
                "ms": ms, "g1_ms": g1_ms, "plain_ms": plain_ms,
                "evals_per_s": evals / (ms / 1e3), "plain_evals_per_s": evals / (plain_ms / 1e3),
            }
        results["slice_epoch"] = {**out["bench"],
                                  "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    # ---- 4. speculative slice epoch (B3) against its plain version and B1 --
    @phase("slice_epoch_v5")
    def _():
        out = {}
        for tag, geo in GEOMETRIES:
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc, cfg, args = geometry(tag, geo)
            pallas_slice_v4.validate_functor(calc, cfg, dev, pallas_slice_v5.slice_epoch_v5)
            kw = (0x01234567, 0x89ABCDEF)

            def plain(calc=calc, cfg=cfg, args=args):
                return pallas_slice_v5.slice_records_packet_plain(
                    lambda p: calc(p)[2], cfg, kw, *args)

            got = pallas_slice_v5.slice_epoch_v5(calc, cfg, kw, *args)
            want, plain_ms = cuda_once(plain)
            v4 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            mism = {
                f"{k}_vs_{other}": int((a != b).sum())
                for other, ref in (("plain", want), ("v4", v4))
                for k, a, b in zip(("t", "logL", "nlike"), got, ref)
            }
            if any(mism.values()):
                raise AssertionError(f"{tag}: B3 differs {mism}")
            err = max((got[0] - want[0]).abs().max().item(),
                      (got[1] - want[1]).abs().max().item())
            evals = int(got[2].sum())
            ms = cuda_ms(lambda: pallas_slice_v5.slice_epoch_v5(calc, cfg, kw, *args), 5)  # noqa: B023
            v4_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            out[tag] = {
                "B": B, "R": R, "D": D, "valid_lanes": int(args[2].sum()),
                "evals": evals, "mismatches": mism, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "v4_ms": v4_ms,
                "evals_per_s": evals / (ms / 1e3), "plain_evals_per_s": evals / (plain_ms / 1e3),
            }
        results["slice_epoch_v5"] = {**out["bench"],
                                     "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    # ---- 5. v3 (B4) and v2 (B5) against their plain versions and B1 -------
    @phase("slice_epoch_v3")
    def _():
        out = {}
        for tag, geo in GEOMETRIES:
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc, cfg, args = geometry(tag, geo)
            pallas_slice_v4.validate_functor(calc, cfg, dev, pallas_slice_v3.slice_epoch_v3)
            kw = (0x01234567, 0x89ABCDEF)

            def plain(calc=calc, cfg=cfg, args=args):
                return pallas_slice_v3.slice_records_window_plain(
                    lambda p: calc(p)[2], cfg, kw, *args)

            got = pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args)
            want, plain_ms = cuda_once(plain)
            v4 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            mism = {
                f"{k}_vs_{other}": int((a != b).sum())
                for other, ref in (("plain", want), ("v4", v4))
                for k, a, b in zip(("t", "logL", "nlike"), got, ref)
            }
            if any(mism.values()):
                raise AssertionError(f"{tag}: B4 differs {mism}")
            err = max((got[0] - want[0]).abs().max().item(),
                      (got[1] - want[1]).abs().max().item())
            ms = cuda_ms(lambda: pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args), 5)  # noqa: B023
            v4_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            out[tag] = {
                "B": B, "R": R, "D": D, "evals": int(got[2].sum()), "mismatches": mism,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "v4_ms": v4_ms,
            }
        results["slice_epoch_v3"] = {**out["bench"],
                                     "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    @phase("slice_epoch_v2")
    def _():
        out = {}
        for tag, geo in GEOMETRIES:
            B, R, D = geo["B"], geo["R"], geo["D"]
            calc, cfg, args = geometry(tag, geo)
            pallas_slice_v4.validate_functor(calc, cfg, dev, pallas_slice.slice_epoch_v2)
            kw = (0x01234567, 0x89ABCDEF)

            def plain(calc=calc, cfg=cfg, args=args):
                return pallas_slice.slice_records_lockstep_plain(
                    lambda p: calc(p)[2], cfg, kw, *args)

            got = pallas_slice.slice_epoch_v2(calc, cfg, kw, *args)
            want, plain_ms = cuda_once(plain)
            v4 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            mism = {
                f"{k}_vs_{other}": int((a != b).sum())
                for other, ref in (("plain", want), ("v4", v4))
                for k, a, b in zip(("t", "logL", "nlike", "cube"), got, ref)
            }
            if any(mism.values()):
                raise AssertionError(f"{tag}: B5 differs {mism}")
            rebuilt = args[0][:, None, :] + torch.cumsum(v4[0][:, :, None] * args[3], dim=1)
            cube_vs_v4 = (got[3] - rebuilt).abs().max().item()
            if not cube_vs_v4 <= 1e-5:
                raise AssertionError(f"{tag}: B5's cube is {cube_vs_v4} from B1's rebuild")
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            ms = cuda_ms(lambda: pallas_slice.slice_epoch_v2(calc, cfg, kw, *args), 5)  # noqa: B023
            out[tag] = {
                "B": B, "R": R, "D": D, "evals": int(got[2].sum()), "mismatches": mism,
                "max_abs_err": err, "max_abs_cube_vs_v4_rebuild": cube_vs_v4,
                "ms": ms, "plain_ms": plain_ms,
            }
        results["slice_epoch_v2"] = {**out["bench"],
                                     "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    # ---- 6. E1: B1 with its micro-steps counted, and the lane efficiency --
    @phase("lane_efficiency")
    def _():
        out = {}
        for tag, geo in (("bench", BENCH), ("gaussian_ini", RUN)):
            calc, cfg, args = geometry(tag, geo)
            kw = (0x01234567, 0x89ABCDEF)
            got = pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *args)
            v4 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            plain_steps = slice_records_plain(lambda p: calc(p)[2], cfg, kw, *args,  # noqa: B023
                                              count_steps=True)[3]
            mism = {k: int((a != b).sum()) for k, a, b in
                    zip(("t", "logL", "nlike", "lane_steps"), got, (*v4, plain_steps))}
            mism["warp_max"] = int((got[4] != pallas_slice_v4.warp_maxima(plain_steps)).sum())
            if any(mism.values()):
                raise AssertionError(f"{tag}: E1 differs {mism}")
            # the study: its own launches (the comparison above does not count)
            pallas_slice_v4.LAUNCHES["slice_epoch_counted"] = 0
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *args), 5)  # noqa: B023
            study = pallas_slice_v4.LAUNCHES["slice_epoch_counted"]
            v4_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            steps, wmax = got[3].to(torch.int64), got[4].to(torch.int64)
            evals = int(got[2].sum())
            out[tag] = {
                "B": geo["B"], "R": geo["R"], "D": geo["D"], "valid_lanes": int(args[2].sum()),
                "sum_lane_steps": int(steps.sum()), "sum_warp_max": int(wmax.sum()),
                "lane_efficiency": pallas_slice_v4.lane_efficiency(got[3], got[4]),
                "lane_steps_max": int(steps.max()), "lane_steps_mean_valid":
                    float(steps[args[2]].float().mean()),
                "evals": evals, "evals_per_step": evals / max(int(steps.sum()), 1),
                "ms": ms, "v4_ms": v4_ms, "study_launches": study,
            }
        results["lane_efficiency"] = {**out["bench"], "max_abs_err": 0.0,
                                      "launches": sum(o["study_launches"] for o in out.values())}
        return out

    # ---- 6b. B1's route for a likelihood evaluated in torch ----------------
    def slice_step_bytes(B: int, D: int, launches: int, R: int) -> int:
        """Bytes the traced route must move: per launch and lane the state
        read and written (ten int32, one int64, three float32: 132 bytes),
        x and its direction read and the probe written (12 D bytes), plus
        the (R, B) records written once."""
        return launches * B * (132 + 12 * D) + 12 * R * B

    @phase("slice_step")
    def _():
        out = {}
        kw = (0x01234567, 0x89ABCDEF)
        for tag, geo in (("gaussian_ini", RUN), ("bench", BENCH), ("d40", TRACED_D40)):
            B, R, D = geo["B"], geo["R"], geo["D"]
            if tag == "d40":  # unit directions: B2 stops at dim 32
                gen = torch.Generator(dev).manual_seed(SEED)
                calc = make_batched_calculator(identity_prior, gaussian(D), D, 2, device=dev)
                x0, bnd, valid, _ = live_set_inputs(B, D, calc, gen, B_valid=geo["B_valid"])
                nh = torch.randn((B, R, D), generator=gen, device=dev)
                args = (x0, bnd, valid, nh / nh.norm(dim=2, keepdim=True),
                        torch.full((B, R), 0.2, device=dev))
                cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
            else:
                calc, cfg, args = geometry(tag, geo)
            want, plain_ms = cuda_once(lambda: slice_records_plain(  # noqa: B023
                lambda p: calc(p)[2], cfg, kw, *args))  # noqa: B023
            pairs = []
            for rounds in (1, 7, 32):
                got = pallas_slice_v4.slice_epoch_traced(calc, cfg, kw, *args, rounds=rounds)
                pairs += [(f"{k}_rounds{rounds}_vs_plain", a, b)
                          for k, a, b in zip(("t", "logL", "nlike"), got, want)]
            b1_ms = None
            if D <= pallas_slice_v4.SLICE_MAXD:  # the same decisions as B1's functor
                pairs += [(f"{k}_vs_B1", a, b) for k, a, b in zip(
                    ("t", "logL", "nlike"), want, pallas_slice_v4.slice_epoch(calc, cfg, kw, *args))]
                b1_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            mism = decisions(f"{tag}: the traced route differs", pairs)
            before = (pallas_slice_v4.LAUNCHES["slice_step"], dict(pallas_slice_v4.TRACED))
            pallas_slice_v4.slice_epoch_traced(calc, cfg, kw, *args)
            per_epoch = pallas_slice_v4.LAUNCHES["slice_step"] - before[0]
            replays = pallas_slice_v4.TRACED["replays"] - before[1]["replays"]
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch_traced(calc, cfg, kw, *args), 3)  # noqa: B023
            evals = int(want[2].sum())
            out[tag] = {
                "B": B, "R": R, "D": D, "valid_lanes": int(args[2].sum()), "evals": evals,
                "mismatches": mism, "launches_per_epoch": per_epoch,
                "replays_per_epoch": replays, "rounds_per_replay": pallas_slice_v4.ROUNDS,
                "ms": ms, "plain_ms": plain_ms, "b1_ms": b1_ms,
                "plain_over_route": plain_ms / ms, "route_over_b1": ms / b1_ms if b1_ms else None,
                "us_per_round": ms * 1e3 / max(per_epoch - 1, 1),
                "evals_per_s": evals / (ms / 1e3),
                "bound": bound(slice_step_bytes(B, D, per_epoch, R), 0),
            }
        results["slice_step"] = {**out["bench"], "max_abs_err": 0.0}
        return out

    # ---- 7. the main path: run() on ini/gaussian.ini ----------------------
    counters = (pallas_dirs.LAUNCHES, pallas_slice_v4.LAUNCHES, pallas_slice_v5.LAUNCHES,
                pallas_slice_v3.LAUNCHES, pallas_slice.LAUNCHES, v3_instr.LAUNCHES,
                prof_grid_overhead.LAUNCHES, prof_pallas_while.LAUNCHES,
                pallas_epoch_v2.LAUNCHES, pallas_slice_repeat.LAUNCHES)
    launches = {k: 0 for c in counters for k in c}

    def reset_launches():
        for c in counters + (pallas_slice_v4.GROUP_LAUNCHES,):
            for k in c:
                c[k] = 0

    def read_launches():
        return {k: v for c in counters for k, v in c.items()}

    def only(ran, kernels):
        """Whether exactly ``kernels`` of the path ran (each at least once)."""
        return all((ran.get(k, 0) > 0) == (k in kernels) for k in launches)

    def add_launches(ran):
        for k, v in ran.items():
            launches[k] += v

    @phase("run_gaussian_ini")
    def _():
        like = gaussian(INI["nDims"])
        with tempfile.TemporaryDirectory() as base:
            reset_launches()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # a replay divergence would warn
                pt.run(
                    like, INI["nDims"], nDerived=INI["nDerived"], nlive=INI["nlive"],
                    num_repeats=INI["num_repeats"], do_clustering=False,
                    precision_criterion=0.001, read_resume=False, base_dir=base,
                    seed=SEED, feedback=-1, device="cuda",
                )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            groups = {G: c for G, c in pallas_slice_v4.GROUP_LAUNCHES.items() if c}
            stats = PolyChordOutput(base, "test")
            with open(os.path.join(base, "test.metrics.jsonl")) as f:
                last = json.loads(f.read().splitlines()[-1])
        if last.get("engine") != "cuda":
            raise AssertionError(f"engine_used is {last.get('engine')!r}, not 'cuda'")
        if last.get("chained_epochs") is not True:
            raise AssertionError("chained epochs were switched off during the run")
        if not only(ran, ("gram_schmidt", "slice_epoch")):
            raise AssertionError(f"the path did not run B1 and B2 (only): {ran}")
        if 1 in groups or not groups:
            raise AssertionError(f"B1 ran at G = 1 on the path: launches by G {groups}")
        add_launches(ran)
        if not (math.isfinite(stats.logZ) and abs(stats.logZ - 0.0) < 3 * stats.logZerr):
            raise AssertionError(f"logZ {stats.logZ} +/- {stats.logZerr} is not within 3 sigma of 0")
        if stats.ndead != last["ndead"] or stats.ndead < INI["nlive"]:
            raise AssertionError(".stats does not match the run")
        results["run_gaussian_ini"] = {"wall_s": wall, "dead_per_s": stats.ndead / wall}
        return {
            "engine_used": last["engine"], "chained_epochs": last["chained_epochs"],
            "ndead": stats.ndead, "logZ": stats.logZ,
            "logZerr": stats.logZerr, "wall_s": wall, "dead_per_s": stats.ndead / wall,
            "launches": ran, "slice_epoch_launches_by_group": groups,
            "device_frac": last.get("device_frac"),
            "host_totals_s": last.get("host_totals"),
            "epoch_timers_s": last.get("epoch_timers"),
        }

    # ---- 7b. any torch likelihood through run(): the traced route ---------
    def traced_run(name, like, n_dims, **kw):
        """run() on the card with every launch count at 0 before it: (the
        final metrics record, the output, wall seconds, the launches).  The
        path must take the traced route and B2 only, with chained epochs
        kept (a replay divergence would warn, and warnings are errors)."""
        with tempfile.TemporaryDirectory() as base:
            reset_launches()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                pt.run(like, n_dims, read_resume=False, base_dir=base, seed=SEED, feedback=-1,
                       device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            stats = PolyChordOutput(base, "test")
            last = read_metrics(base, "test")[-1]
            chains = np.loadtxt(os.path.join(base, "test.txt"), ndmin=2)
        if (last.get("engine"), last.get("route")) != ("cuda", "slice_step"):
            raise AssertionError(f"{name}: engine {last.get('engine')!r}, route "
                                 f"{last.get('route')!r}, not the traced route")
        if last.get("chained_epochs") is not True:
            raise AssertionError(f"{name}: chained epochs were switched off during the run")
        if not only(ran, ("gram_schmidt", "slice_step")):
            raise AssertionError(f"{name}: the path did not run slice_step and B2 (only): {ran}")
        add_launches(ran)
        return last, stats, wall, ran, chains

    def traced_record(last, stats, wall, ran, truth):
        pull = (stats.logZ - truth) / stats.logZerr
        if not (math.isfinite(stats.logZ) and abs(pull) < 3.0):
            raise AssertionError(f"logZ {stats.logZ} +/- {stats.logZerr} is {pull:.2f} sigma "
                                 f"from {truth}")
        return {"engine_used": last["engine"], "route": last["route"], "form": last["form"],
                "chained_epochs": last["chained_epochs"], "ndead": stats.ndead,
                "logZ": stats.logZ, "logZerr": stats.logZerr, "oracle": truth,
                "pull_sigma": pull, "wall_s": wall, "dead_per_s": stats.ndead / wall,
                "launches": {k: v for k, v in ran.items() if v},
                "traced_route": last.get("traced_route"), "device_frac": last.get("device_frac"),
                "host_totals_s": last.get("host_totals"),
                "epoch_timers_s": last.get("epoch_timers")}

    def torch_gaussian(n_dims, mu=0.5, sigma=0.1):
        """gaussian.ini's likelihood as a user writes it in torch: batched,
        with its two derived parameters and no device form."""
        norm = -n_dims * (math.log(sigma) + 0.5 * math.log(2 * math.pi))
        log_vn = 0.5 * n_dims * math.log(math.pi) - math.lgamma(1 + 0.5 * n_dims)

        def loglikelihood(theta):
            r2 = ((theta - mu) ** 2).sum(-1)
            r = torch.sqrt(r2)
            return norm - 0.5 * r2 / sigma ** 2, torch.stack([r, n_dims * torch.log(r) + log_vn], -1)

        return loglikelihood

    @phase("run_gaussian_ini_torch")
    def _():
        last, stats, wall, ran, _ = traced_run(
            "gaussian.ini", torch_gaussian(INI["nDims"]), INI["nDims"], nDerived=INI["nDerived"],
            nlive=INI["nlive"], num_repeats=INI["num_repeats"], do_clustering=False,
            precision_criterion=0.001)
        if last["form"] != "batched":
            raise AssertionError(f"the batched likelihood was read as {last['form']!r}")
        rec = traced_record(last, stats, wall, ran, 0.0)
        functor = results.get("run_gaussian_ini", {})
        rec["functor_run_dead_per_s"] = functor.get("dead_per_s")
        rec["functor_run_wall_s"] = functor.get("wall_s")
        return rec

    def quickstart(theta):
        """The reference quickstart, per point (examples/quickstart.py)."""
        r2 = torch.sum(theta ** 2)
        return -math.log(2 * math.pi * 0.1 * 0.1) * 4 / 2.0 - r2 / 2 / 0.1 ** 2, [r2]

    @phase("run_quickstart_torch")
    def _():
        last, stats, wall, ran, chains = traced_run(
            "quickstart", quickstart, 4, nDerived=1, prior=UniformPrior(-1, 1), nlive=200,
            do_clustering=True)
        if last["form"] != "per_point":
            raise AssertionError(f"the per-point quickstart was read as {last['form']!r}")
        # weight, -2 logL, theta (4), r^2: the derived column is r^2 of its row
        if chains.shape[1] != 2 + 4 + 1:
            raise AssertionError(f"the chains have {chains.shape[1]} columns, not 7")
        r2_err = float(np.abs(chains[:, 6] - (chains[:, 2:6] ** 2).sum(1)).max())
        if not r2_err < 1e-5:
            raise AssertionError(f"the r^2 column is {r2_err} from theta's")
        return {**traced_record(last, stats, wall, ran, -4 * math.log(2.0)),
                "chain_rows": int(chains.shape[0]), "max_abs_r2_err": r2_err}

    @phase("run_gaussian_prior")
    def _():
        D, s_like, mu_p, s_p = 5, 0.5, 1.0, 1.0
        norm = -D * (math.log(s_like) + 0.5 * math.log(2 * math.pi))

        def like(theta):
            return norm - 0.5 * ((theta / s_like) ** 2).sum(-1)

        # Z = prod_d N(mu_p; 0, s_like^2 + s_p^2)
        var = s_like ** 2 + s_p ** 2
        truth = D * (-0.5 * math.log(2 * math.pi * var) - 0.5 * mu_p ** 2 / var)
        last, stats, wall, ran, _ = traced_run(
            "gaussian_prior", like, D, prior=GaussianPrior(mu_p, s_p), nlive=200)
        return traced_record(last, stats, wall, ran, truth)

    # ---- 8. the ini CLI on ini/gaussian_shells.ini (clustering) -----------
    shells = {}
    tmpdirs = []

    @phase("run_gaussian_shells_ini")
    def _():
        base = tempfile.mkdtemp(prefix="shells_cli_")
        tmpdirs.append(base)
        ini = ini_copy(base, "gaussian_shells")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "polychordlite_tpu_torch", ini], cwd=HERE,
            capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        summary = [ln for ln in proc.stdout.splitlines() if ln.startswith("logZ = ")]
        if not summary:
            raise AssertionError("the CLI printed no summary line")
        recs = read_metrics(base, "gaussian_shells")
        last = recs[-1]
        ran = last["kernel_launches"]
        out = PolyChordOutput(base, "gaussian_shells")
        shells.update(base=base, last=last)
        if last.get("engine") != "cuda":
            raise AssertionError(f"engine_used is {last.get('engine')!r}, not 'cuda'")
        if not only(ran, ("gram_schmidt", "slice_epoch")):
            raise AssertionError(f"the CLI run did not run B1 and B2 (only): {ran}")
        add_launches(ran)
        if not (math.isfinite(out.logZ) and abs(out.logZ - SHELLS_LOGZ) < 3 * out.logZerr):
            raise AssertionError(f"logZ {out.logZ} +/- {out.logZerr} not within 3 sigma "
                                 f"of {SHELLS_LOGZ}")
        max_ncluster = max(r["ncluster"] for r in recs)
        if max_ncluster < 2:
            raise AssertionError("the run never held two clusters")
        local, sides = shell_evidences(out, base, "gaussian_shells")
        if abs(lse(local) - out.logZ) > 0.5:
            raise AssertionError(f"local evidences {local} do not sum to logZ {out.logZ}")
        per_shell = {}
        for side, vals in sides.items():
            if not vals:
                raise AssertionError(f"no cluster on the x = {3.5 * side} shell")
            per_shell[side] = lse(vals)
            if abs(per_shell[side] - (out.logZ - math.log(2.0))) > 2 * out.logZerr + 0.25:
                raise AssertionError(f"shell {side}: local logZ {per_shell[side]}, "
                                     f"expected {out.logZ - math.log(2.0)}")
        return {
            "summary": summary[-1], "engine_used": last["engine"],
            "chained_epochs": last.get("chained_epochs"),
            "chains_voided": last.get("chains_voided"),
            "ndead": last["ndead"], "logZ": last["logZ"], "logZerr": last["logZerr"],
            "analytic_logZ": SHELLS_LOGZ, "max_ncluster": max_ncluster,
            "clusters_retired": len(local), "logZ_shell_minus": per_shell[-1],
            "logZ_shell_plus": per_shell[1], "launches": ran,
            "wall_s": wall, "dead_per_s": last["ndead"] / wall,
            "device_frac": last.get("device_frac"),
            "host_totals_s": last.get("host_totals"),
            "epoch_timers_s": last.get("epoch_timers"),
        }

    # ---- 9. the same settings through run(engine="cuda5") (B3) ------------
    def settings_kw(ini, base, engine):
        """run() keywords of an ini's settings, with base_dir and engine."""
        s, blocks, *_ = read_ini(ini)
        skip = ("nDims", "seed_point", "mesh_shape")
        kw = {k: getattr(s, k) for k in s.__dataclass_fields__ if k not in skip}
        kw.update(engine=engine, base_dir=base)
        return s.nDims, BlockPrior(blocks, s.nDims), kw

    @phase("run_gaussian_shells_v5")
    def _():
        if "last" not in shells:
            raise AssertionError("the CLI run failed; nothing to compare with")
        base = tempfile.mkdtemp(prefix="shells_v5_")
        tmpdirs.append(base)
        D, prior, kw = settings_kw(ini_copy(base, "gaussian_shells"), base, "cuda5")
        reset_launches()
        t0 = time.perf_counter()
        pt.run(gaussian_shells(D), D, prior=prior, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = read_launches()
        last = read_metrics(base, "gaussian_shells")[-1]
        if last.get("engine") != "cuda5":
            raise AssertionError(f"engine_used is {last.get('engine')!r}, not 'cuda5'")
        if not only(ran, ("gram_schmidt", "slice_epoch_v5")):
            raise AssertionError(f"the run did not run B3 and B2 (only): {ran}")
        add_launches(ran)
        cli = shells["last"]
        same = {k: last[k] == cli[k] for k in ("ndead", "logZ", "logZerr")}
        with open(os.path.join(base, "gaussian_shells.txt"), "rb") as f_v5, \
                open(os.path.join(shells["base"], "gaussian_shells.txt"), "rb") as f_cli:
            same["txt"] = f_v5.read() == f_cli.read()
        if not all(same.values()):
            raise AssertionError(f"the cuda5 run differs from the CLI run: {same}")
        return {
            "engine_used": last["engine"], "ndead": last["ndead"], "logZ": last["logZ"],
            "logZerr": last["logZerr"], "identical_to_cli": same, "launches": ran,
            "wall_s": wall, "dead_per_s": last["ndead"] / wall,
            "device_frac": last.get("device_frac"),
            "host_totals_s": last.get("host_totals"),
        }

    # ---- 10. the other analytic inis through run_ini, eggbox through the CLI
    zoo = {}

    def oracle_check(name, logZ, logZerr):
        """(oracle, sigma used, pull) of one run; raises beyond 3 sigma."""
        ref, ref_err, _ = ZOO_ORACLES[name]
        sigma = logZerr if ref_err is None else math.hypot(logZerr, ref_err)
        pull = (logZ - ref) / sigma
        if not (math.isfinite(logZ) and abs(pull) < 3.0):
            raise AssertionError(f"{name}: logZ {logZ} +/- {logZerr} is {pull:.2f} sigma "
                                 f"from {ref}")
        return ref, sigma, pull

    def zoo_record(name, base, wall, ran, via):
        last = read_metrics(base, name)[-1]
        if last.get("engine") != "cuda":
            raise AssertionError(f"{name}: engine_used is {last.get('engine')!r}, not 'cuda'")
        if not only(ran, ("gram_schmidt", "slice_epoch")):
            raise AssertionError(f"{name}: the run did not run B1 and B2 (only): {ran}")
        ref, sigma, pull = oracle_check(name, last["logZ"], last["logZerr"])
        return {
            "via": via, "engine_used": last["engine"], "ndead": last["ndead"],
            "logZ": last["logZ"], "logZerr": last["logZerr"], "oracle": ref,
            "oracle_from": ZOO_ORACLES[name][2], "pull_sigma": pull,
            "launches": {k: v for k, v in ran.items() if v},
            "wall_s": wall, "dead_per_s": last["ndead"] / wall,
            "device_frac": last.get("device_frac"), "host_totals_s": last.get("host_totals"),
        }

    @phase("run_zoo_inis")
    def _():
        out = {}
        for name in ZOO_ORACLES:
            base = tempfile.mkdtemp(prefix=f"{name}_")
            tmpdirs.append(base)
            ini = ini_copy(base, name)
            reset_launches()
            t0 = time.perf_counter()
            with open(os.path.join(OUT, f"{name}.log"), "w") as log, \
                    contextlib.redirect_stdout(log):  # the run's feedback lines
                run_ini(ini)  # the default device: the card
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            out[name] = zoo_record(name, base, wall, ran, "run_ini")
            add_launches(ran)
            zoo[name] = base
        base = tempfile.mkdtemp(prefix="eggbox_cli_")
        tmpdirs.append(base)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "polychordlite_tpu_torch", ini_copy(base, "eggbox")],
            cwd=HERE, capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the eggbox CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        ran = read_metrics(base, "eggbox")[-1]["kernel_launches"]
        out["eggbox_cli"] = zoo_record("eggbox", base, wall, ran, "python -m polychordlite_tpu_torch")
        add_launches(ran)
        return out

    # ---- 11. himmelblau on B4 (bitwise the B1 run) and on B5 ---------------
    @phase("run_himmelblau_ab")
    def _():
        if "himmelblau" not in zoo:
            raise AssertionError("the run_ini himmelblau run failed; nothing to compare with")
        out = {}
        for engine, kernel in (("cuda3", "slice_epoch_v3"), ("cuda2", "slice_epoch_v2")):
            base = tempfile.mkdtemp(prefix=f"himmelblau_{engine}_")
            tmpdirs.append(base)
            D, prior, kw = settings_kw(ini_copy(base, "himmelblau"), base, engine)
            reset_launches()
            t0 = time.perf_counter()
            with open(os.path.join(OUT, f"himmelblau_{engine}.log"), "w") as log, \
                    contextlib.redirect_stdout(log):
                pt.run(himmelblau(D), D, prior=prior, device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_launches()
            last = read_metrics(base, "himmelblau")[-1]
            if last.get("engine") != engine:
                raise AssertionError(f"engine_used is {last.get('engine')!r}, not {engine!r}")
            if not only(ran, ("gram_schmidt", kernel)):
                raise AssertionError(f"the {engine} run did not run {kernel} and B2 (only): {ran}")
            add_launches(ran)
            rec = {"engine_used": engine, "ndead": last["ndead"], "logZ": last["logZ"],
                   "logZerr": last["logZerr"], "launches": {k: v for k, v in ran.items() if v},
                   "wall_s": wall, "dead_per_s": last["ndead"] / wall,
                   "device_frac": last.get("device_frac")}
            if engine == "cuda3":  # the same decisions: the B1 run, bit for bit
                ref = read_metrics(zoo["himmelblau"], "himmelblau")[-1]
                same = {k: last[k] == ref[k] for k in ("ndead", "logZ", "logZerr")}
                with open(os.path.join(base, "himmelblau.txt"), "rb") as f, \
                        open(os.path.join(zoo["himmelblau"], "himmelblau.txt"), "rb") as g:
                    same["txt"] = f.read() == g.read()
                if not all(same.values()):
                    raise AssertionError(f"the cuda3 run differs from the cuda run: {same}")
                rec["identical_to_cuda"] = same
            else:  # another chain (v2's cube): held to the analytic evidence
                rec["oracle"], _, rec["pull_sigma"] = oracle_check(
                    "himmelblau", last["logZ"], last["logZerr"])
            out[engine] = rec
        return out

    # ---- 12. the structure-cost studies (E3, E2, E6, E7) ------------------
    # Each phase holds its kernel against its plain version (and the kernels
    # making the same decisions) on the card, then runs its study at full
    # size with that kernel's count set to 0 just before and read just after.
    def study_inputs():
        return slice_inputs(dev, BENCH["B"], BENCH["R"], BENCH["D"], 0)

    STUDY_GEOMETRIES = (("small", SMALL), ("gaussian_ini", RUN), ("bench", BENCH))

    @phase("lockstep_waste")
    def _():
        out = {}
        for tag, geo in STUDY_GEOMETRIES:
            calc, cfg, args = geometry(tag, geo)
            kw = (0x01234567, 0x89ABCDEF)
            got = pallas_slice.slice_epoch_v2_counted(calc, cfg, kw, *args)
            b5 = pallas_slice.slice_epoch_v2(calc, cfg, kw, *args)
            want = pallas_slice.slice_records_lockstep_plain(
                lambda p: calc(p)[2], cfg, kw, *args, count_steps=True)  # noqa: B023
            names = ("t", "logL", "nlike", "cube", "steps", "iters")
            out[tag] = {"B": geo["B"], "R": geo["R"], "mismatches": decisions(
                f"{tag}: E3 differs",
                [(f"{k}_vs_plain", a, b) for k, a, b in zip(names, got, want)]
                + [(f"{k}_vs_B5", a, b) for k, a, b in zip(names, got, b5)]),
                "iters_sum": int(got[5].sum()),
                "ms": cuda_ms(lambda: pallas_slice.slice_epoch_v2_counted(  # noqa: B023
                    calc, cfg, kw, *args), 5),  # noqa: B023
                "b5_ms": cuda_ms(lambda: pallas_slice.slice_epoch_v2(  # noqa: B023
                    calc, cfg, kw, *args), 5)}  # noqa: B023
        calc, cfg, kw, args = study_inputs()
        pallas_slice.LAUNCHES["slice_epoch_v2_counted"] = 0
        rec = prof_lockstep_waste.main()
        study = pallas_slice.LAUNCHES["slice_epoch_v2_counted"]
        _, plain_ms = cuda_once(lambda: pallas_slice.slice_records_lockstep_plain(
            lambda p: calc(p)[2], cfg, kw, *args, count_steps=True))
        B, R, D = BENCH["B"], BENCH["R"], BENCH["D"]
        results["lockstep_waste"] = {
            "ms": rec["ms"], "plain_ms": plain_ms, "max_abs_err": 0.0, "launches": study,
            "lane_efficiency": rec["lane_efficiency"],
            "bound": bound(slice_epoch_bytes(B, R, D, cube=True) + 4 * (R * B + R),
                           rec["lane_steps"] * gaussian_probe_flops(D))}
        return {"checks": out, "study": rec, "study_launches": study, "plain_ms": plain_ms}

    @phase("v3_iters")
    def _():
        out = {}
        for tag, geo in STUDY_GEOMETRIES:
            calc, cfg, args = geometry(tag, geo)
            kw = (0x01234567, 0x89ABCDEF)
            got = v3_instr.slice_epoch_v3_instr(calc, cfg, kw, *args)
            cheap = v3_instr.slice_epoch_v3_instr(calc, cfg, kw, *args, cheap=True)
            b4 = pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args)
            b1 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
            want = pallas_slice_v3.slice_records_window_plain(
                lambda p: calc(p)[2], cfg, kw, *args, count_iters=True)  # noqa: B023
            names = ("t", "logL", "nlike", "iters")
            out[tag] = {"B": geo["B"], "R": geo["R"], "iters_sum": int(got[3].sum()),
                        "mismatches": decisions(
                f"{tag}: E2 differs",
                [(f"{k}_vs_plain", a, b) for k, a, b in zip(names, got, want)]
                + [(f"{k}_vs_{o}", a, b) for o, ref in (("B4", b4), ("B1", b1))
                   for k, a, b in zip(names[:3], got, ref)]
                + [("cheap_iters_not_1", cheap[3], torch.ones_like(cheap[3]))])}
            out[tag].update({  # the same kernel unchecked (no wait for its flag), and B4
                form: cuda_ms(lambda c=c: v3_instr.slice_epoch_v3_instr(  # noqa: B023
                    calc, cfg, kw, *args, cheap=c, check=False), 5)  # noqa: B023
                for form, c in (("ms", False), ("cheap_ms", True))})
            out[tag]["b4_ms"] = cuda_ms(
                lambda: pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args), 5)  # noqa: B023
        calc, cfg, kw, args = study_inputs()
        v3_instr.LAUNCHES["slice_epoch_v3_instr"] = 0
        rec = prof_v3_iters.main()
        study = v3_instr.LAUNCHES["slice_epoch_v3_instr"]
        _, plain_ms = cuda_once(lambda: pallas_slice_v3.slice_records_window_plain(
            lambda p: calc(p)[2], cfg, kw, *args, count_iters=True))
        # what the simulation projects beside what E1 and E3 measured
        steps, wmax = pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *args)[3:]
        sim = sim_iter_distribution.main()
        projections = {
            "sim_lockstep_lane_efficiency": {W: v["lane_efficiency"]
                                             for W, v in sim["lockstep"].items()},
            "sim_free_running_lane_efficiency": {W: v["lane_efficiency"]
                                                 for W, v in sim["free_running"].items()},
            "E1_lane_efficiency_study_inputs": pallas_slice_v4.lane_efficiency(steps, wmax),
            "E1_lane_efficiency_bench": results["lane_efficiency"]["lane_efficiency"],
            "E3_lane_efficiency": results.get("lockstep_waste", {}).get("lane_efficiency"),
        }
        B, R, D = BENCH["B"], BENCH["R"], BENCH["D"]
        results["v3_iters"] = {
            "ms": rec["real"]["ms"], "plain_ms": plain_ms, "max_abs_err": 0.0,
            "launches": study,
            "bound": bound(slice_epoch_bytes(B, R, D) + 4 * (R + 1),
                           int(steps.sum()) * gaussian_probe_flops(D))}
        return {"checks": out, "study": rec, "study_launches": study, "plain_ms": plain_ms,
                "projections": projections, "simulation": sim}

    @phase("grid_overhead")
    def _():
        g = prof_grid_overhead
        R, D, S = g.SIZES["R"], g.SIZES["D"], g.SIZES["S"]
        stream, head, x0 = g.grid_inputs(dev, R, D, S, ones=False, seed=SEED)
        decisions("E6 differs from its plain version", [
            (v, g.grid_steps(v, stream, head, x0), g.grid_steps_plain(v, stream, head, x0))
            for v in g.VARIANTS])
        g.LAUNCHES["grid_steps"] = 0
        rec = g.main()
        study = g.LAUNCHES["grid_steps"]
        stream, head, x0 = g.grid_inputs(dev, R, D, S)
        plain_ms = cuda_ms(lambda: g.grid_steps_plain("E", stream, head, x0), 3)
        E = S * g.LANE
        results["grid_overhead"] = {
            "ms": rec["variants"]["E"]["ms"], "plain_ms": plain_ms, "max_abs_err": 0.0, "launches": study,
            "bound": bound(4 * (R * D * E + 3 * D * E + D * E + R * E), 3 * R * E)}
        return {"study": rec, "study_launches": study, "plain_ms_E": plain_ms}

    @phase("while_cost")
    def _():
        w = prof_pallas_while
        S, n = w.SIZES["S"], w.SIZES["n"]
        x = 0.2 + 0.6 * torch.rand((S, w.LANE), generator=torch.Generator(dev).manual_seed(SEED),
                                   device=dev)
        short = 2000  # every body held to its plain version over this many iterations
        decisions("E7 differs from its plain version", [
            (v, w.while_loop(v, x, short), w.while_loop_plain(v, x, short))
            for v in w.VARIANTS])
        w.LAUNCHES["while_loop"] = 0
        rec = w.main()
        study = w.LAUNCHES["while_loop"]
        # body20 at full length: the kernel against one timed plain run
        zeros = torch.zeros((S, w.LANE), device=dev)
        want, plain_ms = cuda_once(lambda: w.while_loop_plain("body20", zeros, n))
        decisions("E7 body20 differs at full length", [("body20", w.while_loop("body20", zeros, n),
                                                         want)])
        E = S * w.LANE
        results["while_cost"] = {
            "ms": rec["variants"]["body20"]["ms"], "plain_ms": plain_ms, "max_abs_err": 0.0,
            "launches": study,
            "bound": bound(4 * (E + w.BODY20_D * E + E), n * E * (5 * w.BODY20_D + 3))}
        return {"study": rec, "study_launches": study, "plain_ms_body20": plain_ms,
                "checked_iterations": {"all": short, "body20": n}}

    # ---- 13. the prototypes (E4, E5) ---------------------------------------
    def max_err(got, want):
        return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))

    @phase("proto_epoch")
    def _():
        e = pallas_epoch_v2
        D = e.SIZES["D"]
        seed = torch.tensor([1234], dtype=torch.int32, device=dev)
        out, errs = {}, []
        for tag, S, R in (("small", SMALL["B"] // e.LANE, SMALL["R"]),
                          ("full", e.SIZES["S"], e.SIZES["R"])):
            args = e.study_inputs(dev, D, S, R, seed=SEED)
            got = e.proto_epoch(seed, *args)
            (*want, steps), plain_ms = cuda_once(
                lambda: e.proto_epoch_plain(seed, *args, count_steps=True))  # noqa: B023
            mism = decisions(f"{tag}: E4 differs from its plain version",
                             list(zip(("cube", "logL", "nlike"), got, want)))
            errs.append(max_err(got, want))
            steps = steps.to(torch.int64)
            out[tag] = {
                "B": S * e.LANE, "R": R, "D": D, "mismatches": mism, "evals": int(got[2].sum()),
                "accepted_frac": float((got[1] > e.LOGZERO).float().mean()),
                "lane_iterations_sum": int(steps.sum()),
                "lane_iterations_max": int(steps.sum(0).max()),
                "lockstep_iterations": int(steps.flatten(1).max(1).values.sum()),
                "ms": cuda_ms(lambda: e.proto_epoch(seed, *args), 5),  # noqa: B023
                "plain_ms": plain_ms}
        full = out["full"]
        full["us_per_lane_iteration"] = full["ms"] * 1e3 / full["lane_iterations_max"]
        # B1 in the same call, at the bench geometry (E7's measure of it)
        calc, cfg, kw, b1_args = study_inputs()
        b1_steps = pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *b1_args)[3]
        b1_ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *b1_args), 5)
        b1 = {"B": BENCH["B"], "R": BENCH["R"], "D": BENCH["D"], "ms": b1_ms,
              "lane_steps_max": int(b1_steps.max()),
              "us_per_micro_step": b1_ms * 1e3 / int(b1_steps.max())}
        e.LAUNCHES["proto_epoch"] = 0
        rec = e.main()
        study = e.LAUNCHES["proto_epoch"]
        B, R = full["B"], full["R"]
        results["proto_epoch"] = {
            "ms": full["ms"], "plain_ms": full["plain_ms"], "max_abs_err": max(errs),
            "launches": study,
            "bound": bound(4 * (D * B + B + 2 * R * D * B + 2 * R * B + B),
                           full["lane_iterations_sum"] * gaussian_probe_flops(D))}
        return {"checks": out, "b1": b1,
                "e4_lane_iteration_over_b1_micro_step":
                    full["us_per_lane_iteration"] / b1["us_per_micro_step"],
                "study": rec, "study_launches": study}

    @phase("proto_repeat")
    def _():
        p = pallas_slice_repeat
        D = p.SIZES["D"]
        seed = torch.tensor([1234], dtype=torch.int32, device=dev)
        out, errs = {}, []
        for nb in (2, 8):
            x0, nh, w, bnd = p.study_inputs(dev, D, nb, seed=SEED)
            args = (x0, nh, w, bnd)
            got = p.proto_repeat(seed, *args)
            (*want, steps), plain_ms = cuda_once(
                lambda: p.proto_repeat_plain(seed, *args, count_steps=True))  # noqa: B023
            pairs = list(zip(("cube", "logL", "nlike"), got, want))
            errs.append(max_err(got, want))
            xs, xp = x0, x0  # ten launches back to back against the plain chain
            for r in range(10):
                xs, ls, ns = p.proto_repeat(seed + r, xs, nh, w, bnd)
                xp, lp, n_p = p.proto_repeat_plain(seed + r, xp, nh, w, bnd)
            pairs += [("chain_cube", xs, xp), ("chain_logL", ls, lp), ("chain_nlike", ns, n_p)]
            out[f"nb{nb}"] = {
                "B": nb * p.BLOCK, "D": D,
                "mismatches": decisions(f"nb={nb}: E5 differs from its plain version", pairs),
                "evals": int(got[2].sum()), "lane_steps_sum": int(steps.sum()),
                "lane_steps_max": int(steps.max()),
                "ms": graph_ms(lambda: p.proto_repeat(seed, *args)),  # noqa: B023
                "host_clocked_ms": cuda_ms(lambda: p.proto_repeat(seed, *args), 20),  # noqa: B023
                "plain_ms": plain_ms}
        p.LAUNCHES["proto_repeat"] = 0
        rec = p.main()
        study = p.LAUNCHES["proto_repeat"]
        o = out["nb2"]
        B = o["B"]
        results["proto_repeat"] = {
            "ms": o["ms"], "plain_ms": o["plain_ms"], "max_abs_err": max(errs),
            "launches": study,
            "bound": bound(4 * (3 * D * B + 4 * B + 1),
                           o["lane_steps_sum"] * gaussian_probe_flops(D))}
        return {"checks": out, "study": rec, "study_launches": study}

    for d in tmpdirs:
        shutil.rmtree(d, ignore_errors=True)

    if "jax" in sys.modules:
        failed.append("no_jax")
        emit({"phase": "no_jax", "ok": False, "error": "jax was imported"})
    if failed:
        fail(f"failed phases: {failed}")
    # bounds at the bench geometry, from its shapes and the micro-steps its
    # data needed (E1's count; every slice kernel makes those decisions)
    Bb, Rb, Db = BENCH["B"], BENCH["R"], BENCH["D"]
    flops = results["lane_efficiency"]["sum_lane_steps"] * gaussian_probe_flops(Db)
    src = "polychordlite_tpu_torch/csrc/"
    rows = [
        ("slice_epoch", "slice_epoch.cu", "polychordlite_tpu/ops/pallas_slice_v4.py:508",
         "slice_epoch", bound(slice_epoch_bytes(Bb, Rb, Db), flops), None),
        ("gram_schmidt", "gram_schmidt.cu", "polychordlite_tpu/ops/pallas_dirs.py:71",
         "gram_schmidt", (results["gram_schmidt"]["bound_ms"], results["gram_schmidt"]["bound_by"]),
         results["gram_schmidt"]["library_ms"]),
        ("slice_epoch_v5", "slice_epoch_v5.cu", "polychordlite_tpu/ops/pallas_slice_v5.py:606",
         "slice_epoch_v5", bound(slice_epoch_bytes(Bb, Rb, Db), flops), None),
        ("slice_epoch_v3", "slice_epoch_v3.cu", "polychordlite_tpu/ops/pallas_slice_v3.py:345",
         "slice_epoch_v3", bound(slice_epoch_bytes(Bb, Rb, Db), flops), None),
        ("slice_epoch_v2", "slice_epoch_v2.cu", "polychordlite_tpu/ops/pallas_slice.py:372",
         "slice_epoch_v2", bound(slice_epoch_bytes(Bb, Rb, Db, cube=True), flops), None),
        ("slice_epoch_counted", "slice_epoch.cu", "experiments/v4_instr.py:384",
         "lane_efficiency", bound(slice_epoch_bytes(Bb, Rb, Db, counted=True), flops), None),
        ("slice_step", "slice_step.cu", "polychordlite_tpu/ops/pallas_slice_v4.py:508",
         "slice_step", results["slice_step"]["bound"], None),
    ] + [
        (name, source, replaces, res, results[res]["bound"], None)
        for name, source, replaces, res in (
            ("slice_epoch_v3_instr", "slice_epoch_v3_instr.cu", "experiments/v3_instr.py:351",
             "v3_iters"),
            ("slice_epoch_v2_counted", "slice_epoch_v2.cu",
             "experiments/prof_lockstep_waste.py:165", "lockstep_waste"),
            ("grid_steps", "probes.cu", "experiments/prof_grid_overhead.py:90", "grid_overhead"),
            ("while_loop", "probes.cu", "experiments/prof_pallas_while.py:66", "while_cost"),
            ("proto_epoch", "prototypes.cu", "experiments/pallas_epoch_v2.py:141", "proto_epoch"),
            ("proto_repeat", "prototypes.cu", "experiments/pallas_slice_repeat.py:124",
             "proto_repeat"),
        )
    ]
    kernels = []
    PATH_KERNELS = ("slice_epoch", "gram_schmidt", "slice_epoch_v5", "slice_epoch_v3",
                    "slice_epoch_v2", "slice_step")  # the others: their studies' own launches
    se = results["slice_epoch"]
    redesigned = {  # B1's G = 1 form, in this run
        "slice_epoch": {"group": se["group"], "previous_ms": se["g1_ms"],
                        "previous": "the G = 1 form, in this run"},
    }
    for name, source, replaces, res, (bound_ms, bound_by), library_ms in rows:
        r = results[res]
        plain_ms = r.get("plain_ms", results["slice_epoch"]["plain_ms"])  # E1's plain: B1's
        kernels.append({
            "name": name, "route": "cuda", "source": src + source, "replaces": replaces,
            "launches": launches[name] if name in PATH_KERNELS else r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            **redesigned.get(name, {}),
        })
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        fail(f"kernels never launched on their paths: {missing}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
