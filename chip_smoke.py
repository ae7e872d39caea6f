"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's three CUDA kernels from ``polychordlite_tpu_torch/csrc``
(one ``nvcc`` each, started together), checks each against its plain torch
version on the card, then drives the port's paths and checks what comes
out and which kernels ran:

* ``run_gaussian_ini``: ``run()`` on the 20-D Gaussian of
  ``ini/gaussian.ini`` (nlive 500, num_repeats 40, no clustering), engine
  ``"cuda"`` (the v4 kernel) and the Gram-Schmidt kernel;
* ``run_gaussian_shells_ini``: ``python3 -m polychordlite_tpu_torch`` on a
  copy of ``ini/gaussian_shells.ini`` (2-D, two shells, clustering, nlive
  500, num_repeats 10) with only ``base_dir`` and a fixed ``seed`` added;
  the fresh process starts with every launch count at 0 and writes the
  launches of its run into its ``.metrics.jsonl``;
* ``run_gaussian_shells_v5``: the same settings through
  ``run(..., engine="cuda5")`` (the speculative-packet kernel), which must
  give the CLI run's result bit for bit.

Each phase prints one JSON line; the line before the last lists the
kernels, and the last line is ``{"ok": true, "device": ...}``.  Any failed
phase exits non-zero without that line.  Without a CUDA device, or without
the package beside this file, it exits non-zero at once.
"""

from __future__ import annotations

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
SEED = 20250101
BENCH = dict(B=8192, R=100, D=20)        # the slice bench geometry
SMALL = dict(B=1024, R=8, D=20)
INI = dict(nDims=20, nDerived=2, nlive=500, num_repeats=40)  # ini/gaussian.ini
# what run() gives the kernel on ini/gaussian.ini: B = nlive rounded to 8
# logical lanes, padded to 512 physical lanes (parallel/mesh.py)
RUN = dict(B=512, R=40, D=20, B_valid=504)
# ... and on ini/gaussian_shells.ini (nlive 500, num_repeats 10, 2-D)
SHELLS = dict(B=512, R=10, D=2, B_valid=504)
SHELLS_LOGZ = -math.log(60.0)  # normalised shells over the [-6,6] x [-2.5,2.5] box
LIBRARIES = {
    "gram_schmidt": ["gram_schmidt.cu"],
    "slice_epoch": ["slice_epoch.cu"],
    "slice_epoch_v5": ["slice_epoch_v5.cu"],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def shells_ini_copy(base: str) -> str:
    """ini/gaussian_shells.ini with base_dir set to ``base`` and a fixed
    seed added, nothing else changed."""
    with open(os.path.join(HERE, "ini", "gaussian_shells.ini")) as f:
        src = f.read()
    if "base_dir = chains" not in src:
        raise AssertionError("ini/gaussian_shells.ini has no 'base_dir = chains' line")
    src = src.replace("base_dir = chains", f"base_dir = {base}\nseed = {SEED}")
    path = os.path.join(base, "gaussian_shells.ini")
    with open(path, "w") as f:
        f.write(src)
    return path


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
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU", 2)
    sys.path.insert(0, HERE)
    try:
        import polychordlite_tpu_torch as pt
        from polychordlite_tpu_torch.models import gaussian, gaussian_shells
        from polychordlite_tpu_torch.ops import pallas_dirs, pallas_slice_v4, pallas_slice_v5
        from polychordlite_tpu_torch.ops.directions import make_directions
        from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
        from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, slice_records_plain
        from polychordlite_tpu_torch.output import PolyChordOutput
        from polychordlite_tpu_torch.priors import BlockPrior, identity_prior
        from polychordlite_tpu_torch.utils import nvcc
        from polychordlite_tpu_torch.utils.inifile import read_ini
    except ImportError as e:
        fail(f"cannot import the port beside this script ({e})")

    dev = torch.device("cuda")
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
            try:
                out = fn()
                emit({"phase": name, "ok": True, "card": label, **out})
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
        pallas_dirs._lib()
        pallas_slice_v4._lib()
        pallas_slice_v5._lib()
        ptxas = {
            name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            for name, log in nvcc.build_log.items()
        }
        return {"seconds": round(time.perf_counter() - t0, 3),
                "per_library": {k: round(v, 3) for k, v in nvcc.build_seconds.items()},
                "ptxas": ptxas}

    # ---- 2. Gram-Schmidt (B2) against its plain version --------------------
    @phase("gram_schmidt")
    def _():
        out = {}
        for tag, shape in (("bench", (5, 20, 20, BENCH["B"])), ("gaussian_ini", (2, 20, 20, 512))):
            g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(1), device=dev)
            q = pallas_dirs.gram_schmidt_lanes(g)
            q_plain = pallas_dirs.gram_schmidt_plain(g)
            err = (q - q_plain).abs().max().item()
            qtq = torch.einsum("nikb,nijb->nkjb", q, q)
            orth = (qtq - torch.eye(shape[1], device=dev)[None, :, :, None]).abs().max().item()
            if not (err <= 1e-5 and orth <= 1e-5):
                raise AssertionError(f"{tag}: max|dq| {err:.3g}, max|QtQ - I| {orth:.3g}")
            out[tag] = {
                "shape": list(shape), "max_abs_err": err, "orth_err": orth,
                "ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_lanes(g), 20),  # noqa: B023
                "plain_ms": cuda_ms(lambda: pallas_dirs.gram_schmidt_plain(g), 3),  # noqa: B023
            }
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
            if tag == "gaussian_ini":
                x0, bound, valid, chol = live_set_inputs(B, D, calc, gen)
            else:
                x0, bound, valid, chol = ball_inputs(B, D, like, gen)
        cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
        nh, w, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                                   generator=gen)
        return calc, cfg, (x0, bound, valid, nh, w)

    GEOMETRIES = (("small", SMALL), ("gaussian_ini", RUN), ("bench", BENCH),
                  ("shells_ini", SHELLS))

    # ---- 3. slice epoch (B1) against the plain torch engine ----------------
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
            tp, lp, n_p = slice_records_plain(lambda p: calc(p)[2], cfg, kw, *args)  # noqa: B023
            mism = {
                "t": int((t != tp).sum()), "logL": int((l != lp).sum()),
                "nlike": int((n != n_p).sum()),
            }
            if any(mism.values()):
                raise AssertionError(f"{tag}: kernel and plain engine differ {mism}")
            err = max((t - tp).abs().max().item(), (l - lp).abs().max().item())
            evals = int(n.sum())
            ms = cuda_ms(lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args), 5)  # noqa: B023
            plain_ms = cuda_ms(
                lambda: slice_records_plain(lambda p: calc(p)[2], cfg, kw, *args), 1  # noqa: B023
            )
            out[tag] = {
                "B": B, "R": R, "D": D, "valid_lanes": int(valid.sum()),
                "evals": evals, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms,
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
            want = plain()
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
            plain_ms = cuda_ms(plain, 1)
            out[tag] = {
                "B": B, "R": R, "D": D, "valid_lanes": int(args[2].sum()),
                "evals": evals, "mismatches": mism, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "v4_ms": v4_ms,
                "evals_per_s": evals / (ms / 1e3), "plain_evals_per_s": evals / (plain_ms / 1e3),
            }
        results["slice_epoch_v5"] = {**out["bench"],
                                     "max_abs_err": max(o["max_abs_err"] for o in out.values())}
        return out

    # ---- 5. the main path: run() on ini/gaussian.ini ----------------------
    launches = {"gram_schmidt": 0, "slice_epoch": 0, "slice_epoch_v5": 0}

    def reset_launches():
        pallas_dirs.LAUNCHES["gram_schmidt"] = 0
        pallas_slice_v4.LAUNCHES["slice_epoch"] = 0
        pallas_slice_v5.LAUNCHES["slice_epoch_v5"] = 0

    def read_launches():
        return {**pallas_dirs.LAUNCHES, **pallas_slice_v4.LAUNCHES, **pallas_slice_v5.LAUNCHES}

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
            stats = PolyChordOutput(base, "test")
            with open(os.path.join(base, "test.metrics.jsonl")) as f:
                last = json.loads(f.read().splitlines()[-1])
        if last.get("engine") != "cuda":
            raise AssertionError(f"engine_used is {last.get('engine')!r}, not 'cuda'")
        if last.get("chained_epochs") is not True:
            raise AssertionError("chained epochs were switched off during the run")
        if not (ran["gram_schmidt"] and ran["slice_epoch"]) or ran["slice_epoch_v5"]:
            raise AssertionError(f"the path did not run B1 and B2 (only): {ran}")
        add_launches(ran)
        if not (math.isfinite(stats.logZ) and abs(stats.logZ - 0.0) < 3 * stats.logZerr):
            raise AssertionError(f"logZ {stats.logZ} +/- {stats.logZerr} is not within 3 sigma of 0")
        if stats.ndead != last["ndead"] or stats.ndead < INI["nlive"]:
            raise AssertionError(".stats does not match the run")
        return {
            "engine_used": last["engine"], "chained_epochs": last["chained_epochs"],
            "ndead": stats.ndead, "logZ": stats.logZ,
            "logZerr": stats.logZerr, "wall_s": wall, "dead_per_s": stats.ndead / wall,
            "launches": ran,
            "device_frac": last.get("device_frac"),
            "host_totals_s": last.get("host_totals"),
            "epoch_timers_s": last.get("epoch_timers"),
        }

    # ---- 6. the ini CLI on ini/gaussian_shells.ini (clustering) -----------
    shells = {}
    tmpdirs = []

    @phase("run_gaussian_shells_ini")
    def _():
        base = tempfile.mkdtemp(prefix="shells_cli_")
        tmpdirs.append(base)
        ini = shells_ini_copy(base)
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
        if not (ran["gram_schmidt"] and ran["slice_epoch"]) or ran["slice_epoch_v5"]:
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

    # ---- 7. the same settings through run(engine="cuda5") (B3) ------------
    @phase("run_gaussian_shells_v5")
    def _():
        if "last" not in shells:
            raise AssertionError("the CLI run failed; nothing to compare with")
        base = tempfile.mkdtemp(prefix="shells_v5_")
        tmpdirs.append(base)
        s, blocks, *_ = read_ini(shells_ini_copy(base))
        skip = ("nDims", "seed_point", "mesh_shape")
        kw = {k: getattr(s, k) for k in s.__dataclass_fields__ if k not in skip}
        kw.update(engine="cuda5", base_dir=base)
        reset_launches()
        t0 = time.perf_counter()
        pt.run(gaussian_shells(s.nDims), s.nDims, prior=BlockPrior(blocks, s.nDims),
               device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = read_launches()
        last = read_metrics(base, "gaussian_shells")[-1]
        if last.get("engine") != "cuda5":
            raise AssertionError(f"engine_used is {last.get('engine')!r}, not 'cuda5'")
        if not (ran["slice_epoch_v5"] and ran["gram_schmidt"]) or ran["slice_epoch"]:
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

    for d in tmpdirs:
        shutil.rmtree(d, ignore_errors=True)

    if "jax" in sys.modules:
        failed.append("no_jax")
        emit({"phase": "no_jax", "ok": False, "error": "jax was imported"})
    if failed:
        fail(f"failed phases: {failed}")

    src = "polychordlite_tpu_torch/csrc/"
    emit({"kernels": [
        {"name": "slice_epoch", "route": "cuda", "source": src + "slice_epoch.cu",
         "replaces": "polychordlite_tpu/ops/pallas_slice_v4.py:508",
         "launches": launches["slice_epoch"],
         "max_abs_err": results["slice_epoch"]["max_abs_err"],
         "ms": results["slice_epoch"]["ms"], "plain_ms": results["slice_epoch"]["plain_ms"]},
        {"name": "slice_epoch_v5", "route": "cuda", "source": src + "slice_epoch_v5.cu",
         "replaces": "polychordlite_tpu/ops/pallas_slice_v5.py:606",
         "launches": launches["slice_epoch_v5"],
         "max_abs_err": results["slice_epoch_v5"]["max_abs_err"],
         "ms": results["slice_epoch_v5"]["ms"],
         "plain_ms": results["slice_epoch_v5"]["plain_ms"]},
        {"name": "gram_schmidt", "route": "cuda", "source": src + "gram_schmidt.cu",
         "replaces": "polychordlite_tpu/ops/pallas_dirs.py:71",
         "launches": launches["gram_schmidt"],
         "max_abs_err": results["gram_schmidt"]["max_abs_err"],
         "ms": results["gram_schmidt"]["ms"], "plain_ms": results["gram_schmidt"]["plain_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
