"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from ``polychordlite_tpu_torch/csrc``,
checks each against its plain torch version on the card, then drives the
port's main path — ``run()`` on the 20-D Gaussian of ``ini/gaussian.ini``
(nlive 500, num_repeats 40, no clustering) — and checks the evidence and
the launch counts.  Each phase prints one JSON line; the line before the
last lists the kernels, and the last line is ``{"ok": true, "device": ...}``.
Any failed phase exits non-zero without that line.  Without a CUDA device,
or without the package beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
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
        from polychordlite_tpu_torch.models import gaussian
        from polychordlite_tpu_torch.ops import pallas_dirs, pallas_slice_v4
        from polychordlite_tpu_torch.ops.directions import make_directions
        from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
        from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, slice_records_plain
        from polychordlite_tpu_torch.output import PolyChordOutput
        from polychordlite_tpu_torch.priors import identity_prior
        from polychordlite_tpu_torch.utils import nvcc
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

    # ---- 1. build --------------------------------------------------------
    @phase("build")
    def _():
        t0 = time.perf_counter()
        pallas_dirs._lib()
        pallas_slice_v4._lib()
        ptxas = [
            ln.strip() for log in nvcc.build_log.values() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln
        ]
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

    # ---- 3. slice epoch (B1) against the plain torch engine ----------------
    @phase("slice_epoch")
    def _():
        out = {}
        for tag, geo in (("small", SMALL), ("gaussian_ini", RUN), ("bench", BENCH)):
            B, R, D = geo["B"], geo["R"], geo["D"]
            like = gaussian(D)
            calc = make_batched_calculator(identity_prior, like, D, 2)
            cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
            pallas_slice_v4.validate_functor(calc, cfg, dev)
            gen = torch.Generator(dev).manual_seed(SEED)
            if tag == "gaussian_ini":
                x0, bound, valid, chol = live_set_inputs(B, D, calc, gen)
            else:
                x0, bound, valid, chol = ball_inputs(B, D, like, gen)
            nh, w, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                                       generator=gen)
            kw = (0x01234567, 0x89ABCDEF)
            args = (x0, bound, valid, nh, w)
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

    # ---- 4. the main path: run() on ini/gaussian.ini ----------------------
    launches = {}

    @phase("run_gaussian_ini")
    def _():
        like = gaussian(INI["nDims"])
        with tempfile.TemporaryDirectory() as base:
            pallas_dirs.LAUNCHES["gram_schmidt"] = 0
            pallas_slice_v4.LAUNCHES["slice_epoch"] = 0
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
            launches["gram_schmidt"] = pallas_dirs.LAUNCHES["gram_schmidt"]
            launches["slice_epoch"] = pallas_slice_v4.LAUNCHES["slice_epoch"]
            stats = PolyChordOutput(base, "test")
            with open(os.path.join(base, "test.metrics.jsonl")) as f:
                last = json.loads(f.read().splitlines()[-1])
        if last.get("engine") != "cuda":
            raise AssertionError(f"engine_used is {last.get('engine')!r}, not 'cuda'")
        if last.get("chained_epochs") is not True:
            raise AssertionError("chained epochs were switched off during the run")
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the path was never launched: {launches}")
        if not (math.isfinite(stats.logZ) and abs(stats.logZ - 0.0) < 3 * stats.logZerr):
            raise AssertionError(f"logZ {stats.logZ} +/- {stats.logZerr} is not within 3 sigma of 0")
        if stats.ndead != last["ndead"] or stats.ndead < INI["nlive"]:
            raise AssertionError(".stats does not match the run")
        return {
            "engine_used": last["engine"], "chained_epochs": last["chained_epochs"],
            "ndead": stats.ndead, "logZ": stats.logZ,
            "logZerr": stats.logZerr, "wall_s": wall, "dead_per_s": stats.ndead / wall,
            "launches": dict(launches),
            "device_frac": last.get("device_frac"),
            "host_breakdown_s": last.get("host_breakdown"),
            "epoch_timers_s": last.get("epoch_timers"),
        }

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
