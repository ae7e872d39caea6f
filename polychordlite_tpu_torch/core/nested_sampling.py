"""The nested-sampling main loop (counterpart of
``polychordlite_tpu/core/nested_sampling.py``).

Each *epoch* generates a nursery of B independent slice chains on the
device; the host administrator consumes it with the exact reference
bookkeeping (``core/rti.py``), in synchronous mode
(``nested_sampling.F90:262-287``): seeds are drawn from the state as
updated by the previous nursery, one nursery (or chain of K nurseries,
``ops/chained_epoch.py``) in flight.

Randomness: the host generator is ``np.random.default_rng(seed)`` as in the
JAX package; the device generator is a ``torch.Generator`` on the run's
device seeded with ``seed`` (live-point draws, slice directions, chain seed
picks); the slice uniforms are a murmur3 stream keyed per epoch by
``fold_in(key, 100_000 + epoch_idx)`` (``ops/pallas_slice.py``), with
``key`` the raw uint32[2] key of ``seed``.  ``epoch_idx`` is checkpointed.

Multimodal runs (``nested_sampling.py:403-701`` of the JAX package):
clustering at every compression e-fold, and cluster reorganisations
handled without discarding single nurseries — babies of a nursery
dispatched before a reorganisation are re-assigned to clusters by the
Voronoi rule ``add_cluster`` applies to phantoms.  A chained dispatch
(K nurseries from a one-cluster device state) during which a
reorganisation happens has its queued nurseries discarded, its replay
check voided, and chaining cools down for 4 e-folds — for every nursery
of the chain, the last one included (the JAX package skips the cooldown
there: ROADMAP C4).

Ported so far: synchronous mode, single-grade likelihoods, float32.  The
other modes raise ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import math
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import pallas_slice_v4
from ..ops.evaluate import make_batched_calculator
from ..ops.logspace import logsumexp, logsumexp_small
from ..ops.pallas_slice import fold_in, seed_key
from ..ops.precision import F32_SAFE_LOGL
from ..ops.slice_kernel import KERNEL_ENGINES, EpochConfig, epoch_route
from ..parallel.mesh import make_epoch_runner
from ..priors import identity_prior
from ..settings import PolyChordSettings
from ..utils import feedback as fb
from ..utils import io as io_mod
from ..utils import resume as resume_mod
from ..utils.metrics import RunMetrics
from ..utils.writebehind import WriteBehindWriter
from .clustering import do_clustering
from .generate import (
    assign_num_repeats,
    generate_live_points,
    generate_seeds,
    time_speeds,
)
from .rti import (
    RunTimeInfo,
    append_phantoms_batch,
    calculate_logZ_estimate,
    calculate_covmats,
    delete_cluster,
    delete_outermost_point,
    identify_clusters_batch,
    live_logZ,
    try_replace_live,
    update_posteriors,
)

__version__ = "0.1.0"

default_prior = identity_prior


def default_dumper(live, dead, logweights, logZ, logZerr):
    pass


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``: the run goes to the card, and without one it
    raises (naming ``device="cpu"``, the explicit way to run on the CPU).
    Nothing falls back to the CPU by itself."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available for device={str(device)!r} (also the "
            "default); pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def resolve_engine(engine: str, device: torch.device, calc) -> str:
    """Resolve ``engine="auto"``: ``"cuda"`` on a CUDA device, the plain
    torch engine on the CPU.  ``"cuda"`` runs any torch model, batched or
    per point (B1's functor kernel for a model with a device form, the
    traced route ``csrc/slice_step.cu`` for the others) and refuses a
    host-callback model; the other kernel engines of :data:`KERNEL_ENGINES`
    are forced by name and need a device form.  ``engine="torch"`` is the
    plain engine on any device."""
    if engine == "auto":
        if device.type != "cuda":
            return "torch"
        engine = "cuda"
    if engine in KERNEL_ENGINES:
        if device.type != "cuda":
            raise ValueError(f"engine={engine!r} needs device='cuda'")
        if engine == "cuda":
            if calc.uses_callback:
                raise ValueError(
                    "a host-callback likelihood (one that is not a torch function of a "
                    "tensor) has no route on the card; pass engine='torch' to run it on "
                    "the plain engine"
                )
            return engine
        if getattr(calc, "device_spec", None) is None:
            raise ValueError(
                "the CUDA slice kernels need a prior with an affine form and a "
                "likelihood with a device form (priors.py, models/examples.py); "
                "pass engine='torch' to run this model on the plain torch engine"
            )
        return engine
    if engine == "torch":
        return "torch"
    raise ValueError(
        f"unknown engine {engine!r}: use 'auto', 'torch' or one of {KERNEL_ENGINES}"
    )


def _check_supported(s: PolyChordSettings) -> None:
    """Raise for the run modes the port does not have yet."""
    missing = {
        "precision='highest'": getattr(s, "precision", "single") == "highest",
        "synchronous=False": not s.synchronous,
        "maximise=True": bool(s.maximise),
        "an nlives schedule": bool(s.nlives),
        "several speed grades": len(s.grade_dims) > 1,
    }
    for what, asked in missing.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported to the torch package yet")


def more_samples_needed(s: PolyChordSettings, rti: RunTimeInfo) -> bool:
    """Termination rule (nested_sampling.F90:514-543)."""
    if s.max_ndead == 0:
        return False
    if s.max_ndead > 0 and rti.ndead >= s.max_ndead:
        return False
    if (
        s.precision_criterion > 0
        and live_logZ(rti) < math.log(s.precision_criterion) + rti.logZ
    ):
        return False
    return True


def _dump(dumper, s: PolyChordSettings, rti: RunTimeInfo) -> None:
    """Deliver live/dead/weights/evidence to the user callback
    (nested_sampling.F90:546-590; Python array convention: rows = points,
    columns = [physical, derived, birth, logL])."""
    dead = rti.dead_array()
    cols_dead = np.concatenate(
        [dead[:, s.pd], dead[:, [s.b0]], dead[:, [s.l0]]], axis=1
    )
    logw = np.asarray(rti.logweights) + dead[:, s.l0]
    if logw.size:
        logw = logw - logsumexp(np, logw)
    live = rti.all_live()
    cols_live = np.concatenate(
        [live[:, s.pd], live[:, [s.b0]], live[:, [s.l0]]], axis=1
    )
    logZ, varlogZ, *_ = calculate_logZ_estimate(rti)
    dumper(cols_live, cols_dead, logw, logZ, math.sqrt(abs(varlogZ)))


def _write_products(s: PolyChordSettings, rti: RunTimeInfo, nlikesum, rng, key):
    if s.write_resume:
        resume_mod.write_resume_file(s, rti, rng, key)
    if s.write_live:
        io_mod.write_phys_live_points(s, rti)
    if s.write_dead:
        io_mod.write_dead_points(s, rti)
    if s.write_stats:
        io_mod.write_stats_file(s, rti, nlikesum)
    if s.equals or s.posteriors:
        io_mod.write_posterior_files(s, rti)


#: e-folds of per-epoch dispatch after a reorganisation voided a chain
CHAIN_COOLDOWN = 4


def _end_chain_on_reorganisation(turbo, nursery_queue, reorganised: bool) -> None:
    """After consuming a nursery: if it came from a chained dispatch (its
    replay check is pending) and the clusters were reorganised since that
    dispatch, the queued nurseries of the chain — drawn from a one-cluster
    device state — are discarded, the replay check is voided, and chaining
    cools down for :data:`CHAIN_COOLDOWN` e-folds.  This holds for every
    nursery of the chain, the last one included (ROADMAP C4: the JAX
    package tests ``nursery_queue`` and so skips the cooldown there)."""
    if turbo["verify"] is not None and reorganised:
        nursery_queue.clear()
        turbo["verify"] = None
        turbo["cooldown"] = CHAIN_COOLDOWN
        turbo["voided"] += 1


def live_rows_match(host_cube, host_logL, dev_cube, dev_logL) -> bool:
    """Whether the host's live set and the device's final one hold the same
    (logL, cube) rows, in float32, as multisets: the same number of rows,
    each row found on both sides, a NaN equal to a NaN.  (The reference
    compares sorted logL alone, so ties pass whatever their points and one
    NaN reads as a divergence: ROADMAP C14.)"""
    def rows(cube, logL):
        a = np.column_stack([np.asarray(logL, np.float32),
                             np.asarray(cube, np.float32).reshape(len(logL), -1)])
        return a[np.lexsort(a.T[::-1])]

    if len(host_logL) != len(dev_logL):
        return False
    return np.array_equal(rows(host_cube, host_logL), rows(dev_cube, dev_logL), equal_nan=True)


def _kernel_launches() -> dict:
    """The launch counts of the CUDA kernels' wrappers (process-wide)."""
    from ..ops import pallas_dirs, pallas_slice, pallas_slice_v3, pallas_slice_v4, pallas_slice_v5

    return {**pallas_dirs.LAUNCHES, **pallas_slice_v4.LAUNCHES, **pallas_slice_v5.LAUNCHES,
            **pallas_slice_v3.LAUNCHES, **pallas_slice.LAUNCHES}


def _feedback(s: PolyChordSettings, level: int, msg: str) -> None:
    if s.feedback >= level:
        print(msg, flush=True)


def nested_sampling(
    loglikelihood: Callable,
    prior: Callable,
    dumper: Callable,
    settings: PolyChordSettings,
    device: Optional[torch.device] = None,
):
    """Run the sampler.  Returns a dict with logZ, logZerr, ndead, nlike and
    the final state (the [logZ, varlogZ, ndead, nlike] output of
    NestedSampling, nested_sampling.F90:394-402, plus extras)."""
    s = settings.finalise()
    _check_supported(s)
    device = resolve_device(device)
    t_start = time.time()
    launches0 = _kernel_launches()
    traced0 = dict(pallas_slice_v4.TRACED)

    # --- RNG: host generator, device generator and murmur key, all from seed
    seed = s.seed if s.seed >= 0 else int(time.time_ns() % (2**31))
    rng = np.random.default_rng(seed)
    key = seed_key(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    fb.write_opening_statement(s, __version__, device.type)

    calc = make_batched_calculator(
        prior, loglikelihood, s.nDims, s.nDerived, s.logzero, device=device
    )
    n_grades = len(s.grade_dims) if s.grade_dims else 1
    engine = resolve_engine(s.engine, device, calc)

    # --- resume or generate ------------------------------------------------
    io_mod.check_directories(s)
    io_mod.write_properties_file(s)  # anesthetic compat marker
    resumed = False
    if s.read_resume and resume_mod.resume_file_exists(s):
        rti, rng_state, key_saved = resume_mod.read_resume_file(s, n_grades)
        if rng_state is not None:
            rng.bit_generator.state = rng_state
            key = np.asarray(key_saved, dtype=np.uint32)
        resumed = True
        _feedback(s, 1, "Resuming from previous run")
    elif s.cube_samples is not None:
        rti = resume_mod.rti_from_cube_samples(s, s.cube_samples, calc, n_grades, device)
        assign_num_repeats(s, rti, time_speeds(calc, s))
        _feedback(s, 1, f"Starting from {rti.total_nlive()} cube samples")
    else:
        _feedback(s, 1, "Generating initial live points")
        rti, ndiscarded, sec_per_eval = generate_live_points(calc, s, generator, device)
        if s.write_prior:
            io_mod.write_prior_file(s, rti)
            io_mod.write_prior_info(s, s.resolved_nprior(), ndiscarded)
        speeds = time_speeds(calc, s)
        speeds[0] = max(sec_per_eval, 1e-12)
        assign_num_repeats(s, rti, speeds)
    rti._rng = rng

    if rti.num_repeats is None:
        assign_num_repeats(s, rti, time_speeds(calc, s))

    # trim nprior down to nlive, accumulating the evidence of the deleted
    # shells (nested_sampling.F90:200-204)
    if not resumed:
        while rti.total_nlive() > s.nlive:
            delete_outermost_point(rti)
        if s.write_resume:
            resume_mod.write_resume_file(s, rti, rng, key)

    num_repeats = tuple(int(x) for x in rti.num_repeats)
    _feedback(s, 1, f"num_repeats per grade: {list(num_repeats)}")

    # the f32 contour test loses shells beyond F32_SAFE_LOGL where the
    # contour ends, at the top of the live set; the reference only warns
    # about any live point (its fault C8: a tail beyond the limit, as
    # rosenbrock.ini's, carries no evidence), and f64 is not ported
    top = float(rti.all_live()[:, s.l0].max(initial=s.logzero))
    if abs(top) > F32_SAFE_LOGL:
        raise ValueError(
            f"the best live logL is {top:.3g}: the float32 contour test loses "
            f"resolution beyond F32_SAFE_LOGL = {F32_SAFE_LOGL:.0g} (ulp(1e7) = 1), "
            "and precision='highest' (float64) is not ported yet; shift the "
            "likelihood by a constant"
        )
    cfg = EpochConfig(
        n_dims=s.nDims,
        n_phi=max(s.nDerived, 1),
        grade_dims=tuple(s.grade_dims),
        num_repeats=num_repeats,
        logzero=s.logzero,
        engine=engine,
    )
    R = cfg.total_repeats
    run_epoch, B = make_epoch_runner(
        calc, cfg, s.resolved_batch_size(), device, generator
    )
    _feedback(s, 1, f"chain batch {B} on {device}, engine {run_epoch.engine_used()}")

    metrics = RunMetrics(
        io_mod.root_path(s) + ".metrics.jsonl" if s.write_stats else None,
        resume=resumed,
    )
    nlikesum = np.zeros(n_grades, dtype=np.int64)
    any_writes = (
        s.write_resume or s.write_live or s.write_dead
        or s.write_stats or s.equals or s.posteriors
    )
    writer = WriteBehindWriter() if any_writes else None
    try:
        failures = 0
        nfail = s.resolved_nfail()
        # resumes continue the epoch key stream where the saved run left off
        epoch_idx = int(getattr(rti, "epoch_idx", 0))
        t_assemble = 0.0

        _feedback(s, 1, "Started sampling")
        running = more_samples_needed(s, rti)

        def _next_epoch_key():
            nonlocal epoch_idx
            k = fold_in(key, 100_000 + epoch_idx)
            epoch_idx += 1
            rti.epoch_idx = epoch_idx  # checkpointed
            return k

        def _dispatch():
            with metrics.phase("seed_gen"):
                seeds, cluster_ids = generate_seeds(rti, B, rng)
            bound = np.asarray(rti.logLp[cluster_ids], dtype=np.float64).copy()
            chol = rti.cholesky[cluster_ids]
            handle = run_epoch.dispatch(_next_epoch_key(), seeds[:, s.h], bound, chol)
            return handle, bound, np.asarray(cluster_ids), rti.epoch

        # --- chained epochs (ops/chained_epoch.py): K epochs and the
        # live-set update in one dispatch; the host replays every decision
        # and checks its live set against the device's final state.  After
        # a reorganisation voids a chain, per-epoch dispatch for a few
        # e-folds (actively fragmenting runs would otherwise thrash chains)
        nursery_queue = deque()
        turbo_K = int(getattr(s, "chain_epochs", -1))
        if turbo_K < 0:  # auto: host-callback likelihoods dispatch per epoch
            turbo_K = 0 if calc.uses_callback else 8
        turbo = {"enabled": turbo_K > 1, "K": turbo_K, "verify": None,
                 "cooldown": 0, "voided": 0}

        def _turbo_ok():
            return (
                turbo["enabled"]
                and turbo["cooldown"] == 0
                and rti.ncluster == 1
                and rti.total_nlive() == s.nlive
            )

        def _dispatch_any():
            if _turbo_ok():
                K = turbo["K"]
                if s.max_ndead > 0:  # do not chain far past the cap
                    remaining = max(1, s.max_ndead - rti.ndead)
                    K = max(1, min(K, -(-remaining // B)))
                live = rti.live[0]
                h = run_epoch.dispatch_chain(
                    _next_epoch_key(), live[:, s.h], live[:, s.l0],
                    rti.cholesky[0], K,
                )
                return ("chain", h, rti.epoch)
            return ("single", _dispatch())

        pending = _dispatch_any() if running else None
        while running and failures <= nfail and rti.ncluster > 0:
            if not nursery_queue:
                if pending[0] == "single":
                    handle, bound, cluster_ids, epoch_at_dispatch = pending[1]
                    with metrics.device_epoch():
                        outs = run_epoch.collect(handle)
                    nursery_queue.append(
                        (*outs, bound, cluster_ids, epoch_at_dispatch)
                    )
                    turbo["verify"] = None
                else:
                    _, handle, epoch_at = pending
                    with metrics.device_epoch():
                        nurseries, final_live = run_epoch.collect_chain(handle)
                    zero_ids = np.zeros(B, dtype=int)
                    for cube_k, th_k, phi_k, logL_k, nl_k, b0 in nurseries:
                        nursery_queue.append(
                            (cube_k, th_k, phi_k, logL_k, nl_k,
                             np.full(B, b0), zero_ids, epoch_at)
                        )
                    turbo["verify"] = final_live
            (b_cube, b_theta, b_phi, b_logL, nlike, bound, cluster_ids,
             epoch_at_dispatch) = nursery_queue.popleft()
            nlike = nlike.sum(axis=0)
            rti.nlike += nlike
            nlikesum += nlike

            # assemble (B, R, nTotal) baby records; birth contour = the
            # bound the chain was generated at (nested_sampling.F90:260)
            _t0 = time.time()
            babies = np.zeros((B, R, s.nTotal))
            babies[:, :, s.h] = b_cube
            babies[:, :, s.p] = b_theta
            if s.nDerived:
                babies[:, :, s.d] = b_phi[:, :, : s.nDerived]
            babies[:, :, s.b0] = bound[:, None]
            babies[:, :, s.l0] = b_logL
            t_assemble += time.time() - _t0

            # --- consume the nursery in vectorised chunks -------------------
            # a reorganisation since the dispatch: stale seed-cluster ids are
            # re-assigned by the Voronoi rule add_cluster applies to phantoms
            # (run_time_info.f90:444-453), so no generated work is thrown away
            ids = cluster_ids.copy()
            if rti.epoch != epoch_at_dispatch:
                ids = identify_clusters_batch(rti, babies[:, -1])
            chunk = max(8, min(64, s.nlive // 8))
            b0 = 0
            ph_done = 0  # phantom-insertion high-water mark: a chunk that
            # breaks early on a reorganisation restarts at b0 = b, but its
            # phantoms were already inserted up to the old b1
            while b0 < B and running and failures <= nfail and rti.ncluster > 0:
                b1 = min(b0 + chunk, B)
                epoch0 = rti.epoch
                if R > 1 and b1 > ph_done:  # the chunk's phantoms, one insert
                    lo = max(b0, ph_done)
                    append_phantoms_batch(
                        rti,
                        babies[lo:b1, :-1].reshape(-1, s.nTotal),
                        np.repeat(ids[lo:b1], R - 1),
                    )
                    ph_done = b1
                # live candidates: Voronoi membership against the current
                # live set, recomputed every VORONOI_SUB replacements
                # (run_time_info.f90:744-753)
                VORONOI_SUB = 16
                lpts = babies[b0:b1, -1]
                assign = identify_clusters_batch(rti, lpts)
                _nested = ("posteriors", "file_writes", "dumper", "clustering")
                t_loop0 = time.time()
                _n0 = sum(metrics._phase_tot.get(k, 0.0) for k in _nested)
                b = b0
                while b < b1:
                    if rti.epoch != epoch0:
                        break  # reorganisation: re-validate remaining babies
                    i = b - b0
                    if i and i % VORONOI_SUB == 0:
                        assign[i:] = identify_clusters_batch(rti, lpts[i:])
                    res = try_replace_live(
                        rti, lpts[i], int(ids[b]), bool(assign[i] == ids[b])
                    )
                    b += 1
                    if res is True:
                        failures = 0
                    else:
                        failures += 1
                        if failures > nfail:
                            break

                    lse_logXp = logsumexp_small(rti.logXp)
                    update = (
                        lse_logXp
                        <= rti.logX_last_update + math.log(s.compression_factor)
                    )
                    if update:
                        if turbo["cooldown"] > 0:
                            turbo["cooldown"] -= 1
                        rti.logX_last_update = lse_logXp
                        with metrics.phase("posteriors"):
                            update_posteriors(rti)
                        with metrics.phase("file_writes"):
                            if writer is not None:
                                snap_rti = rti.snapshot()
                                snap_rng = copy.deepcopy(rng)
                                snap_nl = nlikesum.copy()
                                writer.submit(
                                    lambda r=snap_rti, g=snap_rng, n=snap_nl:
                                    _write_products(s, r, n, g, key)
                                )
                        with metrics.phase("dumper"):
                            _dump(dumper, s, rti)

                    delete_cluster(rti)
                    if rti.ncluster == 0:
                        break

                    if update:
                        logZ, varlogZ, *_ = calculate_logZ_estimate(rti)
                        metrics.record(
                            ndead=rti.ndead,
                            nlive=rti.total_nlive(),
                            ncluster=rti.ncluster,
                            logZ=logZ,
                            varlogZ=varlogZ,
                            nlike=int(rti.nlike.sum()),
                            engine=run_epoch.engine_used(),
                        )
                        frac = math.exp(
                            min(live_logZ(rti) - rti.logZ, 700.0)
                        ) if rti.logZ > s.logzero else float("inf")
                        fb.write_intermediate_results(
                            s, rti, nlikesum, logZ, varlogZ, frac
                        )
                        nlikesum[:] = 0
                        with metrics.phase("clustering"):
                            if s.do_clustering:
                                if s.sub_clustering_dimensions:
                                    do_clustering(rti, s.sub_clustering_dimensions)
                                do_clustering(rti)
                            calculate_covmats(rti)

                    running = more_samples_needed(s, rti)
                    if not running:
                        break
                # pure insertion cost: exclude the nested e-fold phases
                _n1 = sum(metrics._phase_tot.get(k, 0.0) for k in _nested)
                metrics._phase_tot["baby_loop"] = (
                    metrics._phase_tot.get("baby_loop", 0.0)
                    + (time.time() - t_loop0)
                    - (_n1 - _n0)
                )
                if rti.epoch != epoch0 and rti.ncluster > 0 and b < B:
                    ids[b:] = identify_clusters_batch(rti, babies[b:, -1])
                b0 = b

            _end_chain_on_reorganisation(
                turbo, nursery_queue, rti.epoch != epoch_at_dispatch
            )

            if not nursery_queue and turbo["verify"] is not None:
                # chain fully replayed: the host live set must match the
                # device's final state exactly, row for row
                if rti.ncluster == 1 and running and failures <= nfail:
                    dev_logL, dev_cube = turbo["verify"]
                    live = rti.live[0]
                    if not live_rows_match(live[:, s.h], live[:, s.l0], dev_cube, dev_logL):
                        import warnings

                        warnings.warn(
                            "chained-epoch replay diverged from the device "
                            "live state; disabling chained epochs for this run",
                            stacklevel=2,
                        )
                        turbo["enabled"] = False
                turbo["verify"] = None

            if not nursery_queue and running and failures <= nfail and rti.ncluster > 0:
                # synchronous mode (nested_sampling.F90:262-287): seeds drawn
                # from the state as updated by this nursery
                pending = _dispatch_any()

        if writer is not None:
            writer.flush()
        if s.write_resume:
            resume_mod.write_resume_file(s, rti, rng, key)

        # --- drain the remaining live points (nested_sampling.F90:381-384) -
        while rti.ncluster > 0:
            delete_outermost_point(rti)
            delete_cluster(rti)

        update_posteriors(rti)
        if s.write_live:
            io_mod.write_phys_live_points(s, rti)
        if s.equals or s.posteriors:
            io_mod.write_posterior_files(s, rti)
        if s.write_dead:
            io_mod.write_dead_points(s, rti)
        if s.write_stats:
            io_mod.write_stats_file(s, rti, nlikesum)
        _dump(dumper, s, rti)

        logZ, varlogZ, *_ = calculate_logZ_estimate(rti)
        if failures > nfail:
            print(
                f"Warning, unable to proceed after {failures} failed spawn events",
                flush=True,
            )
        if s.feedback >= 0:
            fb.write_final_results(
                logZ, varlogZ, rti.ndead, rti.nlike.tolist(),
                time.time() - t_start, s.feedback,
            )

        epoch_timers = {
            **{k: round(v, 3) for k, v in run_epoch.timers.items()},
            "assemble": round(t_assemble, 3),
        }
        metrics.record(
            ndead=rti.ndead,
            nlive=0,
            ncluster=rti.ncluster,
            logZ=logZ,
            varlogZ=varlogZ,
            nlike=int(rti.nlike.sum()),
            engine=run_epoch.engine_used(),
            extra={
                "epoch_timers": epoch_timers, "chained_epochs": turbo["enabled"],
                "chains_voided": turbo["voided"],
                # the host phases over the whole run (host_breakdown above
                # holds the last interval only)
                "host_totals": {k: round(v, 3) for k, v in metrics._phase_tot.items()},
                # kernel launches during this run (the functor check included)
                "kernel_launches": {
                    k: v - launches0[k] for k, v in _kernel_launches().items()
                },
                # the model's form (ops/evaluate.py), the kernel its engine ran,
                # and the traced route's graph replays and rounds in this run
                "form": calc.form, "route": epoch_route(engine, calc),
                "traced_route": {
                    k: v - traced0[k] for k, v in pallas_slice_v4.TRACED.items()
                },
            },
        )
        return {
            "logZ": float(logZ),
            "logZerr": float(math.sqrt(abs(varlogZ))),
            "ndead": int(rti.ndead),
            "nlike": int(rti.nlike[0]),
            "nlike_per_grade": rti.nlike.copy(),
            "metrics": {
                **metrics.summary(ndead=rti.ndead, nlike=int(rti.nlike.sum())),
                "engine_used": run_epoch.engine_used(),
                "chained_epochs": turbo["enabled"],
                "epoch_timers": epoch_timers,
            },
            "rti": rti,
        }
    finally:
        if writer is not None:
            writer.close()
