"""The nested-sampling main loop (counterpart of
``polychordlite_tpu/core/nested_sampling.py``).

Each *epoch* generates a nursery of B independent slice chains on the
device; the host administrator consumes it with the exact reference
bookkeeping (``core/rti.py``), in synchronous mode
(``nested_sampling.F90:262-287``): seeds are drawn from the state as
updated by the previous nursery, one nursery (or chain of K nurseries,
``ops/chained_epoch.py``) in flight.  With ``synchronous=False``
(dispatch-ahead, ``nested_sampling.F90:288-313``) the next nursery is
dispatched as soon as one is collected, before the host consumes it: its
seeds are one nursery staler, which biases logZ high (the run warns).

The chain batch is split over shards of local devices (``mesh_shape``)
and over the processes of a ``torch.distributed`` group (under
``torchrun``; ``parallel/distributed.py``), bitwise the one-device run at
the same B (``parallel/mesh.py``).  Administration runs the same on every
process: a clock seed and the timed speeds are root's, the resume decision
is agreed by all, and only process 0 writes files.

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

Run modes (``_check_supported``): ``precision='highest'`` runs the whole
path in float64 (``ops/precision.py``: the calc, the live points, the
directions, the slice engine, the chain and its replay check; on the card
B1's fused or traced route and B2 in double); ``maximise=True`` runs the
post-run maximiser (``core/maximiser.py``) and writes ``<root>.maximum``;
an ``nlives`` schedule is followed by the bookkeeping of ``core/rti.py``
(no chained dispatch under a schedule: a chain keeps nlive fixed); a
resume file in the reference's text format is read
(``utils/legacy_resume.py``).  Several speed grades run on every engine;
a :class:`~polychordlite_tpu_torch.models.graded.GradedLikelihood` runs on
the ``"scan"`` engine, which keeps its slow part across fast-grade
repeats (``ops/slice_kernel.py``), with no chained dispatch.  A
host-callback likelihood (Python, numpy or C) runs on ``"scan"`` too, on
the card the host route; it dispatches one epoch at a time unless
``chain_epochs`` > 1 forces a chain, which runs the route K times in one
dispatch.  Chained epochs run in synchronous mode on one shard only.
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
from ..ops import pallas_dirs
from ..ops.pallas_slice_v4 import check_functor_dims
from ..ops.pallas_slice_v5 import check_dims as check_v5_dims
from ..ops.precision import F32_SAFE_LOGL, PRECISIONS, calc_dtype, real_dtype_scope
from ..ops.slice_kernel import KERNEL_ENGINES, EpochConfig, epoch_route, route_reason
from ..parallel import distributed
from ..parallel.mesh import make_epoch_runner, run_devices
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
    Nothing falls back to the CPU by itself.  A rank of a process group of
    several takes the card ``LOCAL_RANK % device_count`` for ``"cuda"``
    without an index (two ranks on a one-card host share it)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available for device={str(device)!r} (also the "
            "default); pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None and distributed.process_count() > 1:
        device = torch.device("cuda", distributed.local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)  # the rank's default streams and graphs on its card
    return device


def check_chain_request(s: PolyChordSettings, device: torch.device) -> None:
    """Raise if ``chain_epochs > 1`` asks for chained epochs where a run
    never chains: over several shards (local devices, ``mesh_shape``) or
    processes, or with ``synchronous=False`` (a chain is one synchronous
    dispatch on one shard).  Left at -1 (auto) or 0 it dispatches per
    epoch there."""
    if int(getattr(s, "chain_epochs", -1)) <= 1:
        return
    n_shards = len(run_devices(device, s.mesh_shape)) * distributed.process_count()
    why = []
    if n_shards > 1:
        why.append(f"this run splits its batch over {n_shards} shards "
                   f"({distributed.process_count()} process(es))")
    if not s.synchronous:
        why.append("synchronous=False dispatches ahead, one epoch at a time")
    if why:
        raise ValueError(
            f"chain_epochs={int(s.chain_epochs)} asks for chained epochs, and a chain runs "
            f"synchronously on one shard: {'; '.join(why)}; leave chain_epochs at -1 or 0")


def resolve_engine(engine: str, device: torch.device, calc) -> str:
    """Resolve ``engine="auto"``: ``"cuda"`` on a CUDA device, the plain
    torch engine on the CPU; for a :class:`GradedLikelihood` calc
    (``calc.graded``) ``"scan"`` on every device, the one engine that carries
    its slow part (``polychordlite_tpu/core/nested_sampling.py:77-99``), and
    for a host-callback calc (a Python, numpy or C likelihood,
    ``calc.uses_callback``) ``"scan"`` on every device too, as the JAX
    package sends it to its scan engine (``:104-106``): on the card the
    host route, B1's traced kernel driven round by round with the user's
    function called between two launches.  A kernel engine forced by name
    for a graded or a callback calc raises, naming ``"scan"`` (the JAX
    package warns and runs scan instead; the port forces engines by name
    only, ROADMAP C5); ``"torch"`` runs either on the plain engine.
    ``"scan"`` runs any model (the traced route's kernel with a repeat
    barrier on the card for a torch model, the host route for a callback;
    on the card D is bounded only by B2's, ``pallas_dirs.MAXD`` = 29,056 in
    shared memory, and before that by the card's free memory for B2's
    scratch buffer past dim 240, which B2's wrapper checks: 21 GB at D =
    2,048 for 5 bases of 256 chains).
    ``"cuda"`` runs any torch model, batched or per point (B1's functor
    kernel for a model with a device form, B1 with the likelihood lowered
    into it or the traced route ``csrc/slice_step.cu`` for the others:
    ``ops/slice_kernel.py::cuda_route``); the other kernel engines of
    :data:`KERNEL_ENGINES` are forced by name and need a device form.
    ``engine="torch"`` is the plain engine on any device, at any dimension;
    B1's functor kernel and the forced ``"cuda3"`` and ``"cuda2"`` take D up
    to the stream bucket's shared-memory bound for the functor's terms in
    float32 (``pallas_slice_v4.stream_max_d``: 19,370 at one term, 14,528
    at two), the fused route up to the same bound for the lowering's terms
    and dtype (past it the model takes the traced route), the traced route
    up to B2's bound, and ``"cuda5"`` stops at D = 32; above its bound an
    engine raises here, once, naming the bound and ``engine='torch'``.  At
    ``precision='highest'`` (a float64 calc) ``"cuda"`` takes the fused or
    the traced route in double, and the forced ``"cuda5"``, ``"cuda3"`` and
    ``"cuda2"``, whose kernels are float32, raise (as the JAX package sends
    float64 away from its float32 kernels,
    ``polychordlite_tpu/core/nested_sampling.py:304-306``)."""
    graded = bool(getattr(calc, "graded", False))
    callback = bool(calc.uses_callback)
    if engine == "auto":
        if graded or callback:
            engine = "scan"
        elif device.type != "cuda":
            return "torch"
        else:
            engine = "cuda"
    if graded and engine in KERNEL_ENGINES:
        raise ValueError(
            f"engine={engine!r} evaluates the whole likelihood at every probe; a "
            "GradedLikelihood runs on engine='scan', which keeps its slow part across "
            "fast-grade repeats (or engine='torch', which calls it as one function)")
    if callback and engine in KERNEL_ENGINES:
        raise ValueError(
            f"engine={engine!r} evaluates the likelihood in its kernel or in torch on the "
            "card; a host-callback likelihood (one that is not a torch function of a "
            "tensor) runs on engine='scan' (on the card the host route, which calls it "
            "between the kernel's launches) or on engine='torch' (the plain engine)")
    D = calc.n_dims
    if device.type == "cuda" and engine in ("scan",) + KERNEL_ENGINES and D > pallas_dirs.MAXD:
        raise ValueError(
            f"D = {D} exceeds the Gram-Schmidt kernels' bound D <= {pallas_dirs.MAXD} (B2's "
            "working column fills a block's shared memory in float64); pass engine='torch' "
            "to run it on the plain engine")
    if engine == "scan":
        return engine
    if engine in KERNEL_ENGINES:
        if device.type != "cuda":
            raise ValueError(f"engine={engine!r} needs device='cuda'")
        f64 = calc_dtype(calc) == torch.float64
        if engine != "cuda" and f64:
            raise ValueError(
                f"engine={engine!r} runs a float32 kernel, and precision='highest' runs in "
                "float64; use engine='cuda' (B1's fused or traced route in double) or "
                "engine='torch'")
        if engine == "cuda5":
            check_v5_dims(D)
        spec = getattr(calc, "device_spec", None)
        if spec is not None and not (engine == "cuda" and f64):
            # the functor route and the forced engines take the functor
            check_functor_dims(spec["likelihood"]["name"], D)
        if engine == "cuda":
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
        f"unknown engine {engine!r}: use 'auto', 'torch', 'scan' or one of {KERNEL_ENGINES}"
    )


def _check_supported(s: PolyChordSettings) -> None:
    """Raise for an unknown ``precision``.  Every run mode of the JAX
    package is ported."""
    if getattr(s, "precision", "single") not in PRECISIONS:
        raise ValueError(f"precision must be one of {tuple(PRECISIONS)}, not {s.precision!r}")


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
    # file output is owned by process 0 only, as in the reference, where all
    # writes happen on the MPI administrator (nested_sampling.F90:329-334)
    if not distributed.is_root():
        return
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


def live_rows_match(host_cube, host_logL, dev_cube, dev_logL, dtype=np.float32) -> bool:
    """Whether the host's live set and the device's final one hold the same
    (logL, cube) rows, in the run's ``dtype`` (float32, or float64 at
    precision='highest'), as multisets: the same number of rows, each row
    found on both sides, a NaN equal to a NaN.  (The reference compares
    sorted logL alone, so ties pass whatever their points and one NaN reads
    as a divergence: ROADMAP C14.)"""
    def rows(cube, logL):
        a = np.column_stack([np.asarray(logL, dtype),
                             np.asarray(cube, dtype).reshape(len(logL), -1)])
        return a[np.lexsort(a.T[::-1])]

    if len(host_logL) != len(dev_logL):
        return False
    return np.array_equal(rows(host_cube, host_logL), rows(dev_cube, dev_logL), equal_nan=True)


def _kernel_launches() -> dict:
    """The launch counts of the CUDA kernels' wrappers (process-wide)."""
    from ..ops import pallas_dirs, pallas_slice, pallas_slice_v3, pallas_slice_v4, pallas_slice_v5

    return {**pallas_dirs.LAUNCHES, **pallas_slice_v4.LAUNCHES, **pallas_slice_v5.LAUNCHES,
            **pallas_slice_v3.LAUNCHES, **pallas_slice.LAUNCHES}


def _fused_build_seconds(calc) -> dict:
    """The fused route's library build (or load) seconds by G, where the
    run lowered its model (``ops/fused_like.py``)."""
    low = calc.__dict__.get("fused")
    return {str(g): round(t, 3) for g, t in getattr(low, "build_seconds", {}).items()}


def _feedback(s: PolyChordSettings, level: int, msg: str) -> None:
    if s.feedback >= level:
        print(msg, flush=True)


def nested_sampling(
    loglikelihood: Callable,
    prior: Callable,
    dumper: Callable,
    settings: PolyChordSettings,
    device: Optional[torch.device] = None,
    paramnames: Optional[list] = None,
):
    """Run the sampler.  Returns a dict with logZ, logZerr, ndead, nlike and
    the final state (the [logZ, varlogZ, ndead, nlike] output of
    NestedSampling, nested_sampling.F90:394-402, plus extras).  The run
    computes in the dtype of ``precision`` (``ops/precision.py``), set for
    this thread alone and restored on exit, however the run ends
    (``polychordlite_tpu/core/nested_sampling.py:184-189``).  Under
    ``torchrun`` (``WORLD_SIZE`` > 1) the process group is joined first
    (:func:`~polychordlite_tpu_torch.parallel.distributed.initialise_distributed`).
    ``paramnames``, (name, latex) pairs, are written to ``<root>.paramnames``
    beside the properties file, by process 0 as every file."""
    s = settings.finalise()
    _check_supported(s)
    distributed.initialise_distributed()
    device = resolve_device(device)
    with real_dtype_scope(PRECISIONS[getattr(s, "precision", "single")]):
        return _run(loglikelihood, prior, dumper, s, device, paramnames)


def _run(loglikelihood, prior, dumper, s: PolyChordSettings, device: torch.device,
         paramnames=None):
    """The body of :func:`nested_sampling`, in the run's dtype."""
    t_start = time.time()
    launches0 = _kernel_launches()
    traced0 = dict(pallas_slice_v4.TRACED)
    graded0 = dict(pallas_slice_v4.GRADED)
    host0 = dict(pallas_slice_v4.HOST)
    groups0 = dict(pallas_slice_v4.GROUP_LAUNCHES)

    # --- RNG: host generator, device generator and murmur key, all from seed
    seed = s.seed if s.seed >= 0 else int(time.time_ns() % (2**31))
    if distributed.process_count() > 1:
        # every process must administer identically: adopt root's clock seed
        seed = int(distributed.broadcast_from_root(np.int64(seed)))
    rng = np.random.default_rng(seed)
    key = seed_key(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    fb.write_opening_statement(s, __version__, device.type)

    calc = make_batched_calculator(
        prior, loglikelihood, s.nDims, s.nDerived, s.logzero, device=device
    )
    calls0 = int(getattr(calc, "user_calls", 0))
    n_grades = len(s.grade_dims) if s.grade_dims else 1
    if calc.graded and n_grades > 1 and int(s.grade_dims[0]) != calc.n_slow:
        # fast-grade chords must move fast parameters only: a mismatch would
        # let a fast probe move a slow coordinate against a stale cached
        # intermediate (polychordlite_tpu/core/nested_sampling.py:209-223)
        raise ValueError(
            f"GradedLikelihood with n_slow={calc.n_slow} requires "
            f"grade_dims[0] == n_slow, got grade_dims={list(s.grade_dims)}"
        )
    engine = resolve_engine(s.engine, device, calc)
    check_chain_request(s, device)
    if calc.graded and int(getattr(s, "chain_epochs", -1)) > 1:
        # the JAX package lets a forced chain through here and fails later
        # (ROADMAP C1)
        raise ValueError(
            "chain_epochs > 1 asks for chained epochs, and a GradedLikelihood runs "
            "without them: the chain has no aux carry (it hands the device its live set "
            "from epoch to epoch, not the slow intermediate); leave chain_epochs at -1 or 0"
        )
    # the kernel the engine runs for this model, chosen once (a torch
    # likelihood is lowered into B1 here, or refused with its reason)
    route, reason = epoch_route(engine, calc), route_reason(engine, calc)

    # --- resume or generate ------------------------------------------------
    root = distributed.is_root()
    io_mod.check_directories(s)
    if root and paramnames:
        io_mod.write_paramnames_file(s, paramnames)  # and the properties file
    elif root:
        io_mod.write_properties_file(s)  # anesthetic compat marker
    resumed = False
    want_resume = s.read_resume and resume_mod.resume_file_exists(s)
    if distributed.process_count() > 1:
        # process 0 alone writes resume files: every process must follow the
        # same decision, or the administrations part and the next gather
        # hangs.  The flags are gathered so that every process, those that
        # see the file too, raises the same error
        # (polychordlite_tpu/core/nested_sampling.py:241-256)
        all_resume, any_resume = distributed.all_any_flags(want_resume)
        if any_resume and not all_resume:
            raise RuntimeError(
                "the resume file is visible on some processes but not all: runs over "
                "several hosts need base_dir on a filesystem all processes share (or "
                "read_resume=False)"
            )
        want_resume = all_resume
    if want_resume:
        rti, rng_state, key_saved = resume_mod.read_resume_file(s, n_grades)
        if rng_state is not None:
            rng.bit_generator.state = rng_state
            key = np.asarray(key_saved, dtype=np.uint32)
        resumed = True
        _feedback(s, 1, "Resuming from previous run")
    elif s.cube_samples is not None:
        rti = resume_mod.rti_from_cube_samples(s, s.cube_samples, calc, n_grades, device)
        assign_num_repeats(s, rti, time_speeds(calc, s, generator))
        _feedback(s, 1, f"Starting from {rti.total_nlive()} cube samples")
    else:
        _feedback(s, 1, "Generating initial live points")
        rti, ndiscarded, sec_per_eval = generate_live_points(calc, s, generator, device)
        if s.write_prior and root:
            io_mod.write_prior_file(s, rti)
            io_mod.write_prior_info(s, s.resolved_nprior(), ndiscarded)
        speeds = time_speeds(calc, s, generator)
        speeds[0] = max(sec_per_eval, 1e-12)
        assign_num_repeats(s, rti, speeds)
    rti._rng = rng

    if rti.num_repeats is None:
        assign_num_repeats(s, rti, time_speeds(calc, s, generator))

    # trim nprior down to nlive, accumulating the evidence of the deleted
    # shells (nested_sampling.F90:200-204)
    if not resumed:
        while rti.total_nlive() > s.nlive:
            delete_outermost_point(rti)
        if s.write_resume and root:
            resume_mod.write_resume_file(s, rti, rng, key)

    num_repeats = tuple(int(x) for x in rti.num_repeats)
    _feedback(s, 1, f"num_repeats per grade: {list(num_repeats)}")

    # the f32 contour test loses shells beyond F32_SAFE_LOGL where the
    # contour ends, at the top of the live set; the reference only warns
    # about any live point (its fault C8: a tail beyond the limit, as
    # rosenbrock.ini's, carries no evidence).  A float64 run has no limit.
    top = float(rti.all_live()[:, s.l0].max(initial=s.logzero))
    if calc.dtype == torch.float32 and abs(top) > F32_SAFE_LOGL:
        raise ValueError(
            f"the best live logL is {top:.3g}: the float32 contour test loses "
            f"resolution beyond F32_SAFE_LOGL = {F32_SAFE_LOGL:.0g} (ulp(1e7) = 1); "
            "run it with precision='highest' (float64), or shift the likelihood "
            "by a constant"
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
    np_real = np.float32 if calc.dtype == torch.float32 else np.float64
    if not s.synchronous:
        # dispatch-ahead staleness carries a small positive logZ bias at any
        # batch width (the JAX package's 64-seed calibration of the same
        # sampler: mean pull +0.25 to +0.32, logZ bias +0.04 to +0.06,
        # width-independent; benchmarks/calibration_study.json).  Synchronous
        # mode measures unbiased at the same widths.
        import warnings

        warnings.warn(
            "synchronous=False (dispatch-ahead) overlaps device and host work but "
            "biases logZ high by ~+0.05 (~0.3 sigma of a typical run's error bar; "
            "benchmarks/calibration_study.json, 64 seeds/config). Use synchronous=True "
            "(the default) when evidence accuracy matters more than throughput.",
            stacklevel=3,
        )
    run_epoch, B = make_epoch_runner(
        calc, cfg, s.resolved_batch_size(), device, generator,
        n_devices=s.mesh_shape,
    )
    _feedback(s, 1, f"chain batch {B} over {run_epoch.n_shards} shard(s) in "
                    f"{run_epoch.n_processes} process(es) on {device}, engine "
                    f"{run_epoch.engine_used()}, route {route} ({reason})")

    metrics = RunMetrics(
        io_mod.root_path(s) + ".metrics.jsonl" if s.write_stats and root else None,
        resume=resumed,
    )
    nlikesum = np.zeros(n_grades, dtype=np.int64)
    any_writes = root and (
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
        # auto: host-callback and graded likelihoods dispatch per epoch; a
        # forced chain of a callback runs its route K times in one dispatch.
        # A chain is synchronous, on one shard
        one_shard = run_epoch.n_shards == 1
        if turbo_K < 0:
            turbo_K = 8 if (s.synchronous and one_shard and not calc.uses_callback
                            and not calc.graded) else 0
        turbo = {"enabled": turbo_K > 1, "K": turbo_K, "verify": None,
                 "cooldown": 0, "voided": 0, "chains": 0}

        def _turbo_ok():
            # a chain keeps nlive fixed on the device: none under an nlives
            # schedule (nested_sampling.py:448 of the JAX package)
            return (
                turbo["enabled"]
                and turbo["cooldown"] == 0
                and s.synchronous
                and one_shard
                and rti.ncluster == 1
                and not s.nlives
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
                turbo["chains"] += 1
                return ("chain", h, rti.epoch)
            return ("single", _dispatch())

        pending = _dispatch_any() if running else None
        while running and failures <= nfail and rti.ncluster > 0:
            if not nursery_queue:
                if pending[0] == "single":
                    handle, bound, cluster_ids, epoch_at_dispatch = pending[1]
                    gathered = run_epoch.timers["gather"]
                    with metrics.device_epoch():
                        outs = run_epoch.collect(handle)
                    # the gather across processes waits for the other
                    # processes' hosts: host time, not the device's
                    metrics.device_time -= run_epoch.timers["gather"] - gathered
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
                if not s.synchronous:
                    # dispatch-ahead (nested_sampling.F90:288-313): enqueue
                    # the next nursery before consuming this one, so that the
                    # device computes behind the host's bookkeeping; babies
                    # up to two nurseries stale
                    pending = _dispatch_any()
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
                    if not live_rows_match(live[:, s.h], live[:, s.l0], dev_cube, dev_logL,
                                           np_real):
                        import warnings

                        warnings.warn(
                            "chained-epoch replay diverged from the device "
                            "live state; disabling chained epochs for this run",
                            stacklevel=2,
                        )
                        turbo["enabled"] = False
                turbo["verify"] = None

            if (s.synchronous and not nursery_queue and running and failures <= nfail
                    and rti.ncluster > 0):
                # synchronous mode (nested_sampling.F90:262-287): seeds drawn
                # from the state as updated by this nursery
                pending = _dispatch_any()

        if writer is not None:
            writer.flush()
        if s.write_resume and root:
            resume_mod.write_resume_file(s, rti, rng, key)

        # --- optional maximisation (nested_sampling.py:708-712) -----------
        if s.maximise and root:  # it changes no state, and writes <root>.maximum
            from .maximiser import maximise

            maximise(calc, s, rti)

        # --- drain the remaining live points (nested_sampling.F90:381-384) -
        while rti.ncluster > 0:
            delete_outermost_point(rti)
            delete_cluster(rti)

        update_posteriors(rti)
        if root:
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
                # the chain batch's shards over all processes, the processes,
                # and the dispatch mode
                "shards": run_epoch.n_shards, "processes": run_epoch.n_processes,
                "synchronous": bool(s.synchronous),
                "chains_voided": turbo["voided"], "chains_dispatched": turbo["chains"],
                # the run's dtype (ops/precision.py)
                "dtype": str(calc.dtype).replace("torch.", ""),
                # the host phases over the whole run (host_breakdown above
                # holds the last interval only)
                "host_totals": {k: round(v, 3) for k, v in metrics._phase_tot.items()},
                # kernel launches during this run (the functor check included)
                "kernel_launches": {
                    k: v - launches0[k] for k, v in _kernel_launches().items()
                },
                # B1's launches (functor and fused) by "bucket/G"
                "group_launches": {
                    f"{b}/{g}": v - groups0[b, g]
                    for (b, g), v in pallas_slice_v4.GROUP_LAUNCHES.items() if v > groups0[b, g]
                },
                # the model's form (ops/evaluate.py), the kernel its engine ran
                # (chosen before the run) and why, the fused route's library
                # build seconds by G (0 when the library was reused), and the
                # traced route's graph replays and rounds in this run
                "form": calc.form, "route": route, "route_reason": reason,
                "fused_build_seconds": _fused_build_seconds(calc),
                "traced_route": {
                    k: v - traced0[k] for k, v in pallas_slice_v4.TRACED.items()
                },
                # the graded route's (engine "scan") replays and rounds by
                # graph, repeat openings and slow-intermediate rows, and the
                # likelihood calls by speed grade
                "graded_route": {
                    k: v - graded0[k] for k, v in pallas_slice_v4.GRADED.items()
                },
                "nlike_per_grade": [int(n) for n in rti.nlike],
                # a host-callback likelihood: the calls of the user's function
                # in this run, and the host route's rounds, its calls on
                # probes, and the host seconds of a round's parts (launch,
                # copy out, user calls, copy in)
                "host_calls": int(getattr(calc, "user_calls", 0)) - calls0,
                "host_route": {
                    k: v - host0[k] for k, v in pallas_slice_v4.HOST.items()
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
                # this process's calls of a host-callback likelihood
                "host_calls": int(getattr(calc, "user_calls", 0)) - calls0,
            },
            "rti": rti,
        }
    finally:
        if writer is not None:
            writer.close()
