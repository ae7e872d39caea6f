"""The slice-epoch kernel and the epoch built around it
(counterpart of ``polychordlite_tpu/ops/pallas_slice_v4.py``).

:func:`slice_epoch` is the wrapper of the hand-written CUDA kernel
``csrc/slice_epoch.cu``: one chain on a group of G lanes of a warp, each
lane owning the coordinates d = g (mod G) (see the source for its design).
:func:`choose_group` picks G from the chains, the dimension and the card's
SM count.  For CPU tensors it runs the kernel's plain version,
``slice_kernel.slice_records_plain``; for CUDA tensors it launches the
kernel or raises.  The kernel evaluates the likelihood itself through a
device functor of ``csrc/likelihoods.cuh`` (:data:`FUNCTORS`), selected by
``calc.device_spec`` (``ops/evaluate.py``); :func:`validate_functor` checks
that functor against the torch calc, bitwise, through the engine that will
run it, before a run uses it.  :func:`launch_slice_kernel` is shared with
the kernels of ``ops/pallas_slice_v5.py``, ``ops/pallas_slice_v3.py`` and
``ops/pallas_slice.py``.

:func:`slice_epoch_counted` is the wrapper of the same kernel's counted
instantiation at G = 1 (``experiments/v4_instr.py`` at the repository root): B1's
outputs bit for bit, plus the micro-steps each lane executed and the
largest of each warp of 32 lanes, from which :func:`lane_efficiency`
follows.  No run calls it.

:func:`slice_epoch_traced` is B1's route for a model without a device
functor, a likelihood written in torch (the JAX package traces any jnp
likelihood into its kernel): the wrapper of ``csrc/slice_step.cu``, which
runs one micro-step of every chain per launch with the likelihood evaluated
by the torch calc between two launches.  :class:`TracedEpoch` keeps the
kernel's device state and replays ``rounds`` rounds (the calc and one
launch) captured in one CUDA graph until no lane is left running.  Its plain
version is :func:`slice_step_plain` over :class:`StepState`, driven the
same way by :func:`slice_records_rounds_plain`; both are bitwise
``slice_kernel.slice_records_plain`` for the same calc.

:func:`slice_epoch_graded` is the ``"scan"`` engine's epoch, the route of
a :class:`~polychordlite_tpu_torch.models.graded.GradedLikelihood`: the
same kernel with its repeat barrier (``rep_limit``) raised one repeat at a
time, so that every repeat runs in lockstep across the batch and has one
speed grade.  :meth:`TracedEpoch.graded` replays, per repeat, the graph of
its grade: the full calc, or ``calc.fast_point_batch`` on the slow
intermediate kept in a persistent buffer and refreshed in place after slow
repeats.  Its plain version is :func:`slice_records_graded_plain`; both are
bitwise the plain engine on the monolithic form of the model.

:func:`slice_epoch_host` is the ``"scan"`` engine's epoch for a
host-callback likelihood (Python, numpy, or the C ABI's function
pointers), the host route: the same kernel driven by :class:`HostEpoch`
round by round with no graph (a host call cannot be captured), the
probes and the lanes' pending flags copied to pinned host memory after
each launch and the user's function called on the pending probes only
(:class:`ProbeKeeper`), which also keeps the accepted probes (cube, theta
and phi) as the epoch's babies, as the JAX package's scan engine does.
Its plain version is :func:`slice_records_host_plain`; both make the
plain engine's decisions on the same calc (t, logL and nlike bit for
bit).

:func:`slice_epoch_fused` is B1's route for a model without a device
functor whose likelihood ``ops/fused_like.py`` can lower: the same kernel
template (``csrc/slice_epoch.cuh``) instantiated by
``csrc/slice_epoch_fused.cu`` with the lowered functor, one library per
model graph and G; its plain version runs ``slice_kernel.slice_records_plain``
on ``Lowered.plain_logL``, and :func:`validate_fused` holds the kernel
bitwise against that plain version before a run uses it.

At ``precision='highest'`` the fused route, the traced route and the host
route run in double (``slice_epoch_fused_f64``, ``slice_step_f64`` and
``slice_step_host_f64`` in :data:`LAUNCHES`), their plain versions in
float64; the functor kernel and
the kernels that share :func:`launch_slice_kernel` (B3, B4, B5) are float32
and raise for a float64 calc.

Outside the kernel, as in the JAX package (``pallas_slice_v4.py:524-559``):
the baby positions are rebuilt as ``seed + cumsum(t n̂)``, theta and phi
come from one batched evaluation of the calc (on the graded route, the
fast part on the cached intermediate for a fast-grade repeat's babies:
:func:`graded_babies`; the host route passes its kept probes instead),
and everything is packed into the epoch record
(:func:`assemble_epoch`); ``slice_kernel.build_epoch_fn`` puts the pieces
together.
"""

from __future__ import annotations

import ctypes
import gc
import time

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..utils import nvcc
from .pallas_slice import PH_DONE, PH_INIT_R, LaneMachine, _mix, lane_hash
from .precision import calc_dtype
from .slice_kernel import EpochConfig, slice_records_plain

#: the kernel template's dimension buckets and the most coordinates a lane
#: owns in the wide one (SLICE_MAXD, SLICE_MAXD_WIDE and SLICE_LANE_CAP of
#: ``csrc/slice_common.cuh``): D <= 32 at every G of :data:`GROUPS`;
#: 32 < D <= 128 at G = 128 / 4 = 32 only (B1, B4, B5 and the fused route;
#: B3 and the studies stop at 32).  G = 16, at 8 coordinates a lane, took
#: 1.36-1.38x G = 32's time at D = 40, 64 and 128 (B = 512; PERF.md, section
#: 6), so the wide bucket does not build it.
SLICE_MAXD, SLICE_MAXD_WIDE, LANE_CAP = 32, 128, 4
#: the stream bucket above D = 128 (SLICE_MAXD_STREAM): G = 32, the chain's
#: x0, n̂ and staged terms in the block's shared memory, (2 + NT) D values of
#: the run's type, so D is bounded by the ``nvcc.SMEM_MAX`` bytes a block may
#: have (:func:`stream_max_d`)
STREAM = "stream"

#: kernel launches since the last reset (compare-with-plain launches included);
#: the double instantiations of the fused and traced routes under ``_f64``
LAUNCHES = {"slice_epoch": 0, "slice_epoch_counted": 0, "slice_step": 0, "slice_epoch_fused": 0,
            "slice_step_f64": 0, "slice_epoch_fused_f64": 0, "slice_step_graded": 0,
            "slice_step_graded_f64": 0, "slice_step_host": 0, "slice_step_host_f64": 0}
#: the traced route's CUDA-graph replays and the rounds they ran, since the
#: last reset
TRACED = {"replays": 0, "rounds": 0}
#: the graded route's (engine "scan") replays and rounds of each graph (the
#: full calc, the fast part), the launches that opened a repeat, the rows
#: of the slow intermediate it computed, and the rows of the full calc and
#: of the fast part its epoch records took (the babies of slow- and of
#: fast-grade repeats), since the last reset
GRADED = {"replays_full": 0, "replays_fast": 0, "rounds_full": 0, "rounds_fast": 0,
          "openings": 0, "aux_rows": 0, "assembly_rows": 0, "assembly_fast_rows": 0}
#: the host route's rounds (a launch that consumed the user's logL), the
#: user's likelihood calls on its probes (one per probe a lane consumes;
#: its epoch records make none), and the host seconds of a round's parts:
#: the launch enqueued, the copy of the probes and the lanes' rows to
#: pinned memory waited for (the kernel's run included), the user's calls,
#: and the logL written and copied back
HOST = {"rounds": 0, "probe_calls": 0,
        "launch_s": 0.0, "copy_out_s": 0.0, "user_s": 0.0, "copy_in_s": 0.0}
#: rounds (one calc evaluation and one slice_step launch each) in one graph
ROUNDS = 32
#: ... of the graded route, where a replay ends its repeat: a repeat of the
#: 20-D Gaussian takes its slowest lane some 8-12 rounds (counted on the
#: CPU), so 32 would evaluate the slow calc three times as often as needed
GRADED_ROUNDS = 8

WARP = 32  # lanes of a warp: the kernels run one warp per block
#: the lanes a chain may be spread over (the kernel's instantiations)
GROUPS = (1, 2, 4, 8, 16, 32)
#: the G instantiated in each bucket
BUCKET_GROUPS = {SLICE_MAXD: GROUPS,
                 SLICE_MAXD_WIDE: tuple(g for g in GROUPS if g * LANE_CAP >= SLICE_MAXD_WIDE),
                 STREAM: (WARP,)}
#: slice_epoch's and slice_epoch_fused's launches by (bucket, G) since the
#: last reset
GROUP_LAUNCHES = {(b, g): 0 for b, gs in BUCKET_GROUPS.items() for g in gs}
#: the warps per SM that choose_group aims for (PERF.md: the epoch's
#: time against G at the bench and gaussian.ini geometries)
TARGET_WARPS_PER_SM = 8

#: device functors of ``csrc/likelihoods.cuh``: the likelihood form's name
#: -> (functor id, the form's constants in the order the functor takes them)
FUNCTORS = {
    "gaussian": (0, ("mu", "sigma", "norm")),
    "gaussian_shells": (1, ("centre", "radius", "two_s2", "neg_a", "log_two")),
    "half_gaussian": (2, ("mu", "sigma", "norm")),
    "pyramidal": (3, ("mu", "sigma", "norm", "factor")),
    "rastrigin": (4, ("log_norm", "A", "two_pi")),
    "twin_gaussian": (5, ("off", "sigma", "norm", "log_two")),
    "himmelblau": (6, ("norm",)),
    "rosenbrock": (7, ("a", "b", "norm")),
    "eggbox": (8, ()),
    "gaussian_shell": (9, ("radius", "two_s2", "neg_a")),
    # the D x D matrix last; the kernel reads it from the device array of
    # functor_device_data
    "random_gaussian": (10, ("mu", "norm", "invcov")),
}
#: the per-coordinate terms (the functor's NT) where a functor has more than one
FUNCTOR_TERMS = {"twin_gaussian": 2}

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 3 + [ctypes.c_uint] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
)


def _lib():
    return nvcc.load("slice_epoch", ["slice_epoch.cu"])


def stream_max_d(n_terms: int = 1, dtype=torch.float32) -> int:
    """The largest D of the stream bucket for a likelihood of ``n_terms``
    per-coordinate terms in ``dtype``: (2 + n_terms) D values in the
    ``nvcc.SMEM_MAX`` bytes of a block (``SLICE_SMEM_MAX``, the request of
    ``csrc/slice_epoch.cuh::launch_epoch``; 19,370 in float32 at one term,
    14,528 at two, 7,264 in float64 at two)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return nvcc.SMEM_MAX // ((2 + n_terms) * itemsize)


def bucket(D: int, n_terms: int = 1, dtype=torch.float32):
    """The dimension bucket of the kernel template that takes D: 32, 128 or
    :data:`STREAM`; raises above the stream bucket's bound for a likelihood
    of ``n_terms`` terms in ``dtype`` (:func:`stream_max_d`), naming the
    bound and the plain engine, which has none."""
    if D <= SLICE_MAXD:
        return SLICE_MAXD
    if D <= SLICE_MAXD_WIDE:
        return SLICE_MAXD_WIDE
    limit = stream_max_d(n_terms, dtype)
    if D <= limit:
        return STREAM
    raise ValueError(
        f"D = {D} exceeds the CUDA slice kernels' bound D <= {limit} for a likelihood of "
        f"{n_terms} per-coordinate term(s) in {str(dtype).replace('torch.', '')}: a block's "
        f"{nvcc.SMEM_MAX} bytes of shared memory hold (2 + {n_terms}) D of its values; "
        "engine='torch' runs any D")


def choose_group(B: int, D: int, n_sm: int) -> int:
    """G, the lanes of a warp that hold one chain: the smallest power of two
    whose B G / 32 warps reach :data:`TARGET_WARPS_PER_SM` on each of the
    card's ``n_sm`` SMs, and never more lanes than coordinates (G <= D, so
    every lane owns one).  More lanes per chain hide the micro-step's
    dependent chain behind more warps, but spend G times the issue slots on
    each chain's state machine and sums.  Above D = 32 (the wide bucket) G
    is the bucket's one, 128 / :data:`LANE_CAP` = 32: no lane owns more
    than LANE_CAP coordinates, so G >= D / LANE_CAP and never G = 1; above
    128 (the stream bucket) G is 32 as well."""
    g_max = 1 << (min(D, WARP).bit_length() - 1)
    g = BUCKET_GROUPS[bucket(D)][0]
    while g < g_max and B * g < TARGET_WARPS_PER_SM * n_sm * WARP:
        g *= 2
    return g


def launch_group(B: int, D: int, dev: torch.device, group=None):
    """(bucket, G) of a kernel launch on ``dev``: ``group`` if given (it must
    be one of the bucket's :data:`BUCKET_GROUPS`), else :func:`choose_group`."""
    b = bucket(D)
    G = choose_group(B, D, _sm_count(dev)) if group is None else group
    if G not in BUCKET_GROUPS[b]:
        raise ValueError(f"group {G} is not one of {BUCKET_GROUPS[b]} at D={D}")
    return b, G


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _f32(x: float) -> float:
    return float(np.float32(x))


def functor_terms(name: str) -> int:
    """NT, the per-coordinate terms of the device functor ``name``."""
    return FUNCTOR_TERMS.get(name, 1)


def check_functor_dims(name: str, D: int) -> None:
    """Raise if the device functor ``name`` (float32) cannot take D: above the
    stream bucket's bound for its terms (:func:`bucket`), naming the bound and
    engine='torch'."""
    bucket(D, functor_terms(name), torch.float32)


def functor_args(calc, D: int):
    """(functor id, constants, prior a, prior s) — the host float32 arrays a
    kernel entry takes for ``calc.device_spec``, checked against D.  Raises
    for a model without a device form that :data:`FUNCTORS` knows."""
    spec = getattr(calc, "device_spec", None)
    if spec is None or spec["likelihood"]["name"] not in FUNCTORS:
        raise ValueError(
            "the CUDA slice kernels need a prior and likelihood with a device "
            "form (ops/evaluate.py); use engine='torch' for this model"
        )
    name = spec["likelihood"]["name"]
    fid, keys = FUNCTORS[name]
    consts = np.concatenate(
        [np.zeros(0, np.float32)]
        + [np.atleast_1d(np.asarray(spec["likelihood"][k], np.float32)).ravel() for k in keys]
    )
    check_functor_dims(name, D)
    if name == "random_gaussian" and consts.size != 2 + D * D:
        raise ValueError(f"random_gaussian's matrix is not {D} x {D}")
    prior_a, prior_s = (np.ascontiguousarray(v, dtype=np.float32) for v in spec["prior"])
    if prior_a.shape != (D,) or prior_s.shape != (D,):
        raise ValueError(f"the prior's affine form is not per coordinate of D={D}")
    return fid, consts, prior_a, prior_s


def functor_device_data(calc, D: int, device) -> torch.Tensor:
    """The device array every kernel entry takes beside :func:`functor_args`'
    host arrays: [a (D), s (D)], the prior the stream bucket reads, then
    random_gaussian's D x D matrix, which its functor reads in every bucket.
    float32 on ``device``, made once per calc and device."""
    memo = calc.__dict__.setdefault("functor_device_data", {})
    key = (str(device), D)
    if key not in memo:
        fid, consts, prior_a, prior_s = functor_args(calc, D)
        extra = consts[2:] if fid == FUNCTORS["random_gaussian"][0] else consts[:0]
        memo[key] = torch.as_tensor(np.concatenate([prior_a, prior_s, extra]),
                                    dtype=torch.float32).to(device)
    return memo[key]


def launch_slice_kernel(lib, entry: str, calc, cfg: EpochConfig, key_words,
                        x0, bound, valid, nhats, ws, cap=None, extra=(), ints=(), functor=None,
                        lane0=0):
    """Check the inputs of a slice-epoch kernel, launch it on the current
    stream and return (t, logL, nlike), each (B, R).  The model must have a
    device form (``calc.device_spec``) whose functor is in
    :data:`FUNCTORS`, unless ``functor`` gives the entry's first five
    arguments itself (an int, the constants as a host array or a device
    tensor, the prior's a and s as host arrays, and the device array of
    :func:`functor_device_data`'s layout).  ``cap`` is the kernel's micro-step budget
    (``cfg.step_cap`` by default); ``extra`` are further output tensors on
    the device and ``ints`` further int arguments, passed after the stream
    in that order.  The kernel computes in the calc's dtype: a ``functor``
    lowered from the calc is instantiated in it (float64 for the fused
    route's double kernel), and a functor of :data:`FUNCTORS` is float32,
    so a float64 calc without one raises: a float64 run never reaches a
    float32 kernel.  ``lane0`` is the launch's first lane in the whole batch
    (a shard's first logical lane; ``pallas_slice.lane_hash``)."""
    B, R, D = nhats.shape
    dtype = calc_dtype(calc)
    bucket(D, dtype=dtype)  # raises above the stream bucket
    if functor is None and dtype != torch.float32:
        raise TypeError(f"{entry} is a float32 kernel and this model computes in "
                        f"{dtype}; at precision='highest' use engine='cuda' or 'torch'")
    if functor is None:
        functor = (*functor_args(calc, D), functor_device_data(calc, D, x0.device))
    fid, consts, prior_a, prior_s, dev_data = functor
    if x0.shape != (B, D) or bound.shape != (B,) or valid.shape != (B,) or ws.shape != (B, R):
        raise ValueError(f"{entry}: inconsistent shapes")
    dev = x0.device
    for name, a in (("bound", bound), ("valid", valid), ("nhats", nhats), ("ws", ws)):
        if a.device != dev:
            raise ValueError(f"{entry}: {name} is on {a.device}, x0 on {dev}")
    x0t = x0.to(dtype).t().contiguous()
    nhat_t = nhats.to(dtype).permute(1, 2, 0).contiguous()
    w_t = ws.to(dtype).t().contiguous()
    bound_f = bound.to(dtype).contiguous()
    valid_f = valid.to(dtype).contiguous()
    t_out = torch.empty((R, B), dtype=dtype, device=dev)
    l_out = torch.empty((R, B), dtype=dtype, device=dev)
    n_out = torch.empty((R, B), dtype=torch.int32, device=dev)
    for a in extra:
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{entry}: an extra output is not contiguous on {dev}")
    k0, k1 = key_words
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = getattr(lib, entry)
    argtypes = list(_ARGTYPES)
    if dtype == torch.float64:  # logzero in the kernel's type
        argtypes[-2] = ctypes.c_double
    fn.argtypes = argtypes + [ctypes.c_void_p] * len(extra) + [ctypes.c_int] * len(ints)
    fn.restype = ctypes.c_int
    logzero = _f32(cfg.logzero) if dtype == torch.float32 else float(cfg.logzero)
    with torch.cuda.device(dev):
        status = fn(
            fid, consts.data_ptr() if isinstance(consts, torch.Tensor) else consts.ctypes.data,
            prior_a.ctypes.data, prior_s.ctypes.data, dev_data.data_ptr(),
            x0t.data_ptr(), bound_f.data_ptr(), valid_f.data_ptr(),
            nhat_t.data_ptr(), w_t.data_ptr(), t_out.data_ptr(),
            l_out.data_ptr(), n_out.data_ptr(), B, D, R,
            int(k0), int(k1), int(lane0), cfg.max_step, cfg.max_shrink,
            cfg.step_cap if cap is None else int(cap), logzero, stream,
            *(a.data_ptr() for a in extra), *(int(i) for i in ints),
        )
    nvcc.check(status, entry)
    return t_out.t(), l_out.t(), n_out.t()


def slice_epoch(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws,
                group=None, lane0=0):
    """Run the slice repeats of every lane: (t, logL) float32 and nlike
    int32, each (B, R).  ``x0 (B,D)``, ``bound (B,)``, ``valid (B,)`` bool,
    ``nhats (B,R,D)``, ``ws (B,R)``.  CPU tensors: the plain version; CUDA
    tensors: the kernel, which needs ``calc.device_spec``, with ``group``
    lanes per chain (one of the bucket's :data:`BUCKET_GROUPS`;
    :func:`choose_group` by default).  Every G gives the same result bit
    for bit.  ``lane0`` is the first lane's index in the whole batch (a
    shard's first logical lane, ``pallas_slice.lane_hash``); every wrapper
    of a slice kernel takes it."""
    if group is not None and group not in GROUPS:
        raise ValueError(f"group {group} is not one of {GROUPS}")
    if x0.device.type == "cpu":
        return slice_records_plain(
            lambda p: calc(p)[2], cfg, key_words, x0, bound, valid, nhats, ws, lane0=lane0
        )
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    B, R, D = nhats.shape
    key = launch_group(B, D, x0.device, group)
    out = launch_slice_kernel(_lib(), "slice_epoch_launch", calc, cfg, key_words,
                              x0, bound, valid, nhats, ws, ints=(key[1],), lane0=lane0)
    LAUNCHES["slice_epoch"] += 1
    GROUP_LAUNCHES[key] += 1
    return out


def slice_epoch_counted(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws):
    """B1 with its micro-steps counted: (t, logL, nlike, lane_steps,
    warp_max), the first three as :func:`slice_epoch` gives them,
    ``lane_steps (B,)`` int32 the micro-steps each lane executed and
    ``warp_max (ceil(B/32),)`` int32 the largest of each warp's 32 lanes
    (lanes past B count 0).  CPU tensors: the plain engine's own step
    counts; CUDA tensors: the counted kernel."""
    B = x0.shape[0]
    if x0.device.type == "cpu":
        t, l, n, steps = slice_records_plain(
            lambda p: calc(p)[2], cfg, key_words, x0, bound, valid, nhats, ws,
            count_steps=True,
        )
        return t, l, n, steps, warp_maxima(steps)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    steps = torch.empty(B, dtype=torch.int32, device=x0.device)
    wmax = torch.empty(-(-B // WARP), dtype=torch.int32, device=x0.device)
    out = launch_slice_kernel(_lib(), "slice_epoch_counted_launch", calc, cfg, key_words,
                              x0, bound, valid, nhats, ws, extra=(steps, wmax))
    LAUNCHES["slice_epoch_counted"] += 1
    return (*out, steps, wmax)


def warp_maxima(lane_steps: torch.Tensor) -> torch.Tensor:
    """The largest entry of each run of 32 lanes (the last padded with 0)."""
    B = lane_steps.shape[0]
    padded = torch.zeros(-(-B // WARP) * WARP, dtype=torch.int32, device=lane_steps.device)
    padded[:B] = lane_steps.to(torch.int32)
    return padded.view(-1, WARP).amax(dim=1)


def lane_efficiency(lane_steps: torch.Tensor, warp_max: torch.Tensor) -> float:
    """The share of issued lane-steps that did work: a warp runs as long as
    its slowest lane, so sum(lane steps) / (32 * sum(warp max))."""
    issued = WARP * int(warp_max.to(torch.int64).sum())
    return int(lane_steps.to(torch.int64).sum()) / issued if issued else float("nan")


def slice_epoch_fused(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws,
                      group=None, lane0=0):
    """Run the slice repeats of every lane with the model's likelihood
    lowered into B1 (``ops/fused_like.py``): (t, logL) of the lowering's
    dtype (float32; float64 at ``precision='highest'``) and nlike int32,
    each (B, R), with the inputs of :func:`slice_epoch`.  CPU tensors: the
    plain version, ``slice_records_plain`` on ``Lowered.plain_logL``; CUDA
    tensors: ``csrc/slice_epoch_fused.cu`` in that dtype with ``group``
    lanes per chain (:func:`launch_group`), its library built at first use.
    A model the lowering refused raises, naming the reason."""
    from .fused_like import Refused, lowering

    if group is not None and group not in GROUPS:
        raise ValueError(f"group {group} is not one of {GROUPS}")
    low = lowering(calc)
    if isinstance(low, Refused):
        raise ValueError(f"the fused route cannot run this model: {low.reason}")
    if x0.device.type == "cpu":
        return slice_records_plain(low.plain_logL, cfg, key_words, x0, bound, valid, nhats, ws,
                                   lane0=lane0)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    B, R, D = nhats.shape
    key = launch_group(B, D, x0.device, group)
    G = key[1]
    functor = (G, low.device_consts(x0.device), *low.prior, low.device_prior(x0.device))
    out = launch_slice_kernel(low.library(G), "slice_epoch_fused_launch", calc, cfg, key_words,
                              x0, bound, valid, nhats, ws, functor=functor, lane0=lane0)
    LAUNCHES["slice_epoch_fused" if low.dtype == torch.float32 else "slice_epoch_fused_f64"] += 1
    GROUP_LAUNCHES[key] += 1
    return out


def validate_fused(calc, cfg: EpochConfig, device, group: int) -> None:
    """Check the fused kernel at ``group`` lanes per chain against its plain
    version, ``Lowered.plain_logL``, bitwise, on :func:`validate_functor`'s
    probe epoch; raise on any difference.  (:func:`fused_like.lower`
    already held the plain version to the calc.)"""
    from .fused_like import lowering

    validate_functor(calc, cfg, device,
                     lambda *a: slice_epoch_fused(*a, group=group), want=lowering(calc).plain_logL)


def validate_functor(calc, cfg: EpochConfig, device, records=None, want=None) -> None:
    """Check the kernel's likelihood functor against the torch calc on 1280
    cubes, some outside the walls; raise on any difference.

    ``records`` is the wrapper of the engine that will run the functor
    (:func:`slice_epoch` by default; see ``slice_kernel.kernel_wrapper``);
    its second output is the logL; ``want`` gives the logL it must equal
    (the calc's by default).  The kernel is run with zero directions and zero widths,
    so every probe is the seed itself, and with an unbounded contour: the
    lane steps out and shrinks on the spot and accepts its seed with the
    functor's logL (a seed outside the walls is a forced logzero accept).
    Everything is in the calc's dtype (float64 at precision='highest')."""
    records = slice_epoch if records is None else records
    D = cfg.n_dims
    dt = calc_dtype(calc)
    rng = np.random.default_rng(20240131)
    pts = np.concatenate([
        rng.uniform(-0.05, 1.05, (1024, D)),
        np.clip(rng.normal(0.5, 0.1, (256, D)), -0.2, 1.2),
    ]).astype(np.float32 if dt == torch.float32 else np.float64)
    x0 = torch.as_tensor(pts, device=device)
    B = x0.shape[0]
    # one repeat on the plain configuration (a subclass's budget dropped)
    one = EpochConfig(*cfg)._replace(num_repeats=(1,), grade_dims=(D,))
    got = records(
        calc, one, (0, 0), x0,
        torch.full((B,), -torch.finfo(dt).max, dtype=dt, device=device),
        torch.ones(B, dtype=torch.bool, device=device),
        torch.zeros((B, 1, D), dtype=dt, device=device),
        torch.zeros((B, 1), dtype=dt, device=device),
    )[1]
    expect = calc(x0)[2] if want is None else want(x0)
    if not torch.equal(got[:, 0], expect.to(dt)):
        diff = (got[:, 0].double() - expect.double()).abs().max().item()
        raise RuntimeError(
            f"the CUDA likelihood functor disagrees with "
            f"{'the torch calc' if want is None else 'its plain version'} "
            f"(max |dlogL| = {diff:.3g}); not running the kernel"
        )


def assemble_epoch(calc, cfg: EpochConfig, seed, valid, nhats, speeds, t_acc, logL, nlike_rep,
                   cube=None, aux=None, theta_phi=None):
    """Packed epoch record from the per-(lane, repeat) kernel outputs.  The
    baby positions are ``cube (B, R, D)`` where the engine wrote them (v2,
    the host route's kept probes), else rebuilt as ``seed + cumsum(t n̂)``.
    Their theta and phi are ``theta_phi`` where the engine kept them (the
    host route), else come from one batched evaluation of the calc, or,
    given the graded route's ``aux`` (its slow intermediate by repeat),
    from :func:`graded_babies`."""
    B, R, D = nhats.shape
    n_grades = len(cfg.grade_dims)
    if cube is None:
        cube = seed[:, None, :] + torch.cumsum(t_acc[:, :, None] * nhats, dim=1)
    if theta_phi is not None:
        theta, phi = theta_phi
    elif aux is None:
        theta, phi, _ = calc(cube.reshape(B * R, D))
    else:
        theta, phi = graded_babies(calc, cube, aux)
    vmask = valid[:, None, None]
    theta = torch.where(vmask, theta.reshape(B, R, D), 0.0)
    phi = torch.where(vmask, phi.reshape(B, R, cfg.n_phi), 0.0)
    babies = torch.cat([cube, theta, phi, logL[:, :, None]], dim=2).reshape(
        B, R * (2 * D + cfg.n_phi + 1)
    )
    onehot = torch.nn.functional.one_hot(speeds.long(), n_grades)  # (B, R, G)
    nlike_g = (onehot * nlike_rep[:, :, None].to(torch.int64)).sum(dim=1)
    return torch.cat([
        babies,
        nlike_g.to(babies.dtype),
        torch.zeros((B, 1), dtype=babies.dtype, device=seed.device),  # overflow flag (never set)
    ], dim=1)


def graded_babies(calc, cube, aux_by_rep):
    """theta and phi, ``(B, R, D)`` and ``(B, R, n_phi)``, of the babies
    ``cube (B, R, D)`` of a graded-route epoch, as the JAX scan engine keeps
    them from its probes: a slow-grade repeat's through the full calc, a
    fast-grade repeat's through ``calc.fast_point_batch`` on the slow
    intermediate that repeat ran on (``aux_by_rep[r]``; None for a slow
    repeat).  A fast-grade repeat leaves the slow coordinates where they
    were when it opened, so that intermediate is its babies' own.  The
    rows count under ``GRADED["assembly_rows"]`` (the full calc's) and
    ``GRADED["assembly_fast_rows"]``."""
    B, R, D = cube.shape
    runs = {}  # the repeats that share one intermediate (None: the slow ones)
    for r, aux in enumerate(aux_by_rep):
        runs.setdefault(id(aux), (aux, []))[1].append(r)
    theta = phi = None
    for aux, reps in runs.values():
        n = len(reps)
        rows = cube[:, reps].reshape(B * n, D)  # row b n + j: chain b, repeat reps[j]
        if aux is None:
            th, ph, _ = calc(rows)
            GRADED["assembly_rows"] += B * n
        else:
            th, ph, _ = calc.fast_point_batch(
                tree_map(lambda a: a.repeat_interleave(n, dim=0), aux), rows)  # noqa: B023
            GRADED["assembly_fast_rows"] += B * n
        if theta is None:
            theta = th.new_zeros((B, R, D))
            phi = ph.new_zeros((B, R, ph.shape[-1]))
        theta[:, reps] = th.reshape(B, n, D)
        phi[:, reps] = ph.reshape(B, n, -1)
    return theta, phi


# ---------------------------------------------------------------------------
# B1's route for a likelihood evaluated in torch (csrc/slice_step.cu)
# ---------------------------------------------------------------------------


class StepState:
    """The lanes of the traced route between two rounds, in torch: the plain
    version of ``csrc/slice_step.cu``'s device state, in ``x0``'s dtype
    (float32, or float64 at precision='highest').  Set up as the first
    launch sets it up: a valid lane in ``PH_INIT_R`` of repeat 0, an invalid
    one done; every record t = 0, logL = logzero, nlike = 0."""

    def __init__(self, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws, lane0=0):
        B, R, _ = nhats.shape
        dev = x0.device
        real = x0.dtype if x0.dtype == torch.float64 else torch.float32
        self.cfg, self.bound, self.nhats, self.ws = cfg, bound, nhats, ws
        self.logzero = torch.tensor(cfg.logzero, dtype=real).item()
        self.lanes = torch.arange(B, device=dev)
        self.h_lane = lane_hash(key_words, B, dev, lane0)
        self.m = LaneMachine(B, dev, self.logzero, real)
        self.m.phase = torch.where(valid, PH_INIT_R, PH_DONE).to(torch.int64)
        self.rep = torch.where(valid, 0, R).to(torch.int64)
        self.steps = torch.zeros(B, dtype=torch.int64, device=dev)
        self.x = x0.to(real).clone()
        self.t_out = torch.zeros((B, R), dtype=real, device=dev)
        self.l_out = torch.full((B, R), self.logzero, dtype=real, device=dev)
        self.n_out = torch.zeros((B, R), dtype=torch.int32, device=dev)
        self.t = self.probe = None  # the probes of the last launch
        # the lanes whose probe of the last launch awaits its logL (S_PEND)
        self.pending = torch.zeros(B, dtype=torch.bool, device=dev)


def slice_step_plain(st: StepState, logL=None, rep_limit=None) -> bool:
    """One launch of ``csrc/slice_step.cu`` in torch.  Unless ``logL`` is
    None (the epoch's first launch, or one after which no lane has a probe
    pending), consume it, the (B,) logL of ``st.probe``: the transition of
    every lane whose probe was pending, the records of the repeats that
    accept or meet the epoch's budget, an accepted lane's move to its probe
    and the start of its next repeat.  Then propose: the next probes into
    ``st.probe`` for the lanes that are running and whose repeat is below
    ``rep_limit`` (the kernel's repeat barrier; R when None); any other lane
    probes its x with t = 0 and has no probe pending.  Returns whether a
    lane proposed (the kernel's ``active`` flag)."""
    m, cfg = st.m, st.cfg
    R = st.nhats.shape[1]
    if logL is not None:
        active = (m.phase != PH_DONE) & st.pending
        acc, forced = m.decide(cfg, active, st.t, logL, st.bound)
        st.steps = st.steps + active.to(torch.int64)
        capped = active & ~acc & (st.steps >= cfg.step_cap)
        rec = acc | capped
        rows, cols = st.lanes[rec], st.rep[rec]
        st.t_out[rows, cols] = torch.where(acc, st.t, 0.0)[rec]
        st.l_out[rows, cols] = torch.where(acc & ~forced, logL, st.logzero)[rec]
        st.n_out[rows, cols] = m.cnt[rec].to(torch.int32)
        st.x = torch.where(acc[:, None], st.probe, st.x)
        st.rep = torch.where(acc, st.rep + 1, st.rep)
        m.phase = torch.where(acc, torch.where(st.rep >= R, PH_DONE, PH_INIT_R), m.phase)
        m.phase = torch.where(capped | (acc & (st.steps >= cfg.step_cap)), PH_DONE, m.phase)
        m.restart(acc)
    active = (m.phase != PH_DONE) & (st.rep < (R if rep_limit is None else rep_limit))
    r_idx = st.rep.clamp(max=R - 1)
    st.t = m.propose(active, _mix(st.h_lane, st.rep), st.ws[st.lanes, r_idx])
    st.probe = st.x + st.t[:, None] * st.nhats[st.lanes, r_idx]
    st.pending = active
    return bool(active.any())


def slice_records_rounds_plain(logL_fn, cfg: EpochConfig, key_words, x0, bound, valid,
                               nhats, ws, rounds: int = ROUNDS, lane0: int = 0):
    """The traced route in torch, structured as the kernel route runs it: the
    first launch, then replays of ``rounds`` rounds (``logL_fn(probe)`` and
    one :func:`slice_step_plain`) until the flag of a replay's last round
    reads no lane running.  Returns (t, logL, nlike), each (B, R), bitwise
    ``slice_kernel.slice_records_plain`` for any ``rounds``."""
    st = StepState(cfg, key_words, x0, bound, valid, nhats, ws, lane0)
    running = slice_step_plain(st)
    while running:
        for _ in range(rounds):
            running = slice_step_plain(st, logL_fn(st.probe))
    return st.t_out, st.l_out, st.n_out


def repeat_grades(speeds) -> list:
    """The grade of each repeat as ints: ``speeds`` is ``(B, R)`` (the
    directions' slot grades, shared by the batch: its first row is read) or
    ``(R,)``.  One host read."""
    speeds = torch.as_tensor(speeds)
    return [int(g) for g in (speeds[0] if speeds.dim() == 2 else speeds).tolist()]


def graded_schedule(calc, grades):
    """The graded route's schedule, one ``(r, fast, refresh)`` per repeat r,
    shared by its plain version and the card's: ``fast`` when the repeat
    evaluates only the fast part (a fast-grade repeat, ``grades[r]`` > 0, of
    a :class:`GradedLikelihood` calc, ``calc.graded``), ``refresh`` when the
    slow intermediate must first be computed from the chains' positions (a
    slow repeat, or the seeds, moved them since it last was)."""
    graded = bool(getattr(calc, "graded", False))
    stale = True
    for r, grade in enumerate(grades):
        fast = graded and grade != 0
        yield r, fast, fast and stale
        stale = not fast


def slice_records_graded_plain(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats,
                               ws, grades, rounds: int = 1, with_aux: bool = False,
                               lane0: int = 0):
    """The graded route in torch (the plain version of
    :meth:`TracedEpoch.graded`): the traced route's launches with the
    repeat barrier raised one repeat at a time (:func:`graded_schedule`).
    Repeat r runs in lockstep across the batch: the launch that opens it
    (``rep_limit`` r + 1; no lane has a probe pending then, so it consumes
    nothing), then rounds of ``rounds`` until no lane proposed.  A slow
    repeat evaluates the full calc each round, a fast one
    ``calc.fast_point_batch(aux, probe)``, with ``aux =
    calc.slow_aux_batch(x)`` computed before the repeat opens when the
    schedule says so.  Returns (t, logL, nlike), each (B, R): for a calc
    whose fast part gives its full logL bit for bit, those of
    ``slice_kernel.slice_records_plain``, for any ``rounds``; with
    ``with_aux``, also the intermediate each repeat ran on (None for a
    slow one), for :func:`assemble_epoch`."""
    st = StepState(cfg, key_words, x0, bound, valid, nhats, ws, lane0)
    aux, aux_by_rep = None, []
    for r, fast, refresh in graded_schedule(calc, grades):
        if refresh:  # before the repeat opens: the chains' slow parameters
            aux = calc.slow_aux_batch(st.x)
        running = slice_step_plain(st, None, rep_limit=r + 1)
        while running:
            for _ in range(rounds):
                probe = st.probe
                logL = calc.fast_point_batch(aux, probe)[2] if fast else calc(probe)[2]
                running = slice_step_plain(st, logL, rep_limit=r + 1)
        aux_by_rep.append(aux if fast else None)
    out = (st.t_out, st.l_out, st.n_out)
    return (*out, aux_by_rep) if with_aux else out


#: slice_step_launch's arguments: first, 16 device pointers, B, D, R, k0,
#: k1, lane0, max_step, max_shrink, cap, logzero, stream
_STEP_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_uint] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
)
#: slice_step_launch_f64's: logzero a double
_STEP_ARGTYPES_F64 = _STEP_ARGTYPES[:-2] + [ctypes.c_double, ctypes.c_void_p]
_STATE_INTS, _STATE_FLOATS = 11, 3  # S_INTS and F_FLOATS of slice_step.cu
_S_REP, _S_PEND = 8, 10  # the rows S_REP and S_PEND of its integer state



class TracedEpoch:
    """``csrc/slice_step.cu``'s device state for one calc, configuration and
    (B, R, D), and the CUDA graphs of ``rounds`` rounds that replay it, in
    the calc's dtype (float32, or float64 through the entry
    ``slice_step_launch_f64``).

    The buffers are allocated once; each epoch copies its inputs in, runs the
    first launch, captures a graph on its first use (the calc warmed up on
    a side stream first, as capture asks) and replays it until the kernel's
    ``active`` flag reads 0: one host read per replay.  The traced route
    (``__call__``) holds the repeat barrier at R; the graded route
    (:meth:`graded`) raises it one repeat at a time and replays, per repeat,
    the graph of its grade: the full calc, or ``calc.fast_point_batch`` on a
    persistent ``aux`` buffer refreshed in place.  A calc that cannot run
    inside a graph (a host sync such as ``.item()``, a copy from host
    memory) raises ``ValueError``.  The calc keeps its runners
    (:func:`slice_epoch_traced`), so a runner takes the calc as an argument
    and holds no reference to it: no cycle that only the garbage collector
    could free, at a moment that might fall inside another capture."""

    def __init__(self, calc, cfg: EpochConfig, B: int, R: int, D: int, rounds: int, device):
        dtype = calc_dtype(calc)
        self.cfg, self.rounds, self.device = cfg, rounds, device
        self.shape = (B, R, D)
        real = dict(dtype=dtype, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.x0t, self.valid, self.bound = (torch.zeros((D, B), **real), torch.zeros(B, **real),
                                            torch.zeros(B, **real))
        self.nhat, self.w = torch.zeros((R, D, B), **real), torch.zeros((R, B), **real)
        self.logL = torch.zeros(B, **real)
        self.ist = torch.zeros((_STATE_INTS, B), **i32)
        self.steps = torch.zeros(B, dtype=torch.int64, device=device)
        self.fst, self.x = torch.zeros((_STATE_FLOATS, B), **real), torch.zeros((D, B), **real)
        self.probe = torch.zeros((B, D), **real)
        self.t_out, self.l_out = torch.zeros((R, B), **real), torch.zeros((R, B), **real)
        self.n_out, self.active = torch.zeros((R, B), **i32), torch.zeros(1, **i32)
        self.rep_limit = torch.full((1,), R, **i32)
        f64 = dtype == torch.float64
        lib = nvcc.load("slice_step", ["slice_step.cu"])
        self.fn = lib.slice_step_launch_f64 if f64 else lib.slice_step_launch
        self.fn.argtypes = _STEP_ARGTYPES_F64 if f64 else _STEP_ARGTYPES
        self.fn.restype = ctypes.c_int
        self.logzero = float(cfg.logzero) if f64 else _f32(cfg.logzero)
        suffix = "_f64" if f64 else ""
        self.counter, self.graded_counter = "slice_step" + suffix, "slice_step_graded" + suffix
        self.graph = self.fast_graph = self.aux = None

    def _launch(self, first: bool, key_words=(0, 0), lane0: int = 0) -> None:
        B, R, D = self.shape
        cfg = self.cfg
        bufs = (self.x0t, self.valid, self.bound, self.nhat, self.w, self.logL, self.ist,
                self.steps, self.fst, self.x, self.probe, self.t_out, self.l_out, self.n_out,
                self.active, self.rep_limit)
        status = self.fn(
            int(first), *(b.data_ptr() for b in bufs), B, D, R, int(key_words[0]),
            int(key_words[1]), int(lane0), cfg.max_step, cfg.max_shrink, cfg.step_cap, self.logzero,
            torch.cuda.current_stream(self.device).cuda_stream,
        )
        nvcc.check(status, "slice_step_launch")

    def _capture(self, logL_of):
        """The graph of ``rounds`` rounds, each ``logL = logL_of()`` and one
        launch; the last round clears ``active`` first, so that the flag
        tells of that round."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                logL_of()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a graph that the garbage collector frees while this one is being
        # captured ends the capture: collect now, and not during it
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    for i in range(self.rounds):
                        self.logL.copy_(logL_of())
                        if i == self.rounds - 1:  # the flag then tells of the last round
                            self.active.zero_()
                        self._launch(False)
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            first = e.__context__ or e  # what broke the capture, before capture_end's error
            raise ValueError(
                "the CUDA engine runs a model without a device functor inside a CUDA "
                f"graph, and this likelihood or prior cannot be captured in one ({first}); "
                "pass engine='torch' to run it on the plain engine"
            ) from e
        finally:
            gc.enable()
        return graph

    def _start(self, key_words, x0, bound, valid, nhats, ws, rep_limit: int, counter: str,
               lane0: int = 0):
        self.x0t.copy_(x0.t())
        self.valid.copy_(valid)
        self.bound.copy_(bound)
        self.nhat.copy_(nhats.permute(1, 2, 0))
        self.w.copy_(ws.t())
        self.rep_limit.fill_(rep_limit)
        self.active.zero_()
        self._launch(True, key_words, lane0)
        LAUNCHES[counter] += 1

    def _replay(self, graph, counter: str, on_replay) -> None:
        while int(self.active.item()):
            graph.replay()
            LAUNCHES[counter] += self.rounds
            on_replay()

    def _outputs(self):
        return self.t_out.t().contiguous(), self.l_out.t().contiguous(), \
            self.n_out.t().contiguous()

    def __call__(self, calc, key_words, x0, bound, valid, nhats, ws, lane0=0):
        self._start(key_words, x0, bound, valid, nhats, ws, self.shape[1], self.counter, lane0)
        if self.graph is None:
            self.graph = self._capture(lambda: calc(self.probe)[2])

        def count():
            TRACED["replays"] += 1
            TRACED["rounds"] += self.rounds

        self._replay(self.graph, self.counter, count)
        return self._outputs()

    def graded(self, calc, key_words, x0, bound, valid, nhats, ws, grades, lane0=0):
        """The graded route: :func:`slice_records_graded_plain` on the card,
        with its outputs and the intermediate of each repeat.  Repeat r
        opens with ``rep_limit`` r + 1 (the epoch's first launch for r = 0,
        else one launch outside the graphs that only proposes) and replays
        the graph of its grade until no lane proposed; before a fast-grade
        repeat that the schedule refreshes, ``aux`` is computed from the
        chains' positions and copied into the buffer the fast graph reads."""
        B = self.shape[0]
        aux, aux_by_rep = None, []
        for r, fast, refresh in graded_schedule(calc, grades):
            if refresh:
                x = x0 if r == 0 else self.x.t()
                aux = calc.slow_aux_batch(x.contiguous())
                if self.aux is None:  # the buffer the fast graph reads
                    self.aux = tree_map(torch.clone, aux)
                else:
                    for dst, src in zip(tree_leaves(self.aux), tree_leaves(aux)):
                        dst.copy_(src)
                GRADED["aux_rows"] += B
            if r == 0:
                self._start(key_words, x0, bound, valid, nhats, ws, 1, self.graded_counter,
                            lane0)
            else:
                self.rep_limit.fill_(r + 1)
                self.active.zero_()
                self._launch(False)
                LAUNCHES[self.graded_counter] += 1
                GRADED["openings"] += 1
            if fast and self.fast_graph is None:
                self.fast_graph = self._capture(
                    lambda: calc.fast_point_batch(self.aux, self.probe)[2])
            if not fast and self.graph is None:
                self.graph = self._capture(lambda: calc(self.probe)[2])
            kind = "fast" if fast else "full"

            def count(kind=kind):
                GRADED["replays_" + kind] += 1
                GRADED["rounds_" + kind] += self.rounds

            self._replay(self.fast_graph if fast else self.graph, self.graded_counter, count)
            aux_by_rep.append(aux if fast else None)
        return (*self._outputs(), aux_by_rep)


def _runner(calc, cfg: EpochConfig, B: int, R: int, D: int, rounds: int, device) -> TracedEpoch:
    """The calc's :class:`TracedEpoch` for this configuration, shape and
    ``rounds`` (made on first use)."""
    runners = calc.__dict__.setdefault("traced_epochs", {})
    key = (tuple(cfg), cfg.step_cap, B, R, D, rounds, str(device))
    if key not in runners:
        runners[key] = TracedEpoch(calc, cfg, B, R, D, rounds, device)
    return runners[key]


def _check_traced_inputs(name: str, calc, x0, bound, valid, nhats, ws, rounds: int,
                         host: bool = False) -> None:
    """Check a traced-route wrapper's inputs; on the card, a host-callback
    calc raises unless ``host`` (the host route), which needs one."""
    B, R, D = nhats.shape
    if x0.shape != (B, D) or bound.shape != (B,) or valid.shape != (B,) or ws.shape != (B, R):
        raise ValueError(f"{name}: inconsistent shapes")
    if rounds < 1:
        raise ValueError(f"rounds must be at least 1, not {rounds}")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")
    callback = bool(getattr(calc, "uses_callback", False))
    if host and not callback:
        raise ValueError(f"{name}: the host route runs a host-callback likelihood; a torch "
                         "likelihood takes the traced route")
    if x0.device.type == "cpu":
        return
    if callback and not host:
        raise ValueError(
            "a host-callback likelihood cannot run inside a CUDA graph: on the card it runs "
            "on engine='scan' (the host route, slice_step_host), or on engine='torch' (the "
            "plain engine)"
        )
    for arg, a in (("bound", bound), ("valid", valid), ("nhats", nhats), ("ws", ws)):
        if a.device != x0.device:
            raise ValueError(f"{name}: {arg} is on {a.device}, x0 on {x0.device}")


def slice_epoch_traced(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws,
                       rounds: int = ROUNDS, lane0: int = 0):
    """Run the slice repeats of every lane for a model without a device
    functor: (t, logL) of the calc's dtype (float32; float64 at
    precision='highest') and nlike int32, each (B, R), with the inputs of
    :func:`slice_epoch`.  CPU tensors: the plain version,
    :func:`slice_records_rounds_plain`; CUDA tensors: ``csrc/slice_step.cu``
    in that dtype through a :class:`TracedEpoch` kept on the calc, one per
    configuration, shape and ``rounds``.  A host-callback calc
    raises on the card."""
    _check_traced_inputs("slice_epoch_traced", calc, x0, bound, valid, nhats, ws, rounds)
    if x0.device.type == "cpu":
        return slice_records_rounds_plain(lambda p: calc(p)[2], cfg, key_words, x0, bound,
                                          valid, nhats, ws, rounds, lane0)
    B, R, D = nhats.shape
    return _runner(calc, cfg, B, R, D, rounds, x0.device)(calc, key_words, x0, bound, valid,
                                                          nhats, ws, lane0)


def slice_epoch_graded(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws, speeds,
                       rounds=None, with_aux: bool = False, lane0: int = 0):
    """The ``"scan"`` engine's epoch: the slice repeats of every lane run
    one repeat at a time in lockstep across the batch, each repeat of one
    grade (``speeds``, the directions' (B, R) slot grades, shared by the
    batch), with the inputs and outputs of :func:`slice_epoch_traced`.  For
    a :class:`GradedLikelihood` calc a fast-grade repeat evaluates only its
    fast part on the cached slow intermediate.  CPU tensors: the plain
    version, :func:`slice_records_graded_plain` (a round costs the same
    there however the rounds are grouped, so by default it checks the flag
    after each); CUDA tensors: ``csrc/slice_step.cu`` with its repeat
    barrier (:meth:`TracedEpoch.graded`, ``rounds`` per replay, by default
    :data:`GRADED_ROUNDS`), launches counted under ``slice_step_graded``
    (``_f64`` in double).  With ``with_aux``, also the slow intermediate
    each repeat ran on (None for a slow repeat), which
    :func:`assemble_epoch` takes.  A host-callback calc raises on the card."""
    cpu = x0.device.type == "cpu"
    rounds = (1 if cpu else GRADED_ROUNDS) if rounds is None else rounds
    _check_traced_inputs("slice_epoch_graded", calc, x0, bound, valid, nhats, ws, rounds)
    grades = repeat_grades(speeds)
    B, R, D = nhats.shape
    if len(grades) != R:
        raise ValueError(f"slice_epoch_graded: {len(grades)} repeat grades for R = {R}")
    if cpu:
        return slice_records_graded_plain(calc, cfg, key_words, x0, bound, valid, nhats, ws,
                                          grades, rounds, with_aux, lane0)
    out = _runner(calc, cfg, B, R, D, rounds, x0.device).graded(
        calc, key_words, x0, bound, valid, nhats, ws, grades, lane0)
    return out if with_aux else out[:3]


# ---------------------------------------------------------------------------
# B1's route for a host-callback likelihood (csrc/slice_step.cu, no graph)
# ---------------------------------------------------------------------------


class ProbeKeeper:
    """The host side of the host route, shared by :class:`HostEpoch` and its
    plain version :func:`slice_records_host_plain`.

    After each launch it is shown the probes, the lanes whose probe is
    pending (the kernel's ``S_PEND`` row) and each lane's repeat counter
    (``S_REP``).  :meth:`evaluate` calls the user's likelihood
    (``calc.host_point_batch``) on the pending lanes' probes only, one call
    a probe, and gives every other lane logzero, which the kernel does not
    consume.  :meth:`note` keeps, for each lane whose repeat counter moved
    since the last launch, the probe that launch accepted (its cube, theta
    and phi) as the baby of the repeat it ended: the kernel moves the lane
    to that probe, and the JAX package's scan engine emits its accepted
    probes as the babies (``polychordlite_tpu/ops/slice_kernel.py:337-392``).
    :meth:`babies` gives them to the epoch record."""

    def __init__(self, calc, B: int, R: int, D: int):
        np_dt = np.float32 if calc_dtype(calc) == torch.float32 else np.float64
        self.calc, self.logzero = calc, np_dt(calc.logzero)
        self.cube, self.theta = np.zeros((B, R, D), np_dt), np.zeros((B, R, D), np_dt)
        self.phi = np.zeros((B, R, calc.n_phi), np_dt)
        self.kept = np.zeros((B, R), bool)
        # the lanes' last evaluated probes
        self.p_cube, self.p_theta = np.zeros((B, D), np_dt), np.zeros((B, D), np_dt)
        self.p_phi = np.zeros((B, calc.n_phi), np_dt)
        self.rep = None

    def note(self, rep: np.ndarray) -> None:
        """Keep the probes that the last launch accepted: a lane accepts at
        most one a launch, and its repeat counter moves exactly then."""
        if self.rep is not None:
            lanes = np.nonzero(rep != self.rep)[0]
            r = self.rep[lanes]
            self.cube[lanes, r] = self.p_cube[lanes]
            self.theta[lanes, r] = self.p_theta[lanes]
            self.phi[lanes, r] = self.p_phi[lanes]
            self.kept[lanes, r] = True
        self.rep = rep.copy()

    def evaluate(self, probe: np.ndarray, pending: np.ndarray) -> np.ndarray:
        """The (B,) logL of a launch's probes: the user's likelihood on the
        pending lanes' probes, logzero on the others."""
        lanes = np.nonzero(pending)[0]
        cube = probe[lanes]
        theta, phi, ll = self.calc.host_point_batch(cube)
        logL = np.full(len(pending), self.logzero)
        logL[lanes] = ll
        self.p_cube[lanes], self.p_theta[lanes], self.p_phi[lanes] = cube, theta, phi
        HOST["probe_calls"] += len(lanes)
        HOST["rounds"] += 1
        return logL

    def babies(self, x0: torch.Tensor):
        """cube, theta and phi, ``(B, R, D)``, ``(B, R, D)`` and ``(B, R,
        n_phi)`` on ``x0``'s device, of the epoch's babies: a repeat's
        accepted probe, as the lane's position moved to it.  A repeat that
        accepted none (its lane met the epoch's budget: its record is t = 0
        and logL = logzero) holds the lane's last accepted probe, or before
        the first its seed ``x0`` with theta = phi = 0, as an invalid lane's
        rows are; the sampler drops a logzero baby unread."""
        B, R, _ = self.cube.shape
        last = np.maximum.accumulate(np.where(self.kept, np.arange(R), -1), axis=1)
        lanes, at = np.arange(B)[:, None], np.maximum(last, 0)
        some = (last >= 0)[:, :, None]
        seed = x0.detach().cpu().numpy()[:, None, :]
        cube = np.where(some, self.cube[lanes, at], seed).astype(self.cube.dtype)
        theta = np.where(some, self.theta[lanes, at], 0).astype(self.theta.dtype)
        phi = np.where(some, self.phi[lanes, at], 0).astype(self.phi.dtype)
        return tuple(torch.from_numpy(a).to(x0.device) for a in (cube, theta, phi))


def _host_rounds(keeper: ProbeKeeper, launch, read) -> None:
    """The host route's loop: the first launch, then rounds of the user's
    likelihood on the pending probes and one launch, until a launch leaves
    no lane pending.  ``launch(logL)`` runs one launch (``None``: the
    epoch's first); ``read()`` returns the probes, the pending flags and
    the repeat counters after it, as numpy arrays."""
    launch(None)
    while True:
        probe, pending, rep = read()
        keeper.note(rep)
        if not pending.any():
            return
        t0 = time.perf_counter()
        logL = keeper.evaluate(probe, pending)
        HOST["user_s"] += time.perf_counter() - t0
        launch(logL)


def slice_records_host_plain(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws,
                             lane0=0):
    """The host route in torch (the plain version of :class:`HostEpoch`):
    :func:`slice_step_plain` round by round, the user's likelihood called
    through :class:`ProbeKeeper` on the pending lanes' probes only.  Returns
    (t, logL, nlike), each (B, R), bitwise ``slice_kernel.slice_records_plain``
    on the same callback calc (the kernel consumes a logL only where a probe
    is pending), and the babies (cube, theta, phi) of
    :meth:`ProbeKeeper.babies`."""
    st = StepState(cfg, key_words, x0, bound, valid, nhats, ws, lane0)
    keeper = ProbeKeeper(calc, *nhats.shape)

    def launch(logL):
        slice_step_plain(st, None if logL is None else torch.from_numpy(logL).to(st.x.device))

    def read():
        return st.probe.cpu().numpy(), st.pending.cpu().numpy(), st.rep.cpu().numpy()

    _host_rounds(keeper, launch, read)
    return st.t_out, st.l_out, st.n_out, keeper.babies(x0)


class HostEpoch(TracedEpoch):
    """``csrc/slice_step.cu`` driven round by round for a host-callback
    calc, with no CUDA graph (a host call cannot be captured): each round
    launches once, copies the probes ``(B, D)`` and the lanes' rows
    ``S_REP``, ``S_HLANE``, ``S_PEND`` into pinned host buffers on the
    kernel's stream and waits for them on an event (one synchronisation a
    round; whether a lane is left running is read from the same copy),
    calls the user's likelihood on the pending lanes' probes
    (:class:`ProbeKeeper`), writes their logL (logzero elsewhere) into a
    pinned buffer and copies it back on the stream before the next launch.
    The buffers are :class:`TracedEpoch`'s; the double entry
    ``slice_step_launch_f64`` at precision='highest'.  Launches count under
    ``slice_step_host`` (``_f64``), the rounds and the host time of their
    parts in :data:`HOST`."""

    def __init__(self, calc, cfg: EpochConfig, B: int, R: int, D: int, device):
        super().__init__(calc, cfg, B, R, D, 1, device)
        dtype = calc_dtype(calc)
        self.probe_h = torch.empty((B, D), dtype=dtype, pin_memory=True)
        self.rows_h = torch.empty((3, B), dtype=torch.int32, pin_memory=True)
        self.logL_h = torch.empty(B, dtype=dtype, pin_memory=True)
        self.done = torch.cuda.Event()
        self.counter = "slice_step_host" + ("_f64" if dtype == torch.float64 else "")

    def __call__(self, calc, key_words, x0, bound, valid, nhats, ws, lane0=0):
        B, R, D = self.shape
        keeper = ProbeKeeper(calc, B, R, D)
        stream = torch.cuda.current_stream(self.device)

        def launch(logL):
            t0 = time.perf_counter()
            if logL is None:
                self._start(key_words, x0, bound, valid, nhats, ws, R, self.counter, lane0)
            else:
                self.logL_h.numpy()[:] = logL
                self.logL.copy_(self.logL_h, non_blocking=True)
                t1 = time.perf_counter()
                HOST["copy_in_s"] += t1 - t0
                t0 = t1
                self._launch(False)
                LAUNCHES[self.counter] += 1
            HOST["launch_s"] += time.perf_counter() - t0

        def read():
            t0 = time.perf_counter()
            self.probe_h.copy_(self.probe, non_blocking=True)
            self.rows_h.copy_(self.ist[_S_REP:_S_PEND + 1], non_blocking=True)
            self.done.record(stream)
            self.done.synchronize()
            HOST["copy_out_s"] += time.perf_counter() - t0
            rows = self.rows_h.numpy()
            return self.probe_h.numpy(), rows[_S_PEND - _S_REP] != 0, rows[0]

        _host_rounds(keeper, launch, read)
        return (*self._outputs(), keeper.babies(x0))


def slice_epoch_host(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws, lane0=0):
    """The ``"scan"`` engine's epoch for a host-callback likelihood (the
    host route, ``"slice_step_host"``): (t, logL) of the calc's dtype and
    nlike int32, each (B, R), with the inputs of :func:`slice_epoch`, and
    the babies ``(cube, theta, phi)``, the accepted probes, which
    :func:`assemble_epoch` takes as they are.  CPU tensors:
    the plain version, :func:`slice_records_host_plain`; CUDA tensors:
    ``csrc/slice_step.cu`` through a :class:`HostEpoch` kept on the calc.
    A calc without a host evaluator (a torch model) raises: it takes the
    traced route."""
    _check_traced_inputs("slice_epoch_host", calc, x0, bound, valid, nhats, ws, 1,
                         host=True)
    if x0.device.type == "cpu":
        return slice_records_host_plain(calc, cfg, key_words, x0, bound, valid, nhats, ws,
                                        lane0)
    B, R, D = nhats.shape
    runners = calc.__dict__.setdefault("host_epochs", {})
    key = (tuple(cfg), cfg.step_cap, B, R, D, str(x0.device))
    if key not in runners:
        runners[key] = HostEpoch(calc, cfg, B, R, D, x0.device)
    return runners[key](calc, key_words, x0, bound, valid, nhats, ws, lane0)
