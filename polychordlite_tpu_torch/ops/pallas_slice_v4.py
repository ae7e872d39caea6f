"""The slice-epoch kernel and the epoch built around it
(counterpart of ``polychordlite_tpu/ops/pallas_slice_v4.py``).

:func:`slice_epoch` is the wrapper of the hand-written CUDA kernel
``csrc/slice_epoch.cu`` (one thread per chain; see the source for its
design).  For CPU tensors it runs the kernel's plain version,
``slice_kernel.slice_records_plain``; for CUDA tensors it launches the
kernel or raises.  The kernel evaluates the likelihood itself through a
device functor of ``csrc/likelihoods.cuh`` (:data:`FUNCTORS`), selected by
``calc.device_spec`` (``ops/evaluate.py``); :func:`validate_functor` checks
that functor against the torch calc, bitwise, through the engine that will
run it, before a run uses it.  :func:`launch_slice_kernel` is shared with
the kernels of ``ops/pallas_slice_v5.py``, ``ops/pallas_slice_v3.py`` and
``ops/pallas_slice.py``.

:func:`slice_epoch_counted` is the wrapper of the same kernel's counted
instantiation (``experiments/v4_instr.py`` at the repository root): B1's
outputs bit for bit, plus the micro-steps each lane executed and the
largest of each warp of 32 lanes, from which :func:`lane_efficiency`
follows.  No run calls it.

Outside the kernel, as in the JAX package (``pallas_slice_v4.py:524-559``):
the baby positions are rebuilt as ``seed + cumsum(t n̂)``, theta and phi
come from one batched evaluation of the calc, and everything is packed into
the epoch record (:func:`assemble_epoch`); ``slice_kernel.build_epoch_fn``
puts the pieces together.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import nvcc
from .slice_kernel import EpochConfig, slice_records_plain

#: the kernels' bound on the dimension (SLICE_MAXD of ``csrc/slice_common.cuh``)
SLICE_MAXD = 32

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"slice_epoch": 0, "slice_epoch_counted": 0}

WARP = 32  # lanes of a warp: the kernels run one warp per block

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
    # the D x D matrix last: the entry copies it to constant memory
    "random_gaussian": (10, ("mu", "norm", "invcov")),
}

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
)


def _lib():
    return nvcc.load("slice_epoch", ["slice_epoch.cu"])


def _f32(x: float) -> float:
    return float(np.float32(x))


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
    if name == "random_gaussian" and consts.size != 2 + D * D:
        raise ValueError(f"random_gaussian's matrix is not {D} x {D}")
    prior_a, prior_s = (np.ascontiguousarray(v, dtype=np.float32) for v in spec["prior"])
    if prior_a.shape != (D,) or prior_s.shape != (D,):
        raise ValueError(f"the prior's affine form is not per coordinate of D={D}")
    return fid, consts, prior_a, prior_s


def launch_slice_kernel(lib, entry: str, calc, cfg: EpochConfig, key_words,
                        x0, bound, valid, nhats, ws, cap=None, extra=()):
    """Check the inputs of a slice-epoch kernel, launch it on the current
    stream and return (t, logL, nlike), each (B, R).  The model must have a
    device form (``calc.device_spec``) whose functor is in
    :data:`FUNCTORS`.  ``cap`` is the kernel's micro-step budget
    (``cfg.step_cap`` by default); ``extra`` are further output tensors on
    the device, passed after the stream in that order."""
    B, R, D = nhats.shape
    if D > SLICE_MAXD:
        raise ValueError(f"D={D} exceeds the kernels' maximum {SLICE_MAXD}")
    fid, consts, prior_a, prior_s = functor_args(calc, D)
    if x0.shape != (B, D) or bound.shape != (B,) or valid.shape != (B,) or ws.shape != (B, R):
        raise ValueError(f"{entry}: inconsistent shapes")
    dev = x0.device
    for name, a in (("bound", bound), ("valid", valid), ("nhats", nhats), ("ws", ws)):
        if a.device != dev:
            raise ValueError(f"{entry}: {name} is on {a.device}, x0 on {dev}")
    f32 = torch.float32
    x0t = x0.to(f32).t().contiguous()
    nhat_t = nhats.to(f32).permute(1, 2, 0).contiguous()
    w_t = ws.to(f32).t().contiguous()
    bound_f = bound.to(f32).contiguous()
    valid_f = valid.to(f32).contiguous()
    t_out = torch.empty((R, B), dtype=f32, device=dev)
    l_out = torch.empty((R, B), dtype=f32, device=dev)
    n_out = torch.empty((R, B), dtype=torch.int32, device=dev)
    for a in extra:
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{entry}: an extra output is not contiguous on {dev}")
    k0, k1 = key_words
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = getattr(lib, entry)
    fn.argtypes = _ARGTYPES + [ctypes.c_void_p] * len(extra)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(
            fid, consts.ctypes.data, prior_a.ctypes.data, prior_s.ctypes.data,
            x0t.data_ptr(), bound_f.data_ptr(), valid_f.data_ptr(),
            nhat_t.data_ptr(), w_t.data_ptr(), t_out.data_ptr(),
            l_out.data_ptr(), n_out.data_ptr(), B, D, R,
            int(k0), int(k1), cfg.max_step, cfg.max_shrink,
            cfg.step_cap if cap is None else int(cap), _f32(cfg.logzero), stream,
            *(a.data_ptr() for a in extra),
        )
    nvcc.check(status, entry)
    return t_out.t(), l_out.t(), n_out.t()


def slice_epoch(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws):
    """Run the slice repeats of every lane: (t, logL) float32 and nlike
    int32, each (B, R).  ``x0 (B,D)``, ``bound (B,)``, ``valid (B,)`` bool,
    ``nhats (B,R,D)``, ``ws (B,R)``.  CPU tensors: the plain version; CUDA
    tensors: the kernel, which needs ``calc.device_spec``."""
    if x0.device.type == "cpu":
        return slice_records_plain(
            lambda p: calc(p)[2], cfg, key_words, x0, bound, valid, nhats, ws
        )
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    out = launch_slice_kernel(_lib(), "slice_epoch_launch", calc, cfg, key_words,
                              x0, bound, valid, nhats, ws)
    LAUNCHES["slice_epoch"] += 1
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


def validate_functor(calc, cfg: EpochConfig, device, records=None) -> None:
    """Check the kernel's likelihood functor against the torch calc on 1280
    cubes, some outside the walls; raise on any difference.

    ``records`` is the wrapper of the engine that will run the functor
    (:func:`slice_epoch` by default; see ``slice_kernel.kernel_wrapper``);
    its second output is the logL.  The kernel is run with zero directions and zero widths,
    so every probe is the seed itself, and with an unbounded contour: the
    lane steps out and shrinks on the spot and accepts its seed with the
    functor's logL (a seed outside the walls is a forced logzero accept)."""
    records = slice_epoch if records is None else records
    D = cfg.n_dims
    rng = np.random.default_rng(20240131)
    pts = np.concatenate([
        rng.uniform(-0.05, 1.05, (1024, D)),
        np.clip(rng.normal(0.5, 0.1, (256, D)), -0.2, 1.2),
    ]).astype(np.float32)
    x0 = torch.as_tensor(pts, device=device)
    B = x0.shape[0]
    # one repeat on the plain configuration (a subclass's budget dropped)
    one = EpochConfig(*cfg)._replace(num_repeats=(1,), grade_dims=(D,))
    got = records(
        calc, one, (0, 0), x0,
        torch.full((B,), -torch.finfo(torch.float32).max, device=device),
        torch.ones(B, dtype=torch.bool, device=device),
        torch.zeros((B, 1, D), device=device), torch.zeros((B, 1), device=device),
    )[1]
    _, _, want = calc(x0)
    if not torch.equal(got[:, 0], want.to(torch.float32)):
        diff = (got[:, 0].double() - want.double()).abs().max().item()
        raise RuntimeError(
            f"the CUDA likelihood functor disagrees with the torch calc "
            f"(max |dlogL| = {diff:.3g}); not running the kernel"
        )


def assemble_epoch(calc, cfg: EpochConfig, seed, valid, nhats, speeds, t_acc, logL, nlike_rep,
                   cube=None):
    """Packed epoch record from the per-(lane, repeat) kernel outputs.  The
    baby positions are ``cube (B, R, D)`` where the engine wrote them (v2),
    else rebuilt as ``seed + cumsum(t n̂)``."""
    B, R, D = nhats.shape
    n_grades = len(cfg.grade_dims)
    if cube is None:
        cube = seed[:, None, :] + torch.cumsum(t_acc[:, :, None] * nhats, dim=1)
    theta, phi, _ = calc(cube.reshape(B * R, D))
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
        nlike_g.to(torch.float32),
        torch.zeros((B, 1), dtype=torch.float32, device=seed.device),  # overflow flag (never set)
    ], dim=1)
