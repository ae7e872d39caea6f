"""The slice-epoch kernel and the epoch built around it
(counterpart of ``polychordlite_tpu/ops/pallas_slice_v4.py``).

:func:`slice_epoch` is the wrapper of the hand-written CUDA kernel
``csrc/slice_epoch.cu`` (one thread per chain; see the source for its
design).  For CPU tensors it runs the kernel's plain version,
``slice_kernel.slice_records_plain``; for CUDA tensors it launches the
kernel or raises.  The kernel evaluates the likelihood itself through a
device functor selected by ``calc.device_spec`` (``ops/evaluate.py``);
:func:`validate_functor` checks that functor against the torch calc,
bitwise, before a run uses it.

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

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"slice_epoch": 0}

_FUNCTORS = ("gaussian",)


def _lib():
    lib = nvcc.load("slice_epoch", ["slice_epoch.cu"])
    if not getattr(lib, "_typed", False):
        vp, ci, cu, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.slice_epoch_gaussian.argtypes = (
            [vp] * 8 + [ci, ci, ci, cu, cu, ci, ci, ctypes.c_longlong]
            + [cf] * 6 + [vp]
        )
        lib.slice_epoch_gaussian.restype = ci
        lib.slice_epoch_max_dim.argtypes = []
        lib.slice_epoch_max_dim.restype = ci
        lib._typed = True
    return lib


def _f32(x: float) -> float:
    return float(np.float32(x))


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
    spec = getattr(calc, "device_spec", None)
    if spec is None or spec["likelihood"]["name"] not in _FUNCTORS:
        raise ValueError(
            "the CUDA slice kernel needs a prior and likelihood with a device "
            "form (ops/evaluate.py); use engine='torch' for this model"
        )
    B, R, D = nhats.shape
    lib = _lib()
    if D > lib.slice_epoch_max_dim():
        raise ValueError(f"D={D} exceeds the kernel's maximum {lib.slice_epoch_max_dim()}")
    if x0.shape != (B, D) or bound.shape != (B,) or valid.shape != (B,) or ws.shape != (B, R):
        raise ValueError("slice_epoch: inconsistent shapes")
    dev = x0.device
    for name, a in (("bound", bound), ("valid", valid), ("nhats", nhats), ("ws", ws)):
        if a.device != dev:
            raise ValueError(f"slice_epoch: {name} is on {a.device}, x0 on {dev}")
    f32 = torch.float32
    x0t = x0.to(f32).t().contiguous()
    nhat_t = nhats.to(f32).permute(1, 2, 0).contiguous()
    w_t = ws.to(f32).t().contiguous()
    bound_f = bound.to(f32).contiguous()
    valid_f = valid.to(f32).contiguous()
    t_out = torch.empty((R, B), dtype=f32, device=dev)
    l_out = torch.empty((R, B), dtype=f32, device=dev)
    n_out = torch.empty((R, B), dtype=torch.int32, device=dev)
    a, b = spec["prior"]
    like = spec["likelihood"]
    k0, k1 = key_words
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = lib.slice_epoch_gaussian(
            x0t.data_ptr(), bound_f.data_ptr(), valid_f.data_ptr(),
            nhat_t.data_ptr(), w_t.data_ptr(), t_out.data_ptr(),
            l_out.data_ptr(), n_out.data_ptr(), B, D, R,
            int(k0), int(k1), cfg.max_step, cfg.max_shrink,
            cfg.step_cap, _f32(a), _f32(b - a), _f32(like["mu"]),
            _f32(like["sigma"]), _f32(like["norm"]), _f32(cfg.logzero), stream,
        )
    nvcc.check(status, "slice_epoch_gaussian")
    LAUNCHES["slice_epoch"] += 1
    return t_out.t(), l_out.t(), n_out.t()


def validate_functor(calc, cfg: EpochConfig, device) -> None:
    """Check the kernel's likelihood functor against the torch calc on 1280
    cubes, some outside the walls; raise on any difference.

    The kernel is run with zero directions and zero widths, so every probe
    is the seed itself, and with an unbounded contour: the lane steps out
    and shrinks on the spot and accepts its seed with the functor's logL
    (a seed outside the walls is a forced logzero accept)."""
    D = cfg.n_dims
    rng = np.random.default_rng(20240131)
    pts = np.concatenate([
        rng.uniform(-0.05, 1.05, (1024, D)),
        np.clip(rng.normal(0.5, 0.1, (256, D)), -0.2, 1.2),
    ]).astype(np.float32)
    x0 = torch.as_tensor(pts, device=device)
    B = x0.shape[0]
    one = cfg._replace(num_repeats=(1,), grade_dims=(D,))
    _, got, _ = slice_epoch(
        calc, one, (0, 0), x0,
        torch.full((B,), -torch.finfo(torch.float32).max, device=device),
        torch.ones(B, dtype=torch.bool, device=device),
        torch.zeros((B, 1, D), device=device), torch.zeros((B, 1), device=device),
    )
    _, _, want = calc(x0)
    if not torch.equal(got[:, 0], want.to(torch.float32)):
        diff = (got[:, 0].double() - want.double()).abs().max().item()
        raise RuntimeError(
            f"the CUDA likelihood functor disagrees with the torch calc "
            f"(max |dlogL| = {diff:.3g}); not running the kernel"
        )


def assemble_epoch(calc, cfg: EpochConfig, seed, valid, nhats, speeds, t_acc, logL, nlike_rep):
    """Packed epoch record from the per-(lane, repeat) kernel outputs."""
    B, R, D = nhats.shape
    n_grades = len(cfg.grade_dims)
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
