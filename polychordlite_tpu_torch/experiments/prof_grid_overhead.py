"""E6: the skeleton of a sequential grid step on the card (counterpart of
``experiments/prof_grid_overhead.py``).

The TPU kernel is a grid=(R,) step over (R, D, S, 128) float32 that writes
``out[r] = stream[r, 0] * 1.0``, with v3's structural pieces added one at a
time:

    A  the streamed (1, D, S, 128) block of step r, copied out
    B  A, and a while loop of one iteration (+ 1.0)
    C  B, and a constant-index head input (3, D, S, 128) (+ head[0, 0])
    D  C, and v3's whole scratch set, zeroed at r = 0, its ring accumulated
    E  D, and a constant-index x0 input (D, S, 128) (+ x0[0])
    F  B with "parallel" steps

:func:`grid_steps` is the wrapper of the hand-written CUDA kernels of
``csrc/probes.cu``: A-E one cooperative kernel, the steps in order with a
grid barrier between them, each staging its block into shared memory; F
one launch of R x S independent blocks; and ``"B1"``, variant B as one
launch per step.  For CPU tensors it runs :func:`grid_steps_plain`, the
function the kernel computes; for CUDA tensors it launches the kernel or
raises.  :func:`main` times every variant (µs per step).

    python -m polychordlite_tpu_torch.experiments.prof_grid_overhead [--device cpu] [--R 100] ...
"""

from __future__ import annotations

import ctypes
import json

import torch

from ..utils import nvcc
from .bench_geometry import argument_parser, device_label, device_ms, study_device

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"grid_steps": 0}

LIBRARY = ("probes", ["probes.cu"])
LANE = 128
#: the variants, in the entry point's numbering; "B1" is B, one launch per step
VARIANTS = ("A", "B", "C", "D", "E", "F", "B1")
SIZES = dict(R=100, D=20, S=64)  # prof_grid_overhead.py:23


def grid_steps_plain(variant: str, stream, head=None, x0=None):
    """out (R, S, 128) of ``variant`` from stream (R, D, S, 128), head
    (3, D, S, 128) for C-E and x0 (D, S, 128) for E, in the kernel's float
    order: ((stream[r, 0] * 1 + head[0, 0]) + x0[0]) + 1."""
    val = stream[:, 0] * 1.0
    if variant in ("C", "D", "E"):
        val = val + head[0, 0]
    if variant == "E":
        val = val + x0[0]
    if variant != "A":
        val = val + 1.0
    return val


def grid_steps(variant: str, stream, head=None, x0=None):
    """The grid-step kernel of ``variant`` (see :data:`VARIANTS`): out
    (R, S, 128) float32.  CPU tensors: the plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if stream.device.type == "cpu":
        return grid_steps_plain(variant, stream, head, x0)
    if stream.device.type != "cuda":
        raise ValueError(f"unsupported device {stream.device}")
    R, D, S, lane = stream.shape
    dev = stream.device
    if lane != LANE or stream.dtype != torch.float32 or not stream.is_contiguous():
        raise ValueError("stream must be a contiguous (R, D, S, 128) float32 tensor")
    need_head, need_x0 = variant in ("C", "D", "E"), variant == "E"
    for name, a, shape, needed in (("head", head, (3, D, S, LANE), need_head),
                                   ("x0", x0, (D, S, LANE), need_x0)):
        if needed and (a is None or a.shape != shape or a.dtype != torch.float32
                       or a.device != dev or not a.is_contiguous()):
            raise ValueError(f"variant {variant} needs {name} as a contiguous {shape} "
                             f"float32 tensor on {dev}")
    out = torch.empty((R, S, LANE), dtype=torch.float32, device=dev)
    ring = rest = None
    if variant in ("D", "E"):  # v3's scratch set (prof_grid_overhead.py:84-88)
        ring = torch.empty((4, D, S, LANE), dtype=torch.float32, device=dev)
        rest = torch.empty((2 * D + 12, S, LANE), dtype=torch.float32, device=dev)
    fn = nvcc.load(*LIBRARY).grid_steps_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def ptr(a):
        return None if a is None else a.data_ptr()

    with torch.cuda.device(dev):
        status = fn(VARIANTS.index(variant), stream.data_ptr(),
                    ptr(head if need_head else None), ptr(x0 if need_x0 else None),
                    out.data_ptr(), ptr(ring), ptr(rest), R, D, S,
                    torch.cuda.current_stream(dev).cuda_stream)
    nvcc.check(status, f"grid_steps_launch({variant})")
    LAUNCHES["grid_steps"] += R if variant == "B1" else 1
    return out


def grid_inputs(device, R: int, D: int, S: int, ones: bool = True, seed: int = 0):
    """(stream, head, x0): ones, as the JAX study feeds them, or normal
    draws from a seeded generator."""
    shapes = ((R, D, S, LANE), (3, D, S, LANE), (D, S, LANE))
    if ones:
        return tuple(torch.ones(s, device=device) for s in shapes)
    gen = torch.Generator(device).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=device) for s in shapes)


def main(device=None, R=SIZES["R"], D=SIZES["D"], S=SIZES["S"], reps=5):
    dev = study_device(device)
    stream, head, x0 = grid_inputs(dev, R, D, S)
    rec = {"study": "grid_overhead", "device": device_label(dev), "R": R, "D": D, "S": S,
           "variants": {}}
    for v in VARIANTS:
        ms = device_ms(lambda: grid_steps(v, stream, head, x0), reps, dev)  # noqa: B023
        rec["variants"][v] = {"ms": ms, "us_per_step": None if ms is None else ms * 1e3 / R}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(**vars(argument_parser(__doc__, reps=5, **SIZES).parse_args()))
