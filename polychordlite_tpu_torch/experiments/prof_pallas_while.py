"""E7: the cost of one loop iteration on the card (counterpart of
``experiments/prof_pallas_while.py``).

The TPU kernel runs a while loop of N = 50,000 iterations over a (64, 128)
float32 tile with one of four bodies (:17-57):

    counter   acc += 1
    anycond   acc += 1, while any(acc > -1e30) over the whole tile
    prng      acc += u, u a uniform draw per element and iteration
    body20    a dependent 20-D slice-like iteration: probe = b + 0.001 acc
              over b = the input broadcast to (20, 64, 128),
              d = (probe - 0.5) 10, logL = -0.5 sum_d d^2,
              acc = logL > -40 ? acc + 1 : acc / 2

and two bodies of the port's own, which split B1's micro-step beyond
``body20``: ``body20_div`` (d = (probe - 0.5) / 0.1, an IEEE division per
coordinate, as B1's Gaussian has) and ``body20_hash`` (acc += u first, u
the ``prng`` body's uniform of the iteration, as B1 draws one per
micro-step).

:func:`while_loop` is the wrapper of the hand-written CUDA kernel of
``csrc/probes.cu``, one thread per tile element.  The tile-wide ``any``
spans 8,192 threads and so every block: ``anycond`` is a cooperative kernel
with a grid barrier per iteration.  ``anycond_warp`` (``__any_sync``) and
``anycond_cta`` (``__syncthreads_or``) take the same condition over a warp
and over a block instead, and the loop runs on in each warp or block while
its own condition holds — the granularities a loop condition can need.
``prng`` draws u from the port's murmur3 counter hash keyed on (7, lane,
iteration) (``ops/pallas_slice.py``) instead of the TPU's hardware stream
seeded with 7: a seed change.  For CPU tensors it runs
:func:`while_loop_plain`; for CUDA tensors it launches the kernel or
raises.  :func:`main` times every body (µs per iteration) and, from the
same call, B1's time per micro-step (B1 ms / E1's largest lane step count)
at the bench geometry, beside ``body20``.

    python -m polychordlite_tpu_torch.experiments.prof_pallas_while [--device cpu] [--n 50000] ...
"""

from __future__ import annotations

import ctypes
import json
import math

import torch

from ..ops.pallas_slice import _fmix, _mix, uniform_from_hash
from ..ops.pallas_slice_v4 import WARP, slice_epoch, slice_epoch_counted
from ..utils import nvcc
from .bench_geometry import (
    BENCH,
    argument_parser,
    device_label,
    device_ms,
    slice_inputs,
    study_device,
)

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"while_loop": 0}

LIBRARY = ("probes", ["probes.cu"])
LANE = 128  # a block of the kernel: one row of the tile
#: the bodies, in the entry point's numbering
VARIANTS = ("counter", "anycond", "anycond_warp", "anycond_cta", "prng", "body20", "body20_div",
            "body20_hash")
SIZES = dict(S=64, n=50_000)  # prof_pallas_while.py:10, :86
BODY20_D = 20


def prng_uniforms(shape, device):
    """The ``prng`` body's draws: iteration i -> u (shape) float32, the top
    24 bits of fmix(mix(mix(7, lane), i)) times 2**-24, lanes in row-major
    order."""
    size = math.prod(shape)
    h = _mix(torch.full((size,), 7, dtype=torch.int64, device=device),
             torch.arange(size, device=device))
    return lambda i: uniform_from_hash(_fmix(_mix(h, i))).to(torch.float32).view(shape)


def while_loop_plain(variant: str, x: torch.Tensor, n: int, uniform=None):
    """The tile after ``n`` iterations of ``variant``'s body from x (S, 128)
    float32, in the kernel's float order.  ``uniform`` (iteration -> draws)
    replaces the murmur3 stream of ``prng`` and ``body20_hash``."""
    acc = x.to(torch.float32).clone()
    if variant == "counter":
        for _ in range(n):
            acc = acc + 1.0
    elif variant.startswith("anycond"):
        group = {"anycond": acc.numel(), "anycond_warp": WARP, "anycond_cta": LANE}[variant]
        alive = torch.ones(acc.numel() // group, dtype=torch.bool, device=acc.device)
        for i in range(n + 1):  # the condition is evaluated n + 1 times
            alive = alive & (acc > -1e30).view(-1, group).any(dim=1)
            if i == n or not bool(alive.any()):
                break
            acc = torch.where(alive.repeat_interleave(group).view(acc.shape), acc + 1.0, acc)
    elif variant == "prng":
        draw = prng_uniforms(acc.shape, acc.device) if uniform is None else uniform
        for i in range(n):
            acc = acc + draw(i)
    elif variant.startswith("body20"):
        c = torch.tensor(0.001, dtype=torch.float32, device=acc.device)
        tenth = acc.new_full((1,), 0.1)  # a tensor: a true division, not a reciprocal
        b = x.to(torch.float32).expand(BODY20_D, *x.shape)  # :44
        hashed = variant == "body20_hash"
        draw = prng_uniforms(acc.shape, acc.device) if hashed and uniform is None else uniform
        for i in range(n):
            if hashed:
                acc = acc + draw(i)
            x_d = (b + c * acc) - 0.5
            dd = x_d / tenth if variant == "body20_div" else x_d * 10.0
            sq = dd * dd
            total = sq[0]
            for d in range(1, BODY20_D):  # the sum in index order
                total = total + sq[d]
            acc = torch.where(total * -0.5 > -40.0, acc + 1.0, acc * 0.5)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return acc


def while_loop(variant: str, x: torch.Tensor, n: int):
    """The loop kernel of ``variant`` (see :data:`VARIANTS`): the tile after
    ``n`` iterations, (S, 128) float32.  CPU tensors: the plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.device.type == "cpu":
        return while_loop_plain(variant, x, n)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] != LANE or x.dtype != torch.float32:
        raise ValueError("x must be an (S, 128) float32 tensor")
    dev = x.device
    x = x.contiguous()
    b20 = x.expand(BODY20_D, *x.shape).contiguous() if variant.startswith("body20") else None
    out = torch.empty_like(x)
    flags = torch.zeros(3, dtype=torch.int32, device=dev)
    fn = nvcc.load(*LIBRARY).while_loop_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(VARIANTS.index(variant), x.data_ptr(),
                    None if b20 is None else b20.data_ptr(), out.data_ptr(),
                    flags.data_ptr(), int(n), x.numel(),
                    torch.cuda.current_stream(dev).cuda_stream)
    nvcc.check(status, f"while_loop_launch({variant})")
    LAUNCHES["while_loop"] += 1
    return out


def main(device=None, S=SIZES["S"], n=SIZES["n"], reps=3, B=BENCH["B"], R=BENCH["R"],
         D=BENCH["D"], seed=0):
    dev = study_device(device)
    x = torch.zeros((S, LANE), dtype=torch.float32, device=dev)  # :64
    rec = {"study": "while_cost", "device": device_label(dev), "S": S, "n": n, "variants": {}}
    for v in VARIANTS:
        ms = device_ms(lambda: while_loop(v, x, n), reps, dev)  # noqa: B023
        rec["variants"][v] = {"ms": ms, "us_per_iter": None if ms is None else ms * 1e3 / n}
    # B1's time per micro-step from this call: its epoch time over the
    # largest number of micro-steps a lane took (E1's count)
    calc, cfg, kw, args = slice_inputs(dev, B, R, D, seed)
    steps = slice_epoch_counted(calc, cfg, kw, *args)[3]
    b1_ms = device_ms(lambda: slice_epoch(calc, cfg, kw, *args), reps, dev)
    lane_max = int(steps.max())
    rec["b1"] = {"B": B, "R": R, "D": D, "ms": b1_ms, "lane_steps_max": lane_max,
                 "us_per_micro_step": None if b1_ms is None else b1_ms * 1e3 / lane_max}
    b20 = rec["variants"]["body20"]["us_per_iter"]
    rec["b1_micro_step_over_body20_iter"] = (
        None if b1_ms is None else rec["b1"]["us_per_micro_step"] / b20)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(**vars(argument_parser(__doc__, reps=3, **SIZES, **BENCH, seed=0).parse_args()))
