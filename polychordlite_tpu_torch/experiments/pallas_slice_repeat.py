"""E5: one slice repeat per launch on blocks of 8 x 128 chains (counterpart
of ``experiments/pallas_slice_repeat.py``).

The TPU prototype runs grid=(nb,) blocks of (D, 8, 128).  Each block runs
one repeat as a while loop over its 1,024 lanes: every lane not yet DONE
takes one micro-step per iteration, until every lane is DONE or the loop
has run max_inner = 504 iterations.  A uniform u0 drawn before the loop
places each bracket, and every iteration draws again (:48-56).  The
likelihood is E4's (``pallas_epoch_v2.py``); its clip (:28) changes
nothing on the lanes that pass the [0, 1] test.

:func:`proto_repeat` is the wrapper of the hand-written CUDA kernel of
``csrc/prototypes.cu``: one thread per chain, running freely.  It draws
from the murmur3 counter hash keyed on (seed + 7919 block, lane in block,
draw), with draw 0 for u0 and draw i + 1 for iteration i, instead of the
TPU's hardware stream seeded with seed + 7919 block — a seed change — so
the block-wide loop changes no decision.  :func:`proto_repeat_plain` runs
one such loop over all blocks at once: a block whose lanes are all DONE
idles in it, which changes nothing either.  For CPU tensors the wrapper runs
the plain version; for CUDA tensors it launches the kernel or raises.
:func:`main` runs the script's study (:149-183): one repeat, then R = 100
repeats back to back, each a launch with the same n̂ and w and the seed
+ r, the cube of one the x0 of the next (the JAX study's scan makes 100
calls), as evals/s, and the in-bound fraction of the last repeat.

    python -m polychordlite_tpu_torch.experiments.pallas_slice_repeat [--device cpu] [--D 20] [--nb 2] [--R 100]
"""

from __future__ import annotations

import ctypes
import json
import time

import torch

from ..ops.pallas_slice import MASK, _mix
from ..utils import nvcc
from .bench_geometry import argument_parser, device_label, device_once, study_device
from .pallas_epoch_v2 import (
    LANE,
    LIBRARY,
    LOGZERO,
    SIGMA,
    ball_bound,
    check_inputs,
    device_seed,
    hash_draws,
    lockstep_repeat,
    norm,
    rate,
    seed_word,
)

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"proto_repeat": 0}

SUB = 8
BLOCK = SUB * LANE  # 1,024 chains per block
SIZES = dict(D=20, nb=2, R=100)  # pallas_slice_repeat.py:13, :150, :166


def repeat_uniforms(seed: int, rows: int, device):
    """draw k -> (rows, 128) float32: E5's uniforms, the top 24 bits of
    fmix(mix(mix(seed + 7919 block, lane in block), k)) times 2**-24 with
    chains in row-major order and 1,024 to a block; k = 0 is u0 and k = i
    + 1 the draw of iteration i."""
    g = torch.arange(rows * LANE, device=device)
    h = _mix((seed + 7919 * (g // BLOCK)) & MASK, g % BLOCK)
    return lambda k: hash_draws(h)(k).view(rows, LANE)


def proto_repeat_plain(seed, x0, nhat, w, bound, uniform=None, count_steps=False):
    """E5's repeat in plain torch: ``seed`` int32[1], ``x0``, ``nhat`` (D,
    8 nb, 128), ``w``, ``bound`` (8 nb, 128) -> cube (D, 8 nb, 128), logL
    (8 nb, 128) float32 and nlike (8 nb, 128) int32.  ``uniform(k)`` ->
    (8 nb, 128) replaces the murmur3 draw k (0: u0; i + 1: iteration i);
    ``count_steps`` adds the micro-steps of every lane, int32."""
    D, rows, L = x0.shape
    if rows % SUB or L != LANE:
        raise ValueError("proto_repeat: x0 must be (D, 8 nb, 128)")
    B, f32 = rows * L, torch.float32
    draws = repeat_uniforms(seed_word(seed), rows, x0.device) if uniform is None else uniform
    cube, logL, nlike, steps = lockstep_repeat(
        x0.to(f32).reshape(D, B).t(), nhat.to(f32).reshape(D, B).t(), w.to(f32).reshape(B),
        bound.to(f32).reshape(B), lambda it: draws(0 if it == 0 else it + 1).reshape(B))
    out = (cube.t().reshape(D, rows, L), logL.view(rows, L),
           nlike.to(torch.int32).view(rows, L))
    return out + (steps.to(torch.int32).view(rows, L),) if count_steps else out


def proto_repeat(seed, x0, nhat, w, bound):
    """E5's repeat, the inputs and outputs of :func:`proto_repeat_plain`.
    CPU tensors: the plain version; CUDA tensors: the kernel."""
    if x0.device.type == "cpu":
        return proto_repeat_plain(seed, x0, nhat, w, bound)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    D, rows, L = x0.shape
    dev, f32 = x0.device, torch.float32
    if rows % SUB or L != LANE or nhat.shape != x0.shape or w.shape != (rows, L) \
            or bound.shape != (rows, L):
        raise ValueError("proto_repeat: x0, nhat (D, 8 nb, 128), w and bound (8 nb, 128) "
                         "expected")
    check_inputs("proto_repeat", dev, nhat=nhat, w=w, bound=bound)
    x0, nhat, w, bound = (a.to(f32).contiguous() for a in (x0, nhat, w, bound))
    cube = torch.empty((D, rows, L), dtype=f32, device=dev)
    logL = torch.empty((rows, L), dtype=f32, device=dev)
    nlike = torch.empty((rows, L), dtype=torch.int32, device=dev)
    fn = nvcc.load(*LIBRARY).proto_repeat_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(device_seed(seed, dev).data_ptr(), x0.data_ptr(), nhat.data_ptr(),
                    w.data_ptr(), bound.data_ptr(), cube.data_ptr(), logL.data_ptr(),
                    nlike.data_ptr(), rows * L, D, SIGMA, norm(D), LOGZERO,
                    torch.cuda.current_stream(dev).cuda_stream)
    nvcc.check(status, "proto_repeat_launch")
    LAUNCHES["proto_repeat"] += 1
    return cube, logL, nlike


def study_inputs(device, D: int, nb: int, seed: int = 0):
    """(x0, nhat, w, bound) of the script's study (:152-158): seeds 0.5 +
    0.02 N(0, 1), directions N(0, 1) normalised over the coordinates, w =
    3 sigma, the ball contour — from a seeded torch generator on the device
    (another seed than the JAX study's)."""
    gen = torch.Generator(device).manual_seed(seed)
    shape = (D, SUB * nb, LANE)
    x0 = 0.5 + 0.02 * torch.randn(shape, generator=gen, device=device)
    nh = torch.randn(shape, generator=gen, device=device)
    nh = nh / torch.linalg.norm(nh, dim=0, keepdim=True)
    w = torch.full(shape[1:], 3 * SIGMA, device=device)
    bound = torch.full(shape[1:], ball_bound(D), device=device)
    return x0, nh, w, bound


def chain(seed, x0, nhat, w, bound, R: int):
    """R repeats back to back (:167-174): repeat r a launch with the seed
    + r whose cube is the x0 of the next.  Returns (the last cube, the
    likelihood calls summed on the device, the last logL)."""
    xs, total = x0, torch.zeros((), dtype=torch.int64, device=x0.device)
    logL = None
    for r in range(R):
        xs, logL, nlike = proto_repeat(seed + r, xs, nhat, w, bound)
        total = total + nlike.sum()
    return xs, total, logL


def main(device=None, D=SIZES["D"], nb=SIZES["nb"], R=SIZES["R"], seed=0):
    dev = study_device(device)
    x0, nh, w, bound = study_inputs(dev, D, nb, seed)
    seed0 = torch.tensor([1234], dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    first_evals = int(proto_repeat(seed0, x0, nh, w, bound)[2].sum())  # waits for it
    first_ms = (time.perf_counter() - t0) * 1e3 if dev.type == "cuda" else None
    (_, _, nlike), single_ms = device_once(lambda: proto_repeat(seed0, x0, nh, w, bound), dev)
    single_evals = int(nlike.sum())
    chain(seed0, x0, nh, w, bound, R)  # the first chain, as the JAX study's compile run
    (_, total, logL), chain_ms = device_once(lambda: chain(seed0 + 1, x0, nh, w, bound, R), dev)
    chain_evals = int(total)
    rec = {
        "study": "proto_repeat", "device": device_label(dev), "D": D, "nb": nb,
        "B": nb * BLOCK,
        "first_call": {"ms": first_ms, "evals": first_evals,
                       "note": "host clock, the library's load (and build) included"},
        "single": {"ms": single_ms, "evals": single_evals,
                   "evals_per_s": rate(single_evals, single_ms)},
        "chain": {"R": R, "launches": R, "ms": chain_ms, "evals": chain_evals,
                  "evals_per_s": rate(chain_evals, chain_ms)},
        "in_bound_frac": float((logL >= bound - 1e-4).float().mean()),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(**vars(argument_parser(__doc__, **SIZES, seed=0).parse_args()))
