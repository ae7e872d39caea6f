"""E4: the whole slice epoch in one launch (counterpart of
``experiments/pallas_epoch_v2.py``).

The TPU prototype runs grid=(R,) steps over one (S, 128) tile that holds
every chain (B = 128 S).  Step r runs repeat r as a while loop over the
whole tile: every lane not yet DONE takes one micro-step per iteration,
until every lane is DONE or the loop has run max_inner = 504 iterations.
The accepted probe x0 + t n̂ is the repeat's output and, kept in VMEM
scratch, the next repeat's x0; a lane that no repeat accepts keeps its
position.  The likelihood is the normalised Gaussian (mu 0.5, sigma 0.1)
on the cube itself, logzero outside [0, 1] (:32-36).

:func:`proto_epoch` is the wrapper of the hand-written CUDA kernel of
``csrc/prototypes.cu``: one thread per chain, each running its R repeats
freely.  It draws u from the murmur3 counter hash keyed on (seed + r, lane,
iteration) (``ops/pallas_slice.py``) instead of the TPU's hardware stream
seeded with seed + r — a seed change — so the tile-wide loop changes no
decision; :func:`proto_epoch_plain` keeps that loop.  For CPU tensors the
wrapper runs the plain version; for CUDA tensors it launches the kernel or
raises.  :func:`main` runs the script's study (:173-208): the first call,
the best of 3 (seeds 0, 1, 2), the in-bound and accepted fractions, and
whether every chain moves in every repeat (and how many (repeat, lane)
pairs do not).

    python -m polychordlite_tpu_torch.experiments.pallas_epoch_v2 [--device cpu] [--D 20] [--S 64] [--R 100]
"""

from __future__ import annotations

import ctypes
import json
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..ops.pallas_slice import (
    MASK,
    PH_DONE,
    PH_INIT_R,
    LaneMachine,
    _fmix,
    _mix,
    uniform_from_hash,
)
from ..utils import nvcc
from .bench_geometry import argument_parser, device_label, device_once, study_device

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"proto_epoch": 0}

LIBRARY = ("prototypes", ["prototypes.cu"])
LANE = 128
SIZES = dict(D=20, S=64, R=100)  # pallas_epoch_v2.py:17-20
SIGMA = 0.1
CAPS = SimpleNamespace(max_step=200, max_shrink=100)  # :21-22
MAX_INNER = 2 * CAPS.max_step + CAPS.max_shrink + 4
LOGZERO = float(np.float32(-1e30))  # the float32 value every comparison sees


def norm(D: int) -> float:
    """The Gaussian's normalisation, -D (log sigma + log sqrt(2 pi)) (:27)."""
    return -D * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))


def ball_bound(D: int) -> float:
    """The studies' contour: logL on the ball of radius 1.5 sigma sqrt(D)."""
    r0 = SIGMA * math.sqrt(D) * 1.5
    return norm(D) - 0.5 * (r0 / SIGMA) ** 2


def loglike(cube: torch.Tensor) -> torch.Tensor:
    """The prototypes' likelihood of (B, D) cubes in the kernel's float
    order: ((cube - 0.5) / sigma)^2 summed over coordinates in index order,
    logzero outside the unit cube."""
    D = cube.shape[1]
    d = (cube - 0.5) / cube.new_full((1,), SIGMA)
    sq = d * d
    chi2 = sq[:, 0]
    for k in range(1, D):
        chi2 = chi2 + sq[:, k]
    inside = ((cube >= 0.0) & (cube <= 1.0)).all(dim=1)
    return torch.where(inside, norm(D) - 0.5 * chi2, LOGZERO)


def hash_draws(h: torch.Tensor):
    """counter k -> the slice uniforms of the words ``h`` (int64) at k:
    the top 24 bits of fmix(mix(h, k)) times 2**-24, float32."""
    return lambda k: uniform_from_hash(_fmix(_mix(h, k))).to(torch.float32)


def lockstep_repeat(x, nhat, w, bound, draw, budget: int = MAX_INNER):
    """One repeat of B lanes on the chords x + t n̂ (x, n̂ (B, D); w, bound
    (B,)) as the prototypes' while loop runs it: every lane not yet DONE
    takes one micro-step per iteration, iteration ``it`` with the uniforms
    ``draw(it)`` (B,) float32, until every lane is DONE or ``budget``
    iterations have run.  Returns (the accepted probe (B, D), x where none
    was; its logL (B,), logzero for a forced accept or none; likelihood
    calls counted (B,) int64; micro-steps taken (B,) int64)."""
    B = x.shape[0]
    m = LaneMachine(B, x.device, LOGZERO)
    m.phase = torch.full((B,), PH_INIT_R, dtype=torch.int64, device=x.device)
    acc_l = torch.full((B,), LOGZERO, dtype=torch.float32, device=x.device)
    acc_x = x
    it = 0
    while it < budget and bool((m.phase != PH_DONE).any()):
        active = m.phase != PH_DONE
        _, probe, logL, acc, forced = m.step(loglike, CAPS, active, None, w, nhat, x, bound,
                                             u=draw(it))
        acc_l = torch.where(acc, torch.where(forced, LOGZERO, logL), acc_l)
        acc_x = torch.where(acc[:, None], probe, acc_x)
        m.phase = torch.where(acc, PH_DONE, m.phase)
        it += 1
    return acc_x, acc_l, m.cnt, m.it


def seed_word(seed) -> int:
    """The 32-bit word of an int32[1] seed tensor (or an int)."""
    return int(torch.as_tensor(seed).reshape(-1)[0]) & MASK


def epoch_uniforms(seed: int, S: int, device):
    """(repeat r, iteration it) -> (S, 128) float32: E4's uniforms, the top
    24 bits of fmix(mix(mix(seed + r, lane), it)) times 2**-24, lanes in
    row-major order."""
    lanes = torch.arange(S * LANE, device=device)
    return lambda r, it: hash_draws(_mix((seed + r) & MASK, lanes))(it).view(S, LANE)


def proto_epoch_plain(seed, x0, bound, nhats, ws, uniform=None, count_steps=False):
    """E4's epoch in plain torch, a lockstep loop over the whole tile per
    repeat: ``seed`` int32[1], ``x0 (D, S, 128)``, ``bound (S, 128)``,
    ``nhats (R, D, S, 128)``, ``ws (R, S, 128)`` -> cube (R, D, S, 128) and
    logL (R, S, 128) float32, nlike (S, 128) int32 summed over the
    repeats.  ``uniform(r, it)`` -> (S, 128) replaces the murmur3 draws;
    ``count_steps`` adds the micro-steps of every (repeat, lane), (R, S,
    128) int32."""
    D, S, L = x0.shape
    R, B, dev, f32 = nhats.shape[0], S * L, x0.device, torch.float32
    s0 = seed_word(seed)
    lanes = torch.arange(B, device=dev)
    x = x0.to(f32).reshape(D, B).t()
    bnd = bound.to(f32).reshape(B)
    cube = torch.empty((R, D, B), dtype=f32, device=dev)
    logL = torch.empty((R, B), dtype=f32, device=dev)
    nlike = torch.zeros(B, dtype=torch.int64, device=dev)
    steps = torch.empty((R, B), dtype=torch.int32, device=dev)
    for r in range(R):
        if uniform is None:
            draw = hash_draws(_mix((s0 + r) & MASK, lanes))
        else:
            draw = lambda it, r=r: uniform(r, it).reshape(B)  # noqa: E731
        x, logL[r], cnt, st = lockstep_repeat(
            x, nhats[r].to(f32).reshape(D, B).t(), ws[r].to(f32).reshape(B), bnd, draw)
        cube[r] = x.t()
        nlike += cnt
        steps[r] = st.to(torch.int32)
    out = (cube.view(R, D, S, L), logL.view(R, S, L), nlike.to(torch.int32).view(S, L))
    return out + (steps.view(R, S, L),) if count_steps else out


def device_seed(seed, dev) -> torch.Tensor:
    """The int32[1] seed on ``dev``, where the kernels read it."""
    return torch.as_tensor(seed).to(device=dev, dtype=torch.int32).reshape(-1)[:1].contiguous()


def check_inputs(what: str, dev, **arrays) -> None:
    for name, a in arrays.items():
        if a.device != dev:
            raise ValueError(f"{what}: {name} is on {a.device}, x0 on {dev}")


def proto_epoch(seed, x0, bound, nhats, ws):
    """E4's epoch, the inputs and outputs of :func:`proto_epoch_plain`.  CPU
    tensors: the plain version; CUDA tensors: the kernel."""
    if x0.device.type == "cpu":
        return proto_epoch_plain(seed, x0, bound, nhats, ws)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    D, S, L = x0.shape
    R, dev, f32 = nhats.shape[0], x0.device, torch.float32
    if L != LANE or bound.shape != (S, L) or nhats.shape != (R, D, S, L) or ws.shape != (R, S, L):
        raise ValueError("proto_epoch: x0 (D, S, 128), bound (S, 128), nhats (R, D, S, 128) "
                         "and ws (R, S, 128) expected")
    check_inputs("proto_epoch", dev, bound=bound, nhats=nhats, ws=ws)
    x0, bound, nhats, ws = (a.to(f32).contiguous() for a in (x0, bound, nhats, ws))
    cube = torch.empty((R, D, S, L), dtype=f32, device=dev)
    logL = torch.empty((R, S, L), dtype=f32, device=dev)
    nlike = torch.empty((S, L), dtype=torch.int32, device=dev)
    fn = nvcc.load(*LIBRARY).proto_epoch_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(device_seed(seed, dev).data_ptr(), x0.data_ptr(), bound.data_ptr(),
                    nhats.data_ptr(), ws.data_ptr(), cube.data_ptr(), logL.data_ptr(),
                    nlike.data_ptr(), S * L, D, R, SIGMA, norm(D), LOGZERO,
                    torch.cuda.current_stream(dev).cuda_stream)
    nvcc.check(status, "proto_epoch_launch")
    LAUNCHES["proto_epoch"] += 1
    return cube, logL, nlike


def study_inputs(device, D: int, S: int, R: int, seed: int = 0):
    """(x0, bound, nhats, ws) of the script's study (:174-184): seeds 0.5 +
    0.02 N(0, 1), directions N(0, 1) normalised over the coordinates, w =
    3 sigma, the ball contour — drawn from a seeded torch generator on the
    device (another seed than the JAX study's)."""
    gen = torch.Generator(device).manual_seed(seed)
    x0 = 0.5 + 0.02 * torch.randn((D, S, LANE), generator=gen, device=device)
    nh = torch.randn((R, D, S, LANE), generator=gen, device=device)
    nh = nh / torch.linalg.norm(nh, dim=1, keepdim=True)
    ws = torch.full((R, S, LANE), 3 * SIGMA, device=device)
    bound = torch.full((S, LANE), ball_bound(D), device=device)
    return x0, bound, nh, ws


def rate(evals: int, ms):
    return None if ms is None else evals / (ms / 1e3)


def main(device=None, D=SIZES["D"], S=SIZES["S"], R=SIZES["R"], reps=3, seed=0):
    dev = study_device(device)
    args = study_inputs(dev, D, S, R, seed)

    def call(s):
        return proto_epoch(torch.tensor([s], dtype=torch.int32, device=dev), *args)

    t0 = time.perf_counter()
    cube, logL, nlike = call(1234)
    first_evals = int(nlike.sum())  # waits for the kernel
    first_ms = (time.perf_counter() - t0) * 1e3 if dev.type == "cuda" else None
    runs = [device_once(lambda s=s: call(s), dev) for s in range(reps)]
    (_, _, best_nlike), best_ms = min(runs, key=lambda run: run[1] or 0.0)
    evals = int(best_nlike.sum())
    ok = logL > LOGZERO
    moved = (cube[1:] - cube[:-1]).abs().sum(dim=1)
    rec = {
        "study": "proto_epoch", "device": device_label(dev), "D": D, "S": S, "B": S * LANE,
        "R": R,
        "first_call": {"ms": first_ms, "evals": first_evals,
                       "evals_per_s": rate(first_evals, first_ms),
                       "note": "host clock, the library's load (and build) included"},
        "best_of": reps, "ms": best_ms, "evals": evals, "evals_per_s": rate(evals, best_ms),
        "in_bound_frac": float((logL[ok] >= ball_bound(D) - 1e-4).float().mean()),
        "accepted_frac": float(ok.float().mean()),
        "chains_move_every_repeat": bool((moved > 0).all()),
        # (repeat, lane) pairs whose cube equals the last repeat's: an
        # accepted |t n̂| below half an ulp of x0 leaves the chain in place
        "repeats_without_move": int((moved == 0).sum()),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(**vars(argument_parser(__doc__, **SIZES, reps=3, seed=0).parse_args()))
