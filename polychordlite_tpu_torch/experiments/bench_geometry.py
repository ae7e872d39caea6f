"""Inputs, device and timer shared by the studies.

The slice studies run one epoch of the 20-D normalised Gaussian at the
bench geometry (B = 8192 chains, R = 100 repeats), with the inputs of
``experiments/prof_v3_iters.py:31-37``: seeds 0.5 + 0.1 N(0, 1), the ball
contour of radius 1.5 sigma sqrt(D), Cholesky 0.1 I.  The draws come from a
torch generator on the device, seeded, so the JAX study's numbers are not
reproduced (another seed); the structure is.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..core.nested_sampling import resolve_device
from ..models.examples import gaussian
from ..ops.directions import make_directions
from ..ops.evaluate import make_batched_calculator
from ..ops.pallas_slice import key_words, seed_key
from ..ops.slice_kernel import EpochConfig
from ..priors import identity_prior

BENCH = dict(B=8192, R=100, D=20)
SIGMA = 0.1


def study_device(device=None) -> torch.device:
    """The card unless ``device="cpu"``; without a card it raises."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (from the command line: --device cpu)") from None


def device_label(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def device_ms(fn, reps: int, device: torch.device):
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up,
    from CUDA events; ``None`` on the CPU, where no device time exists."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def device_once(fn, device: torch.device):
    """(``fn()``, its device ms from CUDA events); the ms is ``None`` on
    the CPU."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(stop)


def slice_inputs(device: torch.device, B: int, R: int, D: int, seed: int = 0):
    """(calc, cfg, key words, (x0, bound, valid, nhats, ws)) of one epoch
    of the D-dimensional Gaussian (sigma 0.1) at B chains and R repeats."""
    like = gaussian(D, sigma=SIGMA)
    calc = make_batched_calculator(identity_prior, like, D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    gen = torch.Generator(device).manual_seed(seed)
    x0 = 0.5 + SIGMA * torch.randn((B, D), generator=gen, device=device)
    r0 = 1.5 * SIGMA * math.sqrt(D)
    bound = torch.full((B,), like.device_form["norm"] - 0.5 * (r0 / SIGMA) ** 2,
                       device=device)
    valid = torch.ones(B, dtype=torch.bool, device=device)
    chol = (SIGMA * torch.eye(D, device=device)).expand(B, D, D)
    nhats, ws, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                                   generator=gen)
    return calc, cfg, key_words(seed_key(seed)), (x0, bound, valid, nhats, ws)


def argument_parser(doc: str, **sizes) -> argparse.ArgumentParser:
    """A study's command line: ``--device`` and one option per size."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    for name, value in sizes.items():
        p.add_argument(f"--{name}", type=type(value), default=value)
    return p
