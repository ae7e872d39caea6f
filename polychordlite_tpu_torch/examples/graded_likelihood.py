"""Decomposed fast/slow likelihood example — the speed-grade payoff
(counterpart of ``examples/graded_likelihood.py``).

A 6-D Gaussian whose first two ("slow") parameters route through an
artificially expensive computation (a loop of ``--loops`` iterations,
standing in for e.g. a CMB transfer function), while the four "fast"
parameters are cheap.  Passing the decomposition as a GradedLikelihood
lets the sampler cache the slow part per chord seed and re-evaluate only
the fast part along fast-grade slice directions — the reference's
CosmoMC-style win (src/polychord/generate.F90:330-455,
chordal_sampling.f90:94-145).  The graded run takes the ``"scan"`` engine
(on the card B1's traced route held at a barrier after every repeat, the
slow part evaluated only in slow-grade repeats); the same likelihood
presented monolithically takes the default engine (on the card B1 with the
likelihood lowered into it where it can be, else its traced route).

    python -m polychordlite_tpu_torch.examples.graded_likelihood [--device cpu] [--loops 2000]

Prints the wall-clock and the likelihood calls by grade of the graded run
and of the monolithic one, and their ratio.  The loop is 2,000 torch operations
by default: the JAX example's 60,000 is one XLA loop, and here every
iteration is an operation of its own.  Each run also pays its one-off
kernel builds and graph captures, which a longer run amortises better.
"""

import argparse
import json
import math
import time

import torch

import polychordlite_tpu_torch as pt
from polychordlite_tpu_torch import GradedLikelihood
from polychordlite_tpu_torch.priors import UniformPrior

SIGMA = 0.15
N_SLOW, N_FAST = 2, 4
NDIMS = N_SLOW + N_FAST
ANALYTIC = -NDIMS * math.log(2)


def make_heavy_slow(loops: int):
    """The slow part of one point, ``theta_slow (N_SLOW,)``: a loop of
    ``loops`` iterations whose result is the slow parameters' r^2."""

    def heavy_slow(theta_slow):
        s = torch.sum(theta_slow**2)
        c = s
        for _ in range(loops):
            c = c * 0.5 + s * 0.5
        return {"logL_slow": -c / (2 * SIGMA**2)}

    return heavy_slow


def fast_part(aux, theta):
    r2_fast = torch.sum(theta[N_SLOW:] ** 2)
    norm = -NDIMS * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))
    return norm + aux["logL_slow"] - r2_fast / (2 * SIGMA**2), [r2_fast]


def nlike_per_grade(out):
    """The run's likelihood calls by grade, from its final metrics record."""
    with open(f"{out.root}.metrics.jsonl") as f:
        return json.loads(f.read().splitlines()[-1])["nlike_per_grade"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--loops", type=int, default=2000)
    ap.add_argument("--nlive", type=int, default=100)
    ap.add_argument("--max-ndead", type=int, default=3000)
    ap.add_argument("--base-dir", default="chains")
    args = ap.parse_args(argv)
    common = dict(
        nDerived=1,
        prior=UniformPrior(-1, 1),
        nlive=args.nlive,
        max_ndead=args.max_ndead,
        grade_dims=[N_SLOW, N_FAST],
        # literal per-grade repeat counts (grade_frac > 1): both runs then
        # do the same amount of sampling work, isolating the cost of paying
        # the slow part on every probe against only on slow-grade probes
        grade_frac=[4, 12],
        read_resume=False,
        write_resume=False,
        base_dir=args.base_dir,
        seed=11,
        feedback=0,
        precision_criterion=0.01,
        device=args.device,
    )

    graded = GradedLikelihood(make_heavy_slow(args.loops), fast_part, N_SLOW)

    t0 = time.perf_counter()
    out_g = pt.run(graded, NDIMS, file_root="graded", **common)
    t_graded = time.perf_counter() - t0

    t0 = time.perf_counter()
    out_m = pt.run(lambda theta: graded(theta), NDIMS, file_root="mono", **common)
    t_mono = time.perf_counter() - t0

    print(f"analytic logZ          {ANALYTIC:8.3f}")
    for name, out, wall in (("graded:    ", out_g, t_graded), ("monolithic:", out_m, t_mono)):
        print(f"{name} logZ {out.logZ:8.3f} +/- {out.logZerr:.3f}  wall {wall:6.1f}s  "
              f"nlike/grade {nlike_per_grade(out)}")
    print(f"wall-clock ratio monolithic / graded: {t_mono / t_graded:.2f}x")
    return {"graded": (out_g, t_graded), "mono": (out_m, t_mono)}


if __name__ == "__main__":
    main()
