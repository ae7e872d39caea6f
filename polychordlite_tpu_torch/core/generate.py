"""Initial live points, seed selection and speed-grade timing
(counterpart of ``polychordlite_tpu/core/generate.py``).

``generate_live_points`` draws uniform hypercube points with the run's
device generator, in the calc's dtype (float64 under
``precision='highest'``), and evaluates them in batches with the calc
(``generate.F90:186-261``); ``generate_seeds`` (numpy, unchanged) picks
slice seeds on the host (``GenerateSeed``, ``generate.F90:19-55``);
``time_speeds`` times the speed grades and ``assign_num_repeats`` turns
the times into repeats per grade (``generate.F90:303-455``).
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np
import torch

from ..core.rti import RunTimeInfo, find_min_loglikelihoods
from ..settings import PolyChordSettings


def generate_live_points(
    calc: Callable,
    s: PolyChordSettings,
    generator: torch.Generator,
    device: torch.device,
) -> Tuple[RunTimeInfo, int, float]:
    """Sample ``nprior`` points uniform in the hypercube, rejecting
    ``logL <= logzero`` (generate.F90:61-326).  Returns
    (rti, ndiscarded, seconds_per_eval)."""
    nprior = s.resolved_nprior()
    rti = RunTimeInfo(s, len(s.grade_dims))

    batch = max(64, min(4 * nprior, 4096))
    accepted = []
    ndiscarded = 0
    nlike = 0
    total_time = 0.0
    round_idx = 0
    n_phi = max(s.nDerived, 1)
    while sum(a.shape[0] for a in accepted) < nprior and round_idx < 10000:
        round_idx += 1
        t0 = time.perf_counter()
        cube = torch.rand((batch, s.nDims), generator=generator, device=device,
                          dtype=calc.dtype)
        theta, phi, logL = calc(cube)
        packed = torch.cat([cube, theta, phi, logL[:, None]], dim=1)
        packed = packed.cpu().numpy().astype(np.float64)
        total_time += time.perf_counter() - t0
        cube = packed[:, : s.nDims]
        theta = packed[:, s.nDims : 2 * s.nDims]
        phi = packed[:, 2 * s.nDims : 2 * s.nDims + n_phi]
        logL = packed[:, -1]
        ok = logL > s.logzero
        ndiscarded += batch
        nlike += int(ok.sum())
        pts = np.zeros((int(ok.sum()), s.nTotal))
        pts[:, s.h] = cube[ok]
        pts[:, s.p] = theta[ok]
        if s.nDerived:
            pts[:, s.d] = phi[ok][:, : s.nDerived]
        pts[:, s.b0] = s.logzero
        pts[:, s.l0] = logL[ok]
        accepted.append(pts)

    pts = np.concatenate(accepted, axis=0)[:nprior]
    rti.live[0] = pts
    rti.nlike[0] = nlike
    find_min_loglikelihoods(rti)
    sec_per_eval = total_time / max(ndiscarded, 1)
    return rti, ndiscarded, sec_per_eval


def assign_num_repeats(
    s: PolyChordSettings,
    rti: RunTimeInfo,
    speeds: np.ndarray,
) -> None:
    """Per-grade repeat counts (generate.F90:303-316): grade 1 gets
    ``num_repeats``; faster grades get counts scaled by grade_frac and the
    measured speed ratio.  Also sets the posterior thinning factor."""
    from ..parallel.distributed import broadcast_from_root

    # wall-clock timings differ per process; root's decide (MPI_BCAST analogue)
    speeds = broadcast_from_root(np.asarray(speeds, dtype=float))
    gf = np.asarray(s.grade_frac, dtype=float)
    n_grades = len(s.grade_dims)
    num_repeats = np.empty(n_grades, dtype=int)
    if (gf <= 1).any():
        num_repeats[0] = s.num_repeats
        if n_grades > 1:
            num_repeats[1:] = np.rint(
                gf[1:] / gf[0] * num_repeats[0] * speeds[0] / speeds[1:]
            ).astype(int)
    else:
        num_repeats[:] = gf.astype(int)
    num_repeats = np.maximum(num_repeats, 1)
    rti.num_repeats = num_repeats

    if s.boost_posterior < 0:
        rti.thin_posterior = 1.0
    else:
        rti.thin_posterior = float(s.boost_posterior) / float(num_repeats.sum())


def _wait(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seconds_per_row(fn, batches, device: torch.device) -> float:
    """Host-clock seconds per row of ``fn(batch)`` over ``batches``, the
    device's queue drained before and after."""
    _wait(device)
    t0 = time.perf_counter()
    for batch in batches:
        fn(batch)
    _wait(device)
    return (time.perf_counter() - t0) / sum(batch.shape[0] for batch in batches)


def time_speeds(calc, s: PolyChordSettings, generator: torch.Generator) -> np.ndarray:
    """Measure per-grade likelihood cost (generate.F90:330-455,
    ``polychordlite_tpu/core/generate.py:117-166``) on 256 cubes drawn from
    ``generator`` on the calc's device, after one warm-up, each batch timed
    to the end of its device work: grade g's evaluation varies only the
    dimensions from grade g onward.  For a monolithic likelihood all grades
    cost the same (no partial recomputation), which gives
    grade_frac-proportional repeats; for a :class:`GradedLikelihood` with
    two grades the two code paths the ``"scan"`` engine runs are timed
    instead, the full calc against ``calc.fast_point_batch`` on a cached
    slow intermediate.  Nothing is drawn or timed for one grade, or for
    literal repeat counts (every grade_frac above 1)."""
    n_grades = len(s.grade_dims)
    speeds = np.ones(n_grades)
    if n_grades == 1 or not (np.asarray(s.grade_frac) <= 1).any():
        return speeds
    B, reps = 256, 3
    device = calc.device
    base = torch.rand((B, s.nDims), generator=generator, device=device, dtype=calc.dtype)
    calc(base)  # warm up
    if getattr(calc, "graded", False) and n_grades == 2:
        aux = calc.slow_aux_batch(base)
        calc.fast_point_batch(aux, base)
        speeds[0] = max(_seconds_per_row(calc, [base] * reps, device), 1e-12)
        speeds[1] = max(_seconds_per_row(lambda c: calc.fast_point_batch(aux, c),
                                         [base] * reps, device), 1e-12)
        return speeds
    for g in range(n_grades):
        start = int(sum(s.grade_dims[:g]))
        perts = []
        for _ in range(reps):
            pert = base.clone()
            pert[:, start:] = torch.rand((B, s.nDims - start), generator=generator,
                                         device=device, dtype=calc.dtype)
            perts.append(pert)
        speeds[g] = _seconds_per_row(calc, perts, device)
    return speeds


def generate_seeds(
    rti: RunTimeInfo, n: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw ``n`` slice-chain seeds: cluster chosen with probability
    proportional to its volume estimate, then a uniform live point within it
    (GenerateSeed, generate.F90:19-55).  Returns (seed_points (n, nTotal),
    cluster_ids (n,))."""
    s = rti.settings
    logp = rti.logXp - rti.logXp.max()
    probs = np.exp(logp)
    probs /= probs.sum()
    clusters = rng.choice(rti.ncluster, size=n, p=probs)
    seeds = np.empty((n, s.nTotal))
    for b in range(n):
        c = int(clusters[b])
        nl = rti.live[c].shape[0]
        if nl == 0:  # degenerate: fall back to any non-empty cluster
            c = int(np.argmax(rti.nlive))
            clusters[b] = c
            nl = rti.live[c].shape[0]
        seeds[b] = rti.live[c][rng.integers(nl)]
    return seeds, clusters
