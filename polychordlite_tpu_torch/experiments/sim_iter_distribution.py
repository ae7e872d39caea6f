"""Closed-form simulation of the slice state machine's step counts (a copy
of ``experiments/sim_iter_distribution.py``, numpy only, no kernel).

For the bench configuration (20-D Gaussian, contour at r0 = 1.5 sigma
sqrt(D), w = 3 sigma) the chord likelihood is quadratic in t, so "inside"
is the analytic interval [t-, t+].  It simulates Neal's state machine
(chordal_sampling.f90:163-273, as the engines run it) per (lane, repeat) in
vectorised numpy, with the same arithmetic and the same draws in the same
order as the original, and returns the distribution of the counted
evaluations per repeat and the lane efficiency it projects for kernels
that run a repeat in lockstep over a tile of W lanes (v2: B5, E3) or let
each lane run its repeats freely (v4: B1, E1 — whose warp is a tile of 32
lanes).  :func:`main` prints those numbers as one JSON record.

    python -m polychordlite_tpu_torch.experiments.sim_iter_distribution [--B 8192] [--R 100]
"""

from __future__ import annotations

import json

import numpy as np

from .bench_geometry import argument_parser

D = 20
SIGMA = 0.1
R = 100
B = 8192
MAX_STEP = 200
MAX_SHRINK = 100
LOCKSTEP_TILES = (1024, 2048, 8192)
FREE_TILES = (32, 1024, 8192)


def simulate(B=B, R=R, D=D, seed=0):
    """(evals, steps_out, shrinks), each (B, R) int64: the counted
    evaluations per (lane, repeat) and the step-out and shrink counts."""
    rng = np.random.default_rng(seed)
    r0 = 1.5 * SIGMA * np.sqrt(D)
    w = 3.0 * SIGMA
    # per-lane current displacement from centre
    a = SIGMA * rng.standard_normal((B, D))

    evals = np.zeros((B, R), dtype=np.int64)  # counted evals per (lane, repeat)
    steps_out = np.zeros((B, R), dtype=np.int64)
    shrinks = np.zeros((B, R), dtype=np.int64)

    for r in range(R):
        n = rng.standard_normal((B, D))
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        an = np.einsum("ij,ij->i", a, n)
        aa = np.einsum("ij,ij->i", a, a)
        disc = an**2 - (aa - r0**2)
        # all seeds are inside the contour (disc > 0); chord interval [tm, tp]
        s = np.sqrt(np.maximum(disc, 0.0))
        tm, tp = -an - s, -an + s

        u0 = rng.random(B)
        tL = -u0 * w
        tR = (1.0 - u0) * w
        ev = np.full(B, 2)  # INIT_R + INIT_L evaluations

        # stepping out: expand while the end is inside; the terminating
        # (outside) evaluation also counts
        need_r = (tR >= tm) & (tR <= tp)
        need_l = (tL >= tm) & (tL <= tp)
        nsr = np.where(need_r, np.minimum(np.floor(tp / w).astype(int), MAX_STEP) + 1, 0)
        tR = np.where(need_r, np.minimum(np.floor(tp / w) + 1, MAX_STEP) * w, tR)
        nsl = np.where(need_l, np.minimum(np.floor(-tm / w).astype(int), MAX_STEP) + 1, 0)
        tL = np.where(need_l, -np.minimum(np.floor(-tm / w) + 1, MAX_STEP) * w, tL)
        ev += nsr + nsl
        steps_out[:, r] = nsr + nsl

        # shrinkage
        t_acc = np.zeros(B)
        active = np.ones(B, bool)
        nsh = np.zeros(B, dtype=np.int64)
        for _ in range(MAX_SHRINK):
            u = rng.random(B)
            t = tL + u * (tR - tL)
            ev += active
            inside = (t >= tm) & (t <= tp)
            acc = active & inside
            t_acc = np.where(acc, t, t_acc)
            rej = active & ~inside
            tR = np.where(rej & (t > 0), t, tR)
            tL = np.where(rej & (t <= 0), t, tL)
            nsh += active
            active = rej
            if not active.any():
                break
        shrinks[:, r] = nsh
        evals[:, r] = ev
        a = a + t_acc[:, None] * n
    return evals, steps_out, shrinks


def project(evals, steps_out, shrinks, lockstep_tiles=LOCKSTEP_TILES, free_tiles=FREE_TILES):
    """The lane efficiencies the step counts project (the original's
    printed quantities), as a dict."""
    B, R = evals.shape
    tot = evals.sum(axis=1)  # per-lane epoch totals
    out = {
        "evals_per_lane_repeat": {
            "mean": float(evals.mean()), "p50": float(np.percentile(evals, 50)),
            "p90": float(np.percentile(evals, 90)), "p99": float(np.percentile(evals, 99)),
            "p99.99": float(np.percentile(evals, 99.99)), "max": int(evals.max())},
        "steps_out": {"mean": float(steps_out.mean()), "max": int(steps_out.max())},
        "shrinks": {"mean": float(shrinks.mean()), "max": int(shrinks.max())},
        "lane_totals": {"mean": float(tot.mean()), "sd": float(tot.std()),
                        "max": int(tot.max())},
        "lockstep": {}, "free_running": {}, "packets": {},
    }
    for W in lockstep_tiles:
        if B % W:
            continue
        m = evals.reshape(B // W, W, R).max(axis=1)  # (tiles, R) lockstep iterations
        lock = m.sum(axis=1).mean() * 1.0
        out["lockstep"][str(W)] = {"iterations": float(lock), "mean_max_per_repeat": float(m.mean()),
                                   "lane_efficiency": float(evals.mean() * R / lock)}
    for W in free_tiles:
        if B % W:
            continue
        m = tot.reshape(B // W, W).max(axis=1).mean()
        out["free_running"][str(W)] = {"iterations": float(m),
                                       "lane_efficiency": float(tot.mean() / m)}
    # K-probe variants: INIT merged (1 iteration, 2 probes), step-outs in
    # ceil(n/K), shrinks speculative chain in ceil(n/K) iterations
    for K in (2, 4):
        it_k = 1 + np.ceil(steps_out / K) + np.ceil(shrinks / K)
        m8 = it_k.reshape(1, B, R).max(axis=1).sum()
        probes = m8 * K  # per-lane hardware probes under lockstep
        mf = it_k.sum(axis=1).max()
        out["packets"][str(K)] = {
            "lockstep_iterations": float(m8),
            "lockstep_probe_efficiency": float(evals.mean() * R / probes),
            "free_iterations": float(mf),
            "free_probe_efficiency": float(evals.mean() * R / (mf * K))}
    return out


def main(B=B, R=R, seed=0):
    out = {"study": "sim_iter_distribution", "B": B, "R": R, "D": D,
           **project(*simulate(B, R, D, seed))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    args = vars(argument_parser(__doc__, B=B, R=R, seed=0).parse_args())
    args.pop("device")  # numpy only
    main(**args)
