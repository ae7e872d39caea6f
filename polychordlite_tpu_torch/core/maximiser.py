"""Post-run maximisation (counterpart of ``polychordlite_tpu/core/maximiser.py``;
reference ``src/polychord/maximiser.F90`` + ``nelder_mead.f90``).

Finds the maximum-likelihood and maximum-posterior points starting from a
simplex of the nDims+1 best live points, running Nelder-Mead in hypercube
coordinates (maximiser.F90:33-87,138-156).  The posterior mode adds the
log-Jacobian of the prior transform, estimated by central finite differences
(dXdtheta, maximiser.F90:190-224).  Results go to ``<root>.maximum``.

Every evaluation is batched into as few calc calls as possible: a
posterior-mode evaluation fuses the point itself with its 2*nDims Jacobian
probes into ONE call (``_logP_batch``), and the simplex and shrink-step
evaluations batch the whole simplex (points and all Jacobians) into one
call, so a Nelder-Mead iteration costs at most 3 calls in either mode.

Every function but ``_eval_batch`` is the JAX package's code
(``tests/test_torch_host.py`` holds their syntax trees equal).
``_eval_batch`` evaluates through the port's calc on the device the calc
was made for, in the calc's dtype: float64 at ``precision='highest'``.  (The
JAX package casts the cubes to float32 there even at ``'highest'``:
reference fault 12 of ROADMAP queue C, not copied.)
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..settings import PolyChordSettings
from ..utils.io import write_max_file
from .rti import RunTimeInfo


def _eval_batch(calc, s: PolyChordSettings, cubes: np.ndarray) -> np.ndarray:
    """Evaluate (N, nDims) hypercube points into (N, nTotal) records with
    ONE calc call, in the calc's dtype on its device."""
    cubes = np.atleast_2d(cubes)
    theta, phi, logL = (t.cpu().numpy() for t in calc(
        torch.as_tensor(cubes, dtype=calc.dtype, device=calc.device)))
    pts = np.zeros((cubes.shape[0], s.nTotal))
    pts[:, s.h] = cubes
    pts[:, s.p] = np.asarray(theta, dtype=np.float64)
    if s.nDerived:
        pts[:, s.d] = np.asarray(phi, dtype=np.float64)[:, : s.nDerived]
    pts[:, s.b0] = s.logzero
    pts[:, s.l0] = np.asarray(logL, dtype=np.float64)
    return pts


def _eval_point(calc, s: PolyChordSettings, cube: np.ndarray) -> np.ndarray:
    return _eval_batch(calc, s, cube[None])[0]


def _nelder_mead(
    f, f_batch, simplex: np.ndarray, max_iter: int = 2000, tol: float = 1e-9
):
    """Minimise f over the simplex (nelder_mead.f90:7-80: standard
    reflection/expansion/contraction/shrink with a simplex-size stop).
    ``f_batch`` evaluates a (N, nDims) batch in few device calls — used for
    the initial simplex and shrink steps."""
    vals = f_batch(simplex)
    for _ in range(max_iter):
        order = np.argsort(vals)
        simplex, vals = simplex[order], vals[order]
        if np.max(np.abs(simplex[1:] - simplex[0])) < tol:
            break
        centroid = simplex[:-1].mean(axis=0)
        xr = centroid + (centroid - simplex[-1])
        fr = f(xr)
        if fr < vals[0]:
            xe = centroid + 2.0 * (centroid - simplex[-1])
            fe = f(xe)
            if fe < fr:
                simplex[-1], vals[-1] = xe, fe
            else:
                simplex[-1], vals[-1] = xr, fr
        elif fr < vals[-2]:
            simplex[-1], vals[-1] = xr, fr
        else:
            xc = centroid + 0.5 * (simplex[-1] - centroid)
            fc = f(xc)
            if fc < vals[-1]:
                simplex[-1], vals[-1] = xc, fc
            else:
                simplex = simplex[0] + 0.5 * (simplex - simplex[0])
                vals = f_batch(simplex)
    order = np.argsort(vals)
    return simplex[order][0], vals[order][0]


def _jacobian_probes(s: PolyChordSettings, cubes: np.ndarray, eps: float):
    """(N, D) cubes -> clipped up/down probe points, each (N, D, D):
    probe [n, j] is cubes[n] with coordinate j bumped."""
    N, D = cubes.shape
    idx = np.arange(D)
    ups = np.repeat(cubes[:, None, :], D, axis=1)
    dns = ups.copy()
    ups[:, idx, idx] = np.minimum(cubes + eps, 1.0 - 1e-12)
    dns[:, idx, idx] = np.maximum(cubes - eps, 1e-12)
    return ups, dns


def _logP_batch(calc, s: PolyChordSettings, cubes: np.ndarray):
    """(N, D) cubes -> (logP (N,), point records (N, nTotal), dX (N,)) with
    ONE batched device call: the points themselves AND all N*2*nDims
    central-difference Jacobian probes of the prior transform
    (dXdtheta, maximiser.F90:190-224) share a single dispatch.
    logP = logL - log|dtheta/dcube| (posterior density in physical space)."""
    eps = 1e-5
    N, D = cubes.shape
    ups, dns = _jacobian_probes(s, cubes, eps)
    allpts = np.concatenate(
        [cubes, ups.reshape(-1, D), dns.reshape(-1, D)], axis=0
    )
    recs = _eval_batch(calc, s, allpts)
    pts = recs[:N]
    pu = recs[N : N + N * D, s.p].reshape(N, D, D)  # [n, probe j, component]
    pd = recs[N + N * D :, s.p].reshape(N, D, D)
    idx = np.arange(D)
    denom = ups[:, idx, idx] - dns[:, idx, idx]  # (N, D)
    jac = (pu - pd) / denom[:, :, None]
    jac = np.swapaxes(jac, 1, 2)  # jac[n, :, j] = dtheta/dcube_j
    _, logdet = np.linalg.slogdet(jac)
    dX = np.where(np.isfinite(logdet), -logdet, 0.0)
    return pts[:, s.l0] + dX, pts, dX


def _dXdtheta(calc, s: PolyChordSettings, cube: np.ndarray, eps: float = 1e-5):
    """Single-point log-Jacobian correction (maximiser.F90:190-224)."""
    _, _, dX = _logP_batch(calc, s, cube[None])
    return float(dX[0])


def maximise(calc, s: PolyChordSettings, rti: RunTimeInfo) -> None:
    """Find max-likelihood and max-posterior points and write ``.maximum``
    (maximise, maximiser.F90:33-87)."""
    live = rti.all_live()
    if live.shape[0] < s.nDims + 1:
        return
    order = np.argsort(-live[:, s.l0])
    simplex0 = live[order[: s.nDims + 1], s.h].copy()

    def _inside(cubes):
        return np.all((cubes >= 0) & (cubes <= 1), axis=-1)

    def neg_logL(cube):
        if not _inside(cube):
            return -s.logzero  # huge
        return -_eval_point(calc, s, cube)[s.l0]

    def neg_logL_batch(cubes):
        vals = np.full(cubes.shape[0], -s.logzero)
        ok = _inside(cubes)
        if ok.any():
            vals[ok] = -_eval_batch(calc, s, cubes[ok])[:, s.l0]
        return vals

    best_cube, _ = _nelder_mead(neg_logL, neg_logL_batch, simplex0.copy())
    max_point = _eval_point(calc, s, best_cube)

    def neg_logP(cube):
        if not _inside(cube):
            return -s.logzero
        logP, _, _ = _logP_batch(calc, s, cube[None])  # ONE dispatch
        return -logP[0]

    def neg_logP_batch(cubes):
        """Whole simplex (probes + Jacobians) in ONE device call — the
        posterior-mode analogue of neg_logL_batch."""
        vals = np.full(cubes.shape[0], -s.logzero)
        ok = _inside(cubes)
        if ok.any():
            logP, _, _ = _logP_batch(calc, s, cubes[ok])
            vals[ok] = -logP
        return vals

    best_post_cube, _ = _nelder_mead(
        neg_logP, neg_logP_batch, simplex0.copy(), max_iter=400
    )
    max_post_point = _eval_point(calc, s, best_post_cube)
    dX_post = _dXdtheta(calc, s, best_post_cube)

    write_max_file(s, max_point, max_post_point, dX_post)
