"""Output-file writers.

Produces the reference's complete run-product suite in getdist/anesthetic-
compatible formats (``src/polychord/read_write.F90``; SURVEY §5.5 — these
files are the compatibility surface): ``.stats`` (parseable by
``PolyChordOutput``, fixed line offsets per ``pypolychord/output.py:57-99``),
``.txt`` / ``_equal_weights.txt`` weighted posteriors (+ per-cluster files in
``clusters/``), ``_dead(.txt|-birth.txt)``, ``_phys_live(.txt|-birth.txt)``,
``_prior.txt``, ``.paramnames``, ``.properties.ini``, ``.maximum``.

All files are written atomically (temp + rename, read_write.F90:97-123).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.rti import RunTimeInfo, calculate_logZ_estimate
from ..settings import PolyChordSettings

#: float column format — fixed width like the reference's E24.15E3
#: (utils.F90:18-20); plain parsers (getdist/anesthetic/numpy) read it fine.
_F = "%24.15E"


def _fmt_row(vals) -> str:
    return "".join(_F % v for v in np.atleast_1d(vals))


def _fmt_matrix(arr: np.ndarray) -> List[str]:
    """Format a 2-D array as fixed-width rows with one ``%`` call per BLOCK
    of rows (the tuple-interpolation loop runs in C) — the writers below are
    on the per-update hot path (the reference rewrites its products every
    e-fold too, read_write.F90:329-334); per-row ``%`` would make the
    formatting one of the largest host costs of the administrator."""
    arr = np.asarray(arr, dtype=np.float64)
    if arr.size == 0:
        return []
    n, ncol = arr.shape
    rowfmt = _F * ncol
    out: List[str] = []
    block = max(1, 65536 // max(ncol, 1))
    for i in range(0, n, block):
        blk = arr[i : i + block]
        s = ((rowfmt + "\n") * blk.shape[0]) % tuple(blk.ravel())
        out.extend(s.splitlines())
    return out


def root_path(s: PolyChordSettings) -> str:
    return os.path.join(s.base_dir, s.file_root)


def cluster_root(s: PolyChordSettings, i: int) -> str:
    return os.path.join(s.base_dir, "clusters", f"{s.file_root}_{i}")


def check_directories(s: PolyChordSettings) -> None:
    os.makedirs(s.base_dir, exist_ok=True)
    os.makedirs(os.path.join(s.base_dir, "clusters"), exist_ok=True)


def _atomic_write(path: str, lines: List[str]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines))
        if lines:
            f.write("\n")
    os.replace(tmp, path)


# ----------------------------------------------------------------------


def write_stats_file(
    s: PolyChordSettings, rti: RunTimeInfo, nlikesum: np.ndarray
) -> None:
    """``<root>.stats`` — exact line layout of read_write.F90:809-910 so that
    PolyChordOutput's fixed-offset parser works unmodified."""
    check_directories(s)
    logZ, varlogZ, logZp, varlogZp, logZpd, varlogZpd = calculate_logZ_estimate(rti)

    lines = [
        "Evidence estimates:",
        "===================",
        "  - The evidence Z is a log-normally distributed, with location and scale parameters mu and sigma.",
        "  - We denote this as log(Z) = mu +/- sigma.",
        "",
        "Global evidence:",
        "----------------",
        "",
        "log(Z)       = %s +/- %s" % (_F % logZ, _F % math.sqrt(abs(varlogZ))),
        "",
        "",
        "Local evidences:",
        "----------------",
        "",
    ]
    for p in range(rti.ncluster):
        lines.append(
            "log(Z_%i)%s= %s +/- %s (Still Active)"
            % (
                p + 1,
                " " * max(1, 6 - len(str(p + 1))),
                _F % logZp[p],
                _F % math.sqrt(abs(varlogZp[p])),
            )
        )
    for p in range(rti.ncluster_dead):
        idx = p + rti.ncluster
        lines.append(
            "log(Z_%i)%s= %s +/- %s"
            % (
                idx + 1,
                " " * max(1, 6 - len(str(idx + 1))),
                _F % logZpd[p],
                _F % math.sqrt(abs(varlogZpd[p])),
            )
        )
    lines += [
        "",
        "",
        "Run-time information:",
        "---------------------",
        "",
        " ncluster:   %8i /%8i" % (rti.ncluster, rti.ncluster + rti.ncluster_dead),
        " nposterior: %8i" % len(rti.posterior_global),
        " nequals:    %8i" % len(rti.equals_global),
        " ndead:      %8i" % rti.ndead,
        " nlive:      %8i" % rti.total_nlive(),
        " nlike:      " + "".join("%8i" % n for n in rti.nlike),
    ]
    total_nlive = rti.total_nlive()
    if total_nlive > 0:
        update_files = -total_nlive * math.log(s.compression_factor)
        avn = np.asarray(nlikesum, dtype=float) / update_files
        per_slice = np.asarray(nlikesum, dtype=float) / (
            np.maximum(rti.num_repeats, 1) * update_files
        )
    else:
        avn = np.zeros(rti.n_grades)
        per_slice = np.zeros(rti.n_grades)
    lines.append(
        " <nlike>:    "
        + "".join("%8.2f" % x for x in avn)
        + "   ("
        + "".join("%8.2f" % x for x in per_slice)
        + " per slice )"
    )

    if s.posteriors:
        mu, sig = _posterior_moments(s, rti)
        lines += ["", "", "Dim No.       Mean        Sigma"]
        for i in range(s.nDims):
            lines.append("%3i%s +/- %s" % (i + 1, _F % mu[i], _F % sig[i]))
        lines.append("-------------------------------")
        for i in range(s.nDims, s.nDims + s.nDerived):
            lines.append("%3i%s +/- %s" % (i + 1, _F % mu[i], _F % sig[i]))

    _atomic_write(root_path(s) + ".stats", lines)


def _posterior_moments(s: PolyChordSettings, rti: RunTimeInfo):
    """Weighted streaming mean/variance over the global weighted posterior
    (read_write.F90:912-961 semantics, vectorised)."""
    n = len(rti.posterior_global)
    dim = s.nDims + s.nDerived
    if n == 0:
        return np.zeros(dim), np.zeros(dim)
    x = rti.posterior_global.data[:, s.pos_pd]
    pg = rti.posterior_global.data
    logw = pg[:, s.pos_w] + pg[:, s.pos_l]
    logw = logw - logw.max()
    w = np.exp(logw)
    wsum = w.sum()
    mu = (w[:, None] * x).sum(0) / wsum
    var = (w[:, None] * (x - mu) ** 2).sum(0) / wsum
    return mu, np.sqrt(var)


def write_posterior_files(s: PolyChordSettings, rti: RunTimeInfo) -> None:
    """``<root>.txt`` / ``<root>_equal_weights.txt`` + per-cluster files,
    clusters sorted by local evidence (read_write.F90:479-617)."""
    check_directories(s)
    lzp = np.concatenate([rti.logZp, np.asarray(rti.logZp_dead, dtype=float)])
    ordering = np.argsort(-lzp, kind="stable")
    logZ_mean = rti.logZ  # log<Z>, used for cluster weight ratios (:531,:579)

    if s.equals:

        def _equal_matrix(eq, w):
            eq = np.asarray(eq.data if hasattr(eq, "data") else eq)
            out = np.empty((eq.shape[0], 1 + eq.shape[1] - s.p_2l))
            out[:, 0] = w
            out[:, 1:] = eq[:, s.p_2l :]
            return out

        _atomic_write(
            root_path(s) + "_equal_weights.txt",
            _fmt_matrix(_equal_matrix(rti.equals_global, 1.0)),
        )

        if s.cluster_posteriors:
            for rank, c in enumerate(ordering):
                if c < rti.ncluster:
                    eq, lz = rti.equals[c], rti.logZp[c]
                else:
                    eq = rti.equals_dead[c - rti.ncluster]
                    lz = rti.logZp_dead[c - rti.ncluster]
                w = math.exp(min(lz - logZ_mean, 0.0)) if lz > s.logzero else 0.0
                _atomic_write(
                    cluster_root(s, rank + 1) + "_equal_weights.txt",
                    _fmt_matrix(_equal_matrix(eq, w)),
                )

    if s.posteriors:

        def _weighted_matrix(post, shift):
            post = np.asarray(post.data if hasattr(post, "data") else post)
            if post.shape[0] == 0:
                return post.reshape(0, 2 + len(s.pos_pd))
            w = np.exp(np.minimum(post[:, s.pos_w] + post[:, s.pos_l] + shift, 0.0))
            keep = w > 0.0
            post, w = post[keep], w[keep]
            out = np.empty((post.shape[0], 2 + post[:, s.pos_pd].shape[1]))
            out[:, 0] = w
            out[:, 1] = -2 * post[:, s.pos_l]
            out[:, 2:] = post[:, s.pos_pd]
            return out

        _atomic_write(
            root_path(s) + ".txt",
            _fmt_matrix(
                _weighted_matrix(rti.posterior_global, -rti.maxlogweight_global)
            ),
        )

        if s.cluster_posteriors:
            for rank, c in enumerate(ordering):
                if c < rti.ncluster:
                    post, lz, mlw = (
                        rti.posterior[c],
                        rti.logZp[c],
                        rti.maxlogweight[c],
                    )
                else:
                    post = rti.posterior_dead[c - rti.ncluster]
                    lz = rti.logZp_dead[c - rti.ncluster]
                    mlw = rti.maxlogweight_dead[c - rti.ncluster]
                _atomic_write(
                    cluster_root(s, rank + 1) + ".txt",
                    _fmt_matrix(_weighted_matrix(post, lz - logZ_mean - mlw)),
                )


def write_phys_live_points(s: PolyChordSettings, rti: RunTimeInfo) -> None:
    """``<root>_phys_live.txt`` (+ ``-birth``, + per-cluster)
    (read_write.F90:621-676)."""
    check_directories(s)
    lines, lines_birth = [], []
    for c in range(rti.ncluster):
        lp = rti.live[c]
        cl = np.concatenate([lp[:, s.pd], lp[:, [s.l0]]], axis=1)
        cl_lines = _fmt_matrix(cl)
        lines_birth += _fmt_matrix(
            np.concatenate([lp[:, s.pd], lp[:, [s.l0, s.b0]]], axis=1)
        )
        lines += cl_lines
        if s.do_clustering:
            _atomic_write(
                os.path.join(
                    s.base_dir, "clusters", f"{s.file_root}_phys_live_{c + 1}.txt"
                ),
                cl_lines,
            )
    _atomic_write(root_path(s) + "_phys_live.txt", lines)
    _atomic_write(root_path(s) + "_phys_live-birth.txt", lines_birth)


def write_dead_points(s: PolyChordSettings, rti: RunTimeInfo) -> None:
    """``<root>_dead.txt`` (logL first) and ``<root>_dead-birth.txt``
    (params, logL, birth) (read_write.F90:679-719).

    The dead array is append-only, so mid-run updates append just the new
    rows (tracked via ``rti._dead_rows_written``) instead of the reference's
    full rewrite — the run product is identical, the cost drops from
    O(ndead^2) to O(ndead) over a run.

    Crash consistency: each append ends on a newline and is flushed+fsynced,
    so a crash can lose at most the final update's rows, never tear a line
    mid-write into something a reader mis-parses; a resume triggers the
    full-rewrite path (``written > rti.ndead`` after state reload), which
    repairs any torn tail left by an out-of-band kill."""
    check_directories(s)
    written = getattr(rti, "_dead_rows_written", None)
    path_d = root_path(s) + "_dead.txt"
    path_b = root_path(s) + "_dead-birth.txt"
    full = (
        written is None
        or written > rti.ndead
        or not (os.path.exists(path_d) and os.path.exists(path_b))
    )
    start = 0 if full else written
    if start == rti.ndead and not full:
        return
    dead = (
        np.stack(rti.dead[start:])
        if rti.dead[start:]
        else np.zeros((0, s.nTotal))
    )
    lines_d = _fmt_matrix(np.concatenate([dead[:, [s.l0]], dead[:, s.pd]], axis=1))
    lines_b = _fmt_matrix(
        np.concatenate([dead[:, s.pd], dead[:, [s.l0, s.b0]]], axis=1)
    )
    mode = "w" if full else "a"
    for path, lines in ((path_d, lines_d), (path_b, lines_b)):
        with open(path, mode) as f:
            if lines:
                f.write("\n".join(lines))
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
    rti._dead_rows_written = rti.ndead


def write_prior_file(s: PolyChordSettings, rti: RunTimeInfo) -> None:
    """``<root>_prior.txt`` (read_write.F90:721-752)."""
    check_directories(s)
    lp = rti.live[0]
    mat = np.concatenate(
        [np.ones((lp.shape[0], 1)), -2 * lp[:, [s.l0]], lp[:, s.pd]], axis=1
    )
    _atomic_write(root_path(s) + "_prior.txt", _fmt_matrix(mat))


def write_prior_info(s: PolyChordSettings, nprior: int, ndiscarded: int) -> None:
    check_directories(s)
    with open(root_path(s) + ".prior_info", "a") as f:
        f.write("nprior = %12i\n" % nprior)
        f.write("ndiscarded = %12i\n" % ndiscarded)


def write_paramnames_file(
    s: PolyChordSettings, paramnames: Sequence[Tuple[str, str]]
) -> None:
    """``.paramnames`` (getdist) + ``.properties.ini`` (anesthetic)
    (read_write.F90:964-1014)."""
    check_directories(s)
    _atomic_write(
        root_path(s) + ".paramnames",
        ["%s   %s" % (name, latex) for name, latex in paramnames],
    )
    write_properties_file(s)


def write_properties_file(s: PolyChordSettings) -> None:
    check_directories(s)
    _atomic_write(
        root_path(s) + ".properties.ini",
        ["sampler=nested", "label=%s" % s.file_root],
    )


def write_max_file(
    s: PolyChordSettings,
    max_point: np.ndarray,
    max_posterior_point: np.ndarray,
    dXdtheta: float,
    mean_point: Optional[np.ndarray] = None,
) -> None:
    """``<root>.maximum`` (read_write.F90:754-807)."""
    check_directories(s)
    lines = [
        "Maximum LogLikelihood:",
        _F % max_point[s.l0],
        "Maximum Likelihood point:",
        _fmt_row(max_point[s.pd]),
        "",
        "Maximum Posterior:",
        _F % (max_posterior_point[s.l0] + dXdtheta),
        "Maximum Likelihood at posterior:",
        _F % max_posterior_point[s.l0],
        "Maximum Posterior point:",
        _fmt_row(max_posterior_point[s.pd]),
        "",
    ]
    if mean_point is not None:
        lines += [
            "LogLikelihood(mean):",
            _F % mean_point[s.l0],
            "mean point:",
            _fmt_row(mean_point[s.pd]),
        ]
    _atomic_write(root_path(s) + ".maximum", lines)
