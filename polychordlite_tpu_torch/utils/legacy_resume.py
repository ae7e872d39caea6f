"""Legacy PolyChordLite ``.resume`` text-format codec (a copy of
``polychordlite_tpu/utils/legacy_resume.py``, held to it by
``tests/test_torch_host.py``).

Reads and writes the reference's human-readable resume checkpoint
(``src/polychord/read_write.F90:126-476``; the Python-forged variant at
``pypolychord/polychord.py:650-789`` is the same format), so a run started
with the Fortran reference, or with the JAX package's writer, can be
continued by the port.  ``utils/resume.py::read_resume_file`` reads a file
that starts with ``=`` through :func:`read_legacy_resume`.

Layout: ``=== section ===`` headers; integers in I12 fields, doubles in
E24.15E3 fields; per-cluster 3-D arrays are preceded by a separator line per
cluster block.  The reader tokenises values (robust to any line wrapping);
the writer emits fixed-width fields the Fortran formatted reads parse.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.rti import RowStore, RunTimeInfo
from ..settings import PolyChordSettings

_INT = "%12d"
_DBL = "%24.15E"


class _Tokens:
    """Token stream over the resume file: headers are consumed as whole
    lines, values as whitespace-separated tokens."""

    def __init__(self, text: str):
        self.lines = text.splitlines()
        self.i = 0
        self.buf: List[str] = []

    def header(self) -> str:
        assert not self.buf, "unconsumed values before header"
        line = self.lines[self.i]
        self.i += 1
        return line.strip()

    def skip_separator(self) -> None:
        self.buf = []
        self.i += 1

    def _fill(self) -> None:
        while not self.buf and self.i < len(self.lines):
            self.buf = self.lines[self.i].split()
            self.i += 1

    def ints(self, n: int) -> np.ndarray:
        return np.array([int(self._next()) for _ in range(n)], dtype=int)

    def doubles(self, n: int) -> np.ndarray:
        return np.array([float(self._next()) for _ in range(n)])

    def _next(self) -> str:
        self._fill()
        return self.buf.pop(0)


def read_legacy_resume(path: str, s: PolyChordSettings, n_grades: int) -> RunTimeInfo:
    """Parse a reference-format resume file into the administrator state
    (read_resume_file, read_write.F90:384-476, including its validation and
    the re-derivation of maxlogweight_global)."""
    with open(path) as f:
        tk = _Tokens(f.read())

    def int1() -> int:
        tk.header()
        return int(tk.ints(1)[0])

    def ints(n) -> np.ndarray:
        tk.header()
        return tk.ints(n)

    def dbl1() -> float:
        tk.header()
        return float(tk.doubles(1)[0])

    def dbls(n) -> np.ndarray:
        tk.header()
        return tk.doubles(n)

    nDims = int1()
    nDerived = int1()
    if nDims != s.nDims or nDerived != s.nDerived:
        raise ValueError(
            f"resume error: dimensions ({nDims},{nDerived}) do not match "
            f"settings ({s.nDims},{s.nDerived})"
        )
    rti = RunTimeInfo(s, n_grades)
    rti.ndead = int1()
    ncluster = int1()
    ncluster_dead = int1()
    nposterior_global = int1()
    nequals_global = int1()
    ngrades = int1()
    grade_dims = ints(ngrades)
    if list(grade_dims) != list(s.grade_dims):
        raise ValueError("resume error: Grades do not match")
    rti.num_repeats = ints(ngrades)
    rti.nlike = ints(ngrades).astype(np.int64)
    nlive = ints(ncluster)
    nphantom = ints(ncluster)
    nposterior = ints(ncluster)
    nequals = ints(ncluster)
    min_pos = ints(ncluster) - 1  # 1-based -> 0-based
    nposterior_dead = ints(ncluster_dead)
    nequals_dead = ints(ncluster_dead)

    rti.logZ = dbl1()
    rti.logZ2 = dbl1()
    rti.thin_posterior = dbl1()
    rti.logLp = dbls(ncluster)
    rti.logXp = dbls(ncluster)
    rti.logX_last_update = dbl1()
    rti.logZXp = dbls(ncluster)
    rti.logZp = dbls(ncluster)
    rti.logZp2 = dbls(ncluster)
    rti.logZpXp = dbls(ncluster)
    tk.header()  # logXpXq: (ncluster, ncluster), column-major records
    rti.logXpXq = tk.doubles(ncluster * ncluster).reshape(ncluster, ncluster).T
    rti.maxlogweight = dbls(ncluster)
    rti.logZp_dead = list(dbls(ncluster_dead))
    rti.logZp2_dead = list(dbls(ncluster_dead))
    rti.maxlogweight_dead = list(dbls(ncluster_dead))
    rti.i = min_pos

    def read_3d(ncols, counts):
        """header; then per cluster: separator + count rows of ncols."""
        tk.header()
        out = []
        for c in range(len(counts)):
            tk.skip_separator()
            rows = tk.doubles(int(counts[c]) * ncols).reshape(int(counts[c]), ncols)
            out.append(rows)
        return out

    covs = read_3d(s.nDims, [s.nDims] * ncluster)
    rti.covmat = np.stack(covs) if covs else np.zeros((0, s.nDims, s.nDims))
    chols = read_3d(s.nDims, [s.nDims] * ncluster)
    rti.cholesky = np.stack(chols) if chols else np.zeros((0, s.nDims, s.nDims))
    # NOTE: Fortran stores matrices column-major; covariance/cholesky rows
    # here come out transposed relative to ours — covmat is symmetric, and
    # the cholesky transpose of a lower-triangular matrix must be undone:
    rti.covmat = rti.covmat.transpose(0, 2, 1)
    rti.cholesky = rti.cholesky.transpose(0, 2, 1)

    rti.live = read_3d(s.nTotal, nlive)
    tk.header()
    dead = tk.doubles(int(rti.ndead) * s.nTotal).reshape(int(rti.ndead), s.nTotal)
    rti.dead = [row.copy() for row in dead]
    tk.header()
    rti.logweights = list(tk.doubles(int(rti.ndead)))
    rti.phantom = [
        RowStore(s.nTotal, arr) for arr in read_3d(s.nTotal, nphantom)
    ]
    rti.posterior = [
        RowStore(s.nposterior, arr) for arr in read_3d(s.nposterior, nposterior)
    ]
    rti.posterior_dead = read_3d(s.nposterior, nposterior_dead)
    tk.header()
    rti.posterior_global = RowStore(
        s.nposterior,
        tk.doubles(nposterior_global * s.nposterior).reshape(
            nposterior_global, s.nposterior
        ),
    )
    rti.equals = [RowStore(s.np_, arr) for arr in read_3d(s.np_, nequals)]
    rti.equals_dead = read_3d(s.np_, nequals_dead)
    tk.header()
    rti.equals_global = RowStore(
        s.np_,
        tk.doubles(nequals_global * s.np_).reshape(nequals_global, s.np_),
    )

    rti.posterior_stack = [RowStore(s.nposterior) for _ in range(ncluster)]
    rti.maxlogweight_global = (
        float(np.max(rti.maxlogweight)) if ncluster else s.logzero
    )
    return rti


def _fmt_ints(vals) -> str:
    return "".join(_INT % v for v in np.atleast_1d(vals))


def _fmt_dbls(vals) -> str:
    return "".join(_DBL % v for v in np.atleast_1d(vals))


def write_legacy_resume(path: str, s: PolyChordSettings, rti: RunTimeInfo) -> None:
    """Serialise the administrator state in the reference text format
    (write_resume_file, read_write.F90:219-288)."""
    L: List[str] = []

    def w_int(v, hdr):
        L.append(hdr)
        L.append(_fmt_ints([v]))

    def w_ints(v, hdr):
        L.append(hdr)
        if len(np.atleast_1d(v)):
            L.append(_fmt_ints(v))

    def w_dbl(v, hdr):
        L.append(hdr)
        L.append(_fmt_dbls([v]))

    def w_dbls(v, hdr):
        L.append(hdr)
        if len(np.atleast_1d(v)):
            L.append(_fmt_dbls(v))

    def w_mat(m, hdr):
        """2-D written column-record-wise like write_doubles_2."""
        L.append(hdr)
        m = np.asarray(m)
        for col in range(m.shape[1]):
            L.append(_fmt_dbls(m[:, col]))

    def w_3d(blocks, hdr):
        L.append(hdr)
        for blk in blocks:
            L.append("---------------------------------------")
            for row in np.asarray(blk):
                L.append(_fmt_dbls(row))

    nc = rti.ncluster
    w_int(s.nDims, "=== Number of dimensions ===")
    w_int(s.nDerived, "=== Number of derived parameters ===")
    w_int(rti.ndead, "=== Number of dead points/iterations ===")
    w_int(nc, "=== Number of clusters ===")
    w_int(rti.ncluster_dead, "=== Number of dead clusters ===")
    w_int(len(rti.posterior_global), "=== Number of global weighted posterior points ===")
    w_int(len(rti.equals_global), "=== Number of global equally weighted posterior points ===")
    w_int(len(s.grade_dims), "=== Number of grades ===")
    w_ints(s.grade_dims, "=== positions of grades ===")
    w_ints(rti.num_repeats, "=== Number of repeats ===")
    w_ints(rti.nlike, "=== Number of likelihood calls ===")
    w_ints(rti.nlive, "=== Number of live points in each cluster ===")
    w_ints(rti.nphantom, "=== Number of phantom points in each cluster ===")
    w_ints([len(p) for p in rti.posterior], "=== Number of weighted posterior points in each cluster ===")
    w_ints([len(e) for e in rti.equals], "=== Number of equally weighted posterior points in each cluster ===")
    w_ints(np.asarray(rti.i) + 1, "=== Minimum loglikelihood positions ===")
    w_ints([len(p) for p in rti.posterior_dead], "=== Number of weighted posterior points in each dead cluster ===")
    w_ints([len(e) for e in rti.equals_dead], "=== Number of equally weighted posterior points in each dead cluster ===")
    w_dbl(rti.logZ, "=== global evidence -- log(<Z>) ===")
    w_dbl(rti.logZ2, "=== global evidence^2 -- log(<Z^2>) ===")
    w_dbl(rti.thin_posterior, "=== posterior thin factor ===")
    w_dbls(rti.logLp, "=== local loglikelihood bounds ===")
    w_dbls(rti.logXp, "=== local volume -- log(<X_p>) ===")
    w_dbl(rti.logX_last_update, "=== last update volume ===")
    w_dbls(rti.logZXp, "=== global evidence volume cross correlation -- log(<ZX_p>) ===")
    w_dbls(rti.logZp, "=== local evidence -- log(<Z_p>) ===")
    w_dbls(rti.logZp2, "=== local evidence^2 -- log(<Z_p^2>) ===")
    w_dbls(rti.logZpXp, "=== local evidence volume cross correlation -- log(<Z_pX_p>) ===")
    w_mat(rti.logXpXq.T, "=== local volume cross correlation -- log(<X_pX_q>) ===")
    w_dbls(rti.maxlogweight, "=== maximum log weights -- log(w_p) ===")
    w_dbls(rti.logZp_dead, "=== local dead evidence -- log(<Z_p>) ===")
    w_dbls(rti.logZp2_dead, "=== local dead evidence^2 -- log(<Z_p^2>) ===")
    w_dbls(rti.maxlogweight_dead, "=== maximum dead log weights -- log(w_p) ===")
    # matrices: emit transposed so a column-major reader reconstructs ours
    w_3d([m.T for m in rti.covmat], "=== covariance matrices ===")
    w_3d([m.T for m in rti.cholesky], "=== cholesky decompositions ===")
    w_3d(rti.live, "=== live points ===")
    L.append("=== dead points ===")
    for row in rti.dead_array():
        L.append(_fmt_dbls(row))
    w_dbls(np.asarray(rti.logweights), "=== logweights of dead points ===")
    w_3d([p.data for p in rti.phantom], "=== phantom points ===")
    w_3d([p.data for p in rti.posterior], "=== weighted posterior points ===")
    w_3d(rti.posterior_dead, "=== dead weighted posterior points ===")
    L.append("=== global weighted posterior points ===")
    for row in rti.posterior_global:
        L.append(_fmt_dbls(row))
    w_3d([e.data for e in rti.equals], "=== equally weighted posterior points ===")
    w_3d(rti.equals_dead, "=== dead equally weighted posterior points ===")
    L.append("=== global equally weighted posterior points ===")
    for row in rti.equals_global:
        L.append(_fmt_dbls(row))

    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(L) + "\n")
    os.replace(tmp, path)
