"""Run-time information: the sampler's mutable state and the exact
evidence-accumulation recurrences.

This is the host-side administrator state of the batched design (SURVEY §5.8): the
device engine generates batches of candidate chains; this module does the
O(ndead) float64 bookkeeping that the reference performs on MPI rank 0 —
semantics follow ``src/polychord/run_time_info.f90`` function-for-function
(citations inline), with the reference's ragged per-cluster Fortran arrays
replaced by per-cluster numpy arrays (points are rows).

The second-moment bookkeeping tracks, in log space:
  logZ    = log <Z>          logZ2     = log <Z^2>
  logXp   = log <X_p>        logZXp    = log <Z X_p>
  logZp   = log <Z_p>        logZp2    = log <Z_p^2>
  logZpXp = log <Z_p X_p>    logXpXq   = log <X_p X_q>
updated with the exact deletion recurrences of ``update_evidence``
(run_time_info.f90:211-296), giving the unbiased log-normal evidence
estimate logZ = 2 log<Z> - 0.5 log<Z^2> (:652-678).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..ops.linalg import calc_cholesky_np, calc_covmat_np
from ..ops.logspace import logaddexp, logincexp, logsumexp, logsumexp_small
from ..settings import PolyChordSettings

HUGE = np.finfo(np.float64).max


class RowStore:
    """Growable 2-D float64 array with amortised O(1) appends.

    Replaces the reference's ``reallocate``/``add_point`` machinery
    (array_utils.f90:22-431) for the stores that only ever grow or get
    rebuilt (phantoms, posterior stacks): per-row ``vstack`` would be
    O(n^2) over a run."""

    __slots__ = ("_buf", "n")

    def __init__(self, ncols: int, data: Optional[np.ndarray] = None, cap: int = 64):
        if data is not None and len(data):
            data = np.asarray(data, dtype=np.float64).reshape(-1, ncols)
            cap = max(cap, 2 * data.shape[0])
        self._buf = np.empty((cap, ncols))
        self.n = 0
        if data is not None and len(data):
            self._buf[: data.shape[0]] = data
            self.n = data.shape[0]

    @property
    def data(self) -> np.ndarray:
        """View of the live rows (no copy; invalidated by growth)."""
        return self._buf[: self.n]

    @property
    def ncols(self) -> int:
        return self._buf.shape[1]

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return iter(self.data)

    def _reserve(self, extra: int) -> None:
        need = self.n + extra
        if need > self._buf.shape[0]:
            cap = max(2 * self._buf.shape[0], need)
            new = np.empty((cap, self._buf.shape[1]))
            new[: self.n] = self._buf[: self.n]
            self._buf = new

    def append(self, row: np.ndarray) -> None:
        self._reserve(1)
        self._buf[self.n] = row
        self.n += 1

    def extend(self, rows) -> None:
        rows = np.asarray(rows, dtype=np.float64)
        if rows.size == 0:
            return
        rows = rows.reshape(-1, self._buf.shape[1])
        self._reserve(rows.shape[0])
        self._buf[self.n : self.n + rows.shape[0]] = rows
        self.n += rows.shape[0]

    def replace(self, rows) -> None:
        self.n = 0
        self.extend(rows)

    def clear(self) -> None:
        self.n = 0

    def copy_array(self) -> np.ndarray:
        return self.data.copy()

    def __getstate__(self):
        return {"data": self.copy_array()}

    def __setstate__(self, state):
        data = state["data"]
        self._buf = np.empty((max(64, 2 * len(data)), data.shape[1]))
        self._buf[: len(data)] = data
        self.n = len(data)


class RunTimeInfo:
    """Everything needed to resume a run (run_time_info.f90:5-107)."""

    def __init__(self, settings: PolyChordSettings, n_grades: int):
        s = settings
        self.settings = s
        self.n_grades = n_grades

        # active clusters: parallel per-cluster lists
        self.live: List[np.ndarray] = [np.zeros((0, s.nTotal))]
        self.phantom: List[RowStore] = [RowStore(s.nTotal)]
        self.posterior_stack: List[RowStore] = [RowStore(s.nposterior)]
        self.posterior: List[RowStore] = [RowStore(s.nposterior)]
        self.equals: List[RowStore] = [RowStore(s.np_)]

        # global posterior arrays
        self.posterior_global = RowStore(s.nposterior)
        self.equals_global = RowStore(s.np_)

        # dead points (pure NS samples) + their volume logweights
        self.dead: List[np.ndarray] = []
        self.logweights: List[float] = []

        # per-cluster covariances / cholesky
        self.covmat = np.repeat(np.eye(s.nDims)[None], 1, axis=0)
        self.cholesky = np.repeat(np.eye(s.nDims)[None], 1, axis=0)

        # evidence bookkeeping (all log-domain, float64)
        z = s.logzero
        self.logZ = z
        self.logZ2 = z
        self.logXp = np.zeros(1)
        self.logX_last_update = 0.0
        self.logZXp = np.full(1, z)
        self.logZp = np.full(1, z)
        self.logZp2 = np.full(1, z)
        self.logZpXp = np.full(1, z)
        self.logXpXq = np.zeros((1, 1))

        # per-cluster min-likelihood bookkeeping
        self.logLp = np.full(1, z)
        self.i = np.zeros(1, dtype=int) - 1

        # max log weights for equal-weight resampling
        self.maxlogweight = np.full(1, z)
        self.maxlogweight_global = z

        # dead (retired) clusters
        self.posterior_dead: List[np.ndarray] = []
        self.equals_dead: List[np.ndarray] = []
        self.logZp_dead: List[float] = []
        self.logZp2_dead: List[float] = []
        self.maxlogweight_dead: List[float] = []

        self.ndead = 0
        self.nlike = np.zeros(n_grades, dtype=np.int64)
        self.num_repeats: Optional[np.ndarray] = None  # per-grade, set at init
        self.thin_posterior = 0.0

        # epoch counter: incremented on any cluster reorganisation so that
        # in-flight batched babies with stale cluster ids are discarded
        # (the MPI administrator_epoch, nested_sampling.F90:341,357,364)
        self.epoch = 0
        # device-epoch dispatch counter: checkpointed so a resumed run folds
        # fresh indices into the epoch PRNG key (continues the stream, as the
        # reference resume restores the generator state, read_write.F90:384-476)
        self.epoch_idx = 0

    # ------------------------------------------------------------------
    @property
    def ncluster(self) -> int:
        return len(self.live)

    @property
    def ncluster_dead(self) -> int:
        return len(self.logZp_dead)

    @property
    def nlive(self) -> np.ndarray:
        return np.array([c.shape[0] for c in self.live], dtype=int)

    @property
    def nphantom(self) -> np.ndarray:
        return np.array([len(c) for c in self.phantom], dtype=int)

    def total_nlive(self) -> int:
        return int(sum(c.shape[0] for c in self.live))

    def all_live(self) -> np.ndarray:
        return (
            np.concatenate(self.live, axis=0)
            if self.live
            else np.zeros((0, self.settings.nTotal))
        )

    def dead_array(self) -> np.ndarray:
        return (
            np.stack(self.dead)
            if self.dead
            else np.zeros((0, self.settings.nTotal))
        )

    def snapshot(self) -> "RunTimeInfo":
        """Cheap point-in-time copy for the write-behind file products
        (utils/writebehind.py).  ``copy.deepcopy`` walks every dead-point
        row (O(ndead) python objects) and late in a long run the deepcopy
        on the critical path approaches the formatting cost the write-behind
        thread was added to remove (ADVICE r4).  Policy by field type:

        * append-only row lists (``dead``, ``logweights``, ``*_dead``):
          shallow list copy — rows are immutable after append (every
          appender stores a fresh array; delete_outermost copies, DOA
          babies are copied at append);
        * RowStore: memcpy of the live rows (``replace``/``clear`` mutate
          rows in place, so buffer sharing would race the admin thread);
        * numpy arrays: ``.copy()``;
        * settings (immutable after finalise), scalars, the host RNG
          reference (the caller snapshots it separately): shared.
        """
        snap = RunTimeInfo.__new__(RunTimeInfo)
        for name, val in vars(self).items():
            if name == "settings" or name == "_rng":
                out = val
            elif isinstance(val, RowStore):
                out = RowStore(val.ncols, data=val.copy_array())
            elif isinstance(val, np.ndarray):
                out = val.copy()
            elif isinstance(val, list):
                if val and isinstance(val[0], RowStore):
                    out = [RowStore(r.ncols, data=r.copy_array()) for r in val]
                elif val and isinstance(val[0], np.ndarray) and name == "live":
                    out = [a.copy() for a in val]
                else:
                    out = list(val)  # shallow: append-only immutable rows
            else:
                out = val  # scalars / None
            setattr(snap, name, out)
        return snap


# ----------------------------------------------------------------------
# Evidence recurrences
# ----------------------------------------------------------------------


from ..ops.logspace import LOG_ZERO


def _laddexp(a: float, b: float) -> float:
    """Scalar logaddexp with LOG_ZERO short-circuits (utils.F90:376-402).

    Pure ``math`` version: ``update_evidence`` runs once per dead point on
    the host administrator hot path and numpy-scalar dispatch overhead was
    measured to dominate it."""
    if a < b:
        a, b = b, a
    if a <= LOG_ZERO:
        return LOG_ZERO
    if b <= LOG_ZERO:
        return a
    return a + math.log1p(math.exp(b - a))


def update_evidence(rti: RunTimeInfo, p: int) -> float:
    """Delete the lowest point of cluster p from the evidence bookkeeping.

    Exact port of the log-domain recurrences in run_time_info.f90:211-296:
    with n = nlive(p) live points and logL the cluster's minimum
    loglikelihood, the deleted point carries weight X_p/(n+1) and the
    volume contracts by n/(n+1).  Returns the logweight of the deleted
    point (excluding its likelihood factor).
    """
    log2 = math.log(2.0)
    logL = float(rti.logLp[p])
    n = rti.live[p].shape[0]
    lognp = math.log(n)
    lognp1 = math.log(n + 1.0)
    lognp2 = math.log(n + 2.0)
    ncl = rti.ncluster

    logXp_p = float(rti.logXp[p])
    logXpXq_pp = float(rti.logXpXq[p, p])
    logweight = logXp_p - lognp1

    # global and local evidence means
    rti.logZ = _laddexp(float(rti.logZ), logXp_p + logL - lognp1)
    rti.logZp[p] = _laddexp(float(rti.logZp[p]), logXp_p + logL - lognp1)
    # local volume contraction
    rti.logXp[p] = logXp_p + lognp - lognp1

    # global evidence second moment
    rti.logZ2 = _laddexp(
        _laddexp(float(rti.logZ2), log2 + float(rti.logZXp[p]) + logL - lognp1),
        log2 + logXpXq_pp + 2 * logL - lognp1 - lognp2,
    )

    # global evidence-volume cross correlation, q = p
    rti.logZXp[p] = _laddexp(
        float(rti.logZXp[p]) + lognp - lognp1,
        logXpXq_pp + logL + lognp - lognp1 - lognp2,
    )
    # ... and q != p (vectorised over clusters)
    if ncl > 1:
        others = np.arange(ncl) != p
        rti.logZXp[others] = logaddexp(
            np, rti.logZXp[others], rti.logXpXq[p, others] + logL - lognp1
        )

    # local evidence second moment
    rti.logZp2[p] = _laddexp(
        _laddexp(float(rti.logZp2[p]), log2 + float(rti.logZpXp[p]) + logL - lognp1),
        log2 + logXpXq_pp + 2 * logL - lognp1 - lognp2,
    )

    # local evidence-volume cross correlation
    rti.logZpXp[p] = _laddexp(
        float(rti.logZpXp[p]) + lognp - lognp1,
        logXpXq_pp + logL + lognp - lognp1 - lognp2,
    )

    # volume-volume cross correlations
    if ncl > 1:
        delta = lognp - lognp1
        rti.logXpXq[p, :] += delta
        rti.logXpXq[:, p] += delta
        rti.logXpXq[p, p] = logXpXq_pp + lognp - lognp2
    else:
        rti.logXpXq[p, p] += lognp - lognp2

    return float(logweight)


def calculate_logZ_estimate(rti: RunTimeInfo):
    """Unbiased log-normal estimates (run_time_info.f90:652-678):
    logZ = 2 log<Z> - 0.5 log<Z^2>, var = log<Z^2> - 2 log<Z>."""
    logZ = max(-HUGE, 2 * rti.logZ - 0.5 * rti.logZ2)
    varlogZ = rti.logZ2 - 2 * rti.logZ
    logZp = np.maximum(-HUGE, 2 * rti.logZp - 0.5 * rti.logZp2)
    varlogZp = rti.logZp2 - 2 * rti.logZp
    lzd = np.array(rti.logZp_dead)
    lzd2 = np.array(rti.logZp2_dead)
    logZp_dead = np.maximum(-HUGE, 2 * lzd - 0.5 * lzd2)
    varlogZp_dead = lzd2 - 2 * lzd
    return logZ, varlogZ, logZp, varlogZp, logZp_dead, varlogZp_dead


def live_logZ(rti: RunTimeInfo) -> float:
    """Evidence still held in the live points (run_time_info.f90:683-709).

    Called once per dead point by the termination rule — direct numpy
    (max + exp-sum) instead of the generic masked logsumexp wrapper, whose
    call overhead would be paid on every dead point."""
    s = rti.settings
    total = s.logzero
    for p in range(rti.ncluster):
        lp = rti.live[p]
        n = lp.shape[0]
        if n > 0:
            col = lp[:, s.l0]
            m = col.max()
            lse = (
                s.logzero if m <= s.logzero
                else m + math.log(np.exp(col - m).sum())
            )
            term = lse - math.log(n) + rti.logXp[p]
            if total <= s.logzero:
                total = term
            elif term > s.logzero:
                hi, lo = (total, term) if total >= term else (term, total)
                total = hi + math.log1p(math.exp(lo - hi))
    return float(total)


# ----------------------------------------------------------------------
# Point insertion / deletion
# ----------------------------------------------------------------------


def find_min_loglikelihoods(rti: RunTimeInfo, only: Optional[int] = None) -> None:
    """Per-cluster argmin of live logL (run_time_info.f90:883-909); empty
    clusters get logLp = +huge so they are never selected for deletion.
    ``only`` restricts the update to one cluster (insert/delete touch one)."""
    s = rti.settings
    clusters = range(rti.ncluster) if only is None else (only,)
    for p in clusters:
        if rti.live[p].shape[0] == 0:
            rti.i[p] = -1
            rti.logLp[p] = HUGE
        else:
            idx = int(np.argmin(rti.live[p][:, s.l0]))
            rti.i[p] = idx
            rti.logLp[p] = rti.live[p][idx, s.l0]


def identify_cluster(rti: RunTimeInfo, point: np.ndarray) -> int:
    """Voronoi assignment: cluster of the nearest live point in cube space
    (run_time_info.f90:913-949). Vectorised over all live points."""
    if rti.ncluster == 1:
        return 0
    return int(identify_clusters_batch(rti, point[None])[0])


def identify_clusters_batch(rti: RunTimeInfo, points: np.ndarray) -> np.ndarray:
    """Vectorised ``identify_cluster`` for a batch of points (rows); native
    C kernel when available (utils/native.py)."""
    if rti.ncluster == 1:
        return np.zeros(points.shape[0], dtype=int)
    s = rti.settings

    from ..utils import native

    if native.has_native():
        live_all = np.concatenate([c[:, s.h] for c in rti.live], axis=0)
        cluster_of_live = np.concatenate(
            [np.full(c.shape[0], p, dtype=np.int32) for p, c in enumerate(rti.live)]
        )
        if live_all.shape[0]:
            out = native.identify_clusters(
                points[:, s.h], live_all, cluster_of_live
            )
            if out is not None:
                return out

    x = points[:, s.h]
    best_d = np.full(points.shape[0], np.inf)
    best_c = np.zeros(points.shape[0], dtype=int)
    for p in range(rti.ncluster):
        lp = rti.live[p]
        if lp.shape[0] == 0:
            continue
        sq = np.einsum("ij,ij->i", lp[:, s.h], lp[:, s.h])
        d = np.min(
            sq[None, :] - 2.0 * x @ lp[:, s.h].T, axis=1
        ) + np.einsum("ij,ij->i", x, x)
        closer = d < best_d
        best_d = np.where(closer, d, best_d)
        best_c = np.where(closer, p, best_c)
    return best_c


def _posterior_point(
    s: PolyChordSettings,
    point: np.ndarray,
    logweight: float,
    evidence: float,
    volume: float,
) -> np.ndarray:
    """[X, logL, w, Z, theta, phi] (calculate.f90:53-79)."""
    pp = np.empty(s.nposterior)
    pp[s.pos_X] = volume
    pp[s.pos_l] = point[s.l0]
    pp[s.pos_w] = logweight
    pp[s.pos_Z] = evidence
    pp[s.pos_pd] = point[s.pd]
    return pp


def delete_outermost_point(rti: RunTimeInfo) -> None:
    """Delete the globally lowest live point: evidence update, dead-point
    record, posterior-stack push (run_time_info.f90:789-817)."""
    s = rti.settings
    p = int(np.argmin(rti.logLp[: rti.ncluster]))
    logweight = update_evidence(rti, p)
    idx = int(rti.i[p])
    lp = rti.live[p]
    deleted = lp[idx].copy()
    # swap-with-last removal, as the reference's delete_point
    # (array_utils.f90:433-463) — O(nTotal), no reallocation
    lp[idx] = lp[-1]
    rti.live[p] = lp[:-1]
    find_min_loglikelihoods(rti, only=p)
    rti.dead.append(deleted)
    rti.ndead += 1
    rti.logweights.append(logweight)

    pp = _posterior_point(
        s, deleted, logweight, rti.logZ, logsumexp_small(rti.logXp)
    )
    rti.posterior_stack[p].append(pp)
    w = pp[s.pos_w] + pp[s.pos_l]
    rti.maxlogweight[p] = max(rti.maxlogweight[p], w)
    rti.maxlogweight_global = max(rti.maxlogweight_global, rti.maxlogweight[p])


def append_phantoms_batch(
    rti: RunTimeInfo, pts: np.ndarray, cluster_add: np.ndarray
) -> None:
    """Vectorised phantom insertion for a chunk of candidate points.

    Same acceptance rule as the per-point path in ``replace_point``
    (run_time_info.f90:716-787): above the current global contour AND in the
    Voronoi cell of the cluster the chain was seeded from — but with ONE
    ``identify_clusters_batch`` call for the whole chunk instead of a Python
    loop (the chunk is consumed against a single contour snapshot, which the
    reference's async mode licenses, nested_sampling.F90:288-313)."""
    if pts.shape[0] == 0:
        return
    s = rti.settings
    logL = float(np.min(rti.logLp[: rti.ncluster]))
    above = pts[:, s.l0] > logL
    if not above.any():
        return
    pts, cluster_add = pts[above], cluster_add[above]
    assign = identify_clusters_batch(rti, pts)
    ok = assign == cluster_add
    if not ok.any():
        return
    pts, assign = pts[ok], assign[ok]
    for j in np.unique(assign):
        rti.phantom[int(j)].extend(pts[assign == j])


def try_replace_live(
    rti: RunTimeInfo, pt: np.ndarray, cluster_add: int, in_cell: bool
) -> Optional[bool]:
    """Live-candidate half of ``replace_point`` with the Voronoi membership
    test precomputed (``in_cell``).  Returns True if a live point was
    replaced, False if the spawn failed, None if the candidate was dead on
    arrival (recorded with zero weight, run_time_info.f90:781-785)."""
    s = rti.settings
    logL = float(np.min(rti.logLp[: rti.ncluster]))
    if pt[s.l0] > logL:
        if in_cell:
            nlive_target = s.nlive_at(logL)
            if rti.total_nlive() >= max(nlive_target, 1):
                delete_outermost_point(rti)
                if rti.total_nlive() < nlive_target:
                    rti.live[cluster_add] = np.vstack(
                        [rti.live[cluster_add], pt]
                    )
                    find_min_loglikelihoods(rti, only=cluster_add)
                return True
            if rti.total_nlive() < nlive_target:
                rti.live[cluster_add] = np.vstack([rti.live[cluster_add], pt])
                find_min_loglikelihoods(rti, only=cluster_add)
            return False
        return False
    rti.dead.append(pt.copy())
    rti.ndead += 1
    rti.logweights.append(s.logzero)
    return None


def replace_point(
    rti: RunTimeInfo, baby_points: np.ndarray, cluster_add: int
) -> bool:
    """Try to insert a freshly generated chain into the live points
    (run_time_info.f90:716-787).

    ``baby_points`` is (R, nTotal); the first R-1 rows become phantom
    candidates, the last row the live-point candidate.  A candidate is
    accepted iff it is (1) above the *current* global contour min(logLp) and
    (2) in the Voronoi cell of ``cluster_add``.  Respects the variable-nlive
    schedule.  Returns True iff a live point was replaced.
    """
    s = rti.settings
    logL = float(np.min(rti.logLp[: rti.ncluster]))

    # phantom candidates
    for i in range(baby_points.shape[0] - 1):
        pt = baby_points[i]
        if pt[s.l0] > logL:
            if identify_cluster(rti, pt) == cluster_add:
                rti.phantom[cluster_add].append(pt)

    # live-point candidate
    pt = baby_points[-1].copy()
    replaced = False
    if pt[s.l0] > logL:
        if identify_cluster(rti, pt) == cluster_add:
            nlive_target = s.nlive_at(logL)
            if rti.total_nlive() >= max(nlive_target, 1):
                delete_outermost_point(rti)
                replaced = True
            if rti.total_nlive() < nlive_target:
                rti.live[cluster_add] = np.vstack([rti.live[cluster_add], pt])
                find_min_loglikelihoods(rti)
    else:
        # dead on arrival: recorded with zero weight
        # (run_time_info.f90:781-785); copy so the record does not pin the
        # epoch's whole babies buffer and stays immutable (snapshot contract)
        rti.dead.append(pt.copy())
        rti.ndead += 1
        rti.logweights.append(s.logzero)
    return replaced


# ----------------------------------------------------------------------
# Cluster management
# ----------------------------------------------------------------------


def add_cluster(
    rti: RunTimeInfo, p: int, cluster_list: np.ndarray, num_new: int
) -> None:
    """Split cluster p into ``num_new`` clusters (run_time_info.f90:303-505).

    New clusters are appended after the surviving old ones; volumes and all
    evidence cross-correlations are partitioned in proportion to the number
    of live+phantom points n_i each sub-cluster receives:
        <X_i>     = <X_p> n_i / n
        <X_i X_j> = <X_p^2> n_i n_j / n(n+1)            (i != j)
        <X_i^2>   = <X_p^2> n_i (n_i+1) / n(n+1)
    and similarly for Z-cross terms (:458-494).
    """
    s = rti.settings
    old_live = rti.live[p]
    old_posterior = rti.posterior[p].copy_array()
    old_equals = rti.equals[p].copy_array()
    old_maxlogweight = rti.maxlogweight[p]
    all_old_phantoms = [ph.copy_array() for ph in rti.phantom]

    logXp = rti.logXp[p]
    logXp2 = rti.logXpXq[p, p]
    logZp = rti.logZp[p]
    logZp2 = rti.logZp2[p]
    logZXp = rti.logZXp[p]
    logZpXp = rti.logZpXp[p]
    old_idx = [q for q in range(rti.ncluster) if q != p]
    logXpXq_row = rti.logXpXq[p, old_idx]

    n_old = len(old_idx)
    n_total = n_old + num_new

    # --- rebuild per-cluster stores: survivors first, then the new ones ----
    def reorder(lst, new_value_fn):
        return [lst[q] for q in old_idx] + [new_value_fn(k) for k in range(num_new)]

    rti.live = reorder(rti.live, lambda k: old_live[cluster_list == k])
    # EVERY phantom store starts empty: the reference zeroes nphantom for
    # ALL clusters and reassigns every old phantom exactly once
    # (run_time_info.f90:445-451).  Keeping survivors' stores and then
    # re-extending from all_old_phantoms duplicated the survivors'
    # phantoms on every split — compounding to millions of phantoms on
    # fragmenting geometries (shells benchmark: nphantom hit 1.1e8) and
    # skewing the n_i volume-split proportions below.
    rti.phantom = [RowStore(s.nTotal) for _ in range(n_total)]
    rti.posterior_stack = reorder(
        rti.posterior_stack, lambda k: RowStore(s.nposterior)
    )
    # posterior/equals of the split cluster are duplicated into every child
    # (run_time_info.f90:433-441)
    rti.posterior = reorder(
        rti.posterior, lambda k: RowStore(s.nposterior, old_posterior)
    )
    rti.equals = reorder(rti.equals, lambda k: RowStore(s.np_, old_equals))

    rti.covmat = np.concatenate(
        [rti.covmat[old_idx], np.repeat(rti.covmat[p][None], num_new, axis=0)]
    )
    rti.cholesky = np.concatenate(
        [rti.cholesky[old_idx], np.repeat(rti.cholesky[p][None], num_new, axis=0)]
    )

    def expand(vec, fill):
        return np.concatenate([vec[old_idx], np.full(num_new, fill)])

    rti.logLp = expand(rti.logLp, HUGE)
    rti.i = np.concatenate([rti.i[old_idx], np.full(num_new, -1, dtype=int)])
    rti.maxlogweight = expand(rti.maxlogweight, old_maxlogweight)

    find_min_loglikelihoods(rti)

    # --- reassign ALL phantom points by Voronoi over the new live partition,
    # dropping those below their new cluster's contour (:444-453) ----------
    for ph in all_old_phantoms:
        if ph.shape[0] == 0:
            continue
        js = identify_clusters_batch(rti, ph)
        for j in range(rti.ncluster):
            sel = (js == j) & (ph[:, s.l0] > rti.logLp[j])
            if sel.any():
                rti.phantom[j].extend(ph[sel])

    # --- split the evidence bookkeeping (:458-494) -------------------------
    new_sl = slice(n_old, n_total)
    counts = np.array(
        [
            rti.live[n_old + k].shape[0] + len(rti.phantom[n_old + k])
            for k in range(num_new)
        ],
        dtype=float,
    )
    logni = np.log(np.maximum(counts, 1e-300))
    logni1 = np.log(counts + 1.0)
    logn = logsumexp(np, logni)
    logn1 = logaddexp(np, logn, 0.0)

    logXp_new = logXp + logni - logn
    logZXp_new = logZXp + logni - logn
    logZp_new = logZp + logni - logn
    logZp2_new = logZp2 + logni + logni1 - logn - logn1
    logZpXp_new = logZpXp + logni + logni1 - logn - logn1

    rti.logXp = np.concatenate([rti.logXp[old_idx], logXp_new])
    rti.logZXp = np.concatenate([rti.logZXp[old_idx], logZXp_new])
    rti.logZp = np.concatenate([rti.logZp[old_idx], logZp_new])
    rti.logZp2 = np.concatenate([rti.logZp2[old_idx], logZp2_new])
    rti.logZpXp = np.concatenate([rti.logZpXp[old_idx], logZpXp_new])

    new_XpXq = np.empty((n_total, n_total))
    new_XpXq[:n_old, :n_old] = rti.logXpXq[np.ix_(old_idx, old_idx)]
    cross = logXpXq_row[None, :] + logni[:, None] - logn  # (num_new, n_old)
    new_XpXq[new_sl, :n_old] = cross
    new_XpXq[:n_old, new_sl] = cross.T
    block = logXp2 + logni[:, None] + logni[None, :] - logn - logn1
    np.fill_diagonal(block, logXp2 + logni + logni1 - logn - logn1)
    new_XpXq[new_sl, new_sl] = block
    rti.logXpXq = new_XpXq

    # reduce the logweighting of the duplicated posterior points by the
    # evidence split factor (:499-503; literal reference behaviour — the
    # adjustment lands on the logL column of `posterior` / the -2logL column
    # of `equals`)
    for k in range(num_new):
        c = n_old + k
        delta = rti.logZp[c] - logZp
        if len(rti.equals[c]):
            rti.equals[c].data[:, s.p_2l] += delta
        if len(rti.posterior[c]):
            rti.posterior[c].data[:, s.pos_l] += delta

    rti.epoch += 1


def delete_cluster(rti: RunTimeInfo) -> bool:
    """Retire one empty cluster to the dead-cluster stores
    (run_time_info.f90:507-598). Returns True if a cluster was deleted."""
    s = rti.settings
    nlives = rti.nlive
    if not (nlives == 0).any():
        return False

    update_posteriors(rti)

    p = int(np.flatnonzero(nlives == 0)[0])

    rti.posterior_dead.append(rti.posterior[p].copy_array())
    rti.equals_dead.append(rti.equals[p].copy_array())
    rti.logZp_dead.append(float(rti.logZp[p]))
    rti.logZp2_dead.append(float(rti.logZp2[p]))
    rti.maxlogweight_dead.append(float(rti.maxlogweight[p]))

    keep = [q for q in range(rti.ncluster) if q != p]
    for name in ("live", "phantom", "posterior_stack", "posterior", "equals"):
        setattr(rti, name, [getattr(rti, name)[q] for q in keep])
    rti.covmat = rti.covmat[keep]
    rti.cholesky = rti.cholesky[keep]
    for name in ("logXp", "logZXp", "logZp", "logZp2", "logZpXp", "logLp", "i",
                 "maxlogweight"):
        setattr(rti, name, getattr(rti, name)[keep])
    rti.logXpXq = rti.logXpXq[np.ix_(keep, keep)]

    rti.epoch += 1
    return True


def calculate_covmats(rti: RunTimeInfo) -> None:
    """Per-cluster covariance over live+phantom points and its Cholesky
    (run_time_info.f90:601-641)."""
    s = rti.settings
    for p in range(rti.ncluster):
        pts = np.vstack([rti.live[p][:, s.h], rti.phantom[p].data[:, s.h]])
        if pts.shape[0] == 0:
            continue
        rti.covmat[p] = calc_covmat_np(pts)
        rti.cholesky[p] = calc_cholesky_np(rti.covmat[p])


# ----------------------------------------------------------------------
# Posterior machinery
# ----------------------------------------------------------------------


def clean_phantoms(rti: RunTimeInfo, rng: np.random.Generator) -> None:
    """Convert phantoms that have fallen below a recorded posterior-stack
    contour into (thinned) posterior samples (run_time_info.f90:820-877)."""
    s = rti.settings
    for p in range(rti.ncluster):
        stack = rti.posterior_stack[p].data
        n_stack0 = stack.shape[0]  # only match against pre-existing entries
        ph = rti.phantom[p].data
        if ph.shape[0] == 0 or n_stack0 == 0:
            continue
        # A phantom "dies" when some recorded dead contour exceeds its logL;
        # it inherits the weight of the stack entry with the smallest such
        # contour.  Vectorised via a sort + searchsorted.
        order = np.argsort(stack[:n_stack0, s.pos_l], kind="stable")
        sorted_logL = stack[order, s.pos_l]
        idx = np.searchsorted(sorted_logL, ph[:, s.l0], side="right")
        dies = idx < n_stack0
        keep = ~dies
        if dies.any():
            j = order[np.minimum(idx, n_stack0 - 1)]
            take = dies
            if s.equals or s.posteriors:
                thin = rng.random(ph.shape[0]) < rti.thin_posterior
                take = dies & thin
                if take.any():
                    src = j[take]
                    pts = ph[take]
                    rows = np.empty((pts.shape[0], s.nposterior))
                    rows[:, s.pos_X] = stack[src, s.pos_X]
                    rows[:, s.pos_l] = pts[:, s.l0]
                    rows[:, s.pos_w] = stack[src, s.pos_w]
                    rows[:, s.pos_Z] = stack[src, s.pos_Z]
                    rows[:, s.pos_pd] = pts[:, s.pd]
                    rti.posterior_stack[p].extend(rows)
                    w = float(np.max(rows[:, s.pos_w] + rows[:, s.pos_l]))
                    rti.maxlogweight[p] = max(rti.maxlogweight[p], w)
                    rti.maxlogweight_global = max(
                        rti.maxlogweight_global, rti.maxlogweight[p]
                    )
            rti.phantom[p].replace(ph[keep])


def update_posteriors(rti: RunTimeInfo, rng: Optional[np.random.Generator] = None) -> None:
    """Flush the posterior stacks into the weighted/equal-weight posterior
    arrays with rejection resampling against the running max weight
    (run_time_info.f90:955-1066)."""
    s = rti.settings
    if rng is None:
        rng = rti_rng(rti)

    clean_phantoms(rti, rng)

    def _restrip(store: RowStore, maxw: float) -> None:
        """Rejection-resample an equal-weight store against a new max weight
        (run_time_info.f90:975-1025)."""
        eq = store.data
        if not eq.shape[0]:
            return
        w = eq[:, s.p_w]
        auto = w >= maxw
        acc = rng.random(eq.shape[0]) < np.exp(np.minimum(w - maxw, 0.0))
        out = eq[auto | acc]
        out[:, s.p_w] = np.maximum(out[:, s.p_w], maxw)
        store.replace(out)

    if s.equals:
        _restrip(rti.equals_global, rti.maxlogweight_global)
        if s.cluster_posteriors:
            for p in range(rti.ncluster):
                _restrip(rti.equals[p], rti.maxlogweight[p])

    # drain the stacks (vectorised; run_time_info.f90:1028-1064)
    for p in range(rti.ncluster):
        stack = rti.posterior_stack[p].data
        if stack.shape[0] == 0:
            continue
        if s.equals:
            logw = stack[:, s.pos_w] + stack[:, s.pos_l]

            def _equal_rows(maxw):
                acc = rng.random(stack.shape[0]) < np.exp(
                    np.minimum(logw - maxw, 0.0)
                )
                rows = np.empty((int(acc.sum()), s.np_))
                rows[:, s.p_w] = maxw
                rows[:, s.p_2l] = -2 * stack[acc, s.pos_l]
                rows[:, s.p_pd] = stack[acc][:, s.pos_pd]
                return rows

            rti.equals_global.extend(_equal_rows(rti.maxlogweight_global))
            if s.cluster_posteriors:
                rti.equals[p].extend(_equal_rows(rti.maxlogweight[p]))
        if s.posteriors:
            rti.posterior_global.extend(stack)
            if s.cluster_posteriors:
                rti.posterior[p].extend(stack)
        rti.posterior_stack[p].clear()


def rti_rng(rti: RunTimeInfo) -> np.random.Generator:
    """Host RNG attached lazily to the state (seeded by the driver)."""
    if not hasattr(rti, "_rng"):
        rti._rng = np.random.default_rng(0)
    return rti._rng
