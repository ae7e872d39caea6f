"""Structured run metrics — the observability subsystem (SURVEY §5.1/§5.5).

The reference's cost accounting is scattered over console feedback and the
``.stats`` file: per-worker wait/slice efficiency printed at exit
(``src/polychord/nested_sampling.F90:468-498``), and <nlike> per iteration /
per slice in ``.stats`` (``src/polychord/read_write.F90:880-889``).  Here the
same quantities — plus throughput — are emitted as one JSON line per
compression e-fold to ``<base_dir>/<file_root>.metrics.jsonl``, so a run can
be monitored programmatically (the structured analogue of watching
``_phys_live.txt``, README.rst:315-330).

Fields per record:
  t          seconds since run start
  ndead, nlive, ncluster, logZ, logZerr
  nlike      cumulative likelihood evaluations (all grades)
  evals_per_s, dead_per_s       since the previous record
  device_frac                   fraction of wall time inside device epochs —
                                the single-controller analogue of the
                                reference's worker slice_time/(wait+slice)
  epochs     device epoch calls so far
"""

from __future__ import annotations

import json
import math
import os
import time
from contextlib import contextmanager


class RunMetrics:
    """Accumulates phase timers and appends jsonl records.

    Cheap when disabled (``path=None``): every method is a no-op except the
    timer bookkeeping, which is a few floats.
    """

    def __init__(self, path=None, resume: bool = False):
        self.path = path
        self.t_start = time.time()
        self.device_time = 0.0
        self.epochs = 0
        self._last_t = self.t_start
        self._last_nlike = 0
        self._last_ndead = 0
        self._phase_tot = {}   # cumulative seconds per named host phase
        self._phase_last = {}  # snapshot at the previous record
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if not resume or not os.path.exists(path):
                with open(path, "w"):
                    pass  # truncate: a fresh run restarts the stream

    @contextmanager
    def device_epoch(self):
        """Time one device epoch call (the device compute phase)."""
        t0 = time.time()
        try:
            yield
        finally:
            self.device_time += time.time() - t0
            self.epochs += 1

    @contextmanager
    def phase(self, name: str):
        """Accumulate wall time of a named host phase (file writes, the
        per-baby insertion loop, clustering, ...); per-record deltas are
        published as ``host_breakdown`` so the administrator's cost
        structure is observable per e-fold — the VERDICT r3 item-7
        instrument."""
        t0 = time.time()
        try:
            yield
        finally:
            self._phase_tot[name] = (
                self._phase_tot.get(name, 0.0) + time.time() - t0
            )

    def record(self, *, ndead, nlive, ncluster, logZ, varlogZ, nlike,
               engine=None, extra=None):
        now = time.time()
        dt = max(now - self._last_t, 1e-12)
        wall = max(now - self.t_start, 1e-12)
        rec = {
            "t": round(wall, 3),
            "ndead": int(ndead),
            "nlive": int(nlive),
            "ncluster": int(ncluster),
            "logZ": float(logZ),
            "logZerr": float(math.sqrt(abs(varlogZ))),
            "nlike": int(nlike),
            "evals_per_s": round((int(nlike) - self._last_nlike) / dt, 1),
            "dead_per_s": round((int(ndead) - self._last_ndead) / dt, 1),
            "device_frac": round(self.device_time / wall, 4),
            "epochs": self.epochs,
            "host_breakdown": {
                k: round(v - self._phase_last.get(k, 0.0), 4)
                for k, v in self._phase_tot.items()
            },
        }
        if engine is not None:
            # which engine actually executed the epochs since the last
            # record — a demotion mid-run shows up here (VERDICT r4 weak-3)
            rec["engine"] = engine
        if extra:
            rec.update(extra)
        self._phase_last = dict(self._phase_tot)
        self._last_t = now
        self._last_nlike = int(nlike)
        self._last_ndead = int(ndead)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def summary(self, *, ndead, nlike) -> dict:
        wall = max(time.time() - self.t_start, 1e-12)
        return {
            "wall_s": round(wall, 2),
            "device_frac": round(self.device_time / wall, 4),
            "epochs": self.epochs,
            "evals_per_s": round(int(nlike) / wall, 1),
            "dead_per_s": round(int(ndead) / wall, 1),
        }
