"""Checkpoint / resume.

The reference's ``run_time_info`` *is* the checkpoint ("This is what needs to
be saved in order to resume a run", run_time_info.f90:5-9), written every
compression e-fold, atomically (temp + rename, read_write.F90:97-123,219-288).

Native format here: a pickled dict of the full administrator state + host RNG
state + device key (``<root>.resume``), with the reference's dimension/grade
validation on read (read_write.F90:401-417).  ``cube_samples`` start points
are injected directly as an initial state rather than by forging a text
resume file (the reference's Python layer hand-writes the Fortran format,
pypolychord/polychord.py:650-789 — same capability, native path).

Port of ``polychordlite_tpu/utils/resume.py``.  The reader also reads a
checkpoint written by the JAX package: its pickle names that package's
classes (``RowStore``), which :class:`_PortUnpickler` maps to the port's
copies without importing the JAX package, and its ``key`` (a raw
uint32[2] threefry key) becomes the port's raw murmur key of the same
shape.  It also reads the reference's Fortran text format
(``utils/legacy_resume.py``), as the JAX package does: such a file carries
no host generator state or key, so the run goes on from its seed.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..core.rti import RunTimeInfo, find_min_loglikelihoods
from ..settings import PolyChordSettings

RESUME_VERSION = 1

_STATE_FIELDS = [
    "live",
    "phantom",
    "posterior_stack",
    "posterior",
    "equals",
    "posterior_global",
    "equals_global",
    "dead",
    "logweights",
    "covmat",
    "cholesky",
    "logZ",
    "logZ2",
    "logXp",
    "logX_last_update",
    "logZXp",
    "logZp",
    "logZp2",
    "logZpXp",
    "logXpXq",
    "logLp",
    "i",
    "maxlogweight",
    "maxlogweight_global",
    "posterior_dead",
    "equals_dead",
    "logZp_dead",
    "logZp2_dead",
    "maxlogweight_dead",
    "ndead",
    "nlike",
    "num_repeats",
    "thin_posterior",
    "epoch",
    "epoch_idx",
]


def resume_path(s: PolyChordSettings) -> str:
    return os.path.join(s.base_dir, s.file_root + ".resume")


def resume_file_exists(s: PolyChordSettings) -> bool:
    return os.path.exists(resume_path(s))


def write_resume_file(s: PolyChordSettings, rti: RunTimeInfo, rng, key) -> None:
    state = {f: getattr(rti, f) for f in _STATE_FIELDS}
    payload = {
        "version": RESUME_VERSION,
        "nDims": s.nDims,
        "nDerived": s.nDerived,
        "grade_dims": list(s.grade_dims),
        "state": state,
        "rng_state": rng.bit_generator.state,
        "key": np.asarray(key),
    }
    os.makedirs(s.base_dir, exist_ok=True)
    tmp = resume_path(s) + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, resume_path(s))


class _PortUnpickler(pickle.Unpickler):
    """Resolve the JAX package's classes to the port's copies."""

    _PREFIX = "polychordlite_tpu."

    def find_class(self, module, name):
        if module.startswith(self._PREFIX):
            module = "polychordlite_tpu_torch." + module[len(self._PREFIX):]
        return super().find_class(module, name)


def read_resume_file(s: PolyChordSettings, n_grades: int):
    """Returns (rti, rng_state, key). Halts on dimension/grade mismatch
    (read_write.F90:401-417 semantics).

    Reads the pickle checkpoints of this package and of the JAX package,
    and the reference's Fortran text format (rng_state and key None)."""
    path = resume_path(s)
    with open(path, "rb") as f:
        magic = f.read(1)
    if magic == b"=":  # legacy text format starts with '=== ... ==='
        from .legacy_resume import read_legacy_resume

        rti = read_legacy_resume(path, s, n_grades)
        return rti, None, None
    with open(path, "rb") as f:
        payload = _PortUnpickler(f).load()
    if payload["nDims"] != s.nDims or payload["nDerived"] != s.nDerived:
        raise ValueError(
            "resume file dimensions (%i,%i) do not match settings (%i,%i)"
            % (payload["nDims"], payload["nDerived"], s.nDims, s.nDerived)
        )
    if list(payload["grade_dims"]) != list(s.grade_dims):
        raise ValueError("resume file grade_dims do not match settings")
    rti = RunTimeInfo(s, n_grades)
    for fld, val in payload["state"].items():
        setattr(rti, fld, val)
    return rti, payload["rng_state"], payload["key"]


def rti_from_cube_samples(
    s: PolyChordSettings, cube_samples: np.ndarray, calc, n_grades: int,
    device=None,
) -> RunTimeInfo:
    """Build an initial state from user-supplied hypercube points (the
    ``cube_samples`` feature, pypolychord/polychord.py:576-579,650-789)."""
    cube = np.asarray(cube_samples, dtype=np.float64)
    theta, phi, logL = (
        t.cpu().numpy()
        for t in calc(torch.as_tensor(cube, dtype=calc.dtype, device=device))
    )
    rti = RunTimeInfo(s, n_grades)
    n = cube.shape[0]
    pts = np.zeros((n, s.nTotal))
    pts[:, s.h] = cube
    pts[:, s.p] = np.asarray(theta, dtype=np.float64)
    if s.nDerived:
        pts[:, s.d] = np.asarray(phi, dtype=np.float64)[:, : s.nDerived]
    pts[:, s.b0] = s.logzero
    pts[:, s.l0] = np.asarray(logL, dtype=np.float64)
    rti.live[0] = pts
    rti.nlike[0] = n
    find_min_loglikelihoods(rti)
    return rti
