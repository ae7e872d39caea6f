"""Run configuration.

ONE config dataclass with the Python-surface defaults (the reference keeps
three divergent default sets — Fortran ``settings.f90:13-147``, C++
``c_interface.cpp:6-39``, Python ``polychord.py:522-558``; SURVEY §5.6 calls
for unifying on the Python layer's).  Also computes the point-array index
layout (``settings.f90:156-239``).
"""

from __future__ import annotations

import math
from dataclasses import MISSING, dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .ops.logspace import LOG_ZERO


@dataclass
class PolyChordSettings:
    """All options of a nested-sampling run.

    Mirrors ``pypolychord.settings.PolyChordSettings`` (settings.py:176-218)
    attribute-for-attribute, with the Python-layer defaults, plus engine
    extras (``batch_size``, ``chain_epochs``, ``engine``).
    """

    nDims: int = 1
    nDerived: int = 0
    nlive: int = 500
    num_repeats: int = -1  # default 5*nDims, resolved in finalise()
    nprior: int = -1  # default nlive
    nfail: int = -1  # default nlive
    do_clustering: bool = True
    feedback: int = 1
    precision_criterion: float = 0.001
    logzero: float = LOG_ZERO
    max_ndead: int = -1
    boost_posterior: float = 0.0
    posteriors: bool = True
    equals: bool = True
    cluster_posteriors: bool = True
    write_resume: bool = True
    write_paramnames: bool = False
    read_resume: bool = True
    write_stats: bool = True
    write_live: bool = True
    write_dead: bool = True
    write_prior: bool = True
    maximise: bool = False
    compression_factor: float = math.exp(-1.0)
    #: True (reference default, nested_sampling.F90:262-287): one nursery in
    #: flight — seeds are drawn from the *current* state and the device epoch
    #: completes before consumption, so babies are at most one nursery stale.
    #: False: dispatch-ahead async overlap (epoch k+1 enqueued before k is
    #: consumed, the reference's async mode :288-313) — host and device
    #: overlap, babies up to two nurseries stale.  Not ported yet (raises).
    synchronous: bool = True
    base_dir: str = "chains"
    file_root: str = "test"
    cluster_dir: str = "clusters"
    seed: int = -1
    grade_dims: Optional[List[int]] = None
    grade_frac: Optional[List[float]] = None
    nlives: Dict[float, int] = field(default_factory=dict)
    #: accepted (and ini-parsed, ini.f90:83) for settings parity; the
    #: reference allocates it in settings.f90:52 but no code consumes it —
    #: it is dead upstream too, so it is deliberately unused here.
    seed_point: Optional[Sequence[float]] = None
    cube_samples: Optional[np.ndarray] = None
    sub_clustering_dimensions: Optional[List[int]] = None

    # --- engine extras -----------------------------------------------------
    #: chains generated per device epoch (the nursery width; generalises the
    #: reference's synchronous nprocs-1, nested_sampling.F90:262-287).
    #: <=0 -> auto (max(32, nlive) rounded up to a multiple of 8).
    batch_size: int = -1
    #: device epochs chained per dispatch with an on-device live-set
    #: consume loop (ops/chained_epoch.py) — cuts host<->device round
    #: trips by K in synchronous mode.  -1 -> auto (8 when eligible:
    #: synchronous, single device, torch likelihood, one cluster, no
    #: nlives schedule); 0/1 -> off; >1 -> force K.
    chain_epochs: int = -1
    #: number of local devices to shard the chain batch over (None: every
    #: card of a process alone; parallel/mesh.py).  A run is bitwise the
    #: same over any number of shards.
    mesh_shape: Optional[int] = None
    #: slice engine: "auto" (default — "cuda" on a CUDA device, the plain
    #: torch engine on the CPU), "cuda" (the v4 kernel: its functor for a
    #: model with a device form, its traced route for any other torch
    #: model), "cuda5" (the speculative-packet
    #: kernel, the JAX package's forced "pallas5"; decision-exact with
    #: "cuda"), "cuda3", "cuda2", "scan" (graded and host-callback models),
    #: "ring" (the JAX package's ring engine: "cuda"'s route under a budget
    #: of R x 12 micro-steps a lane, an epoch that overflows it re-run by
    #: the runner — bitwise "cuda" with chain_epochs=0 on the card, "torch"
    #: on the CPU; never chained) or "torch" (the plain engine, any device).
    engine: str = "auto"
    #: "single" (float32) or "highest" (float64 — reference precision,
    #: utils.F90:6; needed when |logL| exceeds ~1e6, see ops/precision.py:
    #: B1's fused and traced routes and B2 in double on the card, the plain
    #: engine anywhere).
    precision: str = "single"

    def __init__(self, nDims: int = 1, nDerived: int = 0, **kwargs):
        # dataclass-style init but with the two positional dims first, the
        # way PolyChordSettings(nDims, nDerived) is called in the reference
        # test-suite (tests/test_run_pypolychord.py:25).
        self.nDims = nDims
        self.nDerived = nDerived
        for f_ in self.__dataclass_fields__.values():
            if f_.name in ("nDims", "nDerived"):
                continue
            if f_.default is not MISSING:
                setattr(self, f_.name, f_.default)
            else:
                setattr(self, f_.name, f_.default_factory())
        # Python-surface defaults that depend on nDims
        self.nlive = 25 * nDims
        self.num_repeats = 5 * nDims
        for key, val in kwargs.items():
            if key not in self.__dataclass_fields__:
                raise TypeError(f"unknown setting {key!r}")
            setattr(self, key, val)

    # ------------------------------------------------------------------
    def finalise(self) -> "PolyChordSettings":
        """Resolve defaults and compute index layout
        (initialise_settings, settings.f90:156-239)."""
        if self.num_repeats < 1:
            raise ValueError("You need to set num_repeats. Suggestion: 5*nDims")
        if self.grade_dims is None:
            self.grade_dims = [self.nDims]
        self.grade_dims = [int(d) for d in self.grade_dims]
        if sum(self.grade_dims) != self.nDims:
            raise ValueError(
                f"grade_dims ({sum(self.grade_dims)}) must sum to "
                f"nDims ({self.nDims})"
            )
        if self.grade_frac is None:
            self.grade_frac = [1.0] * len(self.grade_dims)
        # sorted variable-nlive schedule (settings.f90:228-236)
        items = sorted(
            (float(logL), int(n)) for logL, n in (self.nlives or {}).items()
        )
        if items:
            self._loglikes = np.array([x[0] for x in items])
            self._nlives = np.array([x[1] for x in items], dtype=int)
        else:
            self._loglikes = np.array([self.logzero])
            self._nlives = np.array([self.nlive], dtype=int)
        return self

    # --- point-array layout (0-based python slices) ------------------------
    @property
    def nTotal(self) -> int:
        return 2 * self.nDims + self.nDerived + 2

    @property
    def h(self) -> slice:  # hypercube coords
        return slice(0, self.nDims)

    @property
    def p(self) -> slice:  # physical coords
        return slice(self.nDims, 2 * self.nDims)

    @property
    def d(self) -> slice:  # derived params
        return slice(2 * self.nDims, 2 * self.nDims + self.nDerived)

    @property
    def pd(self) -> slice:  # physical + derived (common output block)
        return slice(self.nDims, 2 * self.nDims + self.nDerived)

    @property
    def b0(self) -> int:  # birth contour
        return 2 * self.nDims + self.nDerived

    @property
    def l0(self) -> int:  # loglikelihood
        return 2 * self.nDims + self.nDerived + 1

    # --- posterior-stack layout: [X, logL, w, Z, theta, phi] ---------------
    @property
    def nposterior(self) -> int:
        return 4 + self.nDims + self.nDerived

    pos_X = 0
    pos_l = 1
    pos_w = 2
    pos_Z = 3

    @property
    def pos_p(self) -> slice:
        return slice(4, 4 + self.nDims)

    @property
    def pos_pd(self) -> slice:
        return slice(4, 4 + self.nDims + self.nDerived)

    # --- equals layout: [w, -2logL, theta, phi] ----------------------------
    @property
    def np_(self) -> int:
        return 2 + self.nDims + self.nDerived

    p_w = 0
    p_2l = 1

    @property
    def p_pd(self) -> slice:
        return slice(2, 2 + self.nDims + self.nDerived)

    # ------------------------------------------------------------------
    @property
    def cluster_dir_path(self) -> str:
        import os

        return os.path.join(self.base_dir, self.cluster_dir)

    def nlive_at(self, logL: float) -> int:
        """Target nlive for the contour logL from the nlives schedule
        (replace_point, run_time_info.f90:766-771)."""
        idx = np.searchsorted(self._loglikes, logL, side="left") - 1
        if idx < 0:
            return self.nlive
        return int(self._nlives[idx])

    def resolved_nprior(self) -> int:
        return self.nlive if self.nprior <= 0 else self.nprior

    def resolved_nfail(self) -> int:
        return self.nlive if self.nfail <= 0 else self.nfail

    def resolved_batch_size(self) -> int:
        """Chain-batch width B per device epoch.

        Default B = nlive in both modes: one volume e-fold of deletions
        per epoch, the largest batch that keeps nursery staleness (and
        hence the dead-on-arrival fraction) modest.  Smaller batches leave
        the device underfed; B=5*nlive biases logZ by >2 sigma — staleness
        outruns the slice chains' mixing.

        Calibration of the JAX package's sampler (64 seeds/config,
        benchmarks/calibration_study.json): synchronous mode is
        unbiased at both widths (mean pull −0.009 ± 0.141 at B=nlive,
        +0.036 ± 0.135 at B=nlive/4); asynchronous (dispatch-ahead) mode
        carries a small WIDTH-INDEPENDENT positive bias (+0.246 ± 0.110
        at B=nlive, +0.324 ± 0.115 at B=nlive/4; logZ bias +0.04 to
        +0.06 ≈ 0.3 sigma of a single run's error bar) from babies up to
        two nurseries stale.  An earlier study's B=nlive/4 async fence is
        therefore removed — shrinking B does not reduce the async bias,
        it only costs throughput.  Async runs warn once at start
        (core/nested_sampling.py)."""
        if self.batch_size > 0:
            b = self.batch_size
        else:
            b = max(32, self.nlive)
        return -(-b // 8) * 8  # round up to a multiple of 8 lanes


