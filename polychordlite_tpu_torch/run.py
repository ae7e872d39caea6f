"""Public entry points, API-compatible with ``pypolychord``
(counterpart of ``polychordlite_tpu/run.py``).

``run(loglikelihood, nDims, **kwargs)`` — the modern keyword interface with
the reference Python-layer defaults (pypolychord/polychord.py:221-646);
``run_polychord(loglikelihood, nDims, nDerived, settings, prior, dumper)`` —
the legacy settings-object interface (:16-215).

Differences from the reference (documented deviations):
* the likelihood may be a torch function of a ``(B, D)`` tensor or of one
  point ``(D,)`` (vmapped; both on the device, ``ops/evaluate.py``) or any
  plain Python/numpy callable of one point (host-callback compatibility
  path);
* ``batch_size`` controls the width of the device chain nursery (the analogue
  of the MPI process count; like nprocs in the reference, changing it changes
  the exact sample stream but not the statistics);
* ``device=`` picks the torch device: ``None`` means ``"cuda"``, and
  without a card the run raises; ``device="cpu"`` runs on the CPU.
  ``engine="auto"`` runs the CUDA slice kernel (``"cuda"``, the v4 kernel)
  on a CUDA device and the plain torch engine on the CPU; ``"cuda5"``
  (speculative packets, v5) and ``"cuda3"`` (v3's budget) force other
  kernels that make the same decisions, so the same run; ``"cuda2"`` forces
  the v2 kernel, which writes the cube itself (another chain, the same
  statistics); ``engine="torch"`` is the plain engine anywhere.  On a card
  ``"cuda"`` runs a torch model without a device form (no affine prior or
  no device functor) on the v4 kernel's traced route, bitwise the plain
  engine; the forced ``"cuda5"``, ``"cuda3"`` and ``"cuda2"`` raise for it.
  A host-callback model runs on ``"scan"`` on any device (on the card the
  host route: the v4 kernel's traced route driven round by round, the
  model called on the host between two launches), and every kernel engine
  raises for it, naming ``"scan"``.
"""

from __future__ import annotations

import math
from pathlib import Path

from .core.nested_sampling import (
    default_dumper,
    default_prior,
    nested_sampling,
)
from .output import PolyChordOutput
from .settings import PolyChordSettings


def run_polychord(
    loglikelihood,
    nDims: int,
    nDerived: int,
    settings: PolyChordSettings,
    prior=default_prior,
    dumper=default_dumper,
    device=None,
) -> PolyChordOutput:
    """Legacy interface (pypolychord/polychord.py:16-215): explicit settings
    object in, :class:`PolyChordOutput` out."""
    settings.nDims = nDims
    settings.nDerived = nDerived
    Path(settings.cluster_dir_path).mkdir(parents=True, exist_ok=True)
    nested_sampling(loglikelihood, prior, dumper, settings, device=device)
    return PolyChordOutput(settings.base_dir, settings.file_root)


def run(loglikelihood, nDims: int, device=None, **kwargs):
    """Modern interface (pypolychord/polychord.py:221-646).

    Returns an ``anesthetic.NestedSamples`` when anesthetic is installed,
    otherwise a :class:`PolyChordOutput` (the reference warns and returns
    None; returning the output object is strictly more useful).
    """
    paramnames = kwargs.pop("paramnames", None)

    default_kwargs = {
        "nDerived": 0,
        "prior": default_prior,
        "dumper": default_dumper,
        "nlive": nDims * 25,
        "num_repeats": nDims * 5,
        "nprior": -1,
        "nfail": -1,
        "do_clustering": True,
        "feedback": 1,
        "precision_criterion": 0.001,
        "logzero": -1e30,
        "max_ndead": -1,
        "boost_posterior": 0.0,
        "posteriors": True,
        "equals": True,
        "cluster_posteriors": True,
        "write_resume": True,
        "write_paramnames": False,
        "read_resume": True,
        "write_stats": True,
        "write_live": True,
        "write_dead": True,
        "write_prior": True,
        "maximise": False,
        "compression_factor": math.exp(-1),
        "synchronous": True,
        "base_dir": "chains",
        "file_root": "test",
        "cluster_dir": "clusters",
        "grade_dims": [nDims],
        "nlives": {},
        "seed": -1,
        "cube_samples": None,
        "sub_clustering_dimensions": None,
        "batch_size": -1,
        "engine": "auto",
        "chain_epochs": -1,
        "precision": "single",
    }
    default_kwargs["grade_frac"] = [1.0] * len(
        kwargs.get("grade_dims", default_kwargs["grade_dims"])
    )

    if not set(kwargs.keys()) <= set(default_kwargs.keys()):
        raise TypeError(
            f"{__name__} got unknown keyword arguments: "
            f"{set(kwargs.keys()) - set(default_kwargs.keys())}"
        )
    default_kwargs.update(kwargs)
    kw = default_kwargs

    kw["grade_dims"] = [int(d) for d in list(kw["grade_dims"])]
    if sum(kw["grade_dims"]) != nDims:
        raise ValueError(
            f"grade_dims ({sum(kw['grade_dims'])}) must sum to nDims ({nDims})"
        )
    kw["nlives"] = {float(l): int(n) for l, n in kw["nlives"].items()}

    prior = kw.pop("prior")
    dumper = kw.pop("dumper")

    settings = PolyChordSettings(nDims, kw.pop("nDerived"))
    for k, v in kw.items():
        setattr(settings, k, v)

    if paramnames is not None:
        PolyChordOutput.make_paramnames_file(
            paramnames,
            str(Path(kw["base_dir"]) / (kw["file_root"] + ".paramnames")),
        )

    Path(settings.cluster_dir_path).mkdir(parents=True, exist_ok=True)
    result = nested_sampling(loglikelihood, prior, dumper, settings, device=device)

    if not settings.write_stats:
        # with write_stats off there is no .stats to parse: return the
        # in-memory administrator result
        from types import SimpleNamespace

        return SimpleNamespace(
            logZ=result["logZ"],
            logZerr=result["logZerr"],
            ndead=result["ndead"],
            nlike=result["nlike"],
            metrics=result["metrics"],
        )

    try:
        import anesthetic
    except ImportError:
        return PolyChordOutput(settings.base_dir, settings.file_root)
    return anesthetic.read_chains(
        str(Path(settings.base_dir) / settings.file_root)
    )
