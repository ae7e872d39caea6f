"""Ini-file configuration loader, compatible with the reference ``ini/``
suite (``src/polychord/ini.f90``).

Grammar: ``[section]`` headers are cosmetic; ``key = value`` settings;
``P : name | latex | speed | prior_type | block | params...`` parameter
lines (a ``*`` suffix on the name marks sub-clustering, ini.f90:376-394);
``D : name | latex`` derived-parameter lines; booleans are T/F.
"""

from __future__ import annotations

import math
import shlex
from typing import Dict, List, Optional, Tuple

from ..params import Param, create_priors
from ..settings import PolyChordSettings

_BOOL = {"T": True, "TRUE": True, ".TRUE.": True, "F": False, "FALSE": False, ".FALSE.": False}

# key -> (settings attribute, parser)
_SCALARS = {
    "nlive": ("nlive", int),
    "num_repeats": ("num_repeats", int),
    "nprior": ("nprior", int),
    "nfail": ("nfail", int),
    "do_clustering": ("do_clustering", "bool"),
    "feedback": ("feedback", int),
    "precision_criterion": ("precision_criterion", float),
    "logzero": ("logzero", float),
    "max_ndead": ("max_ndead", int),
    "boost_posterior": ("boost_posterior", float),
    "posteriors": ("posteriors", "bool"),
    "equals": ("equals", "bool"),
    "cluster_posteriors": ("cluster_posteriors", "bool"),
    "write_resume": ("write_resume", "bool"),
    "write_paramnames": ("write_paramnames", "bool"),
    "read_resume": ("read_resume", "bool"),
    "write_stats": ("write_stats", "bool"),
    "write_live": ("write_live", "bool"),
    "write_dead": ("write_dead", "bool"),
    "write_prior": ("write_prior", "bool"),
    "maximise": ("maximise", "bool"),
    "compression_factor": ("compression_factor", float),
    "synchronous": ("synchronous", "bool"),
    "base_dir": ("base_dir", str),
    "file_root": ("file_root", str),
    "seed": ("seed", int),
    "batch_size": ("batch_size", int),
}


def _parse_value(raw: str, parser):
    raw = raw.strip()
    if parser == "bool":
        return _BOOL[raw.upper()]
    return parser(raw)


def _split_kv(line: str) -> Optional[Tuple[str, str]]:
    if "=" not in line:
        return None
    key, _, val = line.partition("=")
    return key.strip(), val.strip()


def parse_param_line(body: str) -> Param:
    """``name | latex | speed | prior_type | block | params...``"""
    fields = [f.strip() for f in body.split("|")]
    if len(fields) < 6:
        raise ValueError(f"malformed P line: {body!r}")
    name = fields[0].split()[0]
    sub_cluster = name.endswith("*")
    if sub_cluster:
        name = name[:-1]
    latex = fields[1]
    speed = int(fields[2].split()[0])
    prior_type = fields[3].split()[0]
    block = int(fields[4].split()[0])
    prior_params = tuple(float(x) for x in fields[5].split())
    return Param(
        paramname=name,
        latex=latex,
        speed=speed,
        prior_type=prior_type,
        prior_block=block,
        prior_params=prior_params,
        sub_cluster=sub_cluster,
    )


def read_ini(path: str):
    """Parse an ini file.  Returns (settings, prior_blocks, paramnames,
    derived_paramnames, raw key/value dict)."""
    params: List[Param] = []
    derived: List[Tuple[str, str]] = []
    kv: Dict[str, str] = {}
    grade_frac_raw = None
    nlives_raw = None
    loglikes_raw = None
    seed_point_raw = None

    with open(path) as f:
        for line in f:
            line = line.split("#")[0].rstrip()
            stripped = line.strip()
            if not stripped or stripped.startswith("["):
                continue
            if stripped.startswith("P ") or stripped.startswith("P:") or stripped.startswith("P\t"):
                _, _, body = stripped.partition(":")
                params.append(parse_param_line(body))
                continue
            if stripped.startswith("D ") or stripped.startswith("D:") or stripped.startswith("D\t"):
                _, _, body = stripped.partition(":")
                fields = [x.strip() for x in body.split("|")]
                derived.append((fields[0], fields[1] if len(fields) > 1 else fields[0]))
                continue
            pair = _split_kv(stripped)
            if pair is None:
                continue
            key, val = pair
            kv[key] = val
            if key == "grade_frac":
                grade_frac_raw = val
            elif key == "nlives":
                nlives_raw = val
            elif key == "loglikes":
                loglikes_raw = val
            elif key == "seed_point":
                seed_point_raw = val

    nDims = len(params)
    nDerived = len(derived)
    settings = PolyChordSettings(max(nDims, 1), nDerived)
    # ini surface defaults follow the Fortran layer where they differ
    # (settings.f90:13-147): most writes off by default there, but we keep
    # the unified Python-layer defaults (SURVEY §5.6) and let the file win.
    for key, val in kv.items():
        if key in _SCALARS:
            attr, parser = _SCALARS[key]
            setattr(settings, attr, _parse_value(val, parser))

    if grade_frac_raw is not None:
        settings.grade_frac = [float(x) for x in grade_frac_raw.split()]
    if nlives_raw is not None and loglikes_raw is not None:
        ns = [int(x) for x in nlives_raw.split()]
        ls = [float(x) for x in loglikes_raw.split()]
        settings.nlives = dict(zip(ls, ns))
    if seed_point_raw is not None:
        settings.seed_point = [float(x) for x in seed_point_raw.split()]

    blocks, grade_dims, sub_dims, paramnames = (
        create_priors(params) if params else ([], [1], [], [])
    )
    if params:
        settings.grade_dims = grade_dims
        if settings.grade_frac is not None and len(settings.grade_frac) != len(
            grade_dims
        ):
            settings.grade_frac = (
                list(settings.grade_frac)
                + [1.0] * (len(grade_dims) - len(settings.grade_frac))
            )[: len(grade_dims)]
        settings.sub_clustering_dimensions = sub_dims or None

    return settings, blocks, paramnames, derived, kv
