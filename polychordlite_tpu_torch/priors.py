"""Prior transforms in torch (counterpart of ``polychordlite_tpu/priors.py``).

A prior is a callable mapping a ``(B, D)`` hypercube tensor to a ``(B, D)``
physical tensor.  This module holds

* the identity (the default prior of ``run()``) and ``UniformPrior``;
* the block-structured prior system of the ini interface with all 15 prior
  types (``src/polychord/priors.f90:5-20,494-614``):
  :class:`PriorBlock`, :func:`hypercube_to_physical`,
  :func:`physical_to_hypercube`, :func:`prior_log_volume`, and
  :class:`BlockPrior`, the prior callable of a block layout.

A prior the CUDA slice kernels can apply themselves carries an ``affine``
descriptor ``(a, s)``: ``theta = a + s * cube`` per coordinate, with ``a``
and ``s`` the exact float32 values the torch transform uses (scalars, or
one per coordinate).  The identity, every ``UniformPrior`` and a block
layout that is all ``uniform`` with hypercube index = physical index have
one; other priors have ``affine = None``.  The kernels' functors apply it
inside the likelihood (``csrc/likelihoods.cuh``).

The other pypolychord prior classes — :class:`GaussianPrior`,
:class:`LogUniformPrior`, :class:`SortedUniformPrior` and
:class:`LogSortedUniformPrior` (``polychordlite_tpu/priors.py:72-121``) —
take scalar or per-coordinate parameters, work on one point ``(D,)`` and on
a batch ``(B, D)``, and have no ``affine`` descriptor: on a card they run
through the CUDA engine's traced route (``ops/pallas_slice_v4.py``).

Every prior here keeps its parameter and index tensors on the device once
made (:func:`_device_tensor`), so that running it copies nothing from the
host and a CUDA graph can capture it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _device_tensor(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``values`` as a tensor, made once per (values, dtype, device) and
    kept: a prior that takes its constants from here copies nothing from the
    host when it runs, which a CUDA graph capture would refuse."""
    return torch.tensor(values, dtype=dtype, device=device)


def _consts(values, x: torch.Tensor) -> torch.Tensor:
    """The float64 ``values`` as a tensor of ``x``'s dtype and device."""
    return _device_tensor(tuple(np.asarray(values, np.float64).ravel().tolist()), x.dtype,
                          x.device)


def identity_prior(cube: torch.Tensor) -> torch.Tensor:
    """theta = cube (the reference's default prior)."""
    return cube


identity_prior.affine = (0.0, 1.0)


class UniformPrior:
    """theta = a + (b - a) * cube (pypolychord ``UniformPrior``).

    ``a`` and ``b`` may be scalars or per-coordinate sequences.  The
    transform is ``a + s * cube`` with ``s = b - a`` taken in float64 and
    both rounded to the cube's dtype, which is what ``affine`` records.
    """

    def __init__(self, a, b):
        self.a = a
        self.b = b
        a64 = np.asarray(a, np.float64)
        s64 = np.asarray(b, np.float64) - a64
        if a64.ndim == 0 and s64.ndim == 0:
            self._a, self._s = float(a64), float(s64)
            self.affine = (float(np.float32(a64)), float(np.float32(s64)))
        else:
            a64, s64 = np.broadcast_arrays(a64, s64)
            self._a, self._s = a64.copy(), s64.copy()
            self.affine = (a64.astype(np.float32), s64.astype(np.float32))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self._a, float):
            return self._a + self._s * x
        return _consts(self._a, x) + _consts(self._s, x) * x


def _coord_params(*vals):
    """The parameters as float64 arrays of one length (a scalar broadcast to
    the vectors' length; all 0-d when every one is a scalar), as the JAX
    package's ``_coord_params`` accepts them.  Raises when the lengths do
    not broadcast."""
    arrs = [np.atleast_1d(np.asarray(v, dtype=np.float64)) for v in vals]
    n = max(a.size for a in arrs)
    if n == 1:
        return [np.float64(a[0]) for a in arrs]
    if any(a.size not in (1, n) for a in arrs):
        raise ValueError("prior parameter lengths do not broadcast")
    return [np.broadcast_to(a, (n,)).copy() for a in arrs]


def _param(v, x: torch.Tensor):
    """A parameter from :func:`_coord_params`: a Python float for a scalar,
    else a tensor on ``x``'s device."""
    return float(v) if np.ndim(v) == 0 else _consts(v, x)


class GaussianPrior:
    """theta = mu + sigma sqrt(2) erfinv(2 cube - 1) (pypolychord
    ``GaussianPrior``); ``mu`` and ``sigma`` scalars or per coordinate.
    ``sigma sqrt(2)`` is rounded to float32 first, as the JAX package's
    ``sigma * jnp.sqrt(2.0)`` is."""

    def __init__(self, mu, sigma):
        self.mu = mu
        self.sigma = sigma
        self._mu, sigma64 = _coord_params(mu, sigma)
        self._scale = (np.asarray(sigma64, np.float32) * np.float32(math.sqrt(2.0))).astype(
            np.float64)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _param(self._mu, x) + _param(self._scale, x) * torch.special.erfinv(2 * x - 1)


class LogUniformPrior(UniformPrior):
    """theta = a (b / a)^cube (pypolychord ``LogUniformPrior``); ``a`` and
    ``b`` scalars or per coordinate."""

    def __init__(self, a, b):
        super().__init__(a, b)
        self._la, self._lb = _coord_params(a, b)
        self.affine = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ratio = self._lb / self._la
        if np.ndim(ratio) == 0:
            return float(self._la) * float(ratio) ** x
        return _consts(self._la, x) * torch.pow(_consts(ratio, x), x)


class SortedUniformPrior(UniformPrior):
    """:class:`UniformPrior` of the sorted uniforms
    :func:`forced_identifiability_transform` makes of the cube (pypolychord
    ``SortedUniformPrior``)."""

    def __init__(self, a, b):
        super().__init__(a, b)
        self.affine = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return super().__call__(forced_identifiability_transform(x))


class LogSortedUniformPrior(LogUniformPrior):
    """:class:`LogUniformPrior` of the sorted uniforms (pypolychord
    ``LogSortedUniformPrior``)."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return super().__call__(forced_identifiability_transform(x))


def forced_identifiability_transform(x: torch.Tensor) -> torch.Tensor:
    """Map iid uniforms to sorted uniforms: t_n = prod_{k>=n} x_k^(1/(k+1)),
    as a reverse cumulative sum in log space (priors.f90:242-261)."""
    n = x.shape[-1]
    ranks = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    logx = torch.log(x.clamp(min=1e-300)) / ranks
    logt = torch.flip(torch.cumsum(torch.flip(logx, (-1,)), dim=-1), (-1,))
    return torch.exp(logt)


# ---------------------------------------------------------------------------
# Block-structured prior system (priors.f90)
# ---------------------------------------------------------------------------

PRIOR_TYPES = (
    "uniform",
    "log_uniform",
    "power_uniform",
    "gaussian",
    "half_gaussian",
    "exponential",
    "sorted_uniform",
    "sorted_gaussian",
    "sorted_half_gaussian",
    "sorted_exponential",
    "adaptive_sorted_uniform",
    "adaptive_sorted_gaussian",
    "adaptive_sorted_half_gaussian",
    "adaptive_sorted_exponential",
    "nn_adaptive_layer_gaussian",
)


@dataclasses.dataclass(frozen=True)
class PriorBlock:
    """One prior block: a set of parameters transformed together.

    Mirrors the reference ``prior`` type (priors.f90:22-29): static hypercube
    and physical index maps plus a flat parameter vector whose layout depends
    on the prior type (interleaved per-parameter values).
    """

    prior_type: str
    hypercube_indices: tuple  # 0-based
    physical_indices: tuple  # 0-based
    parameters: tuple

    @property
    def npars(self) -> int:
        return len(self.hypercube_indices)


def _pairs_np(params, n, stride=2):
    """Split an interleaved parameter vector into per-dimension float64
    arrays, broadcasting a single tuple across the block if only one was
    given."""
    p = np.asarray(params, dtype=np.float64)
    if p.size == stride:
        return [np.full(n, p[i]) for i in range(stride)]
    return [p[i::stride] for i in range(stride)]


def _pairs(params, x, stride=2):
    """:func:`_pairs_np` as tensors of ``x``'s dtype and device."""
    return [_consts(c, x) for c in _pairs_np(params, x.shape[-1], stride)]


def _uniform_htp(x, params):
    a, b = _pairs(params, x)
    return a + (b - a) * x


def _log_uniform_htp(x, params):
    a, b = _pairs(params, x)
    return a * (b / a) ** x


def _power_uniform_htp(x, params):
    # theta^(1/power) uniform; power negative (priors.f90:147-167).
    a, b, power = _pairs(params, x, stride=3)
    const = 1.0 / torch.abs(a ** (1.0 / power) - b ** (1.0 / power))
    phys = a ** (1.0 / power) - x / const
    return phys**power


def _gaussian_htp(x, params):
    mu, sigma = _pairs(params, x)
    return mu + sigma * torch.special.ndtri(x.clamp(1e-300, 1.0 - 1e-16))


def _half_gaussian_htp(x, params):
    return _gaussian_htp(0.5 + 0.5 * x, params)


def _exponential_htp(x, params):
    (lam,) = _pairs(params, x, stride=1)
    return -torch.log1p(-x.clamp(0.0, 1.0 - 1e-16)) / lam


def _adaptive_sorted_transform(x):
    """First coordinate selects how many of the rest are sorted
    (priors.f90:363-384), with a masked reverse log-cumsum."""
    n = x.shape[-1]
    first = 0.5 + x[..., 0] * (n - 1)
    nfunc = torch.floor(first + 0.5).to(torch.int32)  # round to nearest
    rest = x[..., 1:]
    m = rest.shape[-1]
    idx = torch.arange(m, device=x.device)
    active = idx < nfunc[..., None]
    ranks = (idx + 1).to(rest.dtype)
    logx = torch.where(active, torch.log(rest.clamp(min=1e-300)) / ranks, 0.0)
    logt = torch.flip(torch.cumsum(torch.flip(logx, (-1,)), dim=-1), (-1,))
    sorted_rest = torch.where(active, torch.exp(logt), rest)
    return torch.cat([first[..., None], sorted_rest], dim=-1)


def _make_sorted(base):
    def fn(x, params):
        return base(forced_identifiability_transform(x), params)

    return fn


def _make_adaptive(base, param_offset):
    def fn(x, params):
        y = _adaptive_sorted_transform(x)
        rest = base(y[..., 1:], tuple(params[param_offset:]))
        return torch.cat([y[..., :1], rest], dim=-1)

    return fn


def _nn_adaptive_layer_gaussian_htp(x, params):
    """priors.f90:469-488: first coord picks 1 vs 2 hidden layers."""
    first = 0.5 + x[..., 0] * 2.0
    rest = x[..., 1:]
    half = _make_adaptive(_half_gaussian_htp, 2)(rest, tuple(params[2:]))
    full = _make_adaptive(_gaussian_htp, 2)(rest, tuple(params[2:]))
    chosen = torch.where((first < 1.5)[..., None], half, full)
    return torch.cat([first[..., None], chosen], dim=-1)


_HTP = {
    "uniform": _uniform_htp,
    "log_uniform": _log_uniform_htp,
    "power_uniform": _power_uniform_htp,
    "gaussian": _gaussian_htp,
    "half_gaussian": _half_gaussian_htp,
    "exponential": _exponential_htp,
    "sorted_uniform": _make_sorted(_uniform_htp),
    "sorted_gaussian": _make_sorted(_gaussian_htp),
    "sorted_half_gaussian": _make_sorted(_half_gaussian_htp),
    "sorted_exponential": _make_sorted(_exponential_htp),
    "adaptive_sorted_uniform": _make_adaptive(_uniform_htp, 2),
    "adaptive_sorted_gaussian": _make_adaptive(_gaussian_htp, 2),
    "adaptive_sorted_half_gaussian": _make_adaptive(_half_gaussian_htp, 2),
    "adaptive_sorted_exponential": _make_adaptive(_exponential_htp, 1),
    "nn_adaptive_layer_gaussian": _nn_adaptive_layer_gaussian_htp,
}


def hypercube_to_physical(cube: torch.Tensor, blocks: Sequence[PriorBlock]):
    """Dispatch over prior blocks (priors.f90:494-556); ``cube`` may have
    leading batch dimensions."""
    out = torch.zeros_like(cube)
    for blk in blocks:
        h, p = (_device_tensor(tuple(i), torch.int64, cube.device)
                for i in (blk.hypercube_indices, blk.physical_indices))
        out = out.index_copy(-1, p, _HTP[blk.prior_type](cube.index_select(-1, h),
                                                         blk.parameters))
    return out


def physical_to_hypercube(theta: torch.Tensor, blocks: Sequence[PriorBlock]):
    """Inverse transform for the 4 invertible types (priors.f90:558-587)."""
    out = torch.zeros_like(theta)
    for blk in blocks:
        sub = theta[..., list(blk.physical_indices)]
        if blk.prior_type == "uniform":
            a, b = _pairs(blk.parameters, sub)
            cube = (sub - a) / (b - a)
        elif blk.prior_type == "gaussian":
            mu, sigma = _pairs(blk.parameters, sub)
            z = (sub - mu) / sigma
            cube = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
        elif blk.prior_type == "log_uniform":
            a, b = _pairs(blk.parameters, sub)
            cube = torch.log(sub / a) / torch.log(b / a)
        elif blk.prior_type == "sorted_uniform":
            a, b = _pairs(blk.parameters, sub)
            u = (sub - a) / (b - a)
            n = blk.npars
            ratios = torch.cat(
                [u[..., :-1] / u[..., 1:].clamp(min=1e-300), u[..., -1:]], dim=-1
            )
            powers = torch.arange(1, n + 1, dtype=u.dtype, device=u.device)
            cube = ratios**powers
        else:
            raise ValueError(
                f"prior type {blk.prior_type!r} has no inverse transform"
            )
        out[..., list(blk.hypercube_indices)] = cube
    return out


def prior_log_volume(blocks: Sequence[PriorBlock]) -> float:
    """Log prior volume for the types that define one (priors.f90:591-614)."""
    log_two_pi = math.log(2.0 * math.pi)
    total = 0.0
    for blk in blocks:
        p = np.asarray(blk.parameters, dtype=np.float64)
        if blk.prior_type == "uniform":
            a, b = p[0::2], p[1::2]
            if a.size == 1 and blk.npars > 1:
                total += blk.npars * math.log(b[0] - a[0])
            else:
                total += float(np.sum(np.log(b - a)))
        elif blk.prior_type == "gaussian":
            sig = p[1::2]
            if sig.size == 1 and blk.npars > 1:
                total += blk.npars * (0.5 * log_two_pi + math.log(sig[0]))
            else:
                total += float(np.sum(0.5 * log_two_pi + np.log(sig)))
        elif blk.prior_type == "log_uniform":
            a, b = p[0::2], p[1::2]
            total += float(np.sum(np.log(np.log(b / a))))
        elif blk.prior_type == "sorted_uniform":
            total += math.log(p[1] - p[0]) - math.lgamma(1.0 + blk.npars)
    return total


def blocks_affine(blocks: Sequence[PriorBlock], n_dims: int):
    """The ``affine`` descriptor ``(a[D], s[D])`` of a block layout that is
    all ``uniform`` and maps each hypercube index to the same physical
    index, else None.  ``s`` is ``f32(b) - f32(a)`` rounded in float32, as
    :func:`hypercube_to_physical` computes it on a float32 cube."""
    a = np.zeros(n_dims, np.float32)
    s = np.zeros(n_dims, np.float32)
    seen = np.zeros(n_dims, bool)
    for blk in blocks:
        if blk.prior_type != "uniform" or blk.hypercube_indices != blk.physical_indices:
            return None
        lo, hi = (v.astype(np.float32) for v in _pairs_np(blk.parameters, blk.npars))
        idx = list(blk.hypercube_indices)
        a[idx], s[idx], seen[idx] = lo, hi - lo, True
    return (a, s) if seen.all() else None


class BlockPrior:
    """The prior callable of a block layout (the ini interface's prior):
    ``theta = hypercube_to_physical(cube, blocks)``, with an ``affine``
    descriptor where :func:`blocks_affine` gives one."""

    def __init__(self, blocks: Sequence[PriorBlock], n_dims: int):
        self.blocks = tuple(blocks)
        self.affine = blocks_affine(self.blocks, n_dims)

    def __call__(self, cube: torch.Tensor) -> torch.Tensor:
        return hypercube_to_physical(cube, self.blocks)
