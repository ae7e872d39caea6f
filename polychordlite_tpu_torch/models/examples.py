"""Analytic example likelihoods in torch (counterpart of
``polychordlite_tpu/models/examples.py``).

A likelihood takes a ``(B, D)`` physical tensor and returns ``logL (B,)``
or ``(logL (B,), phi (B, nDerived))``.  A likelihood that the CUDA slice
kernel can evaluate itself carries a ``device_form`` descriptor naming its
device functor and that functor's constants (``ops/pallas_slice_v4.py``).

Ported so far: the normalised Gaussian and the two Gaussian shells.
Their arithmetic is written as separate IEEE float operations in a fixed
order — sums over coordinates in index order, logaddexp spelled out, and
every division by a tensor, never by a Python scalar (CUDA turns a division
by a host scalar into a multiplication by its reciprocal) — so that the
device functors (``csrc/likelihoods.cuh``), which do the same operations in
the same order, agree with them bit for bit.
"""

from __future__ import annotations

import math

import torch

LOG_TWO_PI = math.log(2.0 * math.pi)
LOG_SQRT_TWO_PI = 0.5 * LOG_TWO_PI


def _log_vn(n: int) -> float:
    """log volume of the n-ball (utils.F90:754-765)."""
    return 0.5 * n * math.log(math.pi) - math.lgamma(1.0 + 0.5 * n)


def gaussian(n_dims: int, mu: float = 0.5, sigma: float = 0.1):
    """Normalised uncorrelated Gaussian (gaussian.f90:12-41): Z = 1 over an
    infinite prior. Derived params: radius and log enclosed prior volume."""

    norm = -n_dims * (math.log(sigma) + LOG_SQRT_TWO_PI)
    log_vn = _log_vn(n_dims)

    def loglikelihood(theta: torch.Tensor):
        d = (theta - mu) / theta.new_full((1,), sigma)
        dd = d * d
        chi2 = dd[:, 0]
        for k in range(1, dd.shape[1]):
            chi2 = chi2 + dd[:, k]
        logL = norm - 0.5 * chi2
        r = torch.sqrt(torch.sum((theta - mu) ** 2, dim=1))
        return logL, torch.stack([r, n_dims * torch.log(r) + log_vn], dim=1)

    loglikelihood.device_form = {
        "name": "gaussian", "mu": mu, "sigma": sigma, "norm": norm,
    }
    return loglikelihood


def _shell_norm(n_dims: int, radius: float, sigma: float) -> float:
    """Peak normalisation A from gaussian_shell.f90:21-26."""
    r0 = (radius + math.sqrt(radius**2 + 4 * (n_dims - 1) * sigma**2)) / 2
    logf0 = (
        -((radius - r0) ** 2) / 2 / sigma**2
        + (n_dims - 1) * math.log(r0)
        + math.log(float(n_dims))
        + n_dims / 2.0 * math.log(math.pi)
        - math.lgamma(1 + n_dims / 2.0)
    )
    sigma0 = sigma * math.sqrt(
        (1 + radius / math.sqrt(radius**2 + 4 * (n_dims - 1) * sigma**2)) / 2.0
    )
    return logf0 + LOG_SQRT_TWO_PI + math.log(sigma0)


def gaussian_shells(n_dims: int, radius: float = 2.0, sigma: float = 0.1):
    """gaussian_shells.f90:11-58 — the canonical bimodal clustering oracle:
    two equal shells centred at x_1 = -3.5 and +3.5, each with local
    evidence Z/2.  No derived parameters."""
    A = _shell_norm(n_dims, radius, sigma)
    centre = 3.5
    two_s2 = 2.0 * sigma * sigma

    def loglikelihood(theta: torch.Tensor):
        th0 = theta[:, 0]
        rest = torch.zeros_like(th0)
        for k in range(1, theta.shape[1]):
            rest = rest + theta[:, k] * theta[:, k]
        c1 = th0 + centre
        c2 = th0 - centre
        r1 = torch.sqrt(c1 * c1 + rest)
        r2 = torch.sqrt(c2 * c2 + rest)
        d1 = r1 - radius
        d2 = r2 - radius
        div = theta.new_full((1,), two_s2)
        l1 = -A - (d1 * d1) / div
        l2 = -A - (d2 * d2) / div
        m = torch.maximum(l1, l2)
        return (m + torch.log1p(torch.exp(-(l1 - l2).abs()))) - math.log(2.0)

    loglikelihood.device_form = {
        "name": "gaussian_shells", "centre": centre, "radius": radius,
        "two_s2": two_s2, "neg_a": -A, "log_two": math.log(2.0),
    }
    return loglikelihood


LIKELIHOODS = {"gaussian": gaussian, "gaussian_shells": gaussian_shells}


def get_likelihood(name: str, n_dims: int, **kwargs):
    if name not in LIKELIHOODS:
        raise KeyError(f"unknown likelihood {name!r}; have {sorted(LIKELIHOODS)}")
    return LIKELIHOODS[name](n_dims, **kwargs)
