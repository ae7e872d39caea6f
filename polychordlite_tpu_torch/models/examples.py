"""Analytic example likelihoods in torch (counterpart of
``polychordlite_tpu/models/examples.py``).

A likelihood takes a ``(B, D)`` physical tensor and returns ``logL (B,)``
or ``(logL (B,), phi (B, nDerived))``.  A likelihood that the CUDA slice
kernel can evaluate itself carries a ``device_form`` descriptor naming its
device functor and that functor's constants (``ops/pallas_slice_v4.py``).

Only the normalised Gaussian is ported so far.  Its arithmetic is written
as separate IEEE float operations in a fixed order — the chi-square is
summed over coordinates 0..D-1 in index order, and the division is by a
tensor, never by a Python scalar (CUDA turns a division by a host scalar
into a multiplication by its reciprocal) — so that the device functor,
which does the same operations in the same order, agrees with it bit for
bit.
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


LIKELIHOODS = {"gaussian": gaussian}


def get_likelihood(name: str, n_dims: int, **kwargs):
    if name not in LIKELIHOODS:
        raise KeyError(f"unknown likelihood {name!r}; have {sorted(LIKELIHOODS)}")
    return LIKELIHOODS[name](n_dims, **kwargs)
