"""Analytic example likelihoods in torch (counterpart of
``polychordlite_tpu/models/examples.py``).

A likelihood takes a ``(B, D)`` physical tensor and returns ``logL (B,)``
or ``(logL (B,), phi (B, nDerived))``.  A likelihood that the CUDA slice
kernel can evaluate itself carries a ``device_form`` descriptor naming its
device functor and that functor's constants (``ops/pallas_slice_v4.py``).

All eleven analytic likelihoods of the JAX package's zoo are here, each
with a device form.  Their arithmetic is written as separate IEEE float
operations in a fixed order — sums over coordinates in index order,
logaddexp spelled out, integer powers as chains of multiplications, and
every division by a tensor, never by a Python scalar (CUDA turns a division
by a host scalar into a multiplication by its reciprocal) — so that the
device functors (``csrc/likelihoods.cuh``), which do the same operations in
the same order, agree with them bit for bit.  Derived parameters are the
JAX package's; the functors compute logL only.
"""

from __future__ import annotations

import math

import numpy as np
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


def _divisor(theta: torch.Tensor, value: float) -> torch.Tensor:
    """A one-element tensor to divide by (see the module docstring)."""
    return theta.new_full((1,), value)


def _index_sum(terms):
    """Sum of a sequence of (B,) tensors, in index order from the first."""
    total = terms[0]
    for term in terms[1:]:
        total = total + term
    return total


def _mix_of_two(l1, l2):
    """logaddexp(l1, l2) - log 2, spelled out as the functors do it."""
    m = torch.maximum(l1, l2)
    return (m + torch.log1p(torch.exp(-(l1 - l2).abs()))) - math.log(2.0)


def half_gaussian(n_dims: int, sigma: float = 0.1):
    """half_gaussian.f90: first coordinate restricted to a half-Gaussian at 0,
    others centred at 0.5; normalisation includes the +log 2.  Derived:
    radius and log enclosed prior volume."""
    norm = -n_dims * (math.log(sigma) + LOG_SQRT_TWO_PI) + math.log(2.0)
    log_vn = _log_vn(n_dims)

    def loglikelihood(theta: torch.Tensor):
        div = _divisor(theta, sigma)
        z = [(theta[:, k] - (0.0 if k == 0 else 0.5)) / div for k in range(theta.shape[1])]
        chi2 = _index_sum([zk * zk for zk in z])
        logL = norm - 0.5 * chi2
        r = torch.sqrt(chi2) * sigma
        return logL, torch.stack([r, n_dims * torch.log(r) + log_vn - math.log(2.0)], dim=1)

    loglikelihood.device_form = {
        "name": "half_gaussian", "mu": 0.5, "sigma": sigma, "norm": norm,
    }
    return loglikelihood


def pyramidal(n_dims: int, mu: float = 0.5, sigma: float = 0.1):
    """pyramidal.f90: L_inf-norm pyramid, normalised."""
    factor = math.exp(-2.0 / n_dims * math.lgamma(1.0 + 0.5 * n_dims)) * (math.pi / 2.0)
    norm = -n_dims * (LOG_SQRT_TWO_PI + math.log(sigma))

    def loglikelihood(theta: torch.Tensor):
        div = _divisor(theta, sigma)
        m = (theta[:, 0] - mu).abs() / div
        for k in range(1, theta.shape[1]):
            m = torch.maximum(m, (theta[:, k] - mu).abs() / div)
        return norm - (m * m) / _divisor(theta, factor)

    loglikelihood.device_form = {
        "name": "pyramidal", "mu": mu, "sigma": sigma, "norm": norm, "factor": factor,
    }
    return loglikelihood


def rastrigin(n_dims: int, A: float = 10.0):
    """rastrigin.f90: upside-down Rastrigin, per-dim normalisation 4991.2175."""
    log_norm = math.log(4991.21750)
    two_pi = 2.0 * math.pi

    def loglikelihood(theta: torch.Tensor):
        terms = []
        for k in range(theta.shape[1]):
            th = theta[:, k]
            terms.append((th * th + log_norm) - torch.cos(th * two_pi) * A)
        return -_index_sum(terms)

    loglikelihood.device_form = {
        "name": "rastrigin", "log_norm": log_norm, "A": A, "two_pi": two_pi,
    }
    return loglikelihood


def twin_gaussian(n_dims: int, sigma: float = 0.1):
    """twin_gaussian.f90: equal mixture of two Gaussians at (-0.5, -0.5, 0...)
    and (+0.5, +0.5, 0...).  Derived: +1 on the x_1 > 0.5 side, else -1."""
    norm = -n_dims * (math.log(sigma) + LOG_SQRT_TWO_PI)
    off = 0.5

    def loglikelihood(theta: torch.Tensor):
        div = _divisor(theta, sigma)
        z1 = [(theta[:, k] - (-off if k < 2 else 0.0)) / div for k in range(theta.shape[1])]
        z2 = [(theta[:, k] - (off if k < 2 else 0.0)) / div for k in range(theta.shape[1])]
        l1 = norm - 0.5 * _index_sum([z * z for z in z1])
        l2 = norm - 0.5 * _index_sum([z * z for z in z2])
        phi = torch.where(theta[:, 0] > 0.5, 1.0, -1.0).to(theta.dtype)
        return _mix_of_two(l1, l2), phi[:, None]

    loglikelihood.device_form = {
        "name": "twin_gaussian", "off": off, "sigma": sigma, "norm": norm,
        "log_two": math.log(2.0),
    }
    return loglikelihood


def himmelblau(n_dims: int = 2):
    """himmelblau.f90: four-mode 2-D benchmark, normalised."""
    norm = -math.log(0.4071069421432255)

    def loglikelihood(theta: torch.Tensor):
        x, y = theta[:, 0], theta[:, 1]
        a = (x * x + y) - 11.0
        b = (x + y * y) - 7.0
        return (norm - a * a) - b * b

    loglikelihood.device_form = {"name": "himmelblau", "norm": norm}
    return loglikelihood


def _rosenbrock_det(n: int, b: float = 100.0) -> float:
    """Tridiagonal determinant recurrence from rosenbrock.f90:76-96, run
    forward once (the JAX package's recursive form takes exponential time:
    minutes at n = 40, never at 160) with the same operations, so the same
    values; past n ~ 106 it overflows to nan, and so does the model's norm."""
    r = [0.0, 1.0]  # recur(0), recur(1)
    for _ in range(2, n):
        r.append((-2.0 - 10.0 * b) * r[-1] - 16.0 * b * b * r[-2])

    def recur(k: int) -> float:
        return 0.0 if k <= 0 else r[k]

    return abs(-2.0 * b * recur(n - 1) - 16.0 * b * b * recur(n - 2))


def rosenbrock(n_dims: int, a: float = 1.0, b: float = 100.0):
    """rosenbrock.f90: upside-down banana, 2-D normalised."""
    norm = -0.5 * math.log(math.pi**n_dims / _rosenbrock_det(n_dims, b))

    def loglikelihood(theta: torch.Tensor):
        terms = []
        for k in range(theta.shape[1] - 1):
            u = a - theta[:, k]
            v = theta[:, k + 1] - theta[:, k] * theta[:, k]
            terms.append(u * u + (v * v) * b)
        if not terms:
            return torch.full_like(theta[:, 0], norm)
        return norm - _index_sum(terms)

    loglikelihood.device_form = {"name": "rosenbrock", "a": a, "b": b, "norm": norm}
    return loglikelihood


def eggbox(n_dims: int):
    """eggbox.f90: -(2 + prod cos(theta_i/2))^5, the power as q * (q^2)^2."""

    def loglikelihood(theta: torch.Tensor):
        two = _divisor(theta, 2.0)
        p = torch.cos(theta[:, 0] / two)
        for k in range(1, theta.shape[1]):
            p = p * torch.cos(theta[:, k] / two)
        q = p + 2.0
        q2 = q * q
        return -(q * (q2 * q2))

    loglikelihood.device_form = {"name": "eggbox"}
    return loglikelihood


def gaussian_shell(n_dims: int, radius: float = 2.0, sigma: float = 0.1):
    """gaussian_shell.f90: single spherical shell at the origin, normalised.
    Derived: the radius."""
    A = _shell_norm(n_dims, radius, sigma)
    two_s2 = 2.0 * sigma * sigma

    def loglikelihood(theta: torch.Tensor):
        r = torch.sqrt(_index_sum([theta[:, k] * theta[:, k] for k in range(theta.shape[1])]))
        d = r - radius
        return -A - (d * d) / _divisor(theta, two_s2), r[:, None]

    loglikelihood.device_form = {
        "name": "gaussian_shell", "radius": radius, "two_s2": two_s2, "neg_a": -A,
    }
    return loglikelihood


def random_gaussian(n_dims: int, sigma: float = 0.1, seed: int = 0):
    """random_gaussian.f90: correlated Gaussian with a random inverse
    covariance (random_utils.F90:581-614 construction: random orthonormal
    basis with random eigenvalues up to 1/sigma^2), built with the JAX
    package's numpy code and used in float32, as the JAX package uses it.
    The quadratic form is a double loop in index order."""
    rng = np.random.default_rng(seed)
    gauss = rng.standard_normal((n_dims, n_dims))
    q, _ = np.linalg.qr(gauss)
    eigs = rng.uniform(0.0, 1.0, n_dims) / sigma**2
    invcov = (q * eigs) @ q.T
    sign, logdet = np.linalg.slogdet(np.linalg.inv(invcov))
    mu = 0.5
    norm = -0.5 * (n_dims * LOG_TWO_PI + logdet)
    m32 = invcov.astype(np.float32)
    rows = [[float(v) for v in row] for row in m32]

    def loglikelihood(theta: torch.Tensor):
        d = [theta[:, k] - mu for k in range(theta.shape[1])]
        quad = torch.zeros_like(d[0])
        for i, row_i in enumerate(rows):
            row = torch.zeros_like(d[0])
            for j, m_ij in enumerate(row_i):
                row = row + d[j] * m_ij
            quad = quad + d[i] * row
        return norm - 0.5 * quad

    loglikelihood.device_form = {
        "name": "random_gaussian", "mu": mu, "norm": norm, "invcov": m32.ravel().tolist(),
    }
    return loglikelihood


LIKELIHOODS = {
    "gaussian": gaussian,
    "half_gaussian": half_gaussian,
    "pyramidal": pyramidal,
    "rastrigin": rastrigin,
    "twin_gaussian": twin_gaussian,
    "himmelblau": himmelblau,
    "rosenbrock": rosenbrock,
    "eggbox": eggbox,
    "gaussian_shell": gaussian_shell,
    "gaussian_shells": gaussian_shells,
    "random_gaussian": random_gaussian,
}


def get_likelihood(name: str, n_dims: int, **kwargs):
    if name not in LIKELIHOODS:
        raise KeyError(f"unknown likelihood {name!r}; have {sorted(LIKELIHOODS)}")
    return LIKELIHOODS[name](n_dims, **kwargs)
