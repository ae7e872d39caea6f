"""The data-driven example likelihoods in torch (counterpart of
``polychordlite_tpu/models/data_driven.py``).

``fitting`` (the reference's ``fitting.f90``: a piecewise-linear function
fitted to data uncertain in x and y) and ``object_detection``
(``object_detection.f90``: Gaussian blobs in an image), the two examples
that run with the adaptive sorted priors.  Both take a ``(B, D)`` physical
tensor and return ``logL (B,)``, the batched convention of
``models/examples.py``, so ``ops/evaluate.py`` reads them as batched torch
models on the device.  Neither has a device functor; the fused route's
lowering (``ops/fused_like.py``) takes both, with the inis' block priors
(their ``index_select``, ``index_copy`` and the sorted prior's ``flip`` and
``cumsum`` are static remaps and chains there), so on a card they run on
B1's fused route.  fitting's float64 body (a float64 statement type inside
the float32 lowering), its ``searchsorted`` (torch's own halving search),
its gathers and ``erf``, and object_detection's 20 x 20 image lower too:
each model's sum over its data rows (fitting's 50 points, the image's 400
pixels) is a data loop, not a statement a row.  (Before the lowering took
them, the inis' block priors' ``index_select`` refused both first, then
fitting's float64 ``_to_copy`` and ``searchsorted``; object_detection's
likelihood ops were in the table, its image scalarised element by element.)

The data files use the reference formats: ``data.dat`` rows of
``x y sigma_x sigma_y``; ``obj_info.dat`` the scalars nx, xmin, xmax, ny,
ymin, ymax, sigma; ``obj.dat`` ny rows of nx samples.  Without a data
directory a synthetic dataset of the same structure is made.  The loaders
are numpy copies of the JAX package's.  The data live on the likelihood's
device in its dtype, made once per (dtype, device) at the first call, so a
call copies nothing from the host (which a CUDA graph capture would
refuse).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

LOG_TWO_PI = math.log(2.0 * math.pi)


def _on_device(arrays: dict):
    """``get(like)``: the numpy ``arrays`` as tensors of ``like``'s dtype
    and device, made on the first request for that pair and kept."""
    made = {}

    def get(like: torch.Tensor) -> dict:
        key = (like.dtype, like.device)
        if key not in made:
            made[key] = {k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                         for k, v in arrays.items()}
        return made[key]

    return get


# ----------------------------------------------------------------------
# fitting (fitting.f90)
# ----------------------------------------------------------------------


def _synthetic_fitting_data(n_stats: int = 40, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2 * np.pi, n_stats)
    y = np.sin(x) + 0.2 * rng.standard_normal(n_stats)
    sigmax = np.full(n_stats, 2 * np.pi / 10)
    sigmay = np.full(n_stats, 0.2)
    return np.stack([x, y, sigmax, sigmay], axis=1), 0.0, 2 * np.pi


def load_fitting_data(data_dir: Optional[str] = None):
    """Read ``data.dat`` (+ optional ``data_min_max.dat``) in the reference
    format, or synthesise an equivalent dataset."""
    if data_dir is None:
        return _synthetic_fitting_data()
    data = np.loadtxt(os.path.join(data_dir, "data.dat"))
    mm_path = os.path.join(data_dir, "data_min_max.dat")
    if os.path.exists(mm_path):
        mm = np.loadtxt(mm_path)
        x_min, x_max = float(mm[0]), float(mm[1])
    else:
        x_min, x_max = float(data[:, 0].min()), float(data[:, 0].max())
    return data, x_min, x_max


def logsumexp_guarded(a: torch.Tensor, dim: int) -> torch.Tensor:
    """log sum exp over ``dim`` with the JAX package's guard
    (``jax_logsumexp``): an infinite or NaN maximum is replaced by 0 before
    the shift, so a slice whose entries are all ``-inf`` gives ``-inf``."""
    amax = a.amax(dim=dim, keepdim=True)
    amax_safe = torch.where(torch.isfinite(amax), amax, 0.0)
    return torch.log(torch.exp(a - amax_safe).sum(dim=dim)) + amax_safe.squeeze(dim)


def fitting(n_dims: int, data_dir: Optional[str] = None):
    """Piecewise-linear curve fitting with x- and y-uncertain data
    (fitting.f90:17-100): theta = [x-knots (n/2), y-knots (n/2)].

    For points with sigma_x <= 0 the likelihood is a plain Gaussian at the
    interpolated y; otherwise the x-uncertainty is integrated analytically
    over each linear segment via erf (log_exp_int, fitting.f90:48-88).
    The knots are located with ``torch.searchsorted(..., right=True)``,
    the JAX package's ``side="right"``: the two agree on sorted knots, which
    the reference's sorted priors give.

    The likelihood is evaluated in float64 whatever the dtype of ``theta``
    (the reference computes in double) and returned in that dtype.  In
    float32, ``-f/2 + e^2 s^2/2`` cancels catastrophically on a steep
    segment (both terms grow as the squared slope): the JAX package's
    float32 evaluation is off its own float64 one by up to 176 nats on the
    ini's prior, and its ``ini/fitting.ini`` run climbs on those rounding
    spikes without end (ROADMAP C20).  The port does not copy that.
    """
    if n_dims % 2:
        raise ValueError("fitting likelihood needs an even nDims (x and y knots)")
    n_knots = n_dims // 2
    data, x_min, x_max = load_fitting_data(data_dir)
    consts = _on_device({"x0": data[:, 0], "y0": data[:, 1], "sx": data[:, 2],
                         "sy": data[:, 3]})
    logsqrtpiby2 = 0.5 * math.log(math.pi / 2.0)
    log_range = math.log(max(x_max - x_min, 1e-37))
    sqrt_two = math.sqrt(2.0)

    def loglikelihood(theta_in: torch.Tensor) -> torch.Tensor:
        theta = theta_in.to(torch.float64)
        c = consts(theta)
        x0, y0, sx, sy = c["x0"], c["y0"], c["sx"], c["sy"]
        has_sx = sx > 0.0
        B, P = theta.shape[0], x0.shape[0]
        xs = theta[:, :n_knots].contiguous()
        ys = theta[:, n_knots:]

        # --- exact-x points: linear interpolation ---------------------
        idx = torch.searchsorted(xs, x0.expand(B, P).contiguous(), right=True) - 1
        idx = idx.clamp(0, n_knots - 2)
        x1, x2 = xs.gather(1, idx), xs.gather(1, idx + 1)
        y1, y2 = ys.gather(1, idx), ys.gather(1, idx + 1)
        rising = x2 > x1
        frac = torch.where(rising, (x0 - x1) / torch.where(rising, x2 - x1, 1.0), 0.0)
        y_int = y1 + frac.clamp(0.0, 1.0) * (y2 - y1)
        ll_exact = -torch.log(sy) - 0.5 * LOG_TWO_PI - ((y_int - y0) / sy) ** 2 / 2.0

        # --- x-uncertain points: integrate over each segment ----------
        # segment slopes and intercepts (B, S)
        xa, xb = xs[:, :-1], xs[:, 1:]
        m = (ys[:, 1:] - ys[:, :-1]) / torch.where(xb > xa, xb - xa, 1e-20)
        cc = ys[:, :-1] - m * xa
        lo = xa.clamp(x_min, x_max)
        hi = xb.clamp(x_min, x_max)
        seg_ok = hi > lo

        # broadcast: chains (B,1,1), points (1,P,1), segments (B,1,S)
        m3, c3 = m[:, None, :], cc[:, None, :]
        sx3, sy3, x03, y03 = sx[:, None], sy[:, None], x0[:, None], y0[:, None]
        s = (1.0 / sx3 ** 2 + m3 ** 2 / sy3 ** 2) ** -0.5
        e = x03 / sx3 ** 2 + (y03 - c3) * m3 / sy3 ** 2
        f = x03 ** 2 / sx3 ** 2 + (y03 - c3) ** 2 / sy3 ** 2
        a_arg = (lo[:, None, :] - e * s ** 2) / (sqrt_two * s)
        b_arg = (hi[:, None, :] - e * s ** 2) / (sqrt_two * s)
        derf = torch.clamp_min(torch.special.erf(b_arg) - torch.special.erf(a_arg), 1e-37)
        seg_log = logsqrtpiby2 + torch.log(s) + torch.log(derf) - f / 2.0 + e ** 2 * s ** 2 / 2.0
        seg_log = torch.where(seg_ok[:, None, :], seg_log, -math.inf)
        log_int = logsumexp_guarded(seg_log, dim=2)
        ll_intx = (log_int - torch.log(sy) - torch.log(torch.abs(sx) + 1e-37) - LOG_TWO_PI
                   - log_range)

        return torch.where(has_sx, ll_intx, ll_exact).sum(dim=1).to(theta_in.dtype)

    return loglikelihood


# ----------------------------------------------------------------------
# object detection (object_detection.f90)
# ----------------------------------------------------------------------


def _synthetic_object_data(nx=20, ny=20, seed=0):
    rng = np.random.default_rng(seed)
    xg = np.linspace(0.0, 1.0, nx)
    yg = np.linspace(1.0, 0.0, ny)
    X, Y = np.meshgrid(xg, yg, indexing="ij")
    truth = [(1.0, 0.3, 0.7, 0.08), (0.7, 0.7, 0.3, 0.06)]
    img = sum(
        A * np.exp(-((X - x) ** 2 + (Y - y) ** 2) / (2 * R * R))
        for A, x, y, R in truth
    )
    sigma = 0.2
    img = img + sigma * rng.standard_normal((nx, ny))
    return img, xg, yg, sigma


def load_object_data(data_dir: Optional[str] = None):
    """Read ``obj_info.dat`` + ``obj.dat`` in the reference format, or
    synthesise an equivalent image."""
    if data_dir is None:
        return _synthetic_object_data()
    info = []
    with open(os.path.join(data_dir, "obj_info.dat")) as f:
        for line in f:
            info.append(float(line.split()[0]))
    nx, xmin, xmax, ny, ymin, ymax, sigma = info[:7]
    nx, ny = int(nx), int(ny)
    raw = np.loadtxt(os.path.join(data_dir, "obj.dat"))
    # file rows = y; crop to (ny, nx) — the reference's list-directed read
    # takes the first nx values of each of the first ny records (its own
    # obj.dat is 22x22 against a declared 20x20)
    img = raw[:ny, :nx].T  # -> (nx, ny)
    xg = np.linspace(xmin, xmax, nx)
    yg = np.linspace(ymax, ymin, ny)  # descending, as in the reference grid
    return img, xg, yg, sigma


def object_detection(n_dims: int, data_dir: Optional[str] = None):
    """Detect N = nDims/4 Gaussian blobs in an image
    (object_detection.f90:7-34): theta packs [A, x, y, R] per object; the
    likelihood is the pixel-wise Gaussian residual, a dense (nx, ny)
    computation per chain."""
    if n_dims % 4:
        raise ValueError("object_detection needs nDims divisible by 4")
    n_obj = n_dims // 4
    img, xg, yg, sigma = load_object_data(data_dir)
    nx, ny = img.shape
    X, Y = np.meshgrid(xg, yg, indexing="ij")
    consts = _on_device({"img": img, "X": X, "Y": Y})
    norm = -0.5 * nx * ny * math.log(2 * math.pi * sigma * sigma)
    two_s2 = 2 * sigma * sigma

    def loglikelihood(theta: torch.Tensor) -> torch.Tensor:
        c = consts(theta)
        pars = theta.reshape(theta.shape[0], n_obj, 4)
        A = pars[:, :, 0][:, :, None, None]
        x = pars[:, :, 1][:, :, None, None]
        y = pars[:, :, 2][:, :, None, None]
        R = torch.abs(pars[:, :, 3])[:, :, None, None] + 1e-30
        signal = (A * torch.exp(-((c["X"] - x) ** 2 + (c["Y"] - y) ** 2) / (2 * R * R))).sum(1)
        return -((c["img"] - signal) ** 2).sum(dim=(1, 2)) / two_s2 + norm

    return loglikelihood
