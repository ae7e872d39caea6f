"""Batched point evaluation: cube -> (theta, phi, logL)
(counterpart of ``polychordlite_tpu/ops/evaluate.py``).

Semantics of the reference ``calculate_point`` (``calculate.f90:6-50``):
points outside the unit hypercube get ``logL = logzero`` with theta = phi = 0
and the likelihood is not trusted there; a NaN logL counts as logzero.

Two paths share one interface:

* **batched torch path** — the prior and likelihood accept a ``(B, D)``
  torch tensor, so every evaluation in the slice engine is one batched
  computation on the run's device.  The port decides this by calling them
  on a small torch tensor (the JAX package traces them with
  ``jax.eval_shape`` instead).
* **callback path** — any other Python/numpy likelihood is called point by
  point on the host, as the reference does.

When the prior has an ``affine`` descriptor (``priors.py``) and the
likelihood a ``device_form`` (``models/examples.py``), ``calc.device_spec``
holds both, and the CUDA slice kernel can evaluate the model itself.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .logspace import LOG_ZERO
from .precision import real_dtype


class DerivedMismatchError(ValueError):
    """The likelihood's derived-parameter return does not match the declared
    ``nDerived`` — raised loudly rather than silently writing zero columns."""


def _normalise_like_output(out, n_phi: int, n_derived_decl: int, B: int):
    """Accept the reference's tuple-or-scalar return convention for a batch:
    ``logL (B,)`` or ``(logL (B,), phi)`` with phi ``(B, k)`` or a sequence
    of k ``(B,)`` tensors.  Returns (logL (B,), phi (B, n_phi))."""
    if isinstance(out, tuple):
        logL, phi = out
        if not isinstance(phi, torch.Tensor):
            phi = torch.stack(list(phi), dim=1) if len(phi) else None
        if phi is None or phi.numel() == 0:
            if n_derived_decl > 0:
                raise DerivedMismatchError(
                    f"likelihood returned no derived parameters but "
                    f"nDerived={n_derived_decl} was declared"
                )
            phi = None
        else:
            phi = phi.reshape(B, -1)
    else:
        logL, phi = out, None
    dt = real_dtype()
    if not isinstance(logL, torch.Tensor):
        raise TypeError("the likelihood did not return a torch tensor")
    logL = logL.to(dt).reshape(B)
    full = torch.zeros((B, n_phi), dtype=dt, device=logL.device)
    if phi is not None:
        k = min(phi.shape[1], n_phi)
        full[:, :k] = phi[:, :k].to(dt)
    return logL, full


def make_batched_calculator(
    prior_fn: Callable,
    loglike_fn: Callable,
    n_dims: int,
    n_derived: int,
    logzero: float = LOG_ZERO,
    force_callback: bool = False,
):
    """Build ``calc(cube_batch) -> (theta, phi, logL)`` with calculate_point
    semantics, choosing the batched torch or host-callback path."""
    n_phi = max(n_derived, 1)

    use_callback = force_callback
    if not use_callback:
        probe = torch.full((2, n_dims), 0.5, dtype=real_dtype())
        try:
            theta = prior_fn(probe)
            out = loglike_fn(theta)
            ok = isinstance(theta, torch.Tensor) and theta.shape == probe.shape
            if ok:
                _normalise_like_output(out, n_phi, n_derived, 2)
        except DerivedMismatchError:
            # a model bug, not a reason to take the callback path (which
            # would mask it with zeros)
            raise
        except (TypeError, ValueError, RuntimeError, IndexError, AttributeError):
            ok = False
        use_callback = not ok

    if not use_callback:

        def raw_eval(cube):
            theta = prior_fn(cube).to(real_dtype())
            logL, phi = _normalise_like_output(
                loglike_fn(theta), n_phi, n_derived, cube.shape[0]
            )
            return theta, phi, logL

    else:

        def _host_eval(cube_np):
            B = cube_np.shape[0]
            thetas = np.zeros((B, n_dims))
            phis = np.zeros((B, n_phi))
            logLs = np.full((B,), logzero)
            for i in range(B):
                theta = np.asarray(prior_fn(cube_np[i]), dtype=np.float64)
                out = loglike_fn(theta)
                if isinstance(out, tuple):
                    logL, phi = out
                    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
                    if len(phi) == 0 and n_derived > 0:
                        raise DerivedMismatchError(
                            f"likelihood returned no derived parameters "
                            f"but nDerived={n_derived} was declared"
                        )
                else:
                    logL, phi = out, np.zeros((n_phi,))
                thetas[i] = theta
                phis[i, : len(phi)] = phi[:n_phi]
                logLs[i] = logL
            return thetas, phis, logLs

        def raw_eval(cube):
            th, ph, ll = _host_eval(cube.detach().cpu().numpy().astype(np.float64))
            kw = dict(dtype=real_dtype(), device=cube.device)
            return (
                torch.as_tensor(th, **kw),
                torch.as_tensor(ph, **kw),
                torch.as_tensor(ll, **kw),
            )

    def calc_point_batch(cube: torch.Tensor):
        """(B, D) cube -> (theta (B,D), phi (B,n_phi), logL (B,)).

        Out-of-cube points: theta = 0, logL = logzero, likelihood untouched
        (calculate.f90:36-42). NaN likelihoods are treated as unphysical.
        """
        inside = ((cube >= 0.0) & (cube <= 1.0)).all(dim=1)
        theta, phi, logL = raw_eval(cube.clamp(0.0, 1.0))
        logL = torch.where(torch.isnan(logL), logzero, logL)
        logL = torch.where(inside, logL, logzero)
        theta = torch.where(inside[:, None], theta, 0.0)
        phi = torch.where(inside[:, None], phi, 0.0)
        return theta, phi, logL

    calc_point_batch.uses_callback = use_callback
    calc_point_batch.n_phi = n_phi
    calc_point_batch.device_spec = None
    affine = getattr(prior_fn, "affine", None)
    form = getattr(loglike_fn, "device_form", None)
    if not use_callback and affine is not None and form is not None:
        calc_point_batch.device_spec = {
            "prior": tuple(affine), "likelihood": dict(form),
            "n_dims": n_dims, "logzero": float(logzero),
        }
    return calc_point_batch
