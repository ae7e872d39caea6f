"""Batched point evaluation: cube -> (theta, phi, logL)
(counterpart of ``polychordlite_tpu/ops/evaluate.py``).

Semantics of the reference ``calculate_point`` (``calculate.f90:6-50``):
points outside the unit hypercube get ``logL = logzero`` with theta = phi = 0
and the likelihood is not trusted there; a NaN logL counts as logzero.

A model takes one of three forms, tried in this order (the JAX package
traces the prior and likelihood per point and vmaps them,
``polychordlite_tpu/ops/evaluate.py:110-174``, and validates its Pallas tile
path numerically, ``polychordlite_tpu/ops/pallas_slice.py:125-160``):

* ``"batched"`` — the prior and likelihood take a ``(B, D)`` torch tensor
  and return ``(B, D)`` and ``logL (B,)`` (or ``(logL, phi (B, k))``).  A
  model is taken as batched only if, on :data:`PROBE_POINTS` seeded cubes
  (drawn from [-0.05, 1.05]^D and clamped as the calc clamps them, so some
  lie on the cube's walls), it gives what it gives called point by point;
  or, if it cannot be called on one point, the same rows in reversed
  order.  So a per-point likelihood that indexes ``theta[0]`` is never
  read as a batched one.
* ``"per_point"`` — the reference's contract, ``theta (D,) -> logL`` or
  ``(logL, derived)`` with derived a tensor or a list of 0-d tensors,
  vmapped over the batch with ``torch.func.vmap``.
* ``"callback"`` — any other Python/numpy likelihood, called point by point
  on the host, as the reference does; only when neither form above runs.

``calc.form`` names the form.  The first two run on the device: on a card
through B1's route for a traced likelihood (``ops/pallas_slice_v4.py``).

When the prior has an ``affine`` descriptor (``priors.py``) and the
likelihood a ``device_form`` (``models/examples.py``), ``calc.device_spec``
holds both — the prior as per-coordinate float32 arrays ``(a[D], s[D])``,
``theta = a + s * cube`` — and the CUDA slice kernels can evaluate the
model themselves.
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


def _normalise_point_output(out, n_phi: int, n_derived_decl: int):
    """The reference's return convention for one point (``theta (D,)``):
    ``logL`` or ``(logL, phi)`` with phi a tensor or a sequence of 0-d
    tensors or numbers.  Returns (logL (), phi (n_phi,)); works under
    ``torch.func.vmap``."""
    dt = real_dtype()
    logL, phi = out if isinstance(out, tuple) else (out, None)
    if not isinstance(logL, torch.Tensor):
        raise TypeError("the likelihood did not return a torch tensor")
    logL = logL.to(dt).reshape(())
    if phi is not None and not isinstance(phi, torch.Tensor):
        phi = torch.stack([p.to(dt).reshape(()) if isinstance(p, torch.Tensor)
                           else logL.new_full((), float(p)) for p in phi]) if len(phi) else None
    if isinstance(out, tuple) and (phi is None or phi.numel() == 0):
        if n_derived_decl > 0:
            raise DerivedMismatchError(
                f"likelihood returned no derived parameters but "
                f"nDerived={n_derived_decl} was declared"
            )
        phi = None
    if phi is None:
        return logL, logL.new_zeros(n_phi)
    phi = phi.to(dt).reshape(-1)[:n_phi]
    return logL, torch.cat([phi, phi.new_zeros(n_phi - phi.shape[0])])


#: cubes in the probe that decides a model's form
PROBE_POINTS = 64
_FORM_ERRORS = (TypeError, ValueError, RuntimeError, IndexError, AttributeError,
                NotImplementedError)


def _attempt(fn):
    """``fn()``, or None when it raises what a model of another form raises.
    A :class:`DerivedMismatchError` is a model bug, not a reason to take
    another form (the callback would mask it with zeros): it propagates."""
    try:
        return fn()
    except DerivedMismatchError:
        raise
    except _FORM_ERRORS:
        return None


def _same(a, b) -> bool:
    """Whether two (theta, phi, logL) triples agree: allclose at rtol 1e-5,
    with an atol of 1e-6 for float32 sums taken in another order near zero,
    infinities and NaNs equal."""
    return all(x.shape == y.shape and torch.allclose(x, y, rtol=1e-5, atol=1e-6, equal_nan=True)
               for x, y in zip(a, b))


def _model_form(batched, point, n_dims: int, device) -> str:
    """``"batched"``, ``"per_point"`` or ``"callback"`` (module docstring)
    from the raw evaluators ``batched(cube (B, D))`` and ``point(cube (D,))``,
    each returning (theta, phi, logL)."""
    rng = np.random.default_rng(20240131)
    n = PROBE_POINTS + (n_dims == PROBE_POINTS)  # never as many points as coordinates
    cube = torch.as_tensor(rng.uniform(-0.05, 1.05, (n, n_dims)).clip(0.0, 1.0),
                           dtype=real_dtype(), device=device)
    by_batch = _attempt(lambda: batched(cube))
    each = _attempt(lambda: [point(c) for c in cube])
    by_point = None if each is None else tuple(torch.stack(v) for v in zip(*each))
    if by_batch is not None:
        if by_point is not None:
            if _same(by_batch, by_point):
                return "batched"
        else:  # not callable on one point: its rows must not depend on each other
            rev = _attempt(lambda: batched(cube.flip(0)))
            if rev is not None and _same(by_batch, tuple(v.flip(0) for v in rev)):
                return "batched"
    if by_point is not None:
        vm = _attempt(lambda: torch.func.vmap(point)(cube))
        if vm is not None and _same(vm, by_point):
            return "per_point"
    return "callback"


def make_batched_calculator(
    prior_fn: Callable,
    loglike_fn: Callable,
    n_dims: int,
    n_derived: int,
    logzero: float = LOG_ZERO,
    force_callback: bool = False,
    device=None,
):
    """Build ``calc(cube_batch) -> (theta, phi, logL)`` with calculate_point
    semantics, in the model's form (module docstring), decided on
    ``device`` (the CPU by default).  ``calc.form`` names the form."""
    n_phi = max(n_derived, 1)

    def batched(cube):
        theta = prior_fn(cube)
        if not (isinstance(theta, torch.Tensor) and theta.shape == cube.shape):
            raise TypeError("the prior did not map a (B, D) cube to a (B, D) tensor")
        theta = theta.to(real_dtype())
        logL, phi = _normalise_like_output(
            loglike_fn(theta), n_phi, n_derived, cube.shape[0]
        )
        return theta, phi, logL

    def point(cube):
        theta = prior_fn(cube)
        if not (isinstance(theta, torch.Tensor) and theta.shape == cube.shape):
            raise TypeError("the prior did not map a (D,) cube to a (D,) tensor")
        theta = theta.to(real_dtype())
        logL, phi = _normalise_point_output(loglike_fn(theta), n_phi, n_derived)
        return theta, phi, logL

    form = "callback" if force_callback else _model_form(
        batched, point, n_dims, torch.device("cpu") if device is None else device)
    use_callback = form == "callback"

    if form == "batched":
        raw_eval = batched
    elif form == "per_point":
        raw_eval = torch.func.vmap(point)
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

    calc_point_batch.form = form
    calc_point_batch.uses_callback = use_callback
    calc_point_batch.n_phi = n_phi
    calc_point_batch.device_spec = None
    affine = getattr(prior_fn, "affine", None)
    device_form = getattr(loglike_fn, "device_form", None)
    if not use_callback and affine is not None and device_form is not None:
        a, s = (np.broadcast_to(np.asarray(v, np.float32), (n_dims,)).copy()
                for v in affine)
        calc_point_batch.device_spec = {
            "prior": (a, s), "likelihood": dict(device_form),
            "n_dims": n_dims, "logzero": float(logzero),
        }
    return calc_point_batch
