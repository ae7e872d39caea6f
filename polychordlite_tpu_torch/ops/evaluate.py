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
through B1 with the likelihood lowered into it (``ops/fused_like.py``), or
else B1's route for a traced likelihood (``ops/pallas_slice_v4.py``).  A
callback calc has ``calc.host_point_batch``, which evaluates ``(n, D)``
cubes held in host memory (a pinned buffer's numpy view, say) and returns
numpy arrays, building no tensor: the host route of
``ops/pallas_slice_v4.py`` calls it between two launches of B1's traced
kernel, and the calc itself is a thin torch wrapper around it.  Its prior
runs on the host too: per point on a float64 numpy row, as the JAX
package's ``_host_eval`` calls it (a numpy prior, or the C ABI's), or, for
one of the port's torch priors (the ini's block prior, say), on the whole
batch as a CPU tensor of the calc's dtype.  ``calc.user_calls`` counts the calls
of the user's likelihood.

A :class:`~polychordlite_tpu_torch.models.graded.GradedLikelihood` is
read the same way, its batched form calling ``fast_fn(slow_fn(theta[:,
:n_slow]), theta)``; a calc of one that is not a host callback also gets
``slow_aux_batch`` and ``fast_point_batch`` (``calc.graded``), which the
``"scan"`` engine uses to keep the slow part across fast-grade repeats.

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

from ..models.graded import GradedLikelihood
from .logspace import LOG_ZERO
from .precision import real_dtype


class DerivedMismatchError(ValueError):
    """The likelihood's derived-parameter return does not match the declared
    ``nDerived`` — raised loudly rather than silently writing zero columns."""


def _normalise_like_output(out, n_phi: int, n_derived_decl: int, B: int, dt: torch.dtype):
    """Accept the reference's tuple-or-scalar return convention for a batch:
    ``logL (B,)`` or ``(logL (B,), phi)`` with phi ``(B, k)`` or a sequence
    of k ``(B,)`` tensors.  Returns (logL (B,), phi (B, n_phi)) of dtype ``dt``."""
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
    if not isinstance(logL, torch.Tensor):
        raise TypeError("the likelihood did not return a torch tensor")
    logL = logL.to(dt).reshape(B)
    full = torch.zeros((B, n_phi), dtype=dt, device=logL.device)
    if phi is not None:
        k = min(phi.shape[1], n_phi)
        full[:, :k] = phi[:, :k].to(dt)
    return logL, full


def _normalise_point_output(out, n_phi: int, n_derived_decl: int, dt: torch.dtype):
    """The reference's return convention for one point (``theta (D,)``):
    ``logL`` or ``(logL, phi)`` with phi a tensor or a sequence of 0-d
    tensors or numbers.  Returns (logL (), phi (n_phi,)) of dtype ``dt``;
    works under ``torch.func.vmap``."""
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


#: the tolerance at which two forms of a model agree: rtol 1e-5, with an
#: atol of 1e-6 for float32 sums taken in another order near zero
FORM_RTOL, FORM_ATOL = 1e-5, 1e-6


def same_values(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether two tensors agree at the forms' tolerance, infinities and
    NaNs equal."""
    return x.shape == y.shape and torch.allclose(x, y, rtol=FORM_RTOL, atol=FORM_ATOL,
                                                 equal_nan=True)


def _same(a, b) -> bool:
    """Whether two (theta, phi, logL) triples agree (:func:`same_values`)."""
    return all(same_values(x, y) for x, y in zip(a, b))


def probe_cubes(n_dims: int, device, dtype=None) -> torch.Tensor:
    """The :data:`PROBE_POINTS` seeded cubes a model's form is decided on:
    drawn from [-0.05, 1.05]^D and clamped as the calc clamps them, so some
    lie on the cube's walls (one point more where D equals their number),
    in ``dtype`` (:func:`real_dtype` by default)."""
    rng = np.random.default_rng(20240131)
    n = PROBE_POINTS + (n_dims == PROBE_POINTS)  # never as many points as coordinates
    return torch.as_tensor(rng.uniform(-0.05, 1.05, (n, n_dims)).clip(0.0, 1.0),
                           dtype=real_dtype() if dtype is None else dtype, device=device)


def _model_form(batched, point, n_dims: int, device, dtype) -> str:
    """``"batched"``, ``"per_point"`` or ``"callback"`` (module docstring)
    from the raw evaluators ``batched(cube (B, D))`` and ``point(cube (D,))``,
    each returning (theta, phi, logL)."""
    cube = probe_cubes(n_dims, device, dtype)
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


def _torch_prior(prior_fn) -> bool:
    """Whether a host-callback calc calls the prior on the batch as a CPU
    tensor of the calc's dtype (the dtype in which the JAX package's
    callback evaluates its priors): the port's own priors (:mod:`..priors`, the ini's
    block prior among them), which are torch functions of a tensor.  Any
    other prior (a numpy prior, or the C ABI's) is called per point on a
    float64 numpy row, as the JAX package's ``_host_eval`` calls it, and
    what it raises propagates."""
    from ..priors import BlockPrior, GaussianPrior, UniformPrior, identity_prior

    return prior_fn is identity_prior or isinstance(
        prior_fn, (UniformPrior, GaussianPrior, BlockPrior))


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
    ``device`` (the CPU by default).  ``calc.form`` names the form.  The
    calc computes in :func:`real_dtype` as it is when the calc is made
    (``calc.dtype``: float64 under ``precision='highest'``)."""
    n_phi = max(n_derived, 1)
    dt = real_dtype()
    graded = isinstance(loglike_fn, GradedLikelihood)

    def batched(cube):
        theta = prior_fn(cube)
        if not (isinstance(theta, torch.Tensor) and theta.shape == cube.shape):
            raise TypeError("the prior did not map a (B, D) cube to a (B, D) tensor")
        theta = theta.to(dt)
        if graded:  # the object's own call is per point: slice the columns here
            out = loglike_fn.fast_fn(loglike_fn.slow_fn(theta[:, :loglike_fn.n_slow]), theta)
        else:
            out = loglike_fn(theta)
        logL, phi = _normalise_like_output(out, n_phi, n_derived, cube.shape[0], dt)
        return theta, phi, logL

    def point(cube):
        theta = prior_fn(cube)
        if not (isinstance(theta, torch.Tensor) and theta.shape == cube.shape):
            raise TypeError("the prior did not map a (D,) cube to a (D,) tensor")
        theta = theta.to(dt)
        logL, phi = _normalise_point_output(loglike_fn(theta), n_phi, n_derived, dt)
        return theta, phi, logL

    form = "callback" if force_callback else _model_form(
        batched, point, n_dims, torch.device("cpu") if device is None else device, dt)
    use_callback = form == "callback"

    if form == "batched":
        raw_eval = batched
    elif form == "per_point":
        raw_eval = torch.func.vmap(point)
    else:
        torch_prior = _torch_prior(prior_fn)

        def _host_eval(cube_np):
            B = cube_np.shape[0]
            thetas = np.zeros((B, n_dims))
            phis = np.zeros((B, n_phi))
            logLs = np.full((B,), logzero)
            if torch_prior:  # on the batch
                batch = np.asarray(prior_fn(torch.from_numpy(cube_np).to(dt)), dtype=np.float64)
            for i in range(B):
                theta = (batch[i].copy() if torch_prior
                         else np.asarray(prior_fn(cube_np[i]), dtype=np.float64))
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

        np_dt = np.float32 if dt == torch.float32 else np.float64
        lz = np_dt(logzero)

        def host_point_batch(cube_np: np.ndarray):
            """(n, D) cubes in host memory -> (theta (n, D), phi (n, n_phi),
            logL (n,)) numpy arrays of the calc's dtype, with
            :func:`calc_point_batch`'s semantics: the likelihood is called
            on each cube clamped to the walls (one call a row), and a cube
            outside them gets logL = logzero and theta = phi = 0; a NaN logL
            counts as logzero."""
            cube_np = np.asarray(cube_np)
            inside = ((cube_np >= 0.0) & (cube_np <= 1.0)).all(axis=1)
            th, ph, ll = _host_eval(np.clip(cube_np, 0.0, 1.0).astype(np.float64))
            calc_point_batch.user_calls += len(cube_np)
            ll = ll.astype(np_dt)
            ll[np.isnan(ll) | ~inside] = lz
            th, ph = th.astype(np_dt), ph.astype(np_dt)
            th[~inside] = 0.0
            ph[~inside] = 0.0
            return th, ph, ll

    if use_callback:

        def calc_point_batch(cube: torch.Tensor):
            """(B, D) cube -> (theta (B,D), phi (B,n_phi), logL (B,)) on the
            cube's device, from :func:`host_point_batch` on the host."""
            return tuple(torch.from_numpy(a).to(cube.device)
                         for a in host_point_batch(cube.detach().cpu().numpy()))

        calc_point_batch.host_point_batch = host_point_batch
        calc_point_batch.user_calls = 0
    else:

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
    calc_point_batch.n_dims = n_dims
    calc_point_batch.logzero = float(logzero)
    calc_point_batch.dtype = dt
    # what the fused route lowers (ops/fused_like.py), and where it was decided
    calc_point_batch.model = (prior_fn, loglike_fn, n_derived)
    calc_point_batch.device = torch.device("cpu") if device is None else torch.device(device)
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
    calc_point_batch.graded = False
    if graded and not use_callback:
        _attach_graded(calc_point_batch, prior_fn, loglike_fn, form, n_phi, n_derived, dt)
    return calc_point_batch


def _attach_graded(calc, prior_fn, like: GradedLikelihood, form: str, n_phi: int,
                   n_derived: int, dt: torch.dtype) -> None:
    """The decomposed fast/slow evaluators of a :class:`GradedLikelihood`
    (``polychordlite_tpu/ops/evaluate.py:264-305``), in the calc's form:
    ``slow_fn`` and ``fast_fn`` called on the batch, or per point through
    ``torch.func.vmap``.  ``aux`` is what ``slow_fn`` returns: a tensor, or
    a dict, list or tuple of tensors, each with the chain axis first."""
    n_slow, logzero = like.n_slow, calc.logzero

    def theta_of(cube):
        return prior_fn(cube).to(dt)

    if form == "batched":
        def slow_eval(cube):
            return like.slow_fn(theta_of(cube)[:, :n_slow])

        def fast_eval(aux, cube):
            theta = theta_of(cube)
            logL, phi = _normalise_like_output(like.fast_fn(aux, theta), n_phi, n_derived,
                                               cube.shape[0], dt)
            return theta, phi, logL
    else:
        def slow_one(cube):
            return like.slow_fn(theta_of(cube)[:n_slow])

        def fast_one(aux, cube):
            theta = theta_of(cube)
            logL, phi = _normalise_point_output(like.fast_fn(aux, theta), n_phi, n_derived, dt)
            return theta, phi, logL

        slow_eval, fast_eval = torch.func.vmap(slow_one), torch.func.vmap(fast_one)

    def slow_aux_batch(cube: torch.Tensor):
        """(B, D) cubes -> the slow intermediate of each, from the prior of
        the cube clamped to its walls (the calc's clamp)."""
        return slow_eval(cube.clamp(0.0, 1.0))

    def fast_point_batch(aux, cube: torch.Tensor):
        """Fast-grade probe evaluation re-using the cached slow intermediate,
        with calculate_point's semantics (cube walls, NaN guard,
        ``calculate.f90:36-42``): a probe outside the cube gets logzero and
        theta = phi = 0, whatever ``aux`` holds."""
        inside = ((cube >= 0.0) & (cube <= 1.0)).all(dim=1)
        theta, phi, logL = fast_eval(aux, cube.clamp(0.0, 1.0))
        logL = torch.where(torch.isnan(logL), logzero, logL)
        logL = torch.where(inside, logL, logzero)
        theta = torch.where(inside[:, None], theta, 0.0)
        phi = torch.where(inside[:, None], phi, 0.0)
        return theta, phi, logL

    calc.graded = True
    calc.n_slow = n_slow
    calc.slow_aux_batch = slow_aux_batch
    calc.fast_point_batch = fast_point_batch
