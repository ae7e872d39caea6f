"""Python side of the port's C ABI (``cabi/capi.c``; counterpart of
``polychordlite_tpu/capi.py``).

The reference exposes ``polychord_c_interface``, a flat 38-argument bind(c)
routine carrying every setting plus three C function pointers
(``interfaces.F90:285-436``, ``interfaces.h``).  The C shim embeds CPython
(or runs inside a Python process that loaded it) and forwards the same
arguments here; this module wraps the raw callback addresses with ctypes
and drives the port's :func:`~polychordlite_tpu_torch.run.run_polychord`
or :func:`~polychordlite_tpu_torch.inidriver.run_ini`.  A ctypes callable is
not a torch function, so the calc reads the likelihood as a host callback
(``ops/evaluate.py``), and the C prior as a host prior: on the card the run
takes the host route (``ops/pallas_slice_v4.py::slice_epoch_host``), B1's
traced kernel driven round by round with the C functions called between
two launches — the reference's slow-likelihood regime.

The C entry points have a fixed signature, so the device comes from
:data:`DEVICE`: ``None`` (the default) runs on the card, as every entry
point of the port does, and raises without one; set it to ``"cpu"`` (as
the tests do) before the C side calls in to run on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .settings import PolyChordSettings

#: the torch device of the runs the C ABI starts: None means "cuda"
DEVICE = None

_D = ctypes.c_double
_PD = ctypes.POINTER(_D)

LOGLIKE_T = ctypes.CFUNCTYPE(_D, _PD, ctypes.c_int, _PD, ctypes.c_int)
# the likelihood's and the prior's signatures with the arrays passed as
# addresses: the wrappers below call them once a point on the host, and an
# address costs less to pass than a ctypes pointer object
_VP = ctypes.c_void_p
_LOGLIKE_ADDR_T = ctypes.CFUNCTYPE(_D, _VP, ctypes.c_int, _VP, ctypes.c_int)
_PRIOR_ADDR_T = ctypes.CFUNCTYPE(None, _VP, _VP, ctypes.c_int)
DUMPER_T = ctypes.CFUNCTYPE(
    None, ctypes.c_int, ctypes.c_int, ctypes.c_int, _PD, _PD, _PD, _D, _D
)


def _read_array(ptr, n, ctype):
    if not ptr or n <= 0:
        return None
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(n,)
    ).copy()


def _wrap_callbacks(ll_ptr, prior_ptr, dumper_ptr, nDims, nDerived):
    """Python callables over the C callbacks.  The likelihood and the prior
    take one point of nDims values (the host evaluator calls them once a
    point, ``ops/evaluate.py``): the point is copied into a buffer kept for
    the wrapper and passed with the output buffer by address; the
    likelihood returns ``(logL, derived list)``, the prior a new theta
    array.  Called on anything but nDims values they raise ``ValueError``."""
    c_like = _LOGLIKE_ADDR_T(ll_ptr)
    c_prior = _PRIOR_ADDR_T(prior_ptr) if prior_ptr else None
    c_dumper = DUMPER_T(dumper_ptr) if dumper_ptr else None
    like_in, phi = np.zeros(nDims), np.zeros(max(nDerived, 1))
    prior_in = np.zeros(nDims)
    like_in_at, phi_at, prior_in_at = (a.ctypes.data for a in (like_in, phi, prior_in))

    def loglikelihood(theta):
        like_in[...] = theta
        logL = c_like(like_in_at, nDims, phi_at, nDerived)
        return float(logL), phi[:nDerived].tolist()

    def prior(cube):
        prior_in[...] = cube
        theta = np.zeros(nDims)
        c_prior(prior_in_at, theta.ctypes.data, nDims)
        return theta

    def dumper(live, dead, logweights, logZ, logZerr):
        # Fortran passes live(npars, nlive) column-major == one point's
        # parameters contiguous — exactly C-order rows-of-points here.
        live = np.ascontiguousarray(live, dtype=np.float64)
        dead = np.ascontiguousarray(dead, dtype=np.float64)
        lw = np.ascontiguousarray(logweights, dtype=np.float64)
        c_dumper(
            dead.shape[0],
            live.shape[0],
            live.shape[1] if live.ndim == 2 else 0,
            live.ctypes.data_as(_PD),
            dead.ctypes.data_as(_PD),
            lw.ctypes.data_as(_PD),
            float(logZ),
            float(logZerr),
        )

    if prior_ptr == 0 or c_prior is None:
        prior = None
    if dumper_ptr == 0 or c_dumper is None:
        dumper = None
    return loglikelihood, prior, dumper


def run_from_c(
    ll_ptr, prior_ptr, dumper_ptr,
    nlive, num_repeats, nprior, nfail, do_clustering, feedback,
    precision_criterion, logzero, max_ndead, boost_posterior,
    posteriors, equals, cluster_posteriors, write_resume, write_paramnames,
    read_resume, write_stats, write_live, write_dead, write_prior, maximise,
    compression_factor, synchronous, nDims, nDerived, base_dir, file_root,
    nGrade, grade_frac_ptr, grade_dims_ptr, n_nlives, loglikes_ptr,
    nlives_ptr, seed,
):
    """Entry point called by ``cabi/capi.c`` polychord_c_interface."""
    from .core.nested_sampling import default_dumper, default_prior
    from .run import run_polychord

    loglikelihood, prior, dumper = _wrap_callbacks(
        ll_ptr, prior_ptr, dumper_ptr, nDims, nDerived
    )

    s = PolyChordSettings(nDims=nDims, nDerived=nDerived)
    s.nlive = nlive
    s.num_repeats = num_repeats
    s.nprior = nprior
    s.nfail = nfail
    s.do_clustering = bool(do_clustering)
    s.feedback = feedback
    s.precision_criterion = precision_criterion
    s.logzero = logzero
    s.max_ndead = max_ndead
    s.boost_posterior = boost_posterior
    s.posteriors = bool(posteriors)
    s.equals = bool(equals)
    s.cluster_posteriors = bool(cluster_posteriors)
    s.write_resume = bool(write_resume)
    s.write_paramnames = bool(write_paramnames)
    s.read_resume = bool(read_resume)
    s.write_stats = bool(write_stats)
    s.write_live = bool(write_live)
    s.write_dead = bool(write_dead)
    s.write_prior = bool(write_prior)
    s.maximise = bool(maximise)
    s.compression_factor = compression_factor
    s.synchronous = bool(synchronous)
    s.base_dir = base_dir
    s.file_root = file_root
    s.seed = seed

    gf = _read_array(grade_frac_ptr, nGrade, ctypes.c_double)
    gd = _read_array(grade_dims_ptr, nGrade, ctypes.c_int)
    if gf is not None:
        s.grade_frac = gf.tolist()
    if gd is not None:
        s.grade_dims = [int(x) for x in gd]
    lls = _read_array(loglikes_ptr, n_nlives, ctypes.c_double)
    nls = _read_array(nlives_ptr, n_nlives, ctypes.c_int)
    if lls is not None and nls is not None:
        s.nlives = {float(l): int(n) for l, n in zip(lls, nls)}

    run_polychord(
        loglikelihood,
        nDims,
        nDerived,
        s,
        prior=prior if prior is not None else default_prior,
        dumper=dumper if dumper is not None else default_dumper,
        device=DEVICE,
    )
    return 0


def run_from_c_ini(ll_ptr, inifile):
    """Entry point called by ``cabi/capi.c`` polychord_c_interface_ini."""
    from .inidriver import run_ini

    c_like = LOGLIKE_T(ll_ptr)

    def loglikelihood(theta, n_derived):
        theta = np.ascontiguousarray(np.asarray(theta, dtype=np.float64))
        phi = np.zeros(max(n_derived, 1), dtype=np.float64)
        logL = c_like(
            theta.ctypes.data_as(_PD),
            theta.shape[0],
            phi.ctypes.data_as(_PD),
            n_derived,
        )
        return float(logL), phi[:n_derived].tolist()

    run_ini(inifile, loglikelihood=loglikelihood, device=DEVICE)
    return 0
