"""Host-callback likelihoods in the port, on the CPU: the host route's plain
version (``ops/pallas_slice_v4.py::slice_records_host_plain``), the host
evaluator (``ops/evaluate.py``: ``calc.host_point_batch``) against the JAX
package's callback calc, the epoch record's babies from the kept probes
(``ProbeKeeper.babies``), the engine rules
(``core/nested_sampling.py::resolve_engine``) and runs through ``run()``,
against the JAX package's scan engine.

A callback likelihood is a Python or numpy function of one point (here, a
normalised Gaussian written with numpy); the JAX package sends it to its
scan engine through ``jax.pure_callback``, and the port to the same
kernel as its traced route, driven round by round with the function
called on the host between two launches (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold the kernel on the card)."""

import contextlib
import json
import math
import os

import numpy as np
import pytest
import torch

import polychordlite_tpu_torch
from polychordlite_tpu_torch import GradedLikelihood
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.ops import pallas_slice_v4 as v4
from polychordlite_tpu_torch.ops.directions import make_directions
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.precision import real_dtype_scope
from polychordlite_tpu_torch.ops.slice_kernel import (
    EpochConfig,
    build_epoch_fn,
    epoch_route,
    route_reason,
    slice_records_plain,
)
from polychordlite_tpu_torch.priors import BlockPrior, PriorBlock, UniformPrior, identity_prior

torch.set_num_threads(2)

D, B, R = 5, 64, 6
SIGMA = 0.1
KEY = (0x01234567, 0x89ABCDEF)


class NumpyGaussian:
    """A normalised Gaussian at 0.5 written with numpy, one point a call,
    with r as its derived parameter; counts its calls."""

    def __init__(self, n_dims=D):
        self.n_dims, self.calls = n_dims, 0

    def __call__(self, theta):
        theta = np.asarray(theta, dtype=np.float64)
        self.calls += 1
        r2 = float(np.sum((theta - 0.5) ** 2))
        norm = -self.n_dims * math.log(SIGMA * math.sqrt(2 * math.pi))
        return norm - r2 / (2 * SIGMA ** 2), [math.sqrt(r2)]


def epoch_inputs(calc, dtype, seed=0, spread=0.08):
    """Seeds around the peak, some near the walls so that probes leave the
    cube, bounds 2 below each seed's logL, a whitening of the width, four
    invalid lanes, and directions from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    x0 = (0.5 + spread * torch.randn(B, D, generator=g, dtype=dtype)).clamp(0.0, 1.0)
    x0[:3, 0] = torch.tensor([0.0, 0.01, 0.995], dtype=dtype)
    bound = calc(x0)[2] - 2.0
    valid = torch.arange(B) < B - 4
    chol = (0.1 * torch.eye(D, dtype=dtype)).expand(B, D, D)
    nh, w, sp = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=g)
    return x0, bound, valid, nh, w, sp


CFG = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))


def callback_calc(dtype, like=None, prior=identity_prior):
    with real_dtype_scope(dtype):
        return make_batched_calculator(prior, like or NumpyGaussian(), D, 1)


def rebuilt_cube(x0, t, nh):
    """The babies' cubes as the traced route rebuilds them."""
    return x0[:, None, :] + torch.cumsum(t[:, :, None] * nh, dim=1)


def reached(valid, t):
    """The (B, R) rows of valid lanes at or after their first accepted
    probe: the rows the host route's babies fill from a kept probe."""
    return valid[:, None] & (torch.cummax((t != 0).int(), dim=1).values > 0)


def cube_ulps(dtype):
    """How far, in units of the dtype's epsilon, a kept probe may lie from
    the rebuilt cube of the same repeat: the kernel moves x by one rounded
    add a repeat, the rebuild adds the rounded cumulative sum to the seed
    once, so they part by at most one rounding a repeat (R of them)."""
    return R * torch.finfo(dtype).eps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_host_route_plain_is_the_plain_engine(dtype):
    """Over two epochs (the second seeded from the first's last babies), the
    host route's plain version gives the plain engine's t, logL and nlike
    bit for bit on the same callback calc: the kernel consumes a logL only
    where a probe is pending, and the host evaluator is the calc's.  The
    epoch records agree bit for bit in logL and nlike; the babies' cubes
    are the accepted probes, within :func:`cube_ulps` of the plain
    engine's rebuilt ones."""
    calc = callback_calc(dtype)
    assert calc.form == "callback" and calc.uses_callback and calc.dtype == dtype
    x0, bound, valid, nh, w, sp = epoch_inputs(calc, dtype)
    stride = 2 * D + 2
    for epoch in range(2):
        key = (KEY[0] + epoch, KEY[1])
        want = slice_records_plain(lambda p: calc(p)[2], CFG, key, x0, bound, valid, nh, w)
        *got, (cube, theta, phi) = v4.slice_records_host_plain(calc, CFG, key, x0, bound,
                                                               valid, nh, w)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(want[2].sum()) > 0
        rec_want = v4.assemble_epoch(calc, CFG, x0, valid, nh, sp, *want)
        rec_got = v4.assemble_epoch(calc, CFG, x0, valid, nh, sp, *got, cube=cube,
                                    theta_phi=(theta, phi))
        assert rec_got.shape == rec_want.shape and rec_got.dtype == rec_want.dtype
        per_got = rec_got[:, :R * stride].reshape(B, R, stride)
        per_want = rec_want[:, :R * stride].reshape(B, R, stride)
        assert torch.equal(per_got[:, :, -1], per_want[:, :, -1])
        assert torch.equal(rec_got[:, R * stride:], rec_want[:, R * stride:])
        gap = (per_got[:, :, :D] - per_want[:, :, :D]).abs().max().item()
        assert gap <= cube_ulps(dtype)
        last = per_got[:, R - 1, :D]
        x0 = torch.where(valid[:, None], last, x0)
        bound = calc(x0)[2] - 1.0


def test_user_calls_against_nlike():
    """One call of the user's function for each probe a lane consumes: the
    total equals the micro-steps the lanes took (the plain engine's step
    count), and exceeds nlike by the consumed probes whose logL is logzero
    (here the probes outside the cube: nlike counts calls with logL above
    logzero, ``LaneMachine``).  The plain engine, which evaluates every
    lane at every step, makes more calls."""
    like = NumpyGaussian()
    calc = callback_calc(torch.float32, like)
    x0, bound, valid, nh, w, _ = epoch_inputs(calc, torch.float32, spread=0.3)
    below = [0]
    evaluate = calc.host_point_batch

    def counting(cube):
        out = evaluate(cube)
        below[0] += int((out[2] <= np.float32(calc.logzero)).sum())
        return out

    calc.host_point_batch = counting
    h0, calls0 = dict(v4.HOST), like.calls
    t, logL, nlike, _ = v4.slice_records_host_plain(calc, CFG, KEY, x0, bound, valid, nh, w)
    calls = like.calls - calls0
    *_, steps = slice_records_plain(lambda p: calc(p)[2], CFG, KEY, x0, bound, valid, nh, w,
                                    count_steps=True)
    plain_calls = like.calls - calls0 - calls
    assert calls == v4.HOST["probe_calls"] - h0["probe_calls"] == int(steps.sum())
    assert below[0] > 0 and calls == int(nlike.sum()) + below[0]
    assert plain_calls > calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_kept_probes_match_re_evaluation(dtype):
    """The babies are the accepted probes, as the JAX package's scan engine
    emits them: each row's cube is a probe the user's function was called
    on, and its theta and phi are bit for bit the calc's re-evaluation of
    that cube, so the epoch record calls the user's function no more (the
    plain engine's record calls it on all B R babies).  A repeat that
    accepted none holds the lane's last accepted probe; an invalid lane's
    rows are its seed with theta = phi = 0.  The first repeat's cube is
    the rebuilt one bit for bit (one rounded add from the seed on both
    sides), the others within :func:`cube_ulps`."""
    like = NumpyGaussian()
    calc = callback_calc(dtype, like)
    x0, bound, valid, nh, w, sp = epoch_inputs(calc, dtype)
    h0, calls0 = dict(v4.HOST), like.calls
    t, logL, nlike, (cube, theta, phi) = v4.slice_records_host_plain(calc, CFG, KEY, x0, bound,
                                                                     valid, nh, w)
    assert like.calls - calls0 == v4.HOST["probe_calls"] - h0["probe_calls"] > 0
    calls0 = like.calls
    v4.assemble_epoch(calc, CFG, x0, valid, nh, sp, t, logL, nlike, cube=cube,
                      theta_phi=(theta, phi))
    assert like.calls == calls0
    assert cube.dtype == theta.dtype == phi.dtype == dtype
    assert theta.shape == cube.shape == (B, R, D) and phi.shape == (B, R, 1)
    rows = reached(valid, t)
    assert int(rows.sum()) == int(valid.sum()) * R
    th_all, ph_all, _ = calc(cube.reshape(B * R, D))
    assert torch.equal(theta[rows], th_all.reshape(B, R, D)[rows])
    assert torch.equal(phi[rows], ph_all.reshape(B, R, 1)[rows])
    assert not theta[~rows].any() and not phi[~rows].any()
    assert torch.equal(cube[~valid], x0[~valid, None, :].expand(-1, R, -1))
    rebuilt = rebuilt_cube(x0, t, nh)
    first = valid & (t[:, 0] != 0)
    assert int(first.sum()) > 0 and torch.equal(cube[first, 0], rebuilt[first, 0])
    assert (cube - rebuilt).abs().max().item() <= cube_ulps(dtype)


def test_engine_rules_for_a_callback(monkeypatch):
    """"auto" resolves to "scan" for a callback calc on every device (the
    JAX package's rule); on it the route is the host route; a kernel engine
    forced by name raises, naming "scan" (the JAX package warns and runs
    scan: ROADMAP C); "torch" stays the plain engine.  A GradedLikelihood
    read as a callback has no graded evaluators and runs on the host route
    as one callable."""
    calc = callback_calc(torch.float32)
    cpu = torch.device("cpu")
    assert ns.resolve_engine("auto", cpu, calc) == "scan"
    assert ns.resolve_engine("torch", cpu, calc) == "torch"
    assert epoch_route("scan", calc) == "slice_step_host"
    assert "host function" in route_reason("scan", calc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = ns.resolve_device("cuda")
    assert ns.resolve_engine("auto", cuda, calc) == "scan"
    assert ns.resolve_engine("scan", cuda, calc) == "scan"
    for engine in ns.KERNEL_ENGINES:
        with pytest.raises(ValueError, match="engine='scan'"):
            ns.resolve_engine(engine, cuda, calc)
    graded = GradedLikelihood(lambda ts: np.sum(np.asarray(ts) ** 2),
                              lambda aux, t: -float(aux) - float(np.sum(np.asarray(t) ** 2)), 2)
    g = make_batched_calculator(identity_prior, graded, D, 0, force_callback=True)
    assert g.uses_callback and not g.graded
    assert ns.resolve_engine("auto", cuda, g) == "scan"
    assert epoch_route("scan", g) == "slice_step_host"


def test_host_route_refuses_a_torch_model():
    calc = make_batched_calculator(identity_prior, lambda th: -(th ** 2).sum(-1), D, 0)
    x0, bound, valid, nh, w, _ = epoch_inputs(calc, torch.float32)
    with pytest.raises(ValueError, match="traced route"):
        v4.slice_epoch_host(calc, CFG, KEY, x0, bound, valid, nh, w)


def test_host_prior():
    """A host prior (a numpy function of one cube, as the C ABI's prior
    pointer is wrapped) runs per point on the host: the host route's plain
    version is still the plain engine bit for bit, theta is the prior's.
    One of the port's torch priors (the ini's block prior) runs on the
    batch as a CPU tensor of the calc's dtype, and gives the same theta as
    called on the tensor.  What a host prior raises propagates: the calc does not
    move it to another path."""
    def numpy_prior(cube):
        return -1.0 + 2.0 * np.asarray(cube, dtype=np.float64)

    calc = callback_calc(torch.float32, prior=numpy_prior)
    x0, bound, valid, nh, w, sp = epoch_inputs(calc, torch.float32)
    want = slice_records_plain(lambda p: calc(p)[2], CFG, KEY, x0, bound, valid, nh, w)
    *got, keeper = v4.slice_records_host_plain(calc, CFG, KEY, x0, bound, valid, nh, w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    theta = calc(x0)[0]
    assert torch.equal(theta, (-1.0 + 2.0 * x0.double()).float())
    block = BlockPrior([PriorBlock("uniform", tuple(range(D)), tuple(range(D)),
                                   (-1.0, 1.0) * D)], D)
    with pytest.raises(TypeError):
        block(x0[0].numpy())
    blocked = callback_calc(torch.float32, prior=block)
    assert torch.equal(blocked(x0)[0], block(x0))

    def failing_prior(cube):
        raise ZeroDivisionError("a user's prior failed")

    with pytest.raises(ZeroDivisionError, match="user's prior"):
        callback_calc(torch.float32, prior=failing_prior)(x0)


def quickstart_numpy(theta):
    """The reference quickstart written with numpy (4-D, sigma 0.1, r^2
    derived): a host callback."""
    theta = np.asarray(theta, dtype=np.float64)
    r2 = float(np.sum(theta ** 2))
    return -math.log(2 * math.pi * 0.01) * 2.0 - r2 / 2 / 0.01, [r2]


QUICK_KW = dict(nDerived=1, nlive=50, num_repeats=8, do_clustering=False, read_resume=False,
                feedback=-1)


def test_callback_run_takes_the_host_route(tmp_path):
    """run() on a numpy likelihood with the default engine, on the CPU:
    engine "scan", route "slice_step_host" (its plain version), one epoch
    at a time, the user's calls counted in the metrics; within 3 sigma of
    -4 log 2, as the same run on engine="torch" is (its babies are the
    accepted probes, the plain engine's the rebuilt cubes: another chain)."""
    runs = {}
    for engine in ("auto", "torch"):
        base = tmp_path / engine
        out = polychordlite_tpu_torch.run(quickstart_numpy, 4, base_dir=str(base), engine=engine,
                                          prior=UniformPrior(-1, 1), seed=3, device="cpu",
                                          **QUICK_KW)
        last = json.loads((base / "test.metrics.jsonl").read_text().splitlines()[-1])
        runs[engine] = (out, last)
    out, last = runs["auto"]
    assert (last["engine"], last["route"]) == ("scan", "slice_step_host")
    assert runs["torch"][1]["route"] == "plain"
    assert last["chained_epochs"] is False
    host = last["host_route"]
    assert last["host_calls"] >= host["probe_calls"] > 0 and host["rounds"] > 0
    for out, _ in runs.values():
        assert abs(out.logZ + 4 * math.log(2.0)) < 3 * out.logZerr


def test_callback_run_matches_the_jax_scan_engine(tmp_path):
    """The same seeded numpy quickstart through the JAX package's run() on
    the CPU (its scan engine, the likelihood through ``jax.pure_callback``)
    and the port's (the host route's plain version): logZ within 3
    combined sigma."""
    from polychordlite_tpu import run as jax_run
    from polychordlite_tpu.priors import UniformPrior as JaxUniformPrior

    ref = jax_run(quickstart_numpy, 4, base_dir=str(tmp_path / "jax"),
                  prior=JaxUniformPrior(-1, 1), seed=3, **QUICK_KW)
    out = polychordlite_tpu_torch.run(quickstart_numpy, 4, base_dir=str(tmp_path / "port"),
                                      prior=UniformPrior(-1, 1), seed=3, device="cpu",
                                      **QUICK_KW)
    last = json.loads((tmp_path / "port" / "test.metrics.jsonl").read_text().splitlines()[-1])
    assert last["route"] == "slice_step_host"
    combined = math.hypot(out.logZerr, ref.logZerr)
    assert abs(out.logZ - ref.logZ) < 3 * combined, (out.logZ, ref.logZ, combined)


def test_scan_epoch_through_build_epoch_fn():
    """engine "scan" on a callback calc: build_epoch_fn's epoch is the host
    route's record (its plain version and kept probes) bit for bit, and
    the plain engine's in logL and nlike (directions from the same
    draws)."""
    calc = callback_calc(torch.float32)
    x0, bound, valid, nh, w, sp = epoch_inputs(calc, torch.float32)
    chol = (0.1 * torch.eye(D)).expand(B, D, D)
    got = build_epoch_fn(calc, CFG._replace(engine="scan"))(
        KEY, x0, bound, chol, valid, directions=(nh, w, sp))
    *rec, (cube, theta, phi) = v4.slice_records_host_plain(calc, CFG, KEY, x0, bound, valid,
                                                           nh, w)
    assert torch.equal(got, v4.assemble_epoch(calc, CFG, x0, valid, nh, sp, *rec, cube=cube,
                                              theta_phi=(theta, phi)))
    want = build_epoch_fn(calc, CFG)(KEY, x0, bound, chol, valid, directions=(nh, w, sp))
    stride = 2 * D + 2
    logL = slice(stride - 1, R * stride, stride)
    assert torch.equal(got[:, logL], want[:, logL])
    assert torch.equal(got[:, R * stride:], want[:, R * stride:])


# ---------------------------------------------------------------------------
# the host evaluator against the JAX package's callback calc
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def jax_real(dtype):
    """The JAX package's calc dtype for ``dtype``, as its run sets it at
    precision='highest' (``jax.enable_x64`` and ``set_real_dtype``)."""
    import jax
    import jax.numpy as jnp
    from polychordlite_tpu.ops.precision import set_real_dtype

    x64 = dtype == torch.float64
    with jax.enable_x64(x64):
        set_real_dtype(jnp.float64 if x64 else jnp.float32)
        try:
            yield
        finally:
            set_real_dtype(jnp.float32)


def nan_gaussian(theta):
    """A numpy Gaussian with two derived parameters that returns NaN where
    theta[0] > 0.7, and one derived parameter of the two declared where
    theta[1] < 0.3 (the rest padded with zeros)."""
    theta = np.asarray(theta, dtype=np.float64)
    if theta[0] > 0.7:
        return float("nan"), [1.0, 2.0]
    r2 = float(np.sum((theta - 0.5) ** 2))
    return -r2 / (2 * SIGMA ** 2), [math.sqrt(r2)] if theta[1] < 0.3 else [math.sqrt(r2), r2]


def shifted_prior(cube):
    return -1.0 + 2.0 * np.asarray(cube, dtype=np.float64)


def block_priors(n_dims):
    """fitting.ini's block priors (sorted_uniform among them) in both
    packages."""
    from polychordlite_tpu.priors import hypercube_to_physical
    from polychordlite_tpu.utils.inifile import read_ini as jax_read_ini
    from polychordlite_tpu_torch.utils.inifile import read_ini

    ini = os.path.join(REPO, "ini", "fitting.ini")
    jax_blocks = jax_read_ini(ini)[1]
    return BlockPrior(read_ini(ini)[1], n_dims), lambda c: hypercube_to_physical(c, jax_blocks)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_CASES = {  # name: (n_dims, n_derived, likelihood)
    "gaussian": (D, 1, NumpyGaussian()),
    "nan_and_short_derived": (D, 2, nan_gaussian),
    "numpy_prior": (D, 1, NumpyGaussian()),
    "block_prior": (20, 1, NumpyGaussian(20)),
}


def eval_cubes(n_dims, n=256, seed=11):
    """Seeded cubes in [0, 1], a quarter with one coordinate outside (below
    0 or above 1), and rows on the walls."""
    rng = np.random.default_rng(seed)
    cube = rng.uniform(size=(n, n_dims))
    out = np.arange(0, n, 4)
    cube[out, rng.integers(0, n_dims, len(out))] = np.where(out % 8 == 0, -0.03, 1.04)
    cube[1, :] = 0.0
    cube[3, :] = 1.0
    return cube


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_host_evaluator_matches_the_jax_callback_calc(case, dtype):
    """The same cubes through the port's host evaluator
    (``calc.host_point_batch`` and the calc over it) and the JAX package's
    callback calc (``_host_eval`` through ``jax.pure_callback``): theta,
    phi and logL bit for bit, cubes outside [0, 1] at logzero with theta =
    phi = 0, a NaN logL at logzero, derived parameters padded as JAX pads
    them; a numpy prior per point.  The ini's block prior is the port's
    torch prior on the batch in the calc's dtype against the JAX prior per
    point in the same dtype: its uniform columns bit for bit, its
    sorted_uniform columns (``forced_identifiability_transform``: log,
    a reverse cumulative sum and exp, in torch's and XLA's libraries)
    within 64 ulps of the dtype (measured: 32 in float32, 24 in float64),
    phi and logL within 8 (measured: 1, and 4 for logL in float64)."""
    from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator

    n_dims, n_derived, like = EVAL_CASES[case]
    prior = jax_prior = identity_prior
    if case == "numpy_prior":
        prior = jax_prior = shifted_prior
    elif case == "block_prior":
        prior, jax_prior = block_priors(n_dims)
    cube = eval_cubes(n_dims).astype(np.float32 if dtype == torch.float32 else np.float64)
    with real_dtype_scope(dtype):
        calc = make_batched_calculator(prior, like, n_dims, n_derived, force_callback=True)
    host = calc.host_point_batch(cube)
    port = [a.numpy() for a in calc(torch.from_numpy(cube))]
    with jax_real(dtype):
        jcalc = jax_calculator(jax_prior, like, n_dims, n_derived, force_callback=True)
        ref = [np.asarray(a) for a in jcalc(cube)]
    inside = ((cube >= 0) & (cube <= 1)).all(axis=1)
    assert 0 < inside.sum() < len(cube)
    lz = np.asarray(calc.logzero, cube.dtype)
    for name, h, p, r in zip(("theta", "phi", "logL"), host, port, ref):
        assert h.dtype == p.dtype == r.dtype == cube.dtype, name
        assert np.array_equal(h, p), name
        if case != "block_prior":
            assert np.array_equal(h, r), name
        elif name == "theta":
            sort = np.arange(1, 9)  # x2-x9, sorted_uniform
            rest = np.setdiff1d(np.arange(n_dims), sort)
            assert np.array_equal(h[:, rest], r[:, rest])
            assert (np.abs(h - r) <= 64 * np.spacing(np.abs(r))).all()
        else:
            assert (np.abs(h - r) <= 8 * np.spacing(np.abs(r))).all(), name
    assert (host[2][~inside] == lz).all() and not host[0][~inside].any()
    if case == "nan_and_short_derived":
        nan = inside & (cube[:, 0] > 0.7)
        assert nan.any() and (host[2][nan] == lz).all()
        short = inside & ~nan & (cube[:, 1] < 0.3)
        assert short.any() and not host[1][short, 1].any()


def test_derived_mismatch_raises_as_in_jax():
    """A likelihood that returns no derived parameters where some are
    declared raises DerivedMismatchError in both packages' callback calcs."""
    from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator

    def no_derived(theta):
        return -float(np.sum(np.asarray(theta) ** 2)), []

    cube = eval_cubes(D, n=8).astype(np.float32)
    calc = make_batched_calculator(identity_prior, no_derived, D, 1, force_callback=True)
    with pytest.raises(ValueError, match="no derived parameters") as port:
        calc.host_point_batch(cube)
    with pytest.raises(Exception, match="no derived parameters") as ref:
        jax_calculator(identity_prior, no_derived, D, 1, force_callback=True)(cube)
    assert type(port.value).__name__ == "DerivedMismatchError"
    assert "DerivedMismatchError" in repr(ref.value) or \
        type(ref.value).__name__ == "DerivedMismatchError"
