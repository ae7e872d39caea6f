"""Speed grades and decomposed fast/slow likelihoods in the port, on the CPU.

``GradedLikelihood`` (``models/graded.py``), the calc's graded evaluators
(``ops/evaluate.py``), the ``"scan"`` engine's plain version
(``ops/pallas_slice_v4.py::slice_records_graded_plain``), ``time_speeds``
and ``assign_num_repeats`` (``core/generate.py``) and the engine rules
(``core/nested_sampling.py``) are held against the JAX package: the same
numpy-seeded inputs through the JAX function and the port's; JAX's v4
kernel in interpret mode.  The model is ``tests/test_graded.py``'s: a 2 + 2
grade Gaussian whose slow part is a 200-step fixed-point loop that returns
r^2_slow exactly at every step.  The card runs the same engine through
``csrc/slice_step.cu``'s repeat barrier (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import math
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_traced import _jax_v4_records

import polychordlite_tpu
import polychordlite_tpu_torch
from polychordlite_tpu import GradedLikelihood as JaxGraded
from polychordlite_tpu.core.generate import assign_num_repeats as jax_assign_num_repeats
from polychordlite_tpu.models.examples import gaussian as jax_gaussian
from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu.priors import UniformPrior as JaxUniformPrior
from polychordlite_tpu.settings import PolyChordSettings as JaxSettings
from polychordlite_tpu_torch import GradedLikelihood
from polychordlite_tpu_torch.core import generate
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops import pallas_slice_v4 as v4
from polychordlite_tpu_torch.ops.directions import make_directions
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.slice_kernel import (
    EpochConfig,
    build_epoch_fn,
    epoch_route,
    route_reason,
    slice_records_plain,
)
from polychordlite_tpu_torch.output import PolyChordOutput
from polychordlite_tpu_torch.priors import UniformPrior, identity_prior
from polychordlite_tpu_torch.settings import PolyChordSettings

torch.set_num_threads(2)

SIGMA = 0.15
N_SLOW, N_FAST = 2, 2
NDIMS = N_SLOW + N_FAST
NORM = -NDIMS * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))
ANALYTIC_LOGZ = -NDIMS * math.log(2)  # normalised Gaussian over U[-1, 1]^D
CPU = torch.device("cpu")


# ------------------------------------------------------------------ models
def heavy_slow(theta_slow):
    """The slow part, per point: r^2_slow through 200 steps of c <- c/2 +
    r^2_slow/2 (exact at every step), as a log-likelihood term."""
    r2 = torch.sum(theta_slow ** 2)
    c = r2
    for _ in range(200):
        c = c * 0.5 + r2 * 0.5
    return {"logL_slow": -c / (2 * SIGMA ** 2)}


def fast_part(aux, theta):
    r2_fast = torch.sum(theta[N_SLOW:] ** 2)
    return NORM + aux["logL_slow"] - r2_fast / (2 * SIGMA ** 2), [r2_fast]


def heavy_slow_batched(theta_slow):
    """The same slow part on a batch (B, n_slow) -> a (B,) tensor."""
    r2 = (theta_slow ** 2).sum(-1)
    c = r2
    for _ in range(200):
        c = c * 0.5 + r2 * 0.5
    return -c / (2 * SIGMA ** 2)


def fast_part_batched(aux, theta):
    r2_fast = (theta[:, N_SLOW:] ** 2).sum(-1)
    return NORM + aux - r2_fast / (2 * SIGMA ** 2), r2_fast[:, None]


GRADED = GradedLikelihood(heavy_slow, fast_part, N_SLOW)
GRADED_BATCHED = GradedLikelihood(heavy_slow_batched, fast_part_batched, N_SLOW)


def jax_heavy_slow(theta_slow):
    def body(_, c):
        return c * 0.5 + jnp.sum(theta_slow ** 2) * 0.5

    return {"logL_slow": -jax.lax.fori_loop(0, 200, body, jnp.sum(theta_slow ** 2))
            / (2 * SIGMA ** 2)}


def jax_fast_part(aux, theta):
    r2_fast = jnp.sum(theta[N_SLOW:] ** 2)
    return NORM + aux["logL_slow"] - r2_fast / (2 * SIGMA ** 2), [r2_fast]


JAX_GRADED = JaxGraded(jax_heavy_slow, jax_fast_part, N_SLOW)


def graded_calc(like=GRADED, prior=None, n_dims=NDIMS):
    return make_batched_calculator(UniformPrior(-1, 1) if prior is None else prior, like,
                                   n_dims, 1)


def mono_calc(like=GRADED, prior=None, n_dims=NDIMS):
    """The same likelihood as one plain callable, per point or batched as
    ``like`` is written: no graded evaluators."""
    if like is GRADED_BATCHED:
        def mono(th):
            return like.fast_fn(like.slow_fn(th[:, :N_SLOW]), th)
    else:
        def mono(th):
            return like(th)
    calc = make_batched_calculator(UniformPrior(-1, 1) if prior is None else prior, mono,
                                   n_dims, 1)
    assert not calc.graded and calc.form == ("batched" if like is GRADED_BATCHED
                                             else "per_point")
    return calc


def _cubes(n, seed=0, lo=0.02, hi=0.98):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, NDIMS)).astype(np.float32)


# ------------------------------------------------------- the model contract
def test_full_call_contract():
    """GradedLikelihood() as a plain callable is fast(slow(.), .), as the
    JAX object's, at float32 rounding (the same operations in the same
    order: rtol 1e-6, atol 1e-5 on a logL of order 10)."""
    theta = np.array([0.1, -0.2, 0.3, 0.05], np.float32)
    logL, phi = GRADED(torch.as_tensor(theta))
    logL_j, phi_j = JAX_GRADED(jnp.asarray(theta))
    np.testing.assert_allclose(float(logL), float(logL_j), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(float(phi[0]), float(phi_j[0]), rtol=1e-6, atol=1e-7)
    r2 = float((theta.astype(np.float64) ** 2).sum())
    assert abs(float(logL) - (NORM - r2 / 2 / SIGMA ** 2)) < 1e-4
    with pytest.raises(ValueError, match="n_slow"):
        GradedLikelihood(heavy_slow, fast_part, 0)


@pytest.mark.parametrize("like,form", [(GRADED, "per_point"), (GRADED_BATCHED, "batched")])
def test_calc_graded_paths_match_jax(like, form):
    """The calc's full evaluation, ``slow_aux_batch`` and
    ``fast_point_batch`` against the JAX calc on the same cubes (rtol 1e-6,
    atol 1e-5: float32 on both sides), in either form the port reads; the
    fast part on the cached intermediate gives the full logL bit for bit;
    a probe outside the cube is logzero whatever aux holds."""
    calc = graded_calc(like)
    assert calc.form == form and calc.graded and calc.n_slow == N_SLOW
    jcalc = jax_calculator(JaxUniformPrior(-1, 1), JAX_GRADED, NDIMS, 1)
    assert jcalc.graded
    cube = _cubes(64)
    th, ph, ll = calc(torch.as_tensor(cube))
    th_j, ph_j, ll_j = jcalc(jnp.asarray(cube))
    aux = calc.slow_aux_batch(torch.as_tensor(cube))
    aux_j = jcalc.slow_aux_batch(jnp.asarray(cube))
    slow = aux["logL_slow"] if isinstance(aux, dict) else aux
    np.testing.assert_allclose(slow.numpy(), np.asarray(aux_j["logL_slow"]), rtol=1e-6,
                               atol=1e-5)
    ft, fp, fl = calc.fast_point_batch(aux, torch.as_tensor(cube))
    _, _, fl_j = jcalc.fast_point_batch(aux_j, jnp.asarray(cube))
    np.testing.assert_allclose(fl.numpy(), np.asarray(fl_j), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(th_j), rtol=0, atol=1e-7)
    np.testing.assert_allclose(ph[:, 0].numpy(), np.asarray(ph_j)[:, 0], rtol=1e-6, atol=1e-7)
    for a, b in ((ft, th), (fp, ph), (fl, ll)):
        assert torch.equal(a, b)
    # outside the cube: logzero, theta = phi = 0, aux never read (NaN here)
    bad = torch.as_tensor(cube).clone()
    bad[::2, -1] = 1.5
    bad[1::2, 0] = -0.25
    nan_aux = {"logL_slow": torch.full((64,), float("nan"))} if form == "per_point" else \
        torch.full((64,), float("nan"))
    bt, bp, bl = calc.fast_point_batch(nan_aux, bad)
    assert (bl == torch.tensor(calc.logzero)).all()
    assert (bt == 0).all() and (bp == 0).all()
    # a NaN fast part inside the cube is logzero too (calculate.f90:36-42)
    assert (calc.fast_point_batch(nan_aux, torch.as_tensor(cube))[2] == calc.logzero).all()


def test_callback_graded_model_has_no_graded_paths():
    """A graded model that is a host callback gets no graded evaluators, as
    in the JAX package (``and not use_callback``)."""
    calc = make_batched_calculator(UniformPrior(-1, 1), GRADED, NDIMS, 1, force_callback=True)
    assert calc.uses_callback and not calc.graded


# ------------------------------------------------------------- directions
@pytest.mark.parametrize("grade_dims,num_repeats", [((6, 14), (8, 32)), ((2, 1, 1), (1, 2, 3))])
def test_make_directions_grades_match_jax(grade_dims, num_repeats):
    """Two and three grades, the JAX package's draws through the seam: the
    same directions (atol 1e-4: float32 Gram-Schmidt of up to 20 columns in
    another order, then the whitening and its norm, move a direction by up
    to 4e-5 at D = 20), the same slot grades; a grade's rows are exactly zero on the earlier grades'
    coordinates (the whitening is lower-triangular); slot 0 is slow."""
    B, n_dims = 64, sum(grade_dims)
    key = jax.random.PRNGKey(7)
    chain_keys = jax.vmap(lambda i: jax.random.fold_in(key, 2 * i))(jnp.arange(B))
    perm_key = jax.random.fold_in(key, 0x5EED)
    rng = np.random.default_rng(8)
    A = rng.standard_normal((B, n_dims, n_dims)) * 0.1
    chol = np.linalg.cholesky(A @ A.transpose(0, 2, 1) + 0.05 * np.eye(n_dims)).astype(
        np.float32)
    nh_j, w_j, sp_j = jax_make_directions(
        chain_keys, jnp.asarray(chol), grade_dims=grade_dims, num_repeats=num_repeats,
        n_dims=n_dims, shared_perm_key=perm_key)
    from test_torch_kernels import _jax_draws

    gauss, perm = _jax_draws(chain_keys, grade_dims, num_repeats, n_dims, perm_key)
    nh, w, sp = make_directions(torch.as_tensor(chol), grade_dims=grade_dims,
                                num_repeats=num_repeats, n_dims=n_dims, gauss=gauss, perm=perm)
    np.testing.assert_allclose(nh.numpy(), np.asarray(nh_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_j))
    assert (sp == sp[:1]).all() and int(sp[0, 0]) == 0  # shared order, slot 0 slow
    for g in range(len(grade_dims)):
        start = sum(grade_dims[:g])
        rows = nh[sp == g]
        assert rows.shape[0] == B * num_repeats[g]
        assert (rows[:, :start] == 0).all() and (rows[:, start:] != 0).any()


# -------------------------------------------------------- the scan engine
def _epoch_inputs(calc, B=256, seed=0, grade_dims=(N_SLOW, N_FAST), num_repeats=(2, 6)):
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(np.clip(0.5 + 0.05 * rng.standard_normal((B, NDIMS)), 0, 1),
                         dtype=torch.float32)
    ll = calc(x0)[2]
    bound = torch.minimum(ll, ll[torch.as_tensor(rng.permutation(B))]) - 1.0
    valid = torch.arange(B) >= 16  # a block of invalid lanes
    chol = (0.08 * torch.eye(NDIMS)).expand(B, NDIMS, NDIMS)
    nh, w, sp = make_directions(chol, grade_dims=grade_dims, num_repeats=num_repeats,
                                n_dims=NDIMS, generator=torch.Generator().manual_seed(seed))
    cfg = EpochConfig(n_dims=NDIMS, n_phi=1, grade_dims=grade_dims, num_repeats=num_repeats)
    return cfg, (x0, bound, valid, nh, w), sp, chol


@pytest.mark.parametrize("rounds", [1, 7, 32])
@pytest.mark.parametrize("model", ["graded", "batched", "monolithic"])
def test_graded_engine_bitwise_plain_engine(model, rounds):
    """The scan engine's plain version, in rounds of 1, 7 and 32, gives the
    plain engine's t, logL and nlike on the monolithic model bit for bit: a
    fast-grade repeat's probes keep the slow coordinates of x exactly, so
    the cached intermediate is the one the probe would compute.  A
    monolithic calc on the scan engine (every repeat full) too."""
    like = GRADED_BATCHED if model == "batched" else GRADED
    calc = mono_calc() if model == "monolithic" else graded_calc(like)
    mono = mono_calc(like)
    cfg, args, sp, _ = _epoch_inputs(mono, seed=rounds)
    assert sp[0].tolist().count(1) == 6 and int(sp[0, 0]) == 0
    want = slice_records_plain(lambda p: mono(p)[2], cfg, (5, 6), *args)
    got = v4.slice_epoch_graded(calc, cfg, (5, 6), *args, sp, rounds=rounds)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (want[2][:16] == 0).all() and (want[2][16:].sum(1) > 0).all()


def test_scan_epoch_through_build_epoch_fn():
    """``build_epoch_fn`` with engine "scan" packs the same epoch record as
    the plain engine on the monolithic model (theta and phi of a fast-grade
    repeat's babies from the fast part on the cached intermediate, which
    for this model is the full calc's bit for bit), nlike split by grade."""
    calc, mono = graded_calc(), mono_calc()
    cfg, (x0, bound, valid, nh, w), sp, chol = _epoch_inputs(mono, seed=3)
    kw = (9, 10)
    packed = build_epoch_fn(calc, cfg._replace(engine="scan"))(
        kw, x0, bound, chol, valid, directions=(nh, w, sp))
    want = build_epoch_fn(mono, cfg._replace(engine="torch"))(
        kw, x0, bound, chol, valid, directions=(nh, w, sp))
    assert torch.equal(packed, want)
    nlike = packed[:, -3:-1]
    assert (nlike[16:, 0] > 0).all() and (nlike[16:, 1] > nlike[16:, 0]).all()


def test_scan_assembly_runs_slow_fn_on_slow_babies_only():
    """The scan engine's epoch record takes a fast-grade repeat's babies
    from the fast part on the intermediate that repeat ran on: beyond the
    route's own rows, slow_fn runs on the slow-grade repeats' babies only
    (B a slow repeat, counted under ``GRADED["assembly_rows"]``), and the
    fast part on the rest."""
    rows = {"slow": 0, "fast": 0}

    def counting_slow(theta_slow):
        rows["slow"] += theta_slow.shape[0]
        return heavy_slow_batched(theta_slow)

    def counting_fast(aux, theta):
        rows["fast"] += theta.shape[0]
        return fast_part_batched(aux, theta)

    calc = graded_calc(GradedLikelihood(counting_slow, counting_fast, N_SLOW))
    cfg, (x0, bound, valid, nh, w), sp, chol = _epoch_inputs(mono_calc(), seed=4,
                                                             num_repeats=(3, 9))
    B, R = nh.shape[:2]
    n_slow_reps = int((sp[0] == 0).sum())
    kw = (11, 12)
    calc(x0[:2])  # the calc reads the model's form on its first call
    rows.update(slow=0, fast=0)
    v4.slice_epoch_graded(calc, cfg, kw, x0, bound, valid, nh, w, sp)
    route = dict(rows)
    rows.update(slow=0, fast=0)
    assembly0 = v4.GRADED["assembly_rows"]
    build_epoch_fn(calc, cfg._replace(engine="scan"))(kw, x0, bound, chol, valid,
                                                      directions=(nh, w, sp))
    assert v4.GRADED["assembly_rows"] - assembly0 == n_slow_reps * B
    assert rows["slow"] - route["slow"] == n_slow_reps * B
    assert rows["fast"] - route["fast"] == R * B  # every baby: the full calc's fast part too


def test_graded_engine_meets_the_epoch_budget():
    """A budget small enough to stop lanes mid-repeat: under the repeat
    barrier a capped lane stops where the plain engine stops it, and a lane
    waiting at the barrier counts no step."""

    class Capped(EpochConfig):
        @property
        def step_cap(self):
            return 11

    calc, mono = graded_calc(), mono_calc()
    cfg, args, sp, _ = _epoch_inputs(mono, seed=5)
    cfg = Capped(*cfg._replace(max_shrink=3))
    want = slice_records_plain(lambda p: mono(p)[2], cfg, (1, 2), *args)
    for rounds in (1, 5):
        for a, b in zip(v4.slice_epoch_graded(calc, cfg, (1, 2), *args, sp, rounds=rounds),
                        want):
            assert torch.equal(a, b)
    assert (want[0][16:, -1] == 0).any() and (want[2][16:, 0] > 0).all()


def test_slow_fn_never_called_in_a_fast_repeat(monkeypatch):
    """A counting slow_fn: every call falls in a slow-grade repeat or in the
    refresh of the cached intermediate between a slow repeat and the next
    fast one (before the fast repeat opens), never inside a fast-grade
    repeat; and it runs on a small share of the rows the fast part does."""
    state = {"rep_limit": None}
    calls = []
    real_step = v4.slice_step_plain

    def step(st, logL=None, rep_limit=None):
        state["rep_limit"] = rep_limit
        return real_step(st, logL, rep_limit)

    monkeypatch.setattr(v4, "slice_step_plain", step)

    def counting_slow(theta_slow):
        calls.append(state["rep_limit"])
        return heavy_slow(theta_slow)

    fast_rows = []

    def counting_fast(aux, theta):
        fast_rows.append(1)
        return fast_part(aux, theta)

    like = GradedLikelihood(counting_slow, counting_fast, N_SLOW)
    calc, mono = graded_calc(like), mono_calc()
    cfg, args, sp, _ = _epoch_inputs(mono, seed=2, num_repeats=(2, 10))
    grades = sp[0].tolist()
    calls.clear()
    fast_rows.clear()
    v4.slice_epoch_graded(calc, cfg, (7, 8), *args, sp)
    assert calls and 1 in grades
    for lim in calls:
        # inside repeat lim - 1, which must be slow; at a refresh the last
        # launch belongs to the slow repeat before it
        assert lim is not None and grades[lim - 1] == 0, (lim, grades)
    # vmap calls slow_fn once per batch: count the batches of each kind
    assert len(calls) < len(fast_rows) / 2


# ------------------------------------------------ decision-exact with JAX v4
def test_graded_engine_decision_exact_with_jax_v4(monkeypatch):
    """JAX v4 in interpret mode on the monolithic 4-D Gaussian with 2 + 2
    grades, the port's scan engine on the same Gaussian split into a slow
    and a fast part, through the direction seam: identical nlike and t on
    every lane, logL to float noise, but for lanes whose first divergent
    probe sat on the contour (|logL - bound| < 1e-5: the sums of chi^2 run in
    another order)."""
    D, B = NDIMS, 1024
    grade_dims, num_repeats = (N_SLOW, N_FAST), (2, 3)
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    sigma = 0.2
    norm = -D * (math.log(sigma) + 0.5 * math.log(2 * math.pi))
    seeds = (0.5 + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    r0 = 1.5 * sigma * math.sqrt(D)
    bound = np.full((B,), norm - 0.5 * (r0 / sigma) ** 2, np.float32)
    chol = np.broadcast_to(sigma * np.eye(D, dtype=np.float32), (B, D, D)).copy()
    valid = np.arange(B) >= 64
    jcfg = JaxEpochConfig(n_dims=D, n_phi=2, grade_dims=grade_dims, num_repeats=num_repeats)
    jcalc = jax_calculator(lambda c: c, jax_gaussian(D, sigma=sigma), D, 2)
    t_j, l_j, n_j = _jax_v4_records(monkeypatch, jcalc, jcfg, key, seeds, bound, chol, valid)
    dir_keys, _ = _lane_keys(key, B, None)
    nh, w, sp = jax_make_directions(
        dir_keys, jnp.asarray(chol), grade_dims=grade_dims, num_repeats=num_repeats, n_dims=D,
        shared_perm_key=jax.random.fold_in(key, 0x5EED))
    nh, w, sp = (torch.as_tensor(np.array(a)) for a in (nh, w, sp))
    assert sorted(sp[0].tolist()) == [0, 0, 1, 1, 1]

    def slow(th_s):  # the slow coordinates' chi^2, in index order
        d = (th_s - 0.5) / sigma
        return (d * d)[:, 0] + (d * d)[:, 1]

    def fast(chi2_slow, th):
        d = (th[:, N_SLOW:] - 0.5) / sigma
        chi2 = chi2_slow + (d * d)[:, 0] + (d * d)[:, 1]
        return norm - 0.5 * chi2

    calc = make_batched_calculator(identity_prior, GradedLikelihood(slow, fast, N_SLOW), D, 0)
    assert calc.graded and calc.form == "batched"
    cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=grade_dims, num_repeats=num_repeats)
    t, l, n = v4.slice_epoch_graded(calc, cfg, pps.key_words(np.asarray(key)),
                                    torch.as_tensor(seeds), torch.as_tensor(bound),
                                    torch.as_tensor(valid), nh, w, sp)
    t, l, n = t.numpy(), l.numpy(), n.numpy().astype(np.int64)
    lane_ok = ((n == n_j).all(1) & (np.abs(t - t_j) <= 1e-6).all(1)
               & (np.abs(l - l_j) <= 1e-5).all(1))
    bad = np.nonzero(~lane_ok)[0]
    assert len(bad) < B / 1000, f"{len(bad)} lanes differ"
    for b in bad:
        r = int(np.nonzero((n[b] != n_j[b]) | (np.abs(t[b] - t_j[b]) > 1e-6))[0][0])
        assert abs(float(l_j[b, r]) - float(bound[b])) < 1e-5, (b, r)
    assert (n[:64] == 0).all() and (n[64:].sum(1) > 0).all()


# ---------------------------------------------------------------- timing
def test_time_speeds_measures_a_real_ratio():
    """The full calc measures more than twice the fast part on the cached
    intermediate (``tests/test_graded.py:106-117``); a monolithic model's
    grades each perturb their own coordinates; one grade or literal repeats
    time nothing and leave the generator where it was.  Each speed is the
    least of five measurements: a wall-clock time on a CPU shared with other
    test processes is slowed by every stall that falls in its window, never
    sped up, so one stall in the full calc's or the fast part's window cannot
    move the least of five."""
    calc = graded_calc()
    s = PolyChordSettings(NDIMS, 1, grade_dims=[N_SLOW, N_FAST],
                          grade_frac=[0.25, 0.75]).finalise()
    runs = [generate.time_speeds(calc, s, torch.Generator().manual_seed(0)) for _ in range(5)]
    assert all(r.shape == (2,) for r in runs)
    speeds = np.min(np.stack(runs), axis=0)
    assert speeds[0] > 2.0 * speeds[1], (speeds, runs)
    mono = generate.time_speeds(mono_calc(), s, torch.Generator().manual_seed(0))
    assert mono.shape == (2,) and (mono > 0).all()
    for kw in (dict(grade_dims=[NDIMS]), dict(grade_dims=[2, 2], grade_frac=[2.0, 6.0])):
        gen = torch.Generator().manual_seed(5)
        state = gen.get_state()
        out = generate.time_speeds(calc, PolyChordSettings(NDIMS, 1, **kw).finalise(), gen)
        assert (out == 1).all() and torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("speeds,grade_frac,num_repeats", [
    ((1.0, 0.1), (0.25, 0.75), 4), ((3e-6, 2e-7), (0.5, 0.5), 5),
    ((1.0, 1.0, 0.5), (0.2, 0.3, 0.5), 6), ((1.0, 0.01), (8.0, 32.0), 40)])
def test_assign_num_repeats_matches_jax(speeds, grade_frac, num_repeats):
    """The same speeds give the JAX package's repeats per grade and
    thinning factor."""
    kw = dict(grade_dims=[1] * len(speeds), grade_frac=list(grade_frac),
              num_repeats=num_repeats, boost_posterior=2.0)
    n = len(speeds)
    port, ref = types.SimpleNamespace(), types.SimpleNamespace()
    generate.assign_num_repeats(PolyChordSettings(n, 0, **kw).finalise(), port,
                                np.asarray(speeds))
    jax_assign_num_repeats(JaxSettings(n, 0, **kw).finalise(), ref, np.asarray(speeds))
    np.testing.assert_array_equal(port.num_repeats, ref.num_repeats)
    assert port.thin_posterior == ref.thin_posterior


# ------------------------------------------------------------ engine rules
def test_engine_rules_for_a_graded_model(monkeypatch):
    """"auto" resolves to "scan" for a graded calc on every device; a kernel
    engine forced by name raises naming "scan" (the JAX package warns and
    overrides: ROADMAP C); "torch" stays the plain engine; "scan" runs any
    torch model, and a host callback on the card on the host route; the
    routes are named."""
    calc, mono = graded_calc(), mono_calc()
    assert ns.resolve_engine("auto", CPU, calc) == "scan"
    assert ns.resolve_engine("scan", CPU, mono) == "scan"
    assert ns.resolve_engine("torch", CPU, calc) == "torch"
    assert ns.resolve_engine("auto", CPU, mono) == "torch"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = ns.resolve_device("cuda")
    assert ns.resolve_engine("auto", cuda, calc) == "scan"
    for engine in ("cuda", "cuda5", "cuda3", "cuda2"):
        with pytest.raises(ValueError, match="'scan'"):
            ns.resolve_engine(engine, cuda, calc)
    callback = make_batched_calculator(UniformPrior(-1, 1), GRADED, NDIMS, 1,
                                       force_callback=True)
    assert ns.resolve_engine("scan", cuda, callback) == "scan"
    assert epoch_route("scan", callback) == "slice_step_host"
    assert epoch_route("scan", calc) == "slice_step_graded"
    assert route_reason("scan", calc).startswith("GradedLikelihood")
    assert epoch_route("scan", mono) == "slice_step_graded"
    assert "lockstep" in route_reason("scan", mono)


def _run_graded(tmp_path, like=GRADED, device="cpu", **kw):
    opts = dict(nDerived=1, prior=UniformPrior(-1, 1), nlive=80, num_repeats=4,
                grade_dims=[N_SLOW, N_FAST], grade_frac=[0.25, 0.75], read_resume=False,
                base_dir=str(tmp_path), file_root="g", seed=4, feedback=-1,
                precision_criterion=0.01)
    opts.update(kw)
    return polychordlite_tpu_torch.run(like, NDIMS, device=device, **opts)


@pytest.mark.parametrize("case", ["n_slow", "chain", "kernel_engine"])
def test_graded_run_refusals(tmp_path, case):
    """Before any epoch: ``grade_dims[0]`` must equal ``n_slow``; a forced
    chain raises, saying that the chain has no aux carry (ROADMAP C1: the
    JAX package lets it through); a forced kernel engine names "scan"."""
    kw, match = {"n_slow": (dict(grade_dims=[1, 3]), "n_slow"),
                 "chain": (dict(chain_epochs=4), "no aux carry"),
                 "kernel_engine": (dict(engine="cuda"), "'scan'")}[case]
    with pytest.raises(ValueError, match=match):
        _run_graded(tmp_path, **kw)


# ------------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def graded_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("graded")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port = _run_graded(base / "port")
    ref = polychordlite_tpu.run(
        JAX_GRADED, NDIMS, nDerived=1, prior=JaxUniformPrior(-1, 1), nlive=80, num_repeats=4,
        grade_dims=[N_SLOW, N_FAST], grade_frac=[0.25, 0.75], read_resume=False,
        base_dir=str(base / "jax"), file_root="g", seed=4, feedback=0,
        precision_criterion=0.01)
    return port, ref, base / "port"


def _nlike_line(path):
    with open(path) as f:
        line = [ln for ln in f.read().splitlines() if ln.startswith(" nlike:")][0]
    return [int(x) for x in line.split()[1:]]


def test_graded_run_evidence(graded_runs):
    """The 4-D graded model through run(device="cpu"): logZ within 3 sigma
    (+ 0.15, the JAX test's allowance) of -4 log 2, and within 3 combined
    sigma of the JAX package's run of the same settings."""
    port, ref, _ = graded_runs
    assert abs(port.logZ - ANALYTIC_LOGZ) < 3 * port.logZerr + 0.15, (port.logZ, port.logZerr)
    err = math.hypot(port.logZerr, ref.logZerr)
    assert abs(port.logZ - ref.logZ) < 3 * err, (port.logZ, ref.logZ, err)


def test_graded_run_nlike_split(graded_runs):
    """The slow grade makes under 35 % of the likelihood calls
    (``tests/test_graded.py:131-135``); the run took the scan engine's
    route, with no chain, and recorded both counts."""
    port, _, base = graded_runs
    counts = _nlike_line(base / "g.stats")
    assert len(counts) == 2 and counts[0] > 0 and counts[1] > 0
    assert counts[0] < 0.35 * (counts[0] + counts[1]), counts
    out = PolyChordOutput(str(base), "g")
    assert out.ndead == port.ndead and math.isfinite(out.logZ)
    import json

    with open(base / "g.metrics.jsonl") as f:
        last = json.loads(f.read().splitlines()[-1])
    assert (last["engine"], last["route"]) == ("scan", "slice_step_graded")
    assert last["chained_epochs"] is False and last["nlike_per_grade"] == counts


def test_two_grades_run(tmp_path):
    """Two grades of a monolithic model run (they raised before the port
    had them): ``tests/test_parallel.py:65-99``'s run, grade_dims [2, 2]
    with literal repeats [2, 6]; logZ within 2 sigma + 0.15 of -4 log 2, as
    there, and the fast grade's count larger."""
    sigma = 0.2

    def loglike(theta):
        r2 = torch.sum(theta ** 2)
        return -math.log(2 * math.pi * sigma ** 2) * 2.0 - r2 / 2 / sigma ** 2

    out = polychordlite_tpu_torch.run(
        loglike, 4, prior=UniformPrior(-1, 1), nlive=60, num_repeats=4, grade_dims=[2, 2],
        grade_frac=[2.0, 6.0], read_resume=False, base_dir=str(tmp_path), seed=2,
        feedback=-1, precision_criterion=0.02, equals=False, posteriors=False, device="cpu")
    assert abs(out.logZ - ANALYTIC_LOGZ) < 2 * out.logZerr + 0.15
    counts = _nlike_line(tmp_path / "test.stats")
    assert len(counts) == 2 and counts[0] > 0 and counts[1] > counts[0]
