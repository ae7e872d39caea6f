"""The structure-cost studies of the port (E1, E2, E3, E6, E7) on the CPU.

Each port module is held against its JAX kernel in the repository's
top-level ``experiments/``, run in interpret mode on the same numpy-seeded
inputs (as ``tests/test_torch_v2v3.py`` does for the v2 and v3 engines):
on the CPU every wrapper runs its kernel's plain version.  The study
scripts there are loaded by path, inside the tests, because some of them
run their measurements when imported (which fail at once on the CPU).
Then each study's ``main(device="cpu", ...)`` at a small size, the device
rule of the studies, and the numpy simulation against its original.
"""

import contextlib
import importlib.util
import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from polychordlite_tpu.models.examples import gaussian as jax_gaussian
from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu_torch.experiments import (
    prof_grid_overhead,
    prof_lockstep_waste,
    prof_pallas_while,
    prof_v3_iters,
    sim_iter_distribution,
    v3_instr,
)
from polychordlite_tpu_torch.models.examples import gaussian as pt_gaussian
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice_v3 import cap_body, slice_records_window_plain
from polychordlite_tpu_torch.ops.pallas_slice_v4 import slice_epoch_counted
from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, slice_records_plain
from polychordlite_tpu_torch.priors import identity_prior

torch.set_num_threads(2)

PALLAS_CALL = pl.pallas_call  # the real one: the tests below patch the module attribute
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, B, R = 4, 1024, 4  # tests/test_torch_v2v3.py:48
SIGMA = 0.2
NORM = -D * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))


def _load(name):
    """experiments/<name>.py by path (the folder is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", os.path.join(REPO, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with contextlib.redirect_stdout(io.StringIO()):  # what runs at import prints
        spec.loader.exec_module(mod)
    return mod


def _inputs(seed):
    """Ball inputs as tests/test_torch_v2v3.py:53-68, with the directions
    the instrumented kernels draw (no shared slot permutation)."""
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    seeds = (0.5 + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    r0 = 1.5 * SIGMA * math.sqrt(D)
    bound = np.full((B,), NORM - 0.5 * (r0 / SIGMA) ** 2, np.float32)
    chol = np.broadcast_to(SIGMA * np.eye(D, dtype=np.float32), (B, D, D)).copy()
    valid = np.arange(B) >= 64  # a block of invalid lanes
    dir_keys, _ = _lane_keys(key, B, None)
    nh, w, _ = jax_make_directions(dir_keys, jnp.asarray(chol), grade_dims=(D,),
                                   num_repeats=(R,), n_dims=D)
    port = (torch.as_tensor(seeds), torch.as_tensor(bound), torch.as_tensor(valid),
            torch.as_tensor(np.array(nh)), torch.as_tensor(np.array(w)))
    jax_args = (key, jnp.asarray(seeds), jnp.asarray(bound), jnp.asarray(chol),
                jnp.asarray(valid))
    return jax_args, port, pps.key_words(np.asarray(key))


def _jax_calc_cfg():
    jcfg = JaxEpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    return jax_calculator(lambda c: c, jax_gaussian(D, sigma=SIGMA), D, 2), jcfg


def _port_calc_cfg(**kw):
    calc = make_batched_calculator(identity_prior, pt_gaussian(D, sigma=SIGMA), D, 2)
    return calc, EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,), **kw)


def _capture(monkeypatch, module):
    """Capture the raw outputs of ``module``'s pallas_call."""
    captured = {}
    real = module.pl.pallas_call

    def capturing(*a, **k):
        f = real(*a, **k)

        def g(*args):
            captured["out"] = f(*args)
            return captured["out"]

        return g

    monkeypatch.setattr(module.pl, "pallas_call", capturing)
    return captured


def _decision_exact(n, n_j, l, l_j, bound, t=None, t_j=None):
    """The rule of tests/test_torch_v2v3.py:99-114: identical nlike, t to
    1e-6 and logL to 1e-5 (XLA on the CPU may fuse tL + u (tR - tL), which
    the port rounds twice, and the likelihoods sum chi2 in another order);
    a lane may only differ if its first divergent probe sat on the contour."""
    lane_ok = (n == n_j).all(1) & (np.abs(l - l_j) <= 1e-5).all(1)
    if t is not None:
        lane_ok &= (np.abs(t - t_j) <= 1e-6).all(1)
    bad = np.nonzero(~lane_ok)[0]
    assert len(bad) < B / 1000, f"{len(bad)} lanes differ"
    for b in bad:
        r = int(np.nonzero((n[b] != n_j[b]) | (np.abs(l[b] - l_j[b]) > 1e-5))[0][0])
        assert abs(float(l_j[b, r]) - float(bound[b])) < 1e-5, (b, r)
    return lane_ok


def _lanes(a):
    """(R, S, 128) kernel layout -> (B, R)."""
    return np.asarray(a).reshape(R, B).T


# ---- E1: the counted v4 against experiments/v4_instr.py ------------------

def test_e1_counted_matches_jax_v4_instr(monkeypatch):
    """E1 (``slice_epoch_counted``) against the instrumented v4 kernel:
    decision-exact t, logL and nlike; v4_instr counts the 4-micro-step
    bodies of its 1,024-lane chunk, so 4 x that bounds every lane's steps."""
    v4i = _load("v4_instr")
    jax_args, port, kw = _inputs(seed=5)
    jcalc, jcfg = _jax_calc_cfg()
    captured = _capture(monkeypatch, v4i)
    epoch = v4i.build_epoch_fn_pallas_v4(jcalc, jcfg, interpret=True)
    epoch(*jax_args)
    out = np.asarray(captured["out"])  # (R, 4, S, 128): t, logL, nlike, iters
    t_j, l_j = _lanes(out[:, 0]), _lanes(out[:, 1])
    n_j = _lanes(out[:, 2]).astype(np.int64)
    chunk_bodies = np.asarray(epoch.dbg_iters)
    assert (chunk_bodies == chunk_bodies.flat[0]).all()  # one chunk of B = 1024 lanes

    calc, cfg = _port_calc_cfg()
    t, l, n, steps, wmax = slice_epoch_counted(calc, cfg, kw, *port)
    _decision_exact(n.numpy().astype(np.int64), n_j, l.numpy(), l_j, port[1].numpy(),
                    t.numpy(), t_j)
    assert 4 * int(chunk_bodies.flat[0]) >= int(steps.max()) > 0
    assert int(wmax.max()) == int(steps.max())


# ---- E2: the v3 counters against experiments/v3_instr.py -----------------

@pytest.mark.parametrize("cheap", [False, True])
def test_e2_plain_matches_jax_v3_instr(monkeypatch, cheap):
    """E2's plain version (``slice_records_window_plain`` with
    ``count_iters``) against the instrumented v3 kernel, real and cheap:
    decision-exact records and the same body count in every grid step."""
    v3i = _load("v3_instr")
    jax_args, port, kw = _inputs(seed=6)
    jcalc, jcfg = _jax_calc_cfg()
    captured = _capture(monkeypatch, v3i)
    epoch = v3i.build_epoch_fn_pallas_v3(jcalc, jcfg, interpret=True, cheap=cheap)
    epoch(*jax_args)
    t_t, l_t, n_t, _ = (np.asarray(a) for a in captured["out"])
    iters_j = np.asarray(epoch.last_iters)[:, 0, 0]

    calc, cfg = _port_calc_cfg()
    t, l, n, iters = v3_instr.slice_epoch_v3_instr(calc, cfg, kw, *port, cheap=cheap)
    np.testing.assert_array_equal(iters.numpy(), iters_j)
    if cheap:  # the skeleton: R steps of one body, the records untouched
        assert (iters == 1).all()
        for got, want in ((t, t_t), (l, l_t), (n, n_t)):
            np.testing.assert_array_equal(got.numpy(), _lanes(want))
    else:
        assert (iters >= 1).all() and (iters <= cap_body(cfg)).all()
        _decision_exact(n.numpy().astype(np.int64), _lanes(n_t).astype(np.int64), l.numpy(),
                        _lanes(l_t), port[1].numpy(), t.numpy(), _lanes(t_t))


@pytest.mark.parametrize("caps", [{}, {"max_step": 2, "max_shrink": 3}])
def test_e2_plain_records_are_v4s(caps):
    """Counting the bodies changes nothing the v3 engine records: the same
    t, logL and nlike as the plain v4 engine, at caps small enough for
    forced accepts too; and a step's bodies cover its slowest lane."""
    _, port, _ = _inputs(seed=7)
    calc, cfg = _port_calc_cfg(**caps)
    kw = (11, 12)
    v4 = slice_records_plain(lambda p: calc(p)[2], cfg, kw, *port)
    got = slice_records_window_plain(lambda p: calc(p)[2], cfg, kw, *port, count_iters=True)
    for a, b in zip(got[:3], v4):
        assert torch.equal(a, b)
    iters = got[3]
    assert iters.dtype == torch.int32 and iters.shape == (R,)
    # a lane takes at most 4 micro-steps in each body of the epoch
    steps = slice_records_plain(lambda p: calc(p)[2], cfg, kw, *port, count_steps=True)[3]
    assert (iters >= 1).all() and 4 * int(iters.sum()) >= int(steps.max())


# ---- E3: the v2 lockstep waste against prof_lockstep_waste.py ------------

def test_e3_plain_matches_jax_lockstep_waste(monkeypatch):
    """E3's plain version (``slice_records_lockstep_plain`` with
    ``count_steps``) against the instrumented v2 kernel, its module globals
    D and R set small: nlike identical, and ``iters`` identical in
    micro-steps — the JAX loop counter is already a micro-step count, so
    the JAX study's extra factor 4 (ROADMAP C11) is wrong."""
    lw = _load("prof_lockstep_waste")
    monkeypatch.setattr(lw, "D", D)
    monkeypatch.setattr(lw, "R", R)
    jax_args, port, kw = _inputs(seed=8)
    jcalc, jcfg = _jax_calc_cfg()
    nlike_t, iters_t = lw.build_instrumented(jcalc, jcfg)(*jax_args)
    n_j, iters_j = _lanes(nlike_t), np.asarray(iters_t)[:, 0, 0]

    calc, cfg = _port_calc_cfg()
    t, l, n, cube, steps, iters = pps.slice_epoch_v2_counted(calc, cfg, kw, *port)
    np.testing.assert_array_equal(n.numpy(), n_j)
    np.testing.assert_array_equal(iters.numpy(), iters_j)
    # iters is the slowest lane's micro-steps rounded up to a 4-step body
    np.testing.assert_array_equal(iters.numpy(), 4 * -(-steps.numpy().max(0) // 4))
    assert (steps[:64] == 0).all() and (steps[64:] >= 3).all()
    assert int(steps.sum()) >= int(n.sum())
    for a, b in zip((t, l, n, cube), pps.slice_records_lockstep_plain(
            lambda p: calc(p)[2], cfg, kw, *port)):
        assert torch.equal(a, b)


def test_e3_no_valid_lane_runs_no_loop():
    _, port, _ = _inputs(seed=9)
    calc, cfg = _port_calc_cfg()
    x0, bound, valid, nh, w = port
    out = pps.slice_epoch_v2_counted(calc, cfg, (1, 2), x0, bound, torch.zeros_like(valid),
                                     nh, w)
    assert (out[4] == 0).all() and (out[5] == 0).all()


# ---- E6: the grid-step skeleton against prof_grid_overhead.py ------------

class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def grid_module():
    return _load("prof_grid_overhead")


@pytest.mark.parametrize("variant", list("ABCDEF"))
def test_e6_matches_jax_grid_overhead(grid_module, monkeypatch, variant):
    """Each variant's kernel, captured from the study's pallas_call at
    R = 4, S = 8, called again in interpret mode on random inputs, against
    the port's wrapper (its plain version on the CPU): equal."""
    mod = grid_module
    Rs, Ds, Ss = 4, 4, 8
    monkeypatch.setattr(mod, "R", Rs)
    monkeypatch.setattr(mod, "D", Ds)
    monkeypatch.setattr(mod, "S", Ss)
    seen = {}

    def capturing(kernel, **kw):
        seen.update(kernel=kernel, kw=kw)

        def stop(*_):
            raise _Stop

        return stop

    monkeypatch.setattr(mod.pl, "pallas_call", capturing)
    with pytest.raises(_Stop):
        mod.build(variant)
    monkeypatch.undo()
    rng = np.random.default_rng(ord(variant))
    stream, head, x0 = (rng.standard_normal(s).astype(np.float32)
                        for s in ((Rs, Ds, Ss, 128), (3, Ds, Ss, 128), (Ds, Ss, 128)))
    inputs = [stream] + ([head] if variant in "CDE" else []) + ([x0] if variant == "E" else [])
    want = np.asarray(PALLAS_CALL(seen["kernel"], **seen["kw"], interpret=True)(
        *(jnp.asarray(a) for a in inputs)))
    got = prof_grid_overhead.grid_steps(variant, *(torch.as_tensor(a) for a in (stream, head, x0)))
    assert got.shape == (Rs, Ss, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    if variant == "B":  # one launch per step computes B's function
        np.testing.assert_array_equal(prof_grid_overhead.grid_steps(
            "B1", torch.as_tensor(stream)).numpy(), want)


# ---- E7: the loop-body cost against prof_pallas_while.py -----------------

@pytest.fixture(scope="module")
def while_module():
    return _load("prof_pallas_while")


def _while_kernel(mod, monkeypatch, variant, sub):
    seen = {}

    def capturing(kernel, **kw):
        seen.update(kernel=kernel, kw=kw)

        def stop(*_):
            raise _Stop

        return stop

    monkeypatch.setattr(mod.pl, "pallas_call", capturing)
    with pytest.raises(_Stop):
        mod.run(sub, 128, variant)
    monkeypatch.setattr(mod.pl, "pallas_call", PALLAS_CALL)
    return seen["kernel"], seen["kw"]


def _body20_near_contour(x, n, eps=1e-4):
    """Lanes whose logL came within ``eps`` of -40 in some iteration of
    the plain body20 loop (where another summation order may decide the
    other way)."""
    acc = x.clone()
    near = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(n):
        dd = ((x + torch.tensor(0.001, dtype=torch.float32) * acc) - 0.5) * 10.0
        logL = (dd * dd) * 20 * -0.5
        near |= (logL + 40.0).abs() < eps
        acc = torch.where(logL > -40.0, acc + 1.0, acc * 0.5)
    return near


@pytest.mark.parametrize("variant", ["counter", "anycond", "body20", "prng"])
def test_e7_matches_jax_pallas_while(while_module, monkeypatch, variant):
    """Each body's kernel, captured from the study's pallas_call with N =
    300 on an (8, 128) tile, in interpret mode against the port's loop.
    ``prng`` runs under ``pltpu.InterpretParams()``, whose draws are all
    zero, against the plain version fed u = 0.  ``body20`` may differ only
    on lanes whose logL came within 1e-4 of -40."""
    mod = while_module
    n, sub = 300, 8
    monkeypatch.setattr(mod, "N", n)
    kernel, kw = _while_kernel(mod, monkeypatch, variant, sub)
    rng = np.random.default_rng(len(variant))
    x = rng.uniform(0.2, 0.8, (sub, 128)).astype(np.float32)
    interpret = pltpu.InterpretParams() if variant == "prng" else True
    want = np.asarray(PALLAS_CALL(kernel, **kw, interpret=interpret)(jnp.asarray(x)))
    xt = torch.as_tensor(x)
    if variant == "prng":
        got = prof_pallas_while.while_loop_plain("prng", xt, n,
                                                 uniform=lambda i: torch.zeros_like(xt))
        np.testing.assert_array_equal(want, x)  # the interpreter's bits are zeros
    else:
        got = prof_pallas_while.while_loop(variant, xt, n)
    differ = got.numpy() != want
    if variant == "body20":
        near = _body20_near_contour(xt, n).numpy()
        assert not (differ & ~near).any(), "lanes differ away from the contour"
        print(f"body20: {int(differ.sum())} of {differ.size} lanes differ, "
              f"{int(near.sum())} came within 1e-4 of logL = -40")
    else:
        assert not differ.any()


@pytest.mark.parametrize("variant", ["anycond", "anycond_warp", "anycond_cta"])
def test_e7_conditions_of_every_granularity(variant):
    """While some element of the tile, warp or block is above -1e30, the
    condition holds there, and each form adds 1 n times, as the counter
    does — also where a whole warp or row sits below -1e30 (adding 1
    leaves it there)."""
    x = torch.linspace(-1.0, 1.0, 4 * 128, dtype=torch.float32).view(4, 128)
    x[1, :32] = -3e30
    x[2] = -3e30
    assert torch.equal(prof_pallas_while.while_loop(variant, x, 37),
                       prof_pallas_while.while_loop("counter", x, 37))


def test_e7_prng_draws_are_the_slice_uniforms():
    """The prng body's u is the slice engines' uniform at h = mix(7, lane),
    counter i — exact 24-bit values in [0, 1)."""
    draw = prof_pallas_while.prng_uniforms((2, 128), "cpu")
    u0, u1 = draw(0), draw(1)
    assert u0.dtype == torch.float32 and not torch.equal(u0, u1)
    assert ((u0 >= 0) & (u0 < 1)).all() and ((u0 * 2 ** 24) == (u0 * 2 ** 24).round()).all()
    h = pps._mix(7, 5)
    assert u0.flatten()[5].item() == pps.uniform_from_hash(pps._fmix(pps._mix(h, 0))) * 1.0
    x = torch.zeros((2, 128))
    got = prof_pallas_while.while_loop("prng", x, 3)
    assert torch.equal(got, (x + u0) + u1 + draw(2))


# ---- the studies on the CPU ----------------------------------------------

SMALL = dict(B=256, R=4, D=4)


def test_v3_iters_study_on_cpu():
    rec = prof_v3_iters.main(device="cpu", **SMALL, reps=1)
    assert rec["device"] == "cpu" and rec["real"]["ms"] is None and rec["b4_ms"] is None
    assert rec["cheap"]["body_iters"] == SMALL["R"] and rec["cheap"]["evals"] == 0
    real = rec["real"]
    assert real["body_iters"] >= SMALL["R"] and real["micro_steps"] == 4 * real["body_iters"]
    assert real["evals"] > 0 and real["iters_min"] >= 1


def test_lockstep_waste_study_on_cpu():
    rec = prof_lockstep_waste.main(device="cpu", **SMALL, reps=1)
    assert rec["ms"] is None and rec["hardware_probes_per_s"] is None
    assert rec["hardware_probes"] == pytest.approx(
        SMALL["B"] * rec["iters_per_repeat"]["mean"] * SMALL["R"])
    assert 0 < rec["lane_efficiency"] <= rec["step_efficiency"] <= 1
    assert rec["C11_jax_formula"]["lane_efficiency"] == pytest.approx(rec["lane_efficiency"] / 4)
    assert [r["repeat"] for r in rec["repeats"]] == [0]


def test_grid_overhead_study_on_cpu():
    rec = prof_grid_overhead.main(device="cpu", R=3, D=2, S=8, reps=1)
    assert set(rec["variants"]) == set(prof_grid_overhead.VARIANTS)
    assert rec["D"] == 2 and rec["variants"]["A"]["ms"] is None


def test_while_cost_study_on_cpu():
    rec = prof_pallas_while.main(device="cpu", S=8, n=5, reps=1, **SMALL)
    assert set(rec["variants"]) == set(prof_pallas_while.VARIANTS)
    assert rec["variants"]["body20"]["us_per_iter"] is None
    assert rec["b1"]["lane_steps_max"] >= 3 * SMALL["R"] and rec["b1"]["ms"] is None


@pytest.mark.parametrize("study", [prof_v3_iters, prof_lockstep_waste, prof_grid_overhead,
                                   prof_pallas_while])
def test_studies_need_a_card_unless_asked(monkeypatch, study):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        study.main()


def test_simulation_is_the_original():
    """The numpy copy draws and counts as experiments/sim_iter_distribution.py
    does (run here at R = 8 through its source), and projects a lane
    efficiency in (0, 1] for every tile."""
    src = open(os.path.join(REPO, "experiments", "sim_iter_distribution.py")).read()
    assert "R = 100\n" in src
    ns = {}
    with contextlib.redirect_stdout(io.StringIO()):
        exec(compile(src.replace("R = 100\n", "R = 8\n"), "sim_iter_distribution", "exec"), ns)
    evals, steps_out, shrinks = sim_iter_distribution.simulate(R=8)
    for got, name in ((evals, "per_rep"), (steps_out, "steps_out"), (shrinks, "shrinks")):
        np.testing.assert_array_equal(got, ns[name])
    proj = sim_iter_distribution.project(evals, steps_out, shrinks)
    for group in ("lockstep", "free_running"):
        assert all(0 < v["lane_efficiency"] <= 1 for v in proj[group].values())
    assert proj["lockstep"]["8192"]["iterations"] == ns["per_rep"].reshape(1, 8192, 8).max(1).sum()


def test_wrappers_refuse_unknown_variants():
    x = torch.zeros((1, 128))
    with pytest.raises(ValueError):
        prof_pallas_while.while_loop("empty", x, 1)
    with pytest.raises(ValueError):
        prof_grid_overhead.grid_steps("G", torch.zeros((1, 1, 1, 128)))
