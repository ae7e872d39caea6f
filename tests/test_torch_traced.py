"""Any torch likelihood on the device: the model forms of ``ops/evaluate.py``,
the pypolychord prior classes, and B1's route for a traced likelihood
(``ops/pallas_slice_v4.py::slice_epoch_traced``) on the CPU.

The same numpy-seeded inputs go through the JAX package and the port.  On
the CPU the route runs its plain version (``slice_step_plain`` in rounds);
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the CUDA kernel
``csrc/slice_step.cu`` against the same plain versions on the card.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polychordlite_tpu
import polychordlite_tpu_torch
from polychordlite_tpu import priors as jpr
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.pallas_slice_v4 import build_epoch_fn_pallas_v4
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu_torch import priors as ppr
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.models import gaussian
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops import pallas_slice_v4 as v4
from polychordlite_tpu_torch.ops.directions import make_directions
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.slice_kernel import (
    EpochConfig,
    epoch_route,
    kernel_wrapper,
    slice_records_plain,
)

torch.set_num_threads(2)

SIGMA = 0.1
QUICK_D = 4
QUICK_NORM = -math.log(2 * math.pi * SIGMA * SIGMA) * QUICK_D / 2.0


def quickstart_torch(theta):
    """The reference quickstart, per point, in torch (examples/quickstart.py)."""
    r2 = torch.sum(theta ** 2)
    return QUICK_NORM - r2 / 2 / SIGMA ** 2, [r2]


def quickstart_jax(theta):
    r2 = jnp.sum(theta ** 2)
    return QUICK_NORM - r2 / 2 / SIGMA ** 2, [r2]


def index_like(theta):
    """Per point, indexing theta[0]: read as batched at B = D it is wrong."""
    return -(theta[0] ** 2 + theta[1] ** 2) / 2


# ----------------------------------------------------------- model forms
def test_quickstart_is_per_point_not_callback():
    calc = make_batched_calculator(ppr.UniformPrior(-1, 1), quickstart_torch, QUICK_D, 1)
    assert calc.form == "per_point" and not calc.uses_callback
    cube = torch.tensor([[0.5, 0.5, 0.5, 0.5], [0.6, 0.4, 0.5, 0.7]])
    theta, phi, logL = calc(cube)
    r2 = (theta ** 2).sum(1)
    torch.testing.assert_close(phi[:, 0], r2)
    torch.testing.assert_close(logL, QUICK_NORM - r2 / 2 / SIGMA ** 2)


@pytest.mark.parametrize("B", [2, 5])
def test_indexing_model_is_per_point(B):
    """At D = 2 a batch of B = 2 points has the shape of one point's theta:
    the model is still per point, and its values are the point-by-point ones
    (B = 5 crashed mid-run when read as batched)."""
    calc = make_batched_calculator(ppr.identity_prior, index_like, 2, 0)
    assert calc.form == "per_point"
    cube = torch.as_tensor(np.random.default_rng(B).uniform(0, 1, (B, 2)), dtype=torch.float32)
    want = torch.stack([index_like(c) for c in cube])
    assert torch.equal(calc(cube)[2], want)


@pytest.mark.parametrize("case", ["zoo", "sum_last", "rows_coupled", "callback"])
def test_model_form_rules(case):
    like, want = {
        "zoo": (gaussian(3), "batched"),  # batched only: theta[:, k], dim=1
        "sum_last": (lambda th: -((th - 0.5) ** 2).sum(-1), "batched"),  # both agree
        # runs on a batch, but its rows depend on each other: per point
        "rows_coupled": (lambda th: -((th - th.mean(0)) ** 2).sum(-1), "per_point"),
        "callback": (lambda th: float(-np.sum((np.asarray(th) - 0.5) ** 2)), "callback"),
    }[case]
    calc = make_batched_calculator(ppr.identity_prior, like, 3, 2 if case == "zoo" else 0)
    assert calc.form == want and calc.uses_callback == (want == "callback")


# The Gaussian prior narrower than the likelihood: the JAX package's float32
# erfinv is off by up to 1.5e-6 relative in the tails (torch's by 6e-8, both
# against float64), and logL = norm - r2 / (2 sigma^2) magnifies theta's
# error by r2 / sigma^2; at these widths it stays under the tolerance.
GAUSS_SIGMAS = [0.05, 0.05, 0.06, 0.06]


def _jax_prior(name):
    return {"uniform": jpr.UniformPrior(-1, 1), "gaussian": jpr.GaussianPrior(0.0, GAUSS_SIGMAS),
            "log_uniform": jpr.LogUniformPrior([1e-3, 0.01, 0.1, 1.0], 10.0)}[name]


def _port_prior(name):
    return {"uniform": ppr.UniformPrior(-1, 1), "gaussian": ppr.GaussianPrior(0.0, GAUSS_SIGMAS),
            "log_uniform": ppr.LogUniformPrior([1e-3, 0.01, 0.1, 1.0], 10.0)}[name]


@pytest.mark.parametrize("prior", ["uniform", "gaussian", "log_uniform"])
def test_calc_matches_jax(prior):
    """The quickstart likelihood under three priors: the port's calc against
    the JAX package's on the same cubes (some outside the cube)."""
    cube = np.random.default_rng(3).uniform(-0.05, 1.05, (256, QUICK_D)).astype(np.float32)
    jt, jp, jl = (np.asarray(a) for a in
                  jax_calculator(_jax_prior(prior), quickstart_jax, QUICK_D, 1)(jnp.asarray(cube)))
    calc = make_batched_calculator(_port_prior(prior), quickstart_torch, QUICK_D, 1)
    assert calc.form == "per_point"
    pt, pp, pl = (a.numpy() for a in calc(torch.as_tensor(cube)))
    np.testing.assert_allclose(pt, jt, rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(pp, jp, rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=2e-6, atol=1e-5)


# --------------------------------------------------- pypolychord prior classes
PRIOR_CLASSES = {  # class, scalar parameters, per-coordinate parameters
    "gaussian": ("GaussianPrior", (0.3, 2.0), ([-1.0, 0.0, 2.5], [0.5, 1.0, 3.0])),
    "log_uniform": ("LogUniformPrior", (1e-3, 10.0), ([1e-3, 0.1, 2.0], [1.0, 10.0, 50.0])),
    "sorted_uniform": ("SortedUniformPrior", (-2.0, 3.0), ([-2.0, 0.0, 1.0], [3.0, 1.0, 4.0])),
    "log_sorted_uniform": ("LogSortedUniformPrior", (0.1, 10.0),
                           ([0.1, 0.5, 1.0], [10.0, 5.0, 2.0])),
}


def _offset(name, args):
    """The constant term of theta = offset + term (mu, or a of a uniform):
    near theta = 0 the sum cancels, so an error is relative to the term's
    size, |theta| + |offset|, and not to |theta|."""
    if name in ("gaussian", "sorted_uniform"):
        return np.abs(np.asarray(args[0], np.float64))
    return 0.0


@pytest.mark.parametrize("params", ["scalar", "per_coordinate"])
@pytest.mark.parametrize("name", list(PRIOR_CLASSES))
def test_prior_class_matches_jax(name, params):
    """Each prior class against the JAX package's on 1,000 seeded cubes,
    called per point and on the batch (the JAX classes are per point),
    within rtol 1e-6 of the terms' size.  The Gaussian's erfinv is held to
    float64 at that tolerance, and to the JAX package's within 2e-6: its
    float32 erfinv is off by up to 1.5e-6 in the tails."""
    cls, scalar, vector = PRIOR_CLASSES[name]
    args = scalar if params == "scalar" else vector
    cube = np.random.default_rng(7).uniform(0.0, 1.0, (1000, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(getattr(jpr, cls)(*args))(jnp.asarray(cube)), np.float64)
    prior = getattr(ppr, cls)(*args)
    assert getattr(prior, "affine", None) is None
    x = torch.as_tensor(cube)
    batched = prior(x).numpy()
    per_point = torch.stack([prior(c) for c in x]).numpy()
    assert np.isfinite(want).all()
    scale = np.abs(want) + _offset(name, args)
    for got in (batched, per_point):
        if name == "gaussian":
            from scipy.special import erfinv

            mu, sigma = (np.asarray(a, np.float64) for a in args)
            exact = mu + sigma * math.sqrt(2.0) * erfinv(2 * cube.astype(np.float64) - 1)
            assert (np.abs(got - exact) <= 1e-6 * (np.abs(exact) + np.abs(mu))).all()
            assert (np.abs(got - want) <= 2e-6 * scale).all()
        else:
            assert (np.abs(got - want) <= 1e-6 * scale).all()


def test_prior_parameters_must_broadcast():
    with pytest.raises(ValueError, match="broadcast"):
        ppr.GaussianPrior([0.0, 1.0], [1.0, 2.0, 3.0])


# ------------------------------------------------------------ engine rules
@pytest.mark.parametrize("like,n_derived", [(quickstart_torch, 1), (index_like, 0),
                                            (lambda th: -(th ** 2).sum(-1), 0)])
def test_auto_on_a_card_takes_the_cuda_engine(monkeypatch, like, n_derived):
    calc = make_batched_calculator(ppr.UniformPrior(-1, 1), like, 4 if n_derived else 2,
                                   n_derived)
    assert calc.device_spec is None and not calc.uses_callback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = ns.resolve_device("cuda")
    assert ns.resolve_engine("auto", cuda, calc) == "cuda"
    assert epoch_route("cuda", calc) == "slice_step"
    callback = make_batched_calculator(
        ppr.identity_prior, lambda th: float(np.sum(np.asarray(th))), 2, 0)
    with pytest.raises(ValueError, match="engine='torch'"):
        ns.resolve_engine("auto", cuda, callback)


# --------------------------------------------------- the route on the CPU
def _quick_inputs(B, R, seed=0):
    """Seeds near the quickstart's peak, a contour of radius 3 sigma, the
    whitening of its width in the cube, and a block of invalid lanes."""
    rng = np.random.default_rng(seed)
    seeds = (0.5 + 0.02 * rng.standard_normal((B, QUICK_D))).astype(np.float32)
    bound = np.full((B,), QUICK_NORM - 4.5, np.float32)
    chol = np.broadcast_to(np.float32(SIGMA / 2) * np.eye(QUICK_D, dtype=np.float32),
                           (B, QUICK_D, QUICK_D)).copy()
    valid = np.arange(B) >= 64
    return seeds, bound, chol, valid


@pytest.mark.parametrize("rounds", [1, 7, 32])
@pytest.mark.parametrize("form", ["per_point", "batched"])
def test_rounds_bitwise_plain_engine(form, rounds):
    """slice_step_plain in rounds of 1, 7 and 32 gives the plain engine's
    records bit for bit, at the JAX parity tests' shape (B = 1024, R = 4)."""
    like = quickstart_torch if form == "per_point" else (
        lambda th: QUICK_NORM - (th ** 2).sum(-1) / 2 / SIGMA ** 2)
    calc = make_batched_calculator(ppr.UniformPrior(-1, 1), like, QUICK_D,
                                   1 if form == "per_point" else 0)
    assert calc.form == form
    B, R = 1024, 4
    seeds, bound, chol, valid = _quick_inputs(B, R)
    gen = torch.Generator().manual_seed(rounds)
    nh, w, _ = make_directions(torch.as_tensor(chol), grade_dims=(QUICK_D,), num_repeats=(R,),
                               n_dims=QUICK_D, generator=gen)
    cfg = EpochConfig(n_dims=QUICK_D, n_phi=calc.n_phi, grade_dims=(QUICK_D,), num_repeats=(R,))
    args = (torch.as_tensor(seeds), torch.as_tensor(bound), torch.as_tensor(valid), nh, w)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (3, 4), *args)
    got = v4.slice_epoch_traced(calc, cfg, (3, 4), *args, rounds=rounds)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (want[2][:64] == 0).all() and (want[2][64:].sum(1) > 0).all()
    # the "cuda" engine's wrapper takes this route for a model without a functor
    if rounds == 32:
        for a, b in zip(kernel_wrapper("cuda")(calc, cfg, (3, 4), *args), want):
            assert torch.equal(a, b)


def test_rounds_meet_the_epoch_budget():
    """A budget small enough to stop lanes mid-repeat: the rounds record the
    capped repeat and stop the lane exactly where the plain engine does."""

    class Capped(EpochConfig):
        @property
        def step_cap(self):
            return 9

    calc = make_batched_calculator(ppr.UniformPrior(-1, 1), quickstart_torch, QUICK_D, 1)
    seeds, bound, chol, valid = _quick_inputs(256, 3, seed=1)
    nh, w, _ = make_directions(torch.as_tensor(chol), grade_dims=(QUICK_D,), num_repeats=(3,),
                               n_dims=QUICK_D, generator=torch.Generator().manual_seed(0))
    cfg = Capped(n_dims=QUICK_D, n_phi=1, grade_dims=(QUICK_D,), num_repeats=(3,), max_shrink=3)
    args = (torch.as_tensor(seeds), torch.as_tensor(bound), torch.as_tensor(valid), nh, w)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (1, 2), *args)
    for rounds in (1, 5):
        for a, b in zip(v4.slice_epoch_traced(calc, cfg, (1, 2), *args, rounds=rounds), want):
            assert torch.equal(a, b)
    assert (want[2][64:] > 0).any() and (want[0][64:, -1] == 0).any()


def _jax_v4_records(monkeypatch, calc, cfg, key, seeds, bound, chol, valid):
    """Run the JAX v4 kernel in interpret mode and capture its raw
    (R, 3, S, 128) [t, logL, nlike] output (tests/test_torch_kernels.py)."""
    from polychordlite_tpu.ops import pallas_slice_v4 as jv4

    captured = {}
    real = jv4.pl.pallas_call

    def capturing(*a, **k):
        f = real(*a, **k)

        def g(*args):
            captured["out"] = f(*args)
            return captured["out"]

        return g

    monkeypatch.setattr(jv4.pl, "pallas_call", capturing)
    epoch = build_epoch_fn_pallas_v4(calc, cfg, interpret=True)
    epoch(key, jnp.asarray(seeds), jnp.asarray(bound), jnp.asarray(chol), jnp.asarray(valid))
    out = np.asarray(captured["out"])
    B, R = seeds.shape[0], cfg.total_repeats
    return (out[:, 0].reshape(R, B).T, out[:, 1].reshape(R, B).T,
            out[:, 2].reshape(R, B).T.astype(np.int64))


def test_per_point_quickstart_decision_exact_with_jax_v4(monkeypatch):
    """The JAX v4 kernel runs the per-point jnp quickstart through its
    vmapped adapter (its tile check fails on the axis-less sum); the port's
    route on the per-point torch quickstart, fed the same directions and key
    words, makes the same decisions: identical accepted t and nlike, logL to
    float noise."""
    B, R = 1024, 4  # the JAX kernel takes whole (8, 128) tiles
    key = jax.random.PRNGKey(5)
    seeds, bound, chol, valid = _quick_inputs(B, R, seed=5)
    jcfg = JaxEpochConfig(n_dims=QUICK_D, n_phi=1, grade_dims=(QUICK_D,), num_repeats=(R,))
    jcalc = jax_calculator(jpr.UniformPrior(-1, 1), quickstart_jax, QUICK_D, 1)
    t_j, l_j, n_j = _jax_v4_records(monkeypatch, jcalc, jcfg, key, seeds, bound, chol, valid)
    dir_keys, _ = _lane_keys(key, B, None)
    nh, w, _ = jax_make_directions(
        dir_keys, jnp.asarray(chol), grade_dims=(QUICK_D,), num_repeats=(R,), n_dims=QUICK_D,
        shared_perm_key=jax.random.fold_in(key, 0x5EED),
    )
    calc = make_batched_calculator(ppr.UniformPrior(-1, 1), quickstart_torch, QUICK_D, 1)
    cfg = EpochConfig(n_dims=QUICK_D, n_phi=1, grade_dims=(QUICK_D,), num_repeats=(R,))
    t, l, n = (a.numpy() for a in v4.slice_epoch_traced(
        calc, cfg, pps.key_words(np.asarray(key)), torch.as_tensor(seeds),
        torch.as_tensor(bound), torch.as_tensor(valid), torch.as_tensor(np.array(nh)),
        torch.as_tensor(np.array(w))))
    n = n.astype(np.int64)
    lane_ok = ((n == n_j).all(1) & (np.abs(t - t_j) <= 1e-6).all(1)
               & (np.abs(l - l_j) <= 1e-5).all(1))
    bad = np.nonzero(~lane_ok)[0]
    assert len(bad) < B / 100, f"{len(bad)} lanes differ"
    for b in bad:  # only where the first divergent probe sat on the contour
        r = int(np.nonzero((n[b] != n_j[b]) | (np.abs(t[b] - t_j[b]) > 1e-6))[0][0])
        assert abs(float(l_j[b, r]) - float(bound[b])) < 1e-4, (b, r)
    assert n[64:].sum() > 0 and (n[:64] == 0).all()


# --------------------------------------------------------- end to end
RUN_KW = dict(nDerived=1, nlive=100, num_repeats=8, do_clustering=False, read_resume=False,
              seed=21, feedback=-1)


@pytest.fixture(scope="module")
def quick_runs(tmp_path_factory):
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no replay divergence (or any) warning
        out["port"] = polychordlite_tpu_torch.run(
            quickstart_torch, QUICK_D, prior=ppr.UniformPrior(-1, 1), device="cpu",
            base_dir=str(tmp_path_factory.mktemp("port")), **RUN_KW)
    out["jax"] = polychordlite_tpu.run(
        quickstart_jax, QUICK_D, prior=jpr.UniformPrior(-1, 1), mesh_shape=1,
        base_dir=str(tmp_path_factory.mktemp("jax")), **RUN_KW)
    return out


def test_quickstart_run_agrees_with_jax(quick_runs):
    port, ref = quick_runs["port"], quick_runs["jax"]
    truth = -QUICK_D * math.log(2.0)
    sigma = math.hypot(port.logZerr, ref.logZerr)
    assert abs(port.logZ - ref.logZ) < 3 * sigma, (port.logZ, ref.logZ, sigma)
    assert abs(port.logZ - truth) < 3 * port.logZerr


def test_quickstart_run_through_the_route(quick_runs, monkeypatch, tmp_path):
    """The run with the CUDA engine's choice forced on the CPU, where the
    route runs its plain version in rounds: the chained epochs' replay check
    holds (a divergence would warn), the metrics name the route, and the run
    is the plain engine's bit for bit."""
    monkeypatch.setattr(ns, "resolve_engine", lambda engine, device, calc: "cuda")
    v4.LAUNCHES["slice_step"] = 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = polychordlite_tpu_torch.run(
            quickstart_torch, QUICK_D, prior=ppr.UniformPrior(-1, 1), device="cpu",
            base_dir=str(tmp_path), **RUN_KW)
    assert v4.LAUNCHES["slice_step"] == 0  # plain versions only on the CPU
    with open(tmp_path / "test.metrics.jsonl") as f:
        import json

        last = json.loads(f.read().splitlines()[-1])
    assert last["engine"] == "cuda" and last["route"] == "slice_step"
    assert last["form"] == "per_point" and last["chained_epochs"] is True
    port = quick_runs["port"]
    assert (out.ndead, out.logZ, out.logZerr) == (port.ndead, port.logZ, port.logZerr)
    assert np.loadtxt(tmp_path / "test.txt").shape[1] == 2 + QUICK_D + 1  # r2 column
