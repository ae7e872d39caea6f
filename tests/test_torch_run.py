"""The port's slice as a whole on the CPU: ``run()`` end to end, against the
analytic evidence and against the JAX package on the same configuration,
plus the engine and device rules."""

import math
import warnings

import numpy as np
import pytest
import torch

import polychordlite_tpu
import polychordlite_tpu_torch
from polychordlite_tpu.models.examples import gaussian as jax_gaussian
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.models.examples import gaussian
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.output import PolyChordOutput
from polychordlite_tpu_torch.priors import UniformPrior, identity_prior
from polychordlite_tpu_torch.settings import PolyChordSettings

torch.set_num_threads(2)

D = 4
# normalised Gaussian (mu 0.5, sigma 0.1) in the unit cube: Z = 1 to ~1e-6
LOGZ_TRUE = 0.0
KW = dict(nDerived=2, nlive=100, num_repeats=8, do_clustering=False,
          read_resume=False, seed=11, feedback=-1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base_p = str(tmp_path_factory.mktemp("port"))
    base_j = str(tmp_path_factory.mktemp("jax"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no replay-divergence (or any) warning
        port = polychordlite_tpu_torch.run(gaussian(D), D, base_dir=base_p, device="cpu", **KW)
    ref = polychordlite_tpu.run(jax_gaussian(D), D, base_dir=base_j, mesh_shape=1, **KW)
    return port, ref, base_p


def test_logz_within_3_sigma_of_analytic(runs):
    port, ref, _ = runs
    for out in (port, ref):
        assert abs(out.logZ - LOGZ_TRUE) < 3 * out.logZerr, (out.logZ, out.logZerr)


def test_port_agrees_with_jax_package(runs):
    port, ref, _ = runs
    sigma = math.sqrt(port.logZerr**2 + ref.logZerr**2)
    assert abs(port.logZ - ref.logZ) < 3 * sigma, (port.logZ, ref.logZ, sigma)


def test_port_files_parse(runs):
    port, _, base = runs
    out = PolyChordOutput(base, "test")
    assert out.ndead > 500 and math.isfinite(out.logZ)
    samples = np.loadtxt(f"{base}/test.txt")
    assert samples.shape[1] == 2 + D + 2
    assert (samples[:, 0] >= 0).all() and samples[:, 0].max() > 0
    assert np.isfinite(samples).all()
    assert ((samples[:, 2:2 + D] >= 0) & (samples[:, 2:2 + D] <= 1)).all()


def test_chained_epochs_stayed_on(runs, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = ns.nested_sampling(
            gaussian(D), identity_prior, ns.default_dumper,
            polychordlite_tpu_torch.PolyChordSettings(
                D, 2, base_dir=str(tmp_path), **{k: v for k, v in KW.items() if k != "nDerived"},
            ),
            device=CPU,
        )
    assert res["metrics"]["engine_used"] == "torch"
    assert res["metrics"]["chained_epochs"] is True
    assert res["logZ"] == pytest.approx(runs[0].logZ)  # same seed, same run


def test_engine_and_device_rules(monkeypatch):
    calc = make_batched_calculator(identity_prior, gaussian(D), D, 2)
    cpu = torch.device("cpu")
    assert ns.resolve_engine("auto", cpu, calc) == "torch"
    assert ns.resolve_engine("torch", cpu, calc) == "torch"
    for engine in ns.KERNEL_ENGINES:  # the kernels need a card
        with pytest.raises(ValueError):
            ns.resolve_engine(engine, cpu, calc)
    assert ns.resolve_device("cpu") == cpu

    # the default is the card: without one it raises, naming the CPU option
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ns.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ns.resolve_device(None)

    # with a card: every kernel engine for a model with a device form; every
    # kernel engine for a torch model without one that the lowering takes
    # ("cuda" and the forced A/B kernels' fused routes), the forced ones
    # refusing a model the lowering refuses, naming its reason and
    # engine='cuda'; a host-callback model on "scan" (the host route),
    # refused by every kernel engine (naming engine='scan' and
    # engine='torch')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = ns.resolve_device("cuda")
    assert ns.resolve_device(None) == cuda
    assert ns.resolve_engine("auto", cuda, calc) == "cuda"
    for engine in ns.KERNEL_ENGINES:
        assert ns.resolve_engine(engine, cuda, calc) == engine

    def plain_like(theta):
        return -torch.sum((theta - 0.5) ** 2, dim=1)

    no_form = make_batched_calculator(identity_prior, plain_like, D, 0)
    assert no_form.device_spec is None and not no_form.uses_callback
    assert ns.resolve_engine("auto", cuda, no_form) == "cuda"
    for engine in ("cuda5", "cuda3", "cuda2"):
        assert ns.resolve_engine(engine, cuda, no_form) == engine
    assert ns.resolve_engine("torch", cuda, no_form) == "torch"
    refused = make_batched_calculator(
        identity_prior, lambda th: -torch.linalg.vector_norm(th - 0.5, dim=-1), D, 0)
    assert ns.resolve_engine("cuda", cuda, refused) == "cuda"
    for engine in ("cuda5", "cuda3", "cuda2"):
        with pytest.raises(ValueError, match="linalg_vector_norm.*engine='cuda'"):
            ns.resolve_engine(engine, cuda, refused)

    callback = make_batched_calculator(
        identity_prior, lambda th: float(-np.sum((np.asarray(th) - 0.5) ** 2)), D, 0)
    assert callback.uses_callback and callback.form == "callback"
    assert ns.resolve_engine("auto", cuda, callback) == "scan"
    for engine in ns.KERNEL_ENGINES:
        with pytest.raises(ValueError, match="engine='scan'.*engine='torch'"):
            ns.resolve_engine(engine, cuda, callback)
    assert ns.resolve_engine("torch", cuda, callback) == "torch"


def test_calculator_paths():
    calc = make_batched_calculator(UniformPrior(0.0, 1.0), gaussian(D), D, 2)
    a, s = calc.device_spec["prior"]  # per coordinate: theta = a + s * cube
    assert a.dtype == s.dtype == np.float32 and a.shape == s.shape == (D,)
    assert (a == 0.0).all() and (s == 1.0).all()
    assert calc.device_spec["likelihood"]["name"] == "gaussian"
    cube = torch.tensor([[0.5] * D, [1.2] + [0.5] * (D - 1)])
    theta, phi, logL = calc(cube)
    assert logL[1] == torch.tensor(-1e30) and (theta[1] == 0).all() and (phi[1] == 0).all()
    assert logL[0] == pytest.approx(-D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)), rel=1e-6)

    def numpy_like(theta):
        return float(-np.sum((np.asarray(theta) - 0.5) ** 2)), [0.0]

    cb = make_batched_calculator(identity_prior, numpy_like, D, 1)
    assert cb.uses_callback and cb.device_spec is None
    _, _, ll = cb(cube)
    assert ll[0] == 0.0 and ll[1] == torch.tensor(-1e30)


def test_every_mode_passes_the_check_and_an_unknown_precision_raises(tmp_path):
    """No run mode is left unported: asynchronous dispatch
    (tests/test_torch_parallel.py), precision='highest', maximise, an nlives
    schedule and several speed grades (tests/test_torch_precision.py,
    tests/test_torch_modes.py, tests/test_torch_graded.py) pass the check;
    an unknown precision raises before the run starts."""
    with pytest.raises(ValueError, match="precision must be one of"):
        polychordlite_tpu_torch.run(
            gaussian(D), D, device="cpu",
            **{**KW, "precision": "double", "base_dir": str(tmp_path)}
        )
    for extra in ({"synchronous": False}, {"precision": "highest"}, {"maximise": True},
                  {"nlives": {-10.0: 50}}, {"grade_dims": [2, 2], "grade_frac": [1.0, 1.0]}):
        ns._check_supported(PolyChordSettings(D, 2, **extra).finalise())


def test_forced_chain_on_callback_model_runs(tmp_path):
    """``chain_epochs`` > 1 on a host-callback model raises nothing: the
    chain fetches whole epoch records, so it runs, and its replay check
    holds.  Left at auto, such a model dispatches one epoch at a time."""
    def numpy_like(theta):
        return float(-np.sum((np.asarray(theta) - 0.5) ** 2))

    kw = dict(nlive=20, num_repeats=2, do_clustering=False, read_resume=False,
              seed=1, feedback=-1, max_ndead=100, write_stats=False,
              base_dir=str(tmp_path), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        forced = polychordlite_tpu_torch.run(numpy_like, 2, chain_epochs=4, **kw)
    auto = polychordlite_tpu_torch.run(numpy_like, 2, **kw)
    assert forced.metrics["chained_epochs"] is True and forced.ndead >= 100
    assert auto.metrics["chained_epochs"] is False and auto.ndead >= 100
    assert math.isfinite(forced.logZ) and math.isfinite(auto.logZ)


def test_f32_unsafe_loglikelihood_raises(tmp_path):
    """The best live logL beyond F32_SAFE_LOGL: the float32 contour test
    would lose shells where the contour ends and precision='highest' is not
    ported, so the run refuses to start, naming the limit and the option
    (ROADMAP C13; the reference only warns)."""
    base = gaussian(D)

    def shifted(theta):
        logL, phi = base(theta)
        return logL - 5e6, phi

    with pytest.raises(ValueError, match=r"F32_SAFE_LOGL = 1e\+06.*precision='highest'"):
        polychordlite_tpu_torch.run(shifted, D, device="cpu",
                                    **{**KW, "base_dir": str(tmp_path)})


def test_chain_replay_compares_rows():
    """The chain's replay check holds the host's live set to the device's
    final one as (logL, cube) rows (ROADMAP C14): a permutation passes, a
    NaN matches a NaN, and neither tied logL with other points nor a
    missing row passes."""
    rng = np.random.default_rng(3)
    cube = rng.uniform(size=(6, 3)).astype(np.float32)
    logL = rng.normal(size=6).astype(np.float32)
    perm = rng.permutation(6)
    assert ns.live_rows_match(cube, logL, cube[perm], logL[perm])
    nan = logL.copy()
    nan[2] = np.nan
    assert ns.live_rows_match(cube, nan, cube[perm], nan[perm])
    tied = logL.copy()
    tied[1] = tied[0]
    moved = cube.copy()
    moved[1, 0] += 0.25  # the same logL multiset, another point
    assert not ns.live_rows_match(cube, tied, moved, tied)
    assert not ns.live_rows_match(cube, logL, cube[:5], logL[:5])
    assert ns.live_rows_match(cube.astype(np.float64), logL.astype(np.float64), cube, logL)
