"""The port's example zoo against the JAX package's on the CPU: every
analytic likelihood on the same numpy-seeded points, the model checks of
``tests/test_models.py`` that apply, the device forms the CUDA kernels take
for every analytic ini, and small runs of three of them against the JAX
package's runs at the same reduced settings."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polychordlite_tpu.models.examples as jex
import polychordlite_tpu_torch.models.examples as pex
from polychordlite_tpu.inidriver import run_ini as jax_run_ini
from polychordlite_tpu.priors import hypercube_to_physical as jax_hypercube_to_physical
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.inidriver import run_ini
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice_v4 import FUNCTORS, functor_args, validate_functor
from polychordlite_tpu_torch.ops.slice_kernel import KERNEL_ENGINES, EpochConfig, kernel_wrapper
from polychordlite_tpu_torch.priors import BlockPrior
from polychordlite_tpu_torch.utils.inifile import read_ini

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = ("eggbox", "gaussian_shell", "half_gaussian", "himmelblau", "pyramidal",
       "random_gaussian", "rastrigin", "rosenbrock", "twin_gaussian")
#: derived parameters each likelihood returns (the JAX package's)
N_DERIVED = {"half_gaussian": 2, "twin_gaussian": 1, "gaussian_shell": 1}


def _ini(name):
    return read_ini(os.path.join(REPO, "ini", f"{name}.ini"))


def _points(name, n=1024):
    """Cube points of the ini's prior, 1 in 8 of them outside [0, 1], and
    their theta under the ini's block prior (float32)."""
    s, blocks, *_ = _ini(name)
    rng = np.random.default_rng(len(name))
    cube = rng.uniform(0.0, 1.0, (n, s.nDims))
    cube[::8] = rng.uniform(-0.1, 1.1, (n // 8, s.nDims))
    cube = cube.astype(np.float32)
    theta = BlockPrior(blocks, s.nDims)(torch.as_tensor(cube))
    return s.nDims, blocks, cube, theta


def _split(out):
    return out if isinstance(out, tuple) else (out, None)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-5 * np.maximum(1.0, np.abs(want))
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("name", ZOO)
def test_likelihood_matches_jax(name):
    """The torch form against the JAX form on the same float32 theta, and
    both packages' calcs (calculate_point semantics: a cube point outside
    [0, 1] gives logzero) on the same cube points."""
    D, blocks, cube, theta = _points(name)
    like, jlike = pex.get_likelihood(name, D), jex.get_likelihood(name, D)
    logL, phi = _split(like(theta))
    jl, jphi = _split(jax.vmap(jlike)(jnp.asarray(theta.numpy())))
    assert logL.dtype == torch.float32
    _close(logL.numpy(), jl)
    assert (phi is None) == (jphi is None)
    if phi is not None:
        jphi = np.asarray(jphi).reshape(len(cube), -1)
        assert phi.shape == jphi.shape == (len(cube), N_DERIVED[name])
        _close(phi.numpy(), jphi)

    from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calc

    nd = N_DERIVED.get(name, 0)
    calc = make_batched_calculator(BlockPrior(blocks, D), like, D, nd)
    jcalc = jax_calc(lambda c: jax_hypercube_to_physical(c, blocks), jlike, D, nd)
    th, ph, ll = calc(torch.as_tensor(cube))
    jth, jph, jll = (np.asarray(a) for a in jcalc(jnp.asarray(cube)))
    outside = ((cube < 0) | (cube > 1)).any(axis=1)
    assert outside.sum() > 10 and (ll.numpy()[outside] == np.float32(-1e30)).all()
    _close(ll.numpy(), jll)
    _close(th.numpy(), jth)
    _close(ph.numpy(), jph)


def test_eggbox_value():
    like = pex.get_likelihood("eggbox", 2)
    v = float(like(torch.zeros((1, 2)))[0])
    assert np.isclose(v, -(2.0 + 1.0) ** 5, atol=1e-4)


def test_rastrigin_maximum_at_origin():
    like = pex.get_likelihood("rastrigin", 2)
    v0 = float(like(torch.zeros((1, 2)))[0])
    v1 = float(like(torch.full((1, 2), 0.5))[0])
    assert v0 > v1


@pytest.mark.parametrize("name", ZOO)
def test_analytic_ini_has_a_device_form(name):
    """Every analytic ini resolves to its likelihood, with a functor and an
    affine prior, so engine 'auto' on a card runs it on the kernel; the
    functor check passes through every engine's plain version."""
    s, blocks, *_ = _ini(name)
    like = pex.LIKELIHOODS[s.file_root](s.nDims)
    calc = make_batched_calculator(BlockPrior(blocks, s.nDims), like, s.nDims, s.nDerived)
    assert calc.device_spec is not None and not calc.uses_callback
    fid, consts, a, sc = functor_args(calc, s.nDims)
    assert fid == FUNCTORS[name][0] and consts.dtype == np.float32
    assert a.shape == sc.shape == (s.nDims,)
    if name == "random_gaussian":  # mu, norm, then the D x D matrix
        assert consts.size == 2 + s.nDims**2
    cfg = EpochConfig(n_dims=s.nDims, n_phi=calc.n_phi, grade_dims=(s.nDims,),
                      num_repeats=(2,))
    for engine in KERNEL_ENGINES:
        validate_functor(calc, cfg, torch.device("cpu"), kernel_wrapper(engine))


def test_functor_ids_are_distinct():
    ids = [fid for fid, _ in FUNCTORS.values()]
    assert sorted(ids) == list(range(len(pex.LIKELIHOODS)))
    assert set(FUNCTORS) == set(pex.LIKELIHOODS)


def _reduced_ini(tmp_path, name, nlive=60, num_repeats=4, max_ndead=400):
    src = open(os.path.join(REPO, "ini", f"{name}.ini")).read()
    src = (src.replace("nlive = 500", f"nlive = {nlive}")
           .replace("base_dir = chains", f"base_dir = {tmp_path}")
           .replace("feedback = 1", f"feedback = -1\nmax_ndead = {max_ndead}\nseed = 5"))
    for r in (10, 20):
        src = src.replace(f"num_repeats = {r}", f"num_repeats = {num_repeats}")
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / f"{name}.ini"
    path.write_text(src)
    (tmp_path / "clusters").mkdir(exist_ok=True)
    return str(path)


@pytest.mark.parametrize("name", ["rastrigin", "rosenbrock", "twin_gaussian"])
def test_small_run_agrees_with_jax(tmp_path, name):
    """The same reduced ini (nlive 60, num_repeats 4, max_ndead 400) through
    both packages' ini drivers on the CPU: logZ within 3 combined sigma
    (different random streams, the same statistics)."""
    port = run_ini(_reduced_ini(tmp_path / "port", name), device="cpu")
    ref = jax_run_ini(_reduced_ini(tmp_path / "jax", name))
    assert port["ndead"] >= 400 and ref["ndead"] >= 400
    sigma = math.sqrt(port["logZerr"] ** 2 + ref["logZerr"] ** 2)
    assert abs(port["logZ"] - ref["logZ"]) < 3 * sigma, (port["logZ"], ref["logZ"], sigma)
    assert port["metrics"]["engine_used"] == "torch"


def test_run_ini_default_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ini(_reduced_ini(tmp_path, "himmelblau"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ns.resolve_device(None)
