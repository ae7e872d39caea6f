"""The data-driven example likelihoods of the port
(``polychordlite_tpu_torch/models/data_driven.py``) against the JAX
package's (``polychordlite_tpu/models/data_driven.py``): the likelihoods on
seeded points of the inis' priors, the loaders' arrays, the guarded
logsumexp, and ``run_ini`` of ``ini/fitting.ini`` and
``ini/object_detection.ini`` on the CPU at a small size."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychordlite_tpu.models import data_driven as jdd
from polychordlite_tpu_torch.inidriver import data_dir, run_ini
from polychordlite_tpu_torch.models import EXAMPLES, LIKELIHOODS, get_likelihood
from polychordlite_tpu_torch.models import data_driven as tdd
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.fused_like import Refused, lowering
from polychordlite_tpu_torch.priors import BlockPrior
from polychordlite_tpu_torch.utils.inifile import read_ini

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
MODELS = {"fitting": 20, "object_detection": 12}


def prior_points(name: str, n: int = 256, seed: int = 5) -> np.ndarray:
    """``n`` seeded points of the ini's prior (its block prior on uniform
    cubes), float64: fitting's x-knots come out sorted (x1 = -0.5,
    x2-x9 sorted_uniform, xN = 7)."""
    _, blocks, *_ = read_ini(os.path.join(REPO, "ini", f"{name}.ini"))
    cube = np.random.default_rng(seed).uniform(size=(n, MODELS[name]))
    return BlockPrior(blocks, MODELS[name])(torch.as_tensor(cube)).numpy()


def jax_values(name: str, theta: np.ndarray, x64: bool) -> np.ndarray:
    """The JAX package's likelihood on each row, built and evaluated in
    float64 under ``jax.enable_x64`` when ``x64``."""
    with jax.enable_x64(x64):
        like = getattr(jdd, name)(MODELS[name], DATA)
        return np.asarray(jax.vmap(like)(jnp.asarray(theta)), dtype=np.float64)


def test_fitting_prior_points_have_sorted_knots():
    theta = prior_points("fitting")
    xs = theta[:, :10]
    assert (np.diff(xs, axis=1) >= 0).all()
    assert (xs[:, 0] == -0.5).all() and (xs[:, -1] == 7.0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_fitting_matches_jax(dtype):
    """The port evaluates fitting in float64 whatever theta's dtype and
    returns it in that dtype (ROADMAP C20).  float64: within 1e-10
    relative of the JAX package's float64 evaluation (both evaluate the
    same formula; erf and the sums differ in the last bits, 1.4e-11 at
    most on these points).  float32: the float32 rounding of that value,
    within one float32 ulp of the JAX package's float64 evaluation on the
    float32 points.  (The JAX package's own float32 evaluation is off its
    float64 one by up to 176 nats on these points, from the cancellation
    of -f/2 + e^2 s^2 / 2 on steep segments: it is not the reference.)"""
    theta = prior_points("fitting").astype(dtype)
    got = get_likelihood("fitting", 20, data_dir=DATA)(torch.as_tensor(theta))
    assert got.dtype == torch.from_numpy(theta).dtype and got.shape == (256,)
    want = jax_values("fitting", theta.astype(np.float64), x64=True)
    got = got.numpy().astype(np.float64)
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    else:
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_object_detection_matches_jax(dtype):
    """The residual sum over the 20 x 20 image in another order: float32
    within 4e-6 relative of the JAX package's float32 evaluation (1.3e-6
    at most on these points, values -945 to -193), float64 within 1e-13
    relative of its float64 one."""
    theta = prior_points("object_detection").astype(dtype)
    got = get_likelihood("object_detection", 12, data_dir=DATA)(torch.as_tensor(theta))
    assert got.dtype == torch.from_numpy(theta).dtype and got.shape == (256,)
    want = jax_values("object_detection", theta, x64=dtype == np.float64)
    rtol = 4e-6 if dtype == np.float32 else 1e-13
    np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=rtol, atol=0)


@pytest.mark.parametrize("where", ["repo_data", "synthetic"])
def test_fitting_loader_matches_jax(where):
    folder = DATA if where == "repo_data" else None
    got, want = tdd.load_fitting_data(folder), jdd.load_fitting_data(folder)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("where", ["repo_data", "synthetic"])
def test_object_loader_matches_jax(where):
    """The repository's obj.dat is 22 x 22 against obj_info.dat's 20 x 20:
    both loaders crop it to the declared grid."""
    folder = DATA if where == "repo_data" else None
    got, want = tdd.load_object_data(folder), jdd.load_object_data(folder)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    if folder is not None:
        assert got[0].shape == (20, 20)


def test_guarded_logsumexp_matches_jax():
    """A row whose entries are all -inf gives -inf, as the JAX package's
    guard does (torch.logsumexp is not used)."""
    a = np.array([[-np.inf, -np.inf, -np.inf], [1.0, -np.inf, 2.0], [-3.0, 0.5, 700.0]])
    got = tdd.logsumexp_guarded(torch.as_tensor(a), dim=1).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jdd.jax_logsumexp(jnp.asarray(a), axis=1))
    assert got[0] == -np.inf and want[0] == -np.inf
    np.testing.assert_allclose(got, want, rtol=1e-15)


def test_searchsorted_sides_agree_on_sorted_knots():
    """torch.searchsorted(right=True) and jnp.searchsorted(side="right")
    give the same indices on sorted knots, ties included (each returns the
    index after the last knot <= x).  On unsorted knots neither is
    defined: torch runs a binary search over the row as if it were sorted,
    and jnp's default method (``"scan"``) a binary search of its own, so
    the two may return different indices; the sorted priors of the
    reference's inis never give such knots."""
    xs = np.array([-0.5, 0.0, 0.0, 1.5, 3.0, 7.0])
    x = np.array([-0.6, -0.5, 0.0, 0.7, 3.0, 6.9, 7.0, 7.5])
    got = torch.searchsorted(torch.as_tensor(xs), torch.as_tensor(x), right=True).numpy()
    want = np.asarray(jnp.searchsorted(jnp.asarray(xs), jnp.asarray(x), side="right"))
    np.testing.assert_array_equal(got, want)


def test_registered_and_read_as_batched_torch_models():
    """Both are in the models' EXAMPLES (the zoo's LIKELIHOODS keeps the
    models with a device functor) and read as batched torch models (not
    host callbacks); the lowering refuses both, naming why, so on a card
    they take the traced route."""
    for name, D in MODELS.items():
        assert EXAMPLES[name] is getattr(tdd, name) and name not in LIKELIHOODS
        calc = make_batched_calculator(BlockPrior(read_ini(os.path.join(
            REPO, "ini", f"{name}.ini"))[1], D), get_likelihood(name, D, data_dir=DATA), D, 0)
        assert calc.form == "batched" and not calc.uses_callback
        low = lowering(calc)
        assert isinstance(low, Refused) and low.reason


def test_data_dir_rule(tmp_path):
    """The ini's data_dir key, else ../data beside the ini when it holds
    data.dat, else None (the synthetic data)."""
    assert data_dir(os.path.join(REPO, "ini", "fitting.ini"), {"data_dir": "x"}) == "x"
    found = data_dir(os.path.join(REPO, "ini", "fitting.ini"), {})
    assert os.path.samefile(found, DATA)
    (tmp_path / "ini").mkdir()
    assert data_dir(str(tmp_path / "ini" / "a.ini"), {}) is None


def small_ini(tmp_path, name: str, **extra) -> str:
    """ini/<name>.ini at nlive 25, with base_dir in tmp_path, a seed, the
    repository's data directory, and ``extra`` keys replaced."""
    with open(os.path.join(REPO, "ini", f"{name}.ini")) as f:
        lines = f.read().splitlines()
    keys = {"nlive": 25, "base_dir": tmp_path, "data_dir": DATA, "feedback": -1,
            "write_live": "F", "write_dead": "F", **extra}
    out = []
    for ln in lines:
        k = ln.split("=")[0].strip()
        out.append(f"{k} = {keys.pop(k)}" if "=" in ln and k in keys else ln)
    out.insert(out.index("[ output settings ]") + 1, "seed = 11")
    path = tmp_path / f"{name}.ini"
    path.write_text("\n".join(out) + "\n")
    return str(path)


@pytest.mark.parametrize("name,oracle", [
    ("fitting", None), ("object_detection", (-112.916916, 0.507222))])
def test_run_ini_small(tmp_path, name, oracle):
    """Each ini through run_ini on the CPU at nlive 25 (num_repeats cut to
    8 for fitting, to keep the test's time): the plain engine, a finite
    evidence, files written.  object_detection also within 3 combined
    sigma of the JAX package's run of the ini at its own settings (nlive
    50, seed 7, float32: logZ -112.9169 +- 0.5072)."""
    extra = {"num_repeats": 8} if name == "fitting" else {}
    out = run_ini(small_ini(tmp_path, name, **extra), device="cpu")
    assert out["metrics"]["engine_used"] == "torch"
    assert math.isfinite(out["logZ"]) and out["ndead"] > 25
    assert (tmp_path / f"{name}.stats").exists()
    if oracle is not None:
        both = math.hypot(out["logZerr"], oracle[1])
        assert abs(out["logZ"] - oracle[0]) < 3 * both
