"""The port's ini surface on the CPU: the ini reader against the JAX
package's on every shipped ini, the block priors against the JAX package's
in float64, the affine form the CUDA kernels take from an all-uniform
layout, and the CLI end to end in a fresh interpreter without JAX."""

import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polychordlite_tpu.priors as jpr
import polychordlite_tpu_torch.priors as ppr
from polychordlite_tpu.utils.inifile import read_ini as jax_read_ini
from polychordlite_tpu_torch.utils.inifile import read_ini

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIS = sorted(glob.glob(os.path.join(REPO, "ini", "*.ini")))


def test_every_shipped_ini_is_covered():
    assert len(INIS) == 15


@pytest.mark.parametrize("path", INIS, ids=[os.path.basename(p) for p in INIS])
def test_read_ini_matches_jax(path):
    s_p, blocks_p, names_p, derived_p, kv_p = read_ini(path)
    s_j, blocks_j, names_j, derived_j, kv_j = jax_read_ini(path)
    assert vars(s_p) == vars(s_j)
    assert [dataclasses.astuple(b) for b in blocks_p] == [dataclasses.astuple(b) for b in blocks_j]
    assert (names_p, derived_p, kv_p) == (names_j, derived_j, kv_j)


# one parameter tuple per block type (interleaved as the ini gives them)
PARAMS = {
    "uniform": (-1.0, 2.0, 0.0, 5.0, -3.0, -1.0, 0.5, 0.75),
    "log_uniform": (0.1, 10.0),
    "power_uniform": (1.0, 10.0, -2.0),
    "gaussian": (0.5, 2.0, -1.0, 0.3, 0.0, 1.0, 4.0, 0.1),
    "half_gaussian": (0.0, 1.5),
    "exponential": (2.0,),
    "sorted_uniform": (0.0, 1.0),
    "sorted_gaussian": (1.0, 0.5),
    "sorted_half_gaussian": (0.0, 1.0),
    "sorted_exponential": (1.5,),
    "adaptive_sorted_uniform": (0.0, 0.0, -2.0, 3.0),
    "adaptive_sorted_gaussian": (0.0, 0.0, 0.0, 1.0),
    "adaptive_sorted_half_gaussian": (0.0, 0.0, 0.0, 2.0),
    "adaptive_sorted_exponential": (0.0, 1.5),
    "nn_adaptive_layer_gaussian": (0.0, 0.0, 0.0, 0.0, 0.0, 1.0),
}


def _layout(prior_type):
    """A block of the type on hypercube 0..3 (physical 1..4), and a uniform
    block on hypercube 4 (physical 0)."""
    return [
        ppr.PriorBlock(prior_type, (0, 1, 2, 3), (1, 2, 3, 4), PARAMS[prior_type]),
        ppr.PriorBlock("uniform", (4,), (0,), (-2.0, 7.0)),
    ]


def _jax_blocks(blocks):
    return [jpr.PriorBlock(*dataclasses.astuple(b)) for b in blocks]


def _cube(seed, n=512):
    return np.random.default_rng(seed).uniform(0.001, 0.999, (n, 5))


@pytest.mark.parametrize("prior_type", ppr.PRIOR_TYPES)
def test_hypercube_to_physical_matches_jax(prior_type):
    assert set(ppr.PRIOR_TYPES) == set(jpr.PRIOR_TYPES) == set(PARAMS)
    blocks = _layout(prior_type)
    cube = _cube(len(prior_type))
    with jax.enable_x64(True):
        want = np.asarray(jpr.hypercube_to_physical(jnp.asarray(cube), _jax_blocks(blocks)))
    got = ppr.hypercube_to_physical(torch.as_tensor(cube), blocks)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # the callable prior of the layout is the same transform
    np.testing.assert_array_equal(
        ppr.BlockPrior(blocks, 5)(torch.as_tensor(cube)).numpy(), got.numpy()
    )


@pytest.mark.parametrize("prior_type", ["uniform", "gaussian", "log_uniform", "sorted_uniform"])
def test_physical_to_hypercube_matches_jax(prior_type):
    blocks = _layout(prior_type)
    cube = _cube(7)
    theta = ppr.hypercube_to_physical(torch.as_tensor(cube), blocks)
    with jax.enable_x64(True):
        want = np.asarray(jpr.physical_to_hypercube(jnp.asarray(theta.numpy()), _jax_blocks(blocks)))
        vol_j = jpr.prior_log_volume(_jax_blocks(blocks))
    got = ppr.physical_to_hypercube(theta, blocks).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got, cube, rtol=1e-8, atol=1e-10)  # it inverts
    assert ppr.prior_log_volume(blocks) == vol_j
    with pytest.raises(ValueError, match="no inverse"):
        ppr.physical_to_hypercube(theta, _layout("exponential"))


def test_affine_form_of_an_all_uniform_layout():
    _, blocks, *_ = read_ini(os.path.join(REPO, "ini", "gaussian_shells.ini"))
    prior = ppr.BlockPrior(blocks, 2)
    a, s = prior.affine
    np.testing.assert_array_equal(a, np.float32([-6.0, -2.5]))
    np.testing.assert_array_equal(s, np.float32([12.0, 5.0]))
    # bitwise the transform the kernels apply, theta = a + s * cube, in f32
    cube = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (1000, 2)), dtype=torch.float32)
    want = torch.as_tensor(a) + torch.as_tensor(s) * cube
    assert torch.equal(prior(cube), want)
    # s is f32(b) - f32(a) rounded in f32, as the transform takes it
    odd = [ppr.PriorBlock("uniform", (0, 1), (0, 1), (0.1, 0.7, -1.3, 2.9))]
    a, s = ppr.blocks_affine(odd, 2)
    np.testing.assert_array_equal(s, np.float32([0.7, 2.9]) - np.float32([0.1, -1.3]))
    assert torch.equal(ppr.BlockPrior(odd, 2)(cube), torch.as_tensor(a) + torch.as_tensor(s) * cube)
    # vector UniformPrior: the same form
    u = ppr.UniformPrior([-6.0, -2.5], [6.0, 2.5])
    assert torch.equal(u(cube), want)
    # layouts without one: another block type, a permuted index map, a gap
    assert ppr.blocks_affine(_layout("gaussian"), 5) is None
    assert ppr.blocks_affine(_layout("uniform"), 5) is None
    assert ppr.blocks_affine([ppr.PriorBlock("uniform", (0,), (0,), (0.0, 1.0))], 2) is None


def test_engine_auto_on_a_card_refuses_a_layout_without_affine_form(monkeypatch):
    from polychordlite_tpu_torch.core import nested_sampling as ns
    from polychordlite_tpu_torch.models import gaussian
    from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator

    calc = make_batched_calculator(ppr.BlockPrior(_layout("gaussian"), 5), gaussian(5), 5, 2)
    assert calc.device_spec is None and calc.form == "batched"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # "cuda" takes the layout through the fused route (the lowering takes
    # the block layout's index_select and index_copy), and so do the forced
    # A/B kernels, lowered into theirs; a layout the lowering refuses (the
    # adaptive prior's floor) runs on "cuda" (its traced route) and the
    # forced kernels refuse it, naming the plain engine
    refused = make_batched_calculator(
        ppr.BlockPrior(_layout("adaptive_sorted_uniform"), 5), gaussian(5), 5, 2)
    for engine in ("auto", "cuda"):
        assert ns.resolve_engine(engine, torch.device("cuda"), calc) == "cuda"
        assert ns.resolve_engine(engine, torch.device("cuda"), refused) == "cuda"
    for engine in ("cuda5", "cuda3", "cuda2"):
        assert ns.resolve_engine(engine, torch.device("cuda"), calc) == engine
        with pytest.raises(ValueError, match="engine='torch'"):
            ns.resolve_engine(engine, torch.device("cuda"), refused)
    assert ns.resolve_engine("torch", torch.device("cuda"), calc) == "torch"


CLI = """
import runpy, sys
sys.argv = ["polychordlite_tpu_torch", sys.argv[1], "--device", "cpu"]
try:
    runpy.run_module("polychordlite_tpu_torch", run_name="__main__")
except SystemExit as e:
    code = e.code
print("JAX_IMPORTED", any(m == "jax" or m.startswith(("jax.", "polychordlite_tpu.")) for m in sys.modules))
sys.exit(code)
"""


def test_cli_smoke(tmp_path):
    """``python -m polychordlite_tpu_torch --device cpu`` on a shrunk copy of
    the shipped gaussian_shells.ini (the overrides of tests/test_ini_suite.py)."""
    src = open(os.path.join(REPO, "ini", "gaussian_shells.ini")).read()
    src = (
        src.replace("nlive = 500", "nlive = 50")
        .replace("num_repeats = 10", "num_repeats = 4")
        .replace("base_dir = chains", f"base_dir = {tmp_path}")
        .replace("feedback = 1", "feedback = 0\nmax_ndead = 300\nseed = 2")
    )
    ini = tmp_path / "shells.ini"
    ini.write_text(src)
    out = subprocess.run(
        [sys.executable, "-c", CLI, str(ini)], capture_output=True, text=True,
        timeout=300, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "logZ = " in out.stdout and "ndead = " in out.stdout
    assert "JAX_IMPORTED False" in out.stdout
    assert (tmp_path / "gaussian_shells.stats").exists()
    assert (tmp_path / "gaussian_shells.paramnames").exists()
