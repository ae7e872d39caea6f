"""The port's v2 (B5) and v3 (B4) epochs and the counted v4 (E1) on the CPU.

The plain versions of the v2 and v3 kernels against the JAX package's v2
and v3 Pallas kernels in interpret mode, fed the same directions and key
words (as ``tests/test_torch_kernels.py`` does for v4); the three plain
engines against each other; the counted engine's step counts; and the
device rule of the entry points (the card by default, the CPU only when
asked for).
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychordlite_tpu.models.examples import gaussian as jax_gaussian
from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.models.examples import gaussian as pt_gaussian
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice_v3 import slice_epoch_v3, slice_records_window_plain
from polychordlite_tpu_torch.ops.pallas_slice_v4 import (
    lane_efficiency,
    slice_epoch_counted,
    warp_maxima,
)
from polychordlite_tpu_torch.ops.slice_kernel import (
    EpochConfig,
    build_epoch_fn,
    slice_records_plain,
    unpack_epoch,
)
from polychordlite_tpu_torch.priors import identity_prior

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, B, R = 4, 1024, 4  # tests/test_pallas_engine.py:41-53
SIGMA = 0.2
NORM = -D * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))


def _inputs(seed=0, bound_offset=0.0):
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    seeds = (0.5 + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    r0 = 1.5 * SIGMA * math.sqrt(D)
    bound = np.full((B,), NORM - 0.5 * (r0 / SIGMA) ** 2 + bound_offset, np.float32)
    chol = np.broadcast_to(SIGMA * np.eye(D, dtype=np.float32), (B, D, D)).copy()
    valid = np.arange(B) >= 64  # a block of invalid lanes
    dir_keys, _ = _lane_keys(key, B, None)
    nh, w, sp = jax_make_directions(
        dir_keys, jnp.asarray(chol), grade_dims=(D,), num_repeats=(R,), n_dims=D,
        shared_perm_key=jax.random.fold_in(key, 0x5EED),
    )
    port = (torch.as_tensor(seeds), torch.as_tensor(bound), torch.as_tensor(valid),
            torch.as_tensor(np.array(nh)), torch.as_tensor(np.array(w)))
    return key, (seeds, bound, chol, valid), port, torch.as_tensor(np.array(sp))


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


def _jax_calc_cfg():
    jcfg = JaxEpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    return jax_calculator(lambda c: c, jax_gaussian(D, sigma=SIGMA), D, 2), jcfg


def _port_calc_cfg(**kw):
    calc = make_batched_calculator(identity_prior, pt_gaussian(D, sigma=SIGMA), D, 2)
    return calc, EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,), **kw)


def _decision_exact(n, n_j, l, l_j, bound, t=None, t_j=None):
    """Identical nlike on every lane; t (where both have it) to 1e-6 and
    logL to 1e-5, as the v4 parity test of tests/test_torch_kernels.py
    holds them: XLA on the CPU may fuse a product into the following add
    (tL + u (tR - tL)), which the port rounds twice, and the two likelihoods
    sum chi2 in another order.  A lane may only differ if its first
    divergent probe sat on the contour (|logL - bound| < 1e-5)."""
    lane_ok = (n == n_j).all(1) & (np.abs(l - l_j) <= 1e-5).all(1)
    if t is not None:
        lane_ok &= (np.abs(t - t_j) <= 1e-6).all(1)
    bad = np.nonzero(~lane_ok)[0]
    assert len(bad) < B / 1000, f"{len(bad)} lanes differ"
    for b in bad:
        r = int(np.nonzero((n[b] != n_j[b]) | (np.abs(l[b] - l_j[b]) > 1e-5))[0][0])
        assert abs(float(l_j[b, r]) - float(bound[b])) < 1e-5, (b, r)
    return lane_ok


def test_plain_v2_matches_jax_v2(monkeypatch):
    from polychordlite_tpu.ops import pallas_slice as jv2

    key, (seeds, bound, chol, valid), port, _ = _inputs()
    jcalc, jcfg = _jax_calc_cfg()
    captured = _capture(monkeypatch, jv2)
    jv2.build_epoch_fn_pallas(jcalc, jcfg, interpret=True)(
        key, jnp.asarray(seeds), jnp.asarray(bound), jnp.asarray(chol), jnp.asarray(valid))
    cube_t, logL_t, nlike_t = (np.asarray(a) for a in captured["out"])
    cube_j = cube_t.reshape(R, D, B).transpose(2, 0, 1)
    l_j, n_j = logL_t.reshape(R, B).T, nlike_t.reshape(R, B).T.astype(np.int64)

    calc, cfg = _port_calc_cfg()
    t, l, n, cube = pps.slice_epoch_v2(calc, cfg, pps.key_words(np.asarray(key)), *port)
    lane_ok = _decision_exact(n.numpy().astype(np.int64), n_j, l.numpy(), l_j, bound)
    # the cube: the same sequential x + t n-hat, to float noise (2e-6)
    np.testing.assert_allclose(cube.numpy()[lane_ok], cube_j[lane_ok], rtol=0, atol=2e-6)
    np.testing.assert_array_equal(cube.numpy()[:64], np.broadcast_to(seeds[:64, None], (64, R, D)))


def test_plain_v3_matches_jax_v3(monkeypatch):
    from polychordlite_tpu.ops import pallas_slice_v3 as jv3

    key, (seeds, bound, chol, valid), port, _ = _inputs(seed=1)
    jcalc, jcfg = _jax_calc_cfg()
    captured = _capture(monkeypatch, jv3)
    jv3.build_epoch_fn_pallas_v3(jcalc, jcfg, interpret=True)(
        key, jnp.asarray(seeds), jnp.asarray(bound), jnp.asarray(chol), jnp.asarray(valid))
    t_t, logL_t, nlike_t = (np.asarray(a) for a in captured["out"])
    t_j, l_j = t_t.reshape(R, B).T, logL_t.reshape(R, B).T
    n_j = nlike_t.reshape(R, B).T.astype(np.int64)

    calc, cfg = _port_calc_cfg()
    t, l, n = slice_epoch_v3(calc, cfg, pps.key_words(np.asarray(key)), *port)
    _decision_exact(n.numpy().astype(np.int64), n_j, l.numpy(), l_j, bound,
                    t.numpy(), t_j)


@pytest.mark.parametrize("caps", [{}, {"max_step": 2, "max_shrink": 3}])
def test_plain_v2_v3_v4_identical(caps):
    """The three plain engines make the same decisions, bit for bit, at the
    default caps and at caps small enough for forced accepts."""
    _, _, port, _ = _inputs(seed=2, bound_offset=3.0 if caps else 0.0)
    calc, cfg = _port_calc_cfg(**caps)
    kw = (0x01234567, 0x89ABCDEF)
    v4 = slice_records_plain(lambda p: calc(p)[2], cfg, kw, *port)
    v3 = slice_records_window_plain(lambda p: calc(p)[2], cfg, kw, *port)
    v2 = pps.slice_records_lockstep_plain(lambda p: calc(p)[2], cfg, kw, *port)
    for a, b, c in zip(v4, v3, v2[:3]):
        assert torch.equal(a, b) and torch.equal(a, c)
    forced = (v4[1] == np.float32(cfg.logzero)) & port[2][:, None]
    assert bool(forced.any()) == bool(caps)
    # v2's cube is the sequential x + t n-hat: the rebuilt cube to float noise
    rebuilt = port[0][:, None, :] + torch.cumsum(v4[0][:, :, None] * port[3], dim=1)
    assert (v2[3] - rebuilt).abs().max() <= 2e-6


def test_cuda2_epoch_record_carries_the_kernel_cube():
    """The v2 engine's packed record takes the cube v2 wrote; everything
    else is the v4 engine's record."""
    key, (seeds, bound, chol, valid), port, sp = _inputs(seed=3)
    kw = pps.key_words(np.asarray(key))
    out = {}
    for engine in ("torch", "cuda2", "cuda3"):
        calc, cfg = _port_calc_cfg(engine=engine)
        packed = build_epoch_fn(calc, cfg)(
            kw, port[0], port[1], torch.as_tensor(chol), port[2],
            directions=(port[3], port[4], sp))
        out[engine] = unpack_epoch(packed.numpy(), cfg)
    np.testing.assert_array_equal(out["cuda3"][0], out["torch"][0])
    for k in (3, 4):  # logL, nlike
        np.testing.assert_array_equal(out["cuda2"][k], out["torch"][k])
    _, _, _, cube = pps.slice_epoch_v2(calc, cfg, kw, *port)
    np.testing.assert_array_equal(out["cuda2"][0], cube.numpy())
    np.testing.assert_allclose(out["cuda2"][0], out["torch"][0], rtol=0, atol=2e-6)


def test_counted_engine_steps():
    """E1's plain version: the v4 engine's outputs, and per lane the
    micro-steps executed — at least the lane's counted calls — with the
    maximum of each warp of 32 lanes."""
    _, _, port, _ = _inputs(seed=4)
    calc, cfg = _port_calc_cfg()
    kw = (5, 6)
    t, l, n, steps, wmax = slice_epoch_counted(calc, cfg, kw, *port)
    for a, b in zip((t, l, n), slice_records_plain(lambda p: calc(p)[2], cfg, kw, *port)):
        assert torch.equal(a, b)
    assert steps.dtype == wmax.dtype == torch.int32
    assert steps.shape == (B,) and wmax.shape == (B // 32,)
    assert int(steps.sum()) >= int(n.sum()) and (steps[:64] == 0).all()
    assert (steps >= 3 * R)[64:].all()  # a repeat: INIT_R, INIT_L and a shrink at least
    assert (wmax.repeat_interleave(32) >= steps).all()
    assert torch.equal(wmax, warp_maxima(steps))
    eff = lane_efficiency(steps, wmax)
    assert 0.0 < eff <= 1.0
    ragged = warp_maxima(steps[:1000])  # a last warp of 8 lanes, padded with 0
    assert ragged.shape == (32,) and ragged[-1] == steps[992:1000].max()


def test_resolve_device_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ns.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ns.resolve_device("cuda")
    assert ns.resolve_device("cpu") == torch.device("cpu")


def _cli(tmp_path, *flags):
    src = open(os.path.join(REPO, "ini", "himmelblau.ini")).read()
    src = (src.replace("nlive = 500", "nlive = 40")
           .replace("num_repeats = 10", "num_repeats = 2")
           .replace("base_dir = chains", f"base_dir = {tmp_path}")
           .replace("feedback = 1", "feedback = 0\nmax_ndead = 120\nseed = 4"))
    ini = tmp_path / "himmelblau.ini"
    ini.write_text(src)
    return subprocess.run(
        [sys.executable, "-m", "polychordlite_tpu_torch", str(ini), *flags],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_cli_device_flag(tmp_path):
    """``--device cpu`` runs the CLI on the CPU; without it the CLI asks for
    a card and, with none visible, stops naming the CPU option."""
    out = _cli(tmp_path, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "logZ = " in out.stdout and (tmp_path / "himmelblau.stats").exists()
    default = _cli(tmp_path)
    assert default.returncode != 0 and "device='cpu'" in default.stderr
