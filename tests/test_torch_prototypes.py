"""The prototype slice kernels of the port (E4, E5) on the CPU.

E4 (``experiments/pallas_epoch_v2.py``) and E5
(``experiments/pallas_slice_repeat.py``) draw their uniforms from the TPU's
hardware PRNG, which the interpreter cannot run usefully on the CPU (no
rule for ``prng_seed`` under ``interpret=True``; zeros under
``pltpu.InterpretParams()``).  So each script is loaded by path with its
``pltpu`` replaced by a shim: ``prng_seed`` keeps its traced seed, and
``prng_random_bits`` returns bits hashed from (that seed, the lane's index
in the block, the trace-time call index, the traced loop counter ``it`` of
the while body that draws — read from the caller's frame; 0 outside the
loop), so every iteration draws anew, as the hardware stream does.
``pl.pallas_call`` runs with ``interpret=True``.  (With one draw per call
site, the same in every iteration, long shrink sequences made XLA's fused
``tL + u (tR - tL)`` and ``x0 + t n̂`` — one rounding each, where the
port rounds twice — drift past the tolerances below on 2 of 1,024 lanes
with every decision the same; computed with one rounding, the plain
version gave the JAX cube bit for bit.)  The port's plain versions are fed the same uniforms
through their ``uniform=`` seam and held decision-exact to the JAX kernels
at a small size (D = 4), with non-zero draws.  Then the murmur3 draws the
port's kernels use, the studies' ``main()`` on the CPU and the device rule.
"""

import importlib.util
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from polychordlite_tpu_torch.experiments import pallas_epoch_v2 as e4
from polychordlite_tpu_torch.experiments import pallas_slice_repeat as e5
from polychordlite_tpu_torch.ops import pallas_slice as pps

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, S, R, NB = 4, 8, 3, 2
B = S * 128
SEED = 1234
SIGMA = 0.1
NORM = -D * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))
BOUND = NORM - 0.5 * (1.5 * SIGMA * math.sqrt(D) / SIGMA) ** 2

# the shim's hash: h = seed A + lane L + (call + 1) C + it K, then
# murmur3's fmix
_A, _L, _C, _K = 0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F
_F1, _F2 = 0x85EBCA6B, 0xC2B2AE35


def _fmix_jnp(h):
    h = h ^ (h >> 16)
    h = h * jnp.uint32(_F1)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(_F2)
    return h ^ (h >> 16)


def _shim_uniforms(seed, call, it, shape):
    """numpy: the uniforms the kernels make of the shim's bits at loop
    iteration ``it`` (0 outside the loop), (bits & 0xFFFFFF) * 2**-24
    (pallas_epoch_v2.py:55-57)."""
    u32 = lambda v: np.full(shape, v & 0xFFFFFFFF, np.uint32)  # noqa: E731
    lane = np.arange(shape[0] * shape[1], dtype=np.uint32).reshape(shape)
    h = u32(seed) * u32(_A) + lane * u32(_L) + u32(call + 1) * u32(_C) + u32(it) * u32(_K)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(_F1)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(_F2)
    h = h ^ (h >> np.uint32(16))
    return (h & np.uint32(0xFFFFFF)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def _load(name, **globals_):
    """experiments/<name>.py by path, its PRNG shimmed, its pallas_call in
    interpret mode and its module globals ``globals_`` set."""
    spec = importlib.util.spec_from_file_location(
        f"jax_proto_{name}", os.path.join(REPO, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    state = {}

    def prng_seed(seed):
        state.update(seed=seed, calls=0)

    def prng_random_bits(shape):
        # the loop counter `it` of the while body that draws (its frame is
        # two up: body -> rand_u -> here), 0 for a draw outside the loop
        it = sys._getframe(2).f_locals.get("it", 0)
        lane = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * jnp.uint32(shape[1])
                + jax.lax.broadcasted_iota(jnp.uint32, shape, 1))
        u32 = lambda v: jax.lax.bitcast_convert_type(jnp.asarray(v, jnp.int32), jnp.uint32)  # noqa: E731
        h = (u32(state["seed"]) * jnp.uint32(_A) + lane * jnp.uint32(_L)
             + jnp.uint32(state["calls"] + 1) * jnp.uint32(_C) + u32(it) * jnp.uint32(_K))
        state["calls"] += 1
        return jax.lax.bitcast_convert_type(_fmix_jnp(h), jnp.int32)

    mod.pltpu = types.SimpleNamespace(
        prng_seed=prng_seed, prng_random_bits=prng_random_bits,
        bitcast=lambda x, dtype: x.astype(dtype),
        PrefetchScalarGridSpec=pltpu.PrefetchScalarGridSpec, VMEM=pltpu.VMEM,
        CompilerParams=pltpu.CompilerParams)
    mod.pl = types.SimpleNamespace(
        pallas_call=lambda *a, **k: pl.pallas_call(*a, **k, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when)
    for k, v in globals_.items():
        setattr(mod, k, v)
    return mod


def _decision_exact(n, n_j, l, l_j, c, c_j, bound):
    """tests/test_torch_experiments.py's rule for chains with (repeat, lane)
    records l (R, B), cubes c (R, D, B) and per-lane counts n (B,):
    identical nlike, cube to 1e-6 and logL to 1e-5; a lane may only differ
    if its first divergent repeat accepted a probe on the contour."""
    rep_ok = (np.abs(l - l_j) <= 1e-5) & (np.abs(c - c_j) <= 1e-6).all(1)
    lane_ok = (n == n_j) & rep_ok.all(0)
    bad = np.nonzero(~lane_ok)[0]
    assert len(bad) < n.size / 1000, f"{len(bad)} lanes differ"
    for b in bad:
        r = int(np.nonzero(~rep_ok[:, b])[0][0])
        assert abs(float(l_j[r, b]) - float(bound[b])) < 1e-5, (b, r)
    return lane_ok


def _ball(rng, x_shape, nh_shape, axis):
    """Seeds 0.5 + 0.02 N(0, 1) and unit directions, the scripts' study
    inputs (pallas_epoch_v2.py:178-180)."""
    x0 = (0.5 + 0.02 * rng.standard_normal(x_shape)).astype(np.float32)
    nh = rng.standard_normal(nh_shape).astype(np.float32)
    nh /= np.linalg.norm(nh, axis=axis, keepdims=True)
    return x0, nh


# ---- E4 against experiments/pallas_epoch_v2.py ---------------------------

def test_e4_plain_matches_jax_epoch_with_draws():
    """The whole epoch, decision-exact with the JAX kernel in interpret
    mode at D = 4, S = 8 (1,024 chains), R = 3, the draws non-zero: most
    lanes accept every repeat, each after several probes, and the chain
    carries from repeat to repeat."""
    mod = _load("pallas_epoch_v2", D=D, SUB=S, R=R, NORM=NORM)
    rng = np.random.default_rng(11)
    x0, nh = _ball(rng, (D, S, 128), (R, D, S, 128), axis=1)
    ws = np.full((R, S, 128), 3 * SIGMA, np.float32)
    bound = np.full((S, 128), BOUND, np.float32)
    cube_j, logL_j, nlike_j = (np.asarray(a) for a in mod.pallas_epoch(
        jnp.array([SEED], jnp.int32), x0, bound, nh, ws))

    def draw(r, it):
        return torch.as_tensor(_shim_uniforms(SEED + r, 0, it, (S, 128)))

    assert 0.4 < float(draw(0, 0).mean()) < 0.6  # not the interpreter's zeros
    assert not torch.equal(draw(0, 0), draw(0, 1)) and not torch.equal(draw(0, 0), draw(1, 0))
    cube, logL, nlike = e4.proto_epoch_plain(
        torch.tensor([SEED], dtype=torch.int32), *(torch.as_tensor(a) for a in (x0, bound, nh, ws)),
        uniform=draw)
    assert cube.shape == (R, D, S, 128) and logL.shape == (R, S, 128)
    assert nlike.dtype == torch.int32 and nlike.shape == (S, 128)
    _decision_exact(nlike.numpy().reshape(B), nlike_j.reshape(B), logL.numpy().reshape(R, B),
                    logL_j.reshape(R, B), cube.numpy().reshape(R, D, B),
                    cube_j.reshape(R, D, B), bound.reshape(B))
    accepted = logL_j > -1e30
    assert accepted.mean() > 0.98 and nlike_j.mean() > 3 * R
    moved = np.abs(cube_j[1:] - cube_j[:-1]).sum(axis=1)
    assert (moved[accepted[1:]] > 0).all()


def test_e4_epoch_is_its_repeats_chained():
    """Repeat r of an epoch seeded s draws at seed s + r from the position
    repeat r - 1 accepted: R one-repeat epochs seeded s + r, each from the
    last one's cube, give the epoch bit for bit."""
    x0, bound, nh, ws = e4.study_inputs("cpu", D, 2, R, seed=3)
    seed = torch.tensor([77], dtype=torch.int32)
    cube, logL, nlike = e4.proto_epoch(seed, x0, bound, nh, ws)
    x, total = x0, torch.zeros_like(nlike)
    for r in range(R):
        c, l, n = e4.proto_epoch(seed + r, x, bound, nh[r:r + 1], ws[r:r + 1])
        assert torch.equal(c[0], cube[r]) and torch.equal(l[0], logL[r])
        x, total = c[0], total + n
    assert torch.equal(total, nlike)


# ---- E5 against experiments/pallas_slice_repeat.py -----------------------

def test_e5_plain_matches_jax_repeat_with_draws():
    """One repeat over nb = 2 blocks, decision-exact with the JAX kernel in
    interpret mode at D = 4: u0 (the shim's first call in a block) places
    the bracket, the loop's draw (its second call) shrinks it, and the two
    differ."""
    mod = _load("pallas_slice_repeat", D=D, NORM=NORM)
    rng = np.random.default_rng(12)
    rows = 8 * NB
    x0, nh = _ball(rng, (D, rows, 128), (D, rows, 128), axis=0)
    w = np.full((rows, 128), 3 * SIGMA, np.float32)
    bound = np.full((rows, 128), BOUND, np.float32)
    cube_j, logL_j, nlike_j = (np.asarray(a) for a in mod.run_repeat(
        jnp.array([SEED], jnp.int32), x0, nh, w, bound, NB))

    def draw(k):  # k = 0: u0, the first call; k = i + 1: the loop's call at iteration i
        return torch.as_tensor(np.concatenate([
            _shim_uniforms(SEED + 7919 * blk, min(k, 1), max(k - 1, 0), (8, 128))
            for blk in range(NB)]))

    assert not torch.equal(draw(0), draw(1)) and not torch.equal(draw(1), draw(2))
    cube, logL, nlike = e5.proto_repeat_plain(
        torch.tensor([SEED], dtype=torch.int32), *(torch.as_tensor(a) for a in (x0, nh, w, bound)),
        uniform=draw)
    assert cube.shape == (D, rows, 128) and nlike.dtype == torch.int32
    n_lanes = rows * 128
    _decision_exact(nlike.numpy().reshape(n_lanes), nlike_j.reshape(n_lanes),
                    logL.numpy().reshape(1, n_lanes), logL_j.reshape(1, n_lanes),
                    cube.numpy().reshape(1, D, n_lanes), cube_j.reshape(1, D, n_lanes),
                    bound.reshape(n_lanes))
    assert (logL_j > -1e30).mean() > 0.98 and nlike_j.mean() > 3


def test_e5_draw_zero_places_the_bracket():
    """u0 alone places the bracket: with every later draw the same, changing
    u0 moves the INIT_R and INIT_L probes, so the records change, while
    changing draw 1 (the INIT_R iteration's own, unused) changes nothing."""
    x0, nh, w, bound = e5.study_inputs("cpu", D, 1, seed=4)
    seed = torch.tensor([5], dtype=torch.int32)
    base = e5.repeat_uniforms(5, 8, "cpu")

    def run(swap):
        return e5.proto_repeat_plain(seed, x0, nh, w, bound,
                                     uniform=lambda k: base(swap.get(k, k)))

    ref = e5.proto_repeat(seed, x0, nh, w, bound)
    assert all(torch.equal(a, b) for a, b in zip(run({}), ref))
    assert all(torch.equal(a, b) for a, b in zip(run({1: 99}), ref))
    assert not torch.equal(run({0: 99})[0], ref[0])


# ---- the murmur3 draws of the port's kernels ----------------------------

def test_draws_are_the_slice_uniforms_keyed_per_prototype():
    """E4: u of iteration it in repeat r is the slice uniform at
    h = mix(seed + r, lane), counter it; E5: at h = mix(seed + 7919 block,
    lane in block), counter k.  Exact 24-bit values in [0, 1)."""
    seed = 2 ** 31 - 5  # seed + r wraps as the kernels' 32-bit words do
    u = e4.epoch_uniforms(seed, 2, "cpu")
    for r, it, lane in ((0, 0, 0), (3, 7, 200), (1, 503, 255)):
        h = pps._mix((seed + r) & pps.MASK, lane)
        want = pps.uniform_from_hash(pps._fmix(pps._mix(h, it)))
        assert u(r, it).flatten()[lane].item() == want
    v = e5.repeat_uniforms(seed, 16, "cpu")
    for k, g in ((0, 5), (1, 1024 + 5), (9, 2047)):
        h = pps._mix((seed + 7919 * (g // 1024)) & pps.MASK, g % 1024)
        assert v(k).flatten()[g].item() == pps.uniform_from_hash(pps._fmix(pps._mix(h, k)))
    a = u(0, 0)
    assert a.dtype == torch.float32 and ((a >= 0) & (a < 1)).all()
    assert ((a * 2 ** 24) == (a * 2 ** 24).round()).all()
    assert not torch.equal(v(0)[:8], v(0)[8:])  # the blocks draw apart


def test_plain_versions_draw_the_murmur3_stream():
    """Without ``uniform=`` each plain version draws what the seam would be
    given from ``epoch_uniforms`` / ``repeat_uniforms`` (E5: counter 0,
    then it + 1)."""
    seed = torch.tensor([9], dtype=torch.int32)
    args = e4.study_inputs("cpu", D, 1, 2, seed=1)
    u = e4.epoch_uniforms(9, 1, "cpu")
    for a, b in zip(e4.proto_epoch_plain(seed, *args),
                    e4.proto_epoch_plain(seed, *args, uniform=u)):
        assert torch.equal(a, b)
    args = e5.study_inputs("cpu", D, 1, seed=2)
    v = e5.repeat_uniforms(9, 8, "cpu")
    for a, b in zip(e5.proto_repeat_plain(seed, *args), e5.proto_repeat_plain(seed, *args,
                                                                              uniform=v)):
        assert torch.equal(a, b)


def test_step_counts_and_budget():
    """Every lane takes at least 3 micro-steps per repeat (INIT_R, INIT_L and
    one probe more) and none reaches the 504-iteration cap; nlike counts at
    most one call per micro-step."""
    seed = torch.tensor([3], dtype=torch.int32)
    args = e4.study_inputs("cpu", D, 2, 2, seed=5)
    *out, steps = e4.proto_epoch_plain(seed, *args, count_steps=True)
    assert steps.shape == (2, 2, 128) and (steps >= 3).all() and (steps < e4.MAX_INNER).all()
    assert (out[2] <= steps.sum(0)).all()
    *out, steps = e5.proto_repeat_plain(seed, *e5.study_inputs("cpu", D, 1), count_steps=True)
    assert (steps >= 3).all() and (out[2] <= steps).all()


# ---- the wrappers and the studies -------------------------------------

def test_wrappers_raise_off_cpu_and_cuda():
    seed = torch.tensor([1], dtype=torch.int32)
    x0, bound, nh, ws = (a.to("meta") for a in e4.study_inputs("cpu", D, 1, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        e4.proto_epoch(seed, x0, bound, nh, ws)
    x0, nh, w, bound = (a.to("meta") for a in e5.study_inputs("cpu", D, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        e5.proto_repeat(seed, x0, nh, w, bound)
    with pytest.raises(ValueError, match="8 nb"):
        e5.proto_repeat_plain(seed, torch.zeros(D, 4, 128), torch.zeros(D, 4, 128),
                              torch.zeros(4, 128), torch.zeros(4, 128))


def test_proto_epoch_study_on_cpu():
    rec = e4.main(device="cpu", D=D, S=1, R=3, reps=2)
    assert rec["ms"] is None and rec["evals_per_s"] is None and rec["first_call"]["ms"] is None
    assert rec["B"] == 128 and rec["evals"] >= 3 * 3 * 128
    assert rec["accepted_frac"] > 0.9 and rec["in_bound_frac"] == 1.0
    assert rec["chains_move_every_repeat"] is True and rec["repeats_without_move"] == 0


def test_proto_repeat_study_on_cpu():
    rec = e5.main(device="cpu", D=D, nb=1, R=4)
    assert rec["single"]["ms"] is None and rec["chain"]["evals_per_s"] is None
    assert rec["chain"]["launches"] == 4 and rec["chain"]["evals"] > 3 * rec["single"]["evals"]
    assert rec["in_bound_frac"] > 0.9


@pytest.mark.parametrize("study", [e4, e5])
def test_prototype_studies_need_a_card_unless_asked(monkeypatch, study):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        study.main()


@pytest.mark.parametrize("module,sizes", [("pallas_epoch_v2", ["--S", "1", "--R", "2"]),
                                          ("pallas_slice_repeat", ["--nb", "1", "--R", "2"])])
def test_prototype_studies_run_as_modules(module, sizes):
    proc = subprocess.run(
        [sys.executable, "-m", f"polychordlite_tpu_torch.experiments.{module}", "--device", "cpu",
         "--D", "3", *sizes], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert '"device": "cpu"' in proc.stdout.splitlines()[-1]
