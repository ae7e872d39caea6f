"""precision='highest' in the port (``ops/precision.py``), on the CPU.

The JAX package's big likelihood (``tests/test_precision.py``: |logL| ~ 1e7,
where ulp(1e7) = 1 in float32) through the port's ``run()`` in float64,
against its analytic evidence and the JAX package's own float64 run; the
float32 guard (C13) naming the way out; the thread-local dtype; the chain
in float64 (its blob and its replay check, reference fault C2 not copied);
and each float64 piece against its counterpart: the plain Gram-Schmidt
against the JAX ``_gram_schmidt`` under ``jax.enable_x64``, the lowered
body against the calc, the float64 lane machine against the float32 one,
and the engines that refuse float64.
"""

import json
import math
import os
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polychordlite_tpu_torch as pt
from polychordlite_tpu.ops.directions import _gram_schmidt as jax_gram_schmidt
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.models import gaussian
from polychordlite_tpu_torch.ops import fused_like, pallas_dirs, slice_kernel
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice import fold_in, seed_key
from polychordlite_tpu_torch.ops.precision import real_dtype, real_dtype_scope
from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, slice_records_plain
from polychordlite_tpu_torch.parallel.mesh import make_epoch_runner
from polychordlite_tpu_torch.priors import GaussianPrior, UniformPrior, identity_prior
from test_precision import ANALYTIC, NDIMS, OFFSET, SIGMA
from test_precision import run_big as jax_run_big


def big_like(theta):
    """tests/test_precision.py's big likelihood, per point in torch."""
    r2 = torch.sum(theta ** 2)
    norm = -NDIMS * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))
    return OFFSET + norm - r2 / (2 * SIGMA ** 2), [r2]


def run_big(base, **kw):
    """The port's run with tests/test_precision.py's settings."""
    defaults = dict(
        nDerived=1, prior=UniformPrior(-1, 1), nlive=80, num_repeats=2 * NDIMS,
        read_resume=False, base_dir=str(base), file_root="p", seed=2, feedback=0,
        precision_criterion=0.01, device="cpu",
    )
    defaults.update(kw)
    return pt.run(big_like, NDIMS, **defaults)


def last_record(base, root="p"):
    with open(os.path.join(str(base), f"{root}.metrics.jsonl")) as f:
        return json.loads(f.read().splitlines()[-1])


def test_highest_recovers_the_big_evidence_and_agrees_with_jax(tmp_path):
    """float64 recovers 1e7 - 2 log 2 within 3 sigma + 0.2 (the JAX test's
    gate), and agrees with the JAX package's float64 run of the same model
    within 3 combined sigma."""
    out = run_big(tmp_path / "port", precision="highest")
    assert abs(out.logZ - ANALYTIC) < 3 * out.logZerr + 0.2
    rec = last_record(tmp_path / "port")
    assert rec["dtype"] == "float64" and rec["engine"] == "torch"
    ref = jax_run_big(tmp_path / "jax", precision="highest")
    assert abs(out.logZ - ref.logZ) < 3 * math.hypot(out.logZerr, ref.logZerr)


def test_default_precision_raises_naming_highest(tmp_path):
    """C13: a float32 run whose best live logL is beyond F32_SAFE_LOGL
    raises before its first epoch, and the message names the way out."""
    with pytest.raises(ValueError, match="precision='highest'"):
        run_big(tmp_path, max_ndead=150)
    assert real_dtype() == torch.float32


def test_highest_restores_the_thread_dtype(tmp_path):
    """A float64 run leaves real_dtype() float32, also when it raises; a
    default-precision run after it is right."""
    run_big(tmp_path, file_root="r", precision="highest", max_ndead=120)
    assert real_dtype() == torch.float32
    with pytest.raises(ValueError):
        run_big(tmp_path, file_root="bad", precision="highest", engine="cuda3")
    assert real_dtype() == torch.float32
    out = pt.run(gaussian(2), 2, nDerived=2, nlive=50, num_repeats=4, read_resume=False,
                 base_dir=str(tmp_path), file_root="after", seed=3, feedback=0,
                 precision_criterion=0.01, device="cpu")
    assert last_record(tmp_path, "after")["dtype"] == "float32"
    assert abs(out.logZ) < 3 * out.logZerr


def test_concurrent_mixed_precision_threads(tmp_path):
    """The dtype is thread-local (the JAX test of the same name): a float64
    run of the big likelihood and a float32 run of a Gaussian on two
    threads at once, both right, each in its own dtype."""
    results, errors = {}, []

    def worker(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # surface in the main thread
            errors.append((name, e))

    hi = threading.Thread(target=worker, args=("hi", lambda: run_big(
        tmp_path / "hi", precision="highest")))
    lo = threading.Thread(target=worker, args=("lo", lambda: pt.run(
        gaussian(2), 2, nDerived=2, nlive=80, num_repeats=4, read_resume=False,
        base_dir=str(tmp_path / "lo"), file_root="p", seed=4, feedback=0,
        precision_criterion=0.01, device="cpu")))
    hi.start()
    lo.start()
    hi.join()
    lo.join()
    assert not errors, errors
    assert abs(results["hi"].logZ - ANALYTIC) < 3 * results["hi"].logZerr + 0.2
    assert abs(results["lo"].logZ) < 3 * results["lo"].logZerr
    assert last_record(tmp_path / "hi")["dtype"] == "float64"
    assert last_record(tmp_path / "lo")["dtype"] == "float32"
    assert real_dtype() == torch.float32


def test_chained_float64_run_passes_its_replay_check(tmp_path):
    """Chained epochs at float64: the run keeps them (a replay divergence
    warns and switches them off; warnings are errors here) and dispatched
    chains; the chain's blob is float64, not float32 (reference fault C2)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = run_big(tmp_path, precision="highest", do_clustering=False)
    rec = last_record(tmp_path)
    assert rec["chained_epochs"] is True and rec["chains_dispatched"] > 0
    assert rec["chains_voided"] == 0
    assert abs(out.logZ - ANALYTIC) < 3 * out.logZerr + 0.2

    D, nlive = NDIMS, 40
    with real_dtype_scope(torch.float64):
        calc = make_batched_calculator(UniformPrior(-1, 1), big_like, D, 1)
    cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(4,))
    gen = torch.Generator().manual_seed(0)
    run, B = make_epoch_runner(calc, cfg, 16, torch.device("cpu"), gen)
    rng = np.random.default_rng(1)
    live = rng.uniform(0.45, 0.55, (nlive, D))
    logL = calc(torch.as_tensor(live))[2].numpy()
    flat, K, _ = run.dispatch_chain(seed_key(5), live, logL, 0.03 * np.eye(D), 2)
    assert flat.dtype == torch.float64 and K == 2
    nurseries, (final_logL, final_cube) = run.collect_chain((flat, K, nlive))
    # the final live set keeps float64 logL beyond float32's resolution at 1e7
    assert final_logL.dtype == np.float64
    assert not np.array_equal(final_logL, final_logL.astype(np.float32).astype(np.float64))
    assert ns.live_rows_match(final_cube, final_logL, final_cube, final_logL, np.float64)


@pytest.mark.parametrize("dim", [4, 20, 40])
def test_plain_gram_schmidt_float64_matches_jax_x64(dim):
    """gram_schmidt_plain in float64 (the thread-per-basis order up to dim
    32, the warp butterfly above) against the JAX package's XLA
    ``_gram_schmidt`` under ``jax.enable_x64``, within 1e-12: float64 sums
    of at most 40 products in two orders."""
    g = np.random.default_rng(dim).standard_normal((1, dim, dim, 16))
    got = pallas_dirs.gram_schmidt_plain(torch.as_tensor(g)).numpy()
    assert got.dtype == np.float64
    with jax.enable_x64(True):
        want = np.asarray(jax_gram_schmidt(jnp.asarray(g.transpose(0, 3, 1, 2))))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1), rtol=0, atol=1e-12)
    # the wrapper takes float64 on the CPU (its plain version) and counts nothing
    before = dict(pallas_dirs.LAUNCHES)
    np.testing.assert_array_equal(pallas_dirs.gram_schmidt_lanes(torch.as_tensor(g)).numpy(),
                                  got)
    assert pallas_dirs.LAUNCHES == before


def _f64_calc(prior, like, D, n_derived=0):
    with real_dtype_scope(torch.float64):
        return make_batched_calculator(prior, like, D, n_derived)


@pytest.mark.parametrize("model", ["big", "gaussian_ini", "transcendental"])
def test_lowered_float64_body_matches_the_calc(model):
    """At float64 the lowering traces the prior into the body, emits a
    double functor, and its plain version holds the calc within
    fused_like.F64_TOL (rtol = atol = 1e-12) on fresh cubes."""
    if model == "big":
        calc = _f64_calc(UniformPrior(-1, 1), big_like, NDIMS, 1)
    elif model == "gaussian_ini":
        calc = _f64_calc(identity_prior, lambda th: -0.5 * torch.sum(((th - 0.5) / 0.1) ** 2)
                         - 20 * (math.log(0.1) + 0.5 * math.log(2 * math.pi)), 20)
    else:
        calc = _f64_calc(UniformPrior(0.1, 2.0), lambda th: torch.sum(
            torch.exp(-th) + torch.log1p(th) + torch.sin(th) * torch.cos(th) + torch.sqrt(th)
            + torch.tanh(th) + th ** 2.5), 3)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), getattr(low, "reason", None)
    assert low.dtype == torch.float64 and low.prior_lowered and low.consts.dtype == np.float64
    src = low.source(4)
    assert "double" in src and "__dadd_rn" in src and "__fadd_rn" not in src and "float" not in src
    cube = torch.as_tensor(np.random.default_rng(3).uniform(0, 1, (500, calc.n_dims)))
    got, want = low.plain_logL(cube), calc(cube)[2]
    assert got.dtype == want.dtype == torch.float64
    assert torch.allclose(got, want, rtol=fused_like.F64_TOL[0], atol=fused_like.F64_TOL[1])
    if model == "big":  # float64 resolves what float32 cannot at 1e7
        assert len(torch.unique(got)) == len(got)
    # the float32 lowering of the same model is another source (the hash)
    calc32 = make_batched_calculator(UniformPrior(-1, 1), big_like, NDIMS, 1)
    assert fused_like.lowering(calc32).key(4) != low.key(4) or model != "big"


def test_erfinv_is_refused_at_float64_and_takes_the_traced_route():
    """fused_ops.cuh's erfinv and ndtri are float32 sequences: at float64 the
    lowering refuses a Gaussian prior's erfinv, and engine 'cuda' takes the
    traced route, naming the reason; at float32 the same model is lowered."""
    def like(th):
        return -0.5 * torch.sum(th ** 2)

    calc = _f64_calc(GaussianPrior(0.0, 1.0), like, 3)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Refused) and "float64" in low.reason
    assert "erfinv" in low.reason
    route, reason = slice_kernel.cuda_route(calc)
    assert route == "slice_step" and "erfinv" in reason
    calc32 = make_batched_calculator(GaussianPrior(0.0, 1.0), like, 3, 0)
    assert isinstance(fused_like.lowering(calc32), fused_like.Lowered)


def _lane_inputs(B, R, D, seed):
    rng = np.random.default_rng(seed)
    x0 = np.clip(0.5 + 0.05 * rng.standard_normal((B, D)), 0, 1).astype(np.float32)
    other = np.clip(0.5 + 0.05 * rng.standard_normal((B, D)), 0, 1).astype(np.float32)
    g = rng.standard_normal((B, R, D))
    nh = (g / np.linalg.norm(g, axis=2, keepdims=True)).astype(np.float32)
    w = (0.3 * rng.uniform(0.5, 1.5, (B, R))).astype(np.float32)
    valid = np.ones(B, bool)
    valid[:8] = False
    return x0, other, nh, w, valid


def test_float64_lane_machine_against_float32():
    """The plain engine (the float64 LaneMachine) given the float32 engine's
    inputs and key words, exactly representable in both: every lane whose
    probes never came within float32's rounding of its bound makes the same
    decisions (nlike) and the same moves (t within 1e-5), and at least 99 %
    of (lane, repeat) pairs have the same nlike."""
    B, R, D = 512, 8, 4
    x0, other, nh, w, valid = _lane_inputs(B, R, D, 11)

    def like(p):
        return -0.5 * (((p - 0.5) / 0.1) ** 2).sum(1)

    bound = torch.minimum(like(torch.as_tensor(x0)), like(torch.as_tensor(other))).numpy()
    cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
    kw = (0x1234, 0x5678)
    near = torch.full((B,), float("inf"), dtype=torch.float64)
    bound64 = torch.as_tensor(bound, dtype=torch.float64)

    def like64(p):
        out = like(p)
        near.copy_(torch.minimum(near, (out - bound64).abs()))
        return out

    out32 = slice_records_plain(like, cfg, kw, *(torch.as_tensor(a) for a in (
        x0, bound, valid, nh, w)))
    out64 = slice_records_plain(like64, cfg, kw, *(torch.as_tensor(a).to(
        torch.float64 if a.dtype == np.float32 else torch.bool) for a in (
        x0, bound, valid, nh, w)))
    assert out64[0].dtype == out64[1].dtype == torch.float64
    assert out32[0].dtype == torch.float32
    same = (out32[2] == out64[2])
    assert same.float().mean() >= 0.99
    # float32 rounding of logL ~ 1e-6 and of positions after R moves,
    # times the Gaussian's gradient: a margin of 1e-3 in logL
    far = near > 1e-3
    assert far.float().mean() > 0.5
    assert same[far].all()
    assert torch.allclose(out32[0][far].double(), out64[0][far], rtol=0, atol=1e-5)
    assert (out64[2][:8] == 0).all()


def test_float32_engines_refuse_float64():
    """At precision='highest' the forced cuda2, cuda3 and cuda5 raise naming
    engine='cuda' and 'torch'; 'cuda' skips a model's float32 functor and
    says why in route_reason; the float32 kernel wrappers refuse a float64
    calc."""
    calc = _f64_calc(identity_prior, gaussian(4), 4, 2)
    assert calc.device_spec is not None and calc.dtype == torch.float64
    for engine in ("cuda2", "cuda3", "cuda5"):
        with pytest.raises(ValueError, match="engine='cuda'.*'torch'"):
            ns.resolve_engine(engine, torch.device("cuda"), calc)
    assert ns.resolve_engine("cuda", torch.device("cuda"), calc) == "cuda"
    route, reason = slice_kernel.cuda_route(calc)
    assert route == "slice_epoch_fused"
    assert reason.startswith("float64") and "'gaussian'" in reason
    assert slice_kernel.route_reason("cuda", calc) == reason
    calc32 = make_batched_calculator(identity_prior, gaussian(4), 4, 2)
    assert slice_kernel.cuda_route(calc32) == ("slice_epoch", "device functor 'gaussian'")
    from polychordlite_tpu_torch.ops.pallas_slice_v4 import launch_slice_kernel

    z = torch.zeros(8, 4, dtype=torch.float64)
    cfg = EpochConfig(n_dims=4, n_phi=2, grade_dims=(4,), num_repeats=(1,))
    with pytest.raises(TypeError, match="float64"):
        launch_slice_kernel(None, "slice_epoch_launch", calc, cfg, (0, 0), z, z[:, 0],
                            z[:, 0] > 0, z[:, None], z[:, :1])


def test_unknown_precision_raises(tmp_path):
    with pytest.raises(ValueError, match="precision"):
        run_big(tmp_path, precision="double")
    assert fold_in(seed_key(1), 2).dtype == np.uint32  # the key words stay uint32
