"""The fused route on the CPU: a torch likelihood lowered into B1's kernel
(``ops/fused_like.py``, ``ops/pallas_slice_v4.py::slice_epoch_fused``).

The lowering's plain version is held against the model's own calc, the
fused route against the JAX v4 kernel in interpret mode (the same
directions and key words), and the emitted functor, compiled as host C++
where ``g++`` is on the PATH, against the plain version bit for bit.
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the CUDA kernel
``csrc/slice_epoch_fused.cu`` against the same plain version on the card.
"""

import json
import math
import shutil
import subprocess
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polychordlite_tpu_torch
from polychordlite_tpu import priors as jpr
from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu_torch import priors as ppr
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.ops import fused_like
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops import pallas_slice_v4 as v4
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.slice_kernel import (
    EpochConfig,
    epoch_route,
    kernel_wrapper,
    route_reason,
    slice_records_plain,
)
from polychordlite_tpu_torch.utils import nvcc
from test_torch_traced import (  # the quickstart and the JAX v4 capture, shared
    QUICK_D,
    _jax_v4_records,
    _quick_inputs,
    quickstart_jax,
    quickstart_torch,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6  # the model-form tolerance of ops/evaluate.py


def torch_gaussian(n_dims, mu=0.5, sigma=0.1):
    """gaussian.ini's likelihood as a user writes it in torch: batched, with
    its two derived parameters."""
    norm = -n_dims * (math.log(sigma) + 0.5 * math.log(2 * math.pi))
    log_vn = 0.5 * n_dims * math.log(math.pi) - math.lgamma(1 + 0.5 * n_dims)

    def loglikelihood(theta):
        r2 = ((theta - mu) ** 2).sum(-1)
        r = torch.sqrt(r2)
        return norm - 0.5 * r2 / sigma ** 2, torch.stack([r, n_dims * torch.log(r) + log_vn], -1)

    return loglikelihood


def gaussian_prior_like(n_dims=5, sigma=0.5):
    """A Gaussian likelihood N(0, sigma^2), for a GaussianPrior."""
    norm = -n_dims * (math.log(sigma) + 0.5 * math.log(2 * math.pi))
    return lambda theta: norm - 0.5 * ((theta / sigma) ** 2).sum(-1)


def correlated(n_dims=6, seed=0, mu=0.5):
    """A correlated Gaussian: its precision matrix a constant (D, D) tensor,
    inverted inside the likelihood (the lowering folds the inverse)."""
    a = np.random.default_rng(seed).normal(size=(n_dims, n_dims))
    cov = torch.tensor(0.01 * (a @ a.T / n_dims + np.eye(n_dims)), dtype=torch.float32)

    def loglikelihood(theta):
        d = theta - mu
        return -0.5 * (d @ torch.linalg.inv(cov) @ d)

    return loglikelihood


def masked(theta):
    """Arithmetic, comparisons, where, clamp, maximum and a mean: every
    operation rounds once, in host C++ as in torch."""
    d = torch.where(theta > 0.5, theta - 0.5, 0.5 - theta)
    return -(torch.clamp(d, 0.05, 0.4) ** 2).sum(-1) / 0.02 + torch.maximum(theta, 1 - theta).mean(-1)


def calls(theta):
    """Every library call of the op table, a logsumexp and a float power."""
    u = (theta - 0.5) * 4.0
    v = (torch.exp(-u * u) + torch.log1p(theta) - torch.log(theta + 0.1) + torch.expm1(-theta)
         + torch.sin(u) * torch.cos(u) + torch.tanh(u) + torch.sqrt(theta)
         + torch.rsqrt(theta + 1.0) + (theta + 0.5) ** 1.5
         + torch.special.ndtri(theta.clamp(0.01, 0.99)) + torch.abs(u) - 1 / (theta + 2.0))
    return torch.logsumexp(-v * v, -1) - (u * u).sum(-1)


def shapes(theta):
    """Per point: Rosenbrock's neighbours through slices, a stack, a cat, a
    transpose, an expand, an amax and the matrix products."""
    a = theta[..., 1:] - theta[..., :-1] ** 2
    b = torch.stack([theta[..., 0], theta[..., -1]], -1)
    c = torch.cat([a, b], -1)
    m = torch.arange(1.0, 1.0 + theta.shape[-1] ** 2).reshape(theta.shape[-1], -1) / 10.0
    q = (theta @ m.T) * theta
    w = theta.unsqueeze(-1).expand(*theta.shape, 2).sum(-1)
    return -(c * c).sum(-1) - q.sum(-1) / 50.0 + w.amax(-1) + theta @ m @ theta / 100.0


MODELS = {  # prior, likelihood, D, nDerived, the form
    "gaussian_ini": (ppr.identity_prior, torch_gaussian(20), 20, 2, "batched"),
    "quickstart": (ppr.UniformPrior(-1, 1), quickstart_torch, QUICK_D, 1, "per_point"),
    "gaussian_prior": (ppr.GaussianPrior(1.0, 1.0), gaussian_prior_like(), 5, 0, "batched"),
    "correlated": (ppr.UniformPrior(0, 1), correlated(), 6, 0, "per_point"),
    "masked": (ppr.identity_prior, masked, 3, 0, "batched"),
    "log_uniform": (ppr.LogUniformPrior([0.1, 1.0, 2.0], 10.0),
                    lambda th: -0.5 * (((th - 2.0) / 0.5) ** 2).sum(-1), 3, 0, "batched"),
    "calls": (ppr.identity_prior, calls, 6, 0, "batched"),
    "shapes": (ppr.identity_prior, shapes, 5, 0, "per_point"),
}


def _calc(name):
    prior, like, D, nd, _ = MODELS[name]
    return make_batched_calculator(prior, like, D, nd)


def _cubes(D, n=512, seed=11):
    """Seeded cubes, some outside [0, 1]^D and some on its walls."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.05, 1.05, (n, D))
    c[: n // 8] = c[: n // 8].clip(0.0, 1.0)
    return torch.as_tensor(c, dtype=torch.float32)


# ------------------------------------------------------------- lowering
@pytest.mark.parametrize("name", list(MODELS))
def test_lowering_agrees_with_the_calc(name):
    """Each model lowers, and its plain version gives the calc's logL within
    rtol 1e-5 / atol 1e-6 on seeded cubes (outside ones at logzero)."""
    calc = _calc(name)
    assert calc.form == MODELS[name][4]
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), getattr(low, "reason", None)
    assert low.prior_lowered == (name in ("gaussian_prior", "log_uniform"))
    cube = _cubes(calc.n_dims)
    got, want = low.plain_logL(cube), calc(cube)[2]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert (got[~((cube >= 0) & (cube <= 1)).all(1)] == calc.logzero).all()
    assert epoch_route("cuda", calc) == "slice_epoch_fused"
    assert route_reason("cuda", calc).startswith("lowered")


def test_gaussian_prior_quantile_against_float64():
    """The lowered erfinv and ndtri (Giles's polynomial, Acklam's tails) hold
    float64 to 5e-7 relative over float32's range, infinite at the ends."""
    from scipy.special import erfinv, ndtri

    p = np.concatenate([np.geomspace(1e-37, 0.5, 2000),
                        1 - np.geomspace(6e-8, 0.5, 2000)]).astype(np.float32)
    for got, want in ((fused_like._ndtri(torch.as_tensor(p)), ndtri(p.astype(np.float64))),
                      (fused_like._erfinv(torch.as_tensor(2 * p - 1)),
                       erfinv((2 * p - 1).astype(np.float64)))):
        got = got.double().numpy()
        ok = np.isfinite(want) & (want != 0)
        assert (np.abs(got[ok] - want[ok]) <= 5e-7 * np.abs(want[ok])).all()
    ends = torch.tensor([0.0, 1.0])
    assert fused_like._ndtri(ends).tolist() == [-math.inf, math.inf]
    assert fused_like._erfinv(2 * ends - 1).tolist() == [-math.inf, math.inf]


def _branch(theta):
    """A data-dependent branch: the same values batched and per point."""
    scale = 2.0 if bool((theta > 2.0).any()) else 1.0
    return -scale * (theta ** 2).sum(-1)


REFUSALS = {  # likelihood, D, the reason's words
    "data_dependent_branch": (_branch, 3, "data-dependent"),
    "op_outside_the_table": (lambda th: torch.lgamma(th + 1.0).sum(-1), 3, "aten.lgamma"),
    # past the stream bucket's bound (float32, one term): refused before the trace
    "d19371": (lambda th: -(th ** 2).sum(-1), 19371, "D = 19371"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_lowering_refuses_with_its_reason(case):
    like, D, words = REFUSALS[case]
    calc = make_batched_calculator(ppr.identity_prior, like, D, 0)
    assert calc.form == "batched"
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Refused) and words in low.reason, low
    assert epoch_route("cuda", calc) == "slice_step"
    assert words in route_reason("cuda", calc)
    x0 = torch.full((2, D), 0.5)
    with pytest.raises(ValueError, match="fused route cannot run"):
        v4.slice_epoch_fused(calc, None, (0, 0), x0, torch.zeros(2), torch.ones(2, dtype=bool),
                             torch.zeros((2, 1, D)), torch.zeros((2, 1)))


def test_emitted_source_is_deterministic_and_its_hash_ignores_constants():
    """The same model twice gives the same source; another prior and
    likelihood constant with the same graph the same hash (one library);
    another graph, or another G, another hash."""
    def lowered(mu, sigma, s_like, power=2):
        norm = -5 * math.log(s_like)
        like = (lambda th: norm - 0.5 * ((th / s_like) ** power).sum(-1))
        return fused_like.lower(make_batched_calculator(ppr.GaussianPrior(mu, sigma), like, 5, 0))

    a, b = lowered(1.0, 1.0, 0.5), lowered(1.0, 1.0, 0.5)
    assert a.source(4) == b.source(4) and a.key(4) == b.key(4)
    other = lowered(-2.0, 0.3, 0.9)
    assert other.key(4) == a.key(4) and not np.array_equal(other.consts, a.consts)
    assert lowered(1.0, 1.0, 0.5, power=4).key(4) != a.key(4)
    assert a.key(8) != a.key(4)
    assert "__ldg(c + " in a.emit_functor()  # the constants come through the buffer
    assert nvcc.library_path("f", [fused_like.SOURCE], a.source(4)) != nvcc.library_path(
        "f", [fused_like.SOURCE], a.source(8))


# ------------------------------------------------------ the route on the CPU
def test_fused_route_decision_exact_with_jax_v4(monkeypatch):
    """The JAX v4 kernel runs the per-point jnp quickstart inside its body;
    the port's fused route (its plain version on the CPU) on the per-point
    torch quickstart, fed the same directions and key words, makes the same
    decisions: nlike identical on every lane, the accepted t within 1e-6
    (the bound of tests/test_torch_kernels.py: XLA rounds the chord's
    arithmetic in its own order, so about half the t differ in the last
    bit, 4.5e-8 at most here), logL within 1e-5 |logL| + 1e-6."""
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
    calc = _calc("quickstart")
    cfg = EpochConfig(n_dims=QUICK_D, n_phi=1, grade_dims=(QUICK_D,), num_repeats=(R,))
    t, l, n = (a.numpy() for a in v4.slice_epoch_fused(
        calc, cfg, pps.key_words(np.asarray(key)), torch.as_tensor(seeds),
        torch.as_tensor(bound), torch.as_tensor(valid), torch.as_tensor(np.array(nh)),
        torch.as_tensor(np.array(w))))
    assert np.array_equal(n.astype(np.int64), n_j)
    assert (np.abs(t - t_j) <= 1e-6).all()
    assert (np.abs(l - l_j) <= 1e-5 * np.abs(l_j) + 1e-6).all()
    assert n[64:].sum() > 0 and (n[:64] == 0).all()


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors the "cuda" engine's wrapper takes the fused route and
    runs slice_records_plain on the lowering's plain version; no launch."""
    calc = _calc("quickstart")
    seeds, bound, chol, valid = _quick_inputs(256, 3, seed=2)
    from polychordlite_tpu_torch.ops.directions import make_directions

    nh, w, _ = make_directions(torch.as_tensor(chol), grade_dims=(QUICK_D,), num_repeats=(3,),
                               n_dims=QUICK_D, generator=torch.Generator().manual_seed(0))
    cfg = EpochConfig(n_dims=QUICK_D, n_phi=1, grade_dims=(QUICK_D,), num_repeats=(3,))
    args = (torch.as_tensor(seeds), torch.as_tensor(bound), torch.as_tensor(valid), nh, w)
    before = v4.LAUNCHES["slice_epoch_fused"]
    want = slice_records_plain(fused_like.lowering(calc).plain_logL, cfg, (1, 2), *args)
    for a, b in zip(kernel_wrapper("cuda")(calc, cfg, (1, 2), *args), want):
        assert torch.equal(a, b)
    assert v4.LAUNCHES["slice_epoch_fused"] == before
    assert (want[2][64:].sum(1) > 0).all()


def test_quickstart_run_through_the_fused_route(monkeypatch, tmp_path):
    """run() with the CUDA engine's choice forced on the CPU: the fused
    route's plain version; the metrics name the route and its reason, the
    chained epochs' replay check holds, logZ within 3 sigma of -4 log 2."""
    monkeypatch.setattr(ns, "resolve_engine", lambda engine, device, calc: "cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = polychordlite_tpu_torch.run(
            quickstart_torch, QUICK_D, prior=ppr.UniformPrior(-1, 1), device="cpu",
            base_dir=str(tmp_path), nDerived=1, nlive=100, num_repeats=8,
            do_clustering=False, read_resume=False, seed=21, feedback=-1)
    with open(tmp_path / "test.metrics.jsonl") as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["route"] == "slice_epoch_fused" and last["route_reason"].startswith("lowered")
    assert last["form"] == "per_point" and last["chained_epochs"] is True
    assert last["fused_build_seconds"] == {}  # nothing built on the CPU
    assert abs(out.logZ + QUICK_D * math.log(2.0)) < 3 * out.logZerr


# ------------------------------------------------- the functor as host C++
_HOST_MAIN = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __fadd_rn(a, b) ((a) + (b))
#define __fsub_rn(a, b) ((a) - (b))
#define __fmul_rn(a, b) ((a) * (b))
#define __fdiv_rn(a, b) ((a) / (b))
#define __ldg(p) (*(p))
template <int M> struct AffinePriorT { float a[M]; float s[M]; };
#include "fused_ops.cuh"
#include "fused_like.cuh"

// stdin: B, then logzero, the constants, a, s and the B x D cubes as float32;
// stdout: the B logL as float32, as likelihoods.cuh's like_eval gives them.
int main() {
    int B;
    if (fread(&B, sizeof B, 1, stdin) != 1) return 1;
    static float c[FUSED_NC + 1];
    FusedLike like;
    if (fread(&like.logzero, sizeof(float), 1, stdin) != 1) return 1;
    if (fread(c, sizeof(float), FUSED_NC, stdin) != FUSED_NC) return 1;
    if (fread(like.prior.a, sizeof(float), FUSED_D, stdin) != FUSED_D) return 1;
    if (fread(like.prior.s, sizeof(float), FUSED_D, stdin) != FUSED_D) return 1;
    like.c = c;
    float* p = (float*)malloc(sizeof(float) * FUSED_D * B);
    if (fread(p, sizeof(float), (size_t)FUSED_D * B, stdin) != (size_t)FUSED_D * B) return 1;
    for (int b = 0; b < B; ++b) {
        bool inside = true;
        float T[FusedLike::NT][FusedLike::MAXD];
        for (int d = 0; d < FUSED_D; ++d) {
            const float x = p[b * FUSED_D + d];
            inside = inside && x >= 0.0f && x <= 1.0f;
            float o[FusedLike::NT];
            like.term(__fadd_rn(__fmul_rn(x, like.prior.s[d]), like.prior.a[d]), d, o);
            for (int j = 0; j < FusedLike::NT; ++j) T[j][d] = o[j];
        }
        float l = like.combine(T, FUSED_D);
        if (l != l) l = like.logzero;
        if (!inside) l = like.logzero;
        fwrite(&l, sizeof l, 1, stdout);
    }
    return 0;
}
"""


@pytest.mark.parametrize("name", ["quickstart", "gaussian_ini", "correlated", "masked", "shapes"])
def test_emitted_functor_is_bitwise_its_plain_version_as_host_cpp(name, tmp_path):
    """The emitted term and combine, compiled by g++ with -ffp-contract=off
    and the intrinsics mapped to plain float operations: for a model of
    arithmetic, comparisons and selections only, every logL is the plain
    version's bit for bit."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on the PATH")
    calc = _calc(name)
    low = fused_like.lower(calc)
    assert not {op for op, _ in low.term + low.combine} - {
        "add", "sub", "mul", "div", "max", "min", "lt", "le", "gt", "ge", "eq", "ne", "where",
        "neg", "abs", "f32"}
    (tmp_path / "fused_like.cuh").write_text(low.source(1))
    (tmp_path / "main.cpp").write_text(_HOST_MAIN)
    exe = tmp_path / "fused"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", str(tmp_path),
                    "-I", str(nvcc.CSRC), str(tmp_path / "main.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    cube = _cubes(calc.n_dims, n=1024, seed=5)
    stdin = (np.int32(cube.shape[0]).tobytes() + np.float32(low.logzero).tobytes()
             + low.consts.tobytes()
             + low.prior[0].tobytes() + low.prior[1].tobytes() + cube.numpy().tobytes())
    res = subprocess.run([str(exe)], input=stdin, capture_output=True, check=True, timeout=300)
    got = np.frombuffer(res.stdout, np.float32)
    want = low.plain_logL(cube).numpy()
    assert got.shape == want.shape and np.array_equal(got.view(np.uint32), want.view(np.uint32))
