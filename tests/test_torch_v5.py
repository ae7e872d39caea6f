"""The speculative-packet slice engine (``ops/pallas_slice_v5.py``) on the CPU.

Its plain version, ``slice_records_packet_plain``, is held to the JAX
package's v5 kernel in interpret mode through the same direction seam and
key words that ``tests/test_torch_kernels.py`` uses for v4, and bitwise to
the port's v4 plain engine on the edge cases of the JAX package's own
v5-against-v4 test (``tests/test_pallas_engine.py:191-198``) and on lanes
stopped by the epoch's budget.  The kernel's packet machine
(``csrc/packet_machine.cuh``), built by ``g++`` as host C++ and driven one
lane at a time with the Gaussian functor, is held bitwise to the same plain
version.  The CUDA kernel is compared with the same plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Deviation from the JAX v5 kernel, by design: the budget of an epoch is
v4's, counted in consumed probes (``EpochConfig.step_cap``), so a budget
may stop a lane inside a packet; JAX v5 counts macro-steps
(``pallas_slice_v5.py:115``).  The budget is never reached by these
configurations in the comparison with JAX, only in the capped-lane case
below, where v5 is held to v4's budget instead.
"""

import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychordlite_tpu.models.examples import gaussian as jax_gaussian
from polychordlite_tpu.models.examples import gaussian_shells as jax_shells
from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.pallas_slice_v5 import build_epoch_fn_pallas_v5
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu_torch.models import examples as pex
from polychordlite_tpu_torch.models.examples import gaussian, gaussian_shells
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops.directions import make_directions
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice_v4 import functor_args, slice_epoch, validate_functor
from polychordlite_tpu_torch.ops.pallas_slice_v5 import (
    slice_epoch_v5,
    slice_records_packet_plain,
)
from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, slice_records_plain
from polychordlite_tpu_torch.priors import BlockPrior, PriorBlock, UniformPrior, identity_prior
from polychordlite_tpu_torch.utils import nvcc

torch.set_num_threads(2)

D = 4
SIGMA = 0.2
NORM = -D * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))


def _jax_v5_records(monkeypatch, calc, cfg, key, seeds, bound, chol, valid):
    """Run the JAX v5 kernel in interpret mode and capture its raw
    (R, 3, S, 128) [t, logL, nlike] output."""
    from polychordlite_tpu.ops import pallas_slice_v5 as v5

    captured = {}
    real = v5.pl.pallas_call

    def capturing(*a, **k):
        f = real(*a, **k)

        def g(*args):
            out = f(*args)
            captured["out"] = out
            return out

        return g

    monkeypatch.setattr(v5.pl, "pallas_call", capturing)
    epoch = build_epoch_fn_pallas_v5(calc, cfg, interpret=True)
    epoch(key, jnp.asarray(seeds), jnp.asarray(bound), jnp.asarray(chol), jnp.asarray(valid))
    out = np.asarray(captured["out"])
    B = seeds.shape[0]
    R = cfg.total_repeats
    t = out[:, 0].reshape(R, B).T
    logL = out[:, 1].reshape(R, B).T
    nlike = out[:, 2].reshape(R, B).T.astype(np.int64)
    return t, logL, nlike


@pytest.mark.parametrize("R,seed", [(2, 0), (4, 1)])
def test_packet_plain_decision_exact_with_jax_v5(monkeypatch, R, seed):
    B = 1024
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    seeds = (0.5 + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    r0 = 1.5 * SIGMA * math.sqrt(D)
    bound = np.full((B,), NORM - 0.5 * (r0 / SIGMA) ** 2, np.float32)
    chol = np.broadcast_to(SIGMA * np.eye(D, dtype=np.float32), (B, D, D)).copy()
    valid = np.arange(B) >= 64
    jcfg = JaxEpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    jcalc = jax_calculator(lambda c: c, jax_gaussian(D, sigma=SIGMA), D, 2)
    t_j, l_j, n_j = _jax_v5_records(monkeypatch, jcalc, jcfg, key, seeds, bound, chol, valid)
    dir_keys, _ = _lane_keys(key, B, None)
    nh, w, _ = jax_make_directions(
        dir_keys, jnp.asarray(chol), grade_dims=(D,), num_repeats=(R,), n_dims=D,
        shared_perm_key=jax.random.fold_in(key, 0x5EED),
    )
    nh, w = (torch.as_tensor(np.array(a)) for a in (nh, w))
    calc = make_batched_calculator(identity_prior, gaussian(D, sigma=SIGMA), D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    kw = pps.key_words(np.asarray(key))
    args = (torch.as_tensor(seeds), torch.as_tensor(bound), torch.as_tensor(valid), nh, w)
    t, l, n = slice_records_packet_plain(lambda p: calc(p)[2], cfg, kw, *args)
    t, l, n = t.numpy(), l.numpy(), n.numpy().astype(np.int64)

    # decision-exact: identical nlike and t on every lane, logL to float
    # noise; a lane may only differ if its first divergent probe sat on the
    # contour (the two likelihoods sum chi2 in another order)
    lane_ok = (
        (n == n_j).all(1)
        & (np.abs(t - t_j) <= 1e-6).all(1)
        & (np.abs(l - l_j) <= 1e-5).all(1)
    )
    bad = np.nonzero(~lane_ok)[0]
    assert len(bad) < B / 1000, f"{len(bad)} lanes differ"
    for b in bad:
        r = int(np.nonzero((n[b] != n_j[b]) | (np.abs(t[b] - t_j[b]) > 1e-6))[0][0])
        assert abs(float(l_j[b, r]) - float(bound[b])) < 1e-5, (b, r)
    assert (n[:64] == 0).all() and (l[:64] == np.float32(cfg.logzero)).all()
    # the wrapper takes the plain version for CPU tensors
    for a, b in zip(slice_epoch_v5(calc, cfg, kw, *args), (t, l, n)):
        np.testing.assert_array_equal(a.numpy(), b)


class CappedConfig(EpochConfig):
    """An epoch budget small enough to stop lanes mid-repeat."""

    @property
    def step_cap(self) -> int:
        return 13


def _ball_inputs(B, R, chol_scale, bound_off, seed=2):
    gen = torch.Generator().manual_seed(seed)
    x0 = 0.5 + 0.05 * torch.randn((B, D), generator=gen)
    r0 = 1.5 * SIGMA * math.sqrt(D)
    bound = torch.full((B,), NORM - 0.5 * (r0 / SIGMA) ** 2 + bound_off)
    valid = torch.arange(B) >= 100
    nh, w, _ = make_directions((chol_scale * torch.eye(D)).expand(B, D, D), grade_dims=(D,),
                               num_repeats=(R,), n_dims=D, generator=gen)
    return x0, bound, valid, nh, w


@pytest.mark.parametrize(
    "max_step,max_shrink,chol_scale,bound_off,capped",
    [
        (100, 100, SIGMA, 0.0, False),   # typical contour
        (3, 100, 0.002, 0.0, False),     # step-out ladder capped
        (100, 2, 0.5, 5.0, False),       # forced (logzero) shrink accepts
        (1, 100, SIGMA, 0.0, False),     # max_step <= 1: INIT slots 2, 3 stop at once
        (100, 100, SIGMA, 0.0, True),    # the epoch's budget ends lanes mid-packet
    ],
)
def test_packet_plain_bitwise_equal_to_v4_plain(max_step, max_shrink, chol_scale, bound_off,
                                                capped):
    B, R = 1024, 5
    cls = CappedConfig if capped else EpochConfig
    cfg = cls(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,),
              max_step=max_step, max_shrink=max_shrink)
    calc = make_batched_calculator(identity_prior, gaussian(D, sigma=SIGMA), D, 2)
    args = _ball_inputs(B, R, chol_scale, bound_off)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (7, 9), *args)
    got = slice_records_packet_plain(lambda p: calc(p)[2], cfg, (7, 9), *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    t, logL, nlike = got
    if capped:  # every valid lane stopped by the budget, most inside a repeat
        assert (nlike[100:].sum(1) <= cfg.step_cap).all()
        assert (nlike[100:, -1] == 0).all()
        assert ((t == 0) & (nlike > 0))[100:].any(1).float().mean() > 0.5
    if bound_off:  # the forced accepts happened
        assert (logL[100:] == np.float32(cfg.logzero)).any()


def _shells_float64(theta, radius=2.0, sigma=0.1):
    """The shells' formula (``models/examples.py::gaussian_shells``) in
    float64 on float32 points: (logL, |dlogL/dr1| ulp(r1) + |dlogL/dr2|
    ulp(r2)), the change of logL that one float32 ulp of each radius makes."""
    th = theta.astype(np.float64)
    n_dims = th.shape[1]
    A = pex._shell_norm(n_dims, radius, sigma)
    rest = (th[:, 1:] ** 2).sum(1)
    r = [np.sqrt((th[:, 0] + c) ** 2 + rest) for c in (3.5, -3.5)]
    ls = [-A - (ri - radius) ** 2 / (2 * sigma ** 2) for ri in r]
    m = np.maximum(*ls)
    logL = m + np.log1p(np.exp(-np.abs(ls[0] - ls[1]))) - math.log(2.0)
    # d logL / d r_i = w_i (R - r_i) / sigma^2, w_i the shell's share of the sum
    per_ulp = sum(np.exp(li - logL - math.log(2.0)) * np.abs(ri - radius) / sigma ** 2
                  * np.spacing(ri.astype(np.float32)) for li, ri in zip(ls, r))
    return logL, per_ulp


def test_shells_likelihood_matches_jax():
    """The shells' float32 likelihood of both packages against a float64
    evaluation of the same formula.  The function is ill-conditioned where
    a point sits off a shell: dlogL/dr = (R - r) / sigma^2, so one float32
    ulp of r moves logL by up to ~1e-5, and float32 code that rounds r
    differently (XLA's CPU code differs by host) lands that far apart.
    Tolerance, per point: both are within 4 ulps of each radius times
    |dlogL/dr_i| plus 4 ulps of the result (1.7 of each at most, measured);
    the port's error is at most JAX's plus 2 ulps of each radius times
    |dlogL/dr_i| plus one ulp of the result (JAX's CPU code is the nearer
    to float64 on some points, by up to 1.2 of those radius ulps, the port
    on others); and where that conditioning term is below 1e-6 the two
    packages agree to rtol = atol = 1e-6."""
    rng = np.random.default_rng(3)
    for n_dims in (2, 5):
        theta = np.concatenate([
            rng.uniform(-6, 6, (2000, n_dims)),
            np.array([3.5, 0.0] + [0.0] * (n_dims - 2)) + rng.normal(0, 1.2, (2000, n_dims)),
        ]).astype(np.float32)
        want = np.asarray(jax_shells(n_dims)(jnp.asarray(theta.T)))
        got = gaussian_shells(n_dims)(torch.as_tensor(theta)).numpy()
        assert got.dtype == np.float32
        exact, per_ulp = _shells_float64(theta)
        ulp = np.spacing(np.abs(got))
        err, err_jax = np.abs(got - exact), np.abs(want.astype(np.float64) - exact)
        bound = 4 * per_ulp + 4 * ulp
        assert (err <= bound).all() and (err_jax <= bound).all()
        assert (err <= err_jax + 2 * per_ulp + ulp).all()
        tight = 4 * per_ulp < 1e-6
        assert tight.sum() >= 20
        np.testing.assert_allclose(got[tight], want[tight], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_dims,radius,sigma", [(2, 2.0, 0.1), (3, 1.5, 0.2), (6, 2.0, 0.05)])
def test_shells_constants_match_jax(n_dims, radius, sigma):
    """The shells' constants — peak normalisation A, radius, sigma and the
    centres at x_1 = -3.5, +3.5 — are the JAX package's for the same
    arguments, and the device form carries them as the functor takes them."""
    from polychordlite_tpu.models import examples as jex
    from polychordlite_tpu_torch.models import examples as pex

    A = jex._shell_norm(n_dims, radius, sigma)
    assert pex._shell_norm(n_dims, radius, sigma) == A
    form = gaussian_shells(n_dims, radius=radius, sigma=sigma).device_form
    assert form == {"name": "gaussian_shells", "centre": 3.5, "radius": radius,
                    "two_s2": 2.0 * sigma * sigma, "neg_a": -A, "log_two": math.log(2.0)}
    rng = np.random.default_rng(n_dims)
    theta = rng.uniform(-6, 6, (500, n_dims)).astype(np.float32)
    want = np.asarray(jax_shells(n_dims, radius, sigma)(jnp.asarray(theta.T)))
    got = gaussian_shells(n_dims, radius, sigma)(torch.as_tensor(theta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _shells_calc(n_dims=2):
    blocks = [PriorBlock("uniform", (0, 1), (0, 1), (-6.0, 6.0, -2.5, 2.5))]
    if n_dims > 2:
        blocks.append(PriorBlock("uniform", tuple(range(2, n_dims)), tuple(range(2, n_dims)),
                                 (-2.5, 2.5)))
    return make_batched_calculator(BlockPrior(blocks, n_dims), gaussian_shells(n_dims), n_dims, 0)


@pytest.mark.parametrize("engine", ["cuda", "cuda5"])
def test_validate_functor_runs_on_cpu(engine):
    records = slice_epoch_v5 if engine == "cuda5" else slice_epoch
    for calc, n_dims in (
        (make_batched_calculator(identity_prior, gaussian(D, sigma=SIGMA), D, 2), D),
        (make_batched_calculator(UniformPrior([0.0] * D, [1.0] * D), gaussian(D), D, 2), D),
        (_shells_calc(2), 2),
        (_shells_calc(3), 3),
    ):
        assert calc.device_spec is not None
        cfg = EpochConfig(n_dims=n_dims, n_phi=calc.n_phi, grade_dims=(n_dims,),
                          num_repeats=(3,))
        validate_functor(calc, cfg, torch.device("cpu"), records)  # raises on a mismatch


def test_shells_through_both_engines_on_cpu():
    """The shells functor's model through the v4 and the packet plain
    engines at the shape run() gives them (2-D, R = 10): bitwise equal."""
    calc = _shells_calc(2)
    B, R = 512, 10
    cfg = EpochConfig(n_dims=2, n_phi=1, grade_dims=(2,), num_repeats=(R,))
    rng = np.random.default_rng(5)
    ang = rng.uniform(0, 2 * np.pi, 500)
    side = np.where(rng.uniform(size=500) < 0.5, -3.5, 3.5)
    r = 2.0 + 0.1 * rng.standard_normal(500)
    live_th = np.stack([side + r * np.cos(ang), r * np.sin(ang)], 1)
    live = torch.as_tensor(((live_th - [-6.0, -2.5]) / [12.0, 5.0]).astype(np.float32))
    live_logL = calc(live)[2]
    pick = torch.as_tensor(rng.integers(0, 500, B))
    other = torch.as_tensor(rng.integers(0, 500, B))
    x0 = live[pick]
    bound = torch.minimum(live_logL[pick], live_logL[other])
    valid = torch.arange(B) < 504
    chol = torch.linalg.cholesky(torch.cov(live.T)).expand(B, 2, 2)
    nh, w, _ = make_directions(chol, grade_dims=(2,), num_repeats=(R,), n_dims=2,
                               generator=torch.Generator().manual_seed(0))
    args = (x0, bound, valid, nh, w)
    a = slice_epoch(calc, cfg, (3, 4), *args)
    b = slice_epoch_v5(calc, cfg, (3, 4), *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (a[1][:504] >= bound[:504, None]).all() and (a[2][:504] > 0).all()


# ------------------------------------------ the packet machine as host C++
# What the kernel sources need of CUDA on the host: the rounded intrinsics,
# float and double (csrc/rounded.cuh), as plain operations (built with
# -ffp-contract=off) and the runtime's names that likelihoods.cuh mentions.
_STUB_CUDA_RUNTIME = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __fadd_rn(a, b) ((a) + (b))
#define __fsub_rn(a, b) ((a) - (b))
#define __fmul_rn(a, b) ((a) * (b))
#define __fdiv_rn(a, b) ((a) / (b))
#define __dadd_rn(a, b) ((a) + (b))
#define __dsub_rn(a, b) ((a) - (b))
#define __dmul_rn(a, b) ((a) * (b))
#define __ddiv_rn(a, b) ((a) / (b))
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaMemcpyHostToDevice = 1 };
template <class... A> inline int cudaMemcpyToSymbolAsync(A...) { return 0; }
"""

_PACKET_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
#include "packet_machine.cuh"

template <class T>
static T* take(size_t n) {
    T* p = (T*)malloc(sizeof(T) * (n ? n : 1));
    if (fread(p, sizeof(T), n, stdin) != n) exit(1);
    return p;
}

// stdin: B, D, R, max_step, max_shrink (int32), k0, k1 (uint32), cap (int64),
// logzero, mu, sigma, norm, a[D], s[D], x0 (D, B), bound (B), valid (B),
// n-hat (R, D, B), w (R, B) as float32; stdout: t, logL (R, B) float32 and
// nlike (R, B) int32, from packet_chain_epoch one lane at a time.
int main() {
    const int* n = take<int>(5);
    const int B = n[0], D = n[1], R = n[2];
    const uint32_t* k = take<uint32_t>(2);
    const long long cap = *take<long long>(1);
    const float* c = take<float>(4);
    const float* pa = take<float>(D);
    const float* ps = take<float>(D);
    const float* x0t = take<float>((size_t)D * B);
    const float* bound = take<float>(B);
    const float* valid = take<float>(B);
    const float* nhat = take<float>((size_t)R * D * B);
    const float* w = take<float>((size_t)R * B);
    float* t = (float*)malloc(sizeof(float) * R * B);
    float* logL = (float*)malloc(sizeof(float) * R * B);
    int* nlike = (int*)malloc(sizeof(int) * R * B);
    const GaussianLike<SLICE_MAXD> like{affine_prior(pa, ps, D), c[1], c[2], c[3], c[0]};
    const EpochArgs a = epoch_args(x0t, bound, valid, nhat, w, t, logL, nlike, B, D, R, k[0],
                                   k[1], n[3], n[4], cap);
    for (int b = 0; b < B; ++b) packet_chain_epoch(like, a, b);
    fwrite(t, sizeof(float), (size_t)R * B, stdout);
    fwrite(logL, sizeof(float), (size_t)R * B, stdout);
    fwrite(nlike, sizeof(int), (size_t)R * B, stdout);
    return 0;
}
"""


@pytest.fixture(scope="module")
def packet_host(tmp_path_factory):
    """packet_machine.cuh with a one-lane main program, built by g++ (skips without it)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on the PATH")
    tmp = tmp_path_factory.mktemp("packet_host")
    (tmp / "cuda_runtime.h").write_text(_STUB_CUDA_RUNTIME)
    (tmp / "main.cpp").write_text(_PACKET_MAIN)
    exe = tmp / "packet"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", str(tmp), "-I",
                    str(nvcc.CSRC), str(tmp / "main.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    return exe


def _run_packet_host(exe, calc, cfg, key_words, x0, bound, valid, nhats, ws):
    B, R, Dn = nhats.shape
    _, consts, prior_a, prior_s = functor_args(calc, Dn)
    f32 = np.float32
    stdin = b"".join([
        np.array([B, Dn, R, cfg.max_step, cfg.max_shrink], np.int32).tobytes(),
        np.array(key_words, np.uint32).tobytes(), np.int64(cfg.step_cap).tobytes(),
        np.array([cfg.logzero, *consts], f32).tobytes(), prior_a.tobytes(), prior_s.tobytes(),
        x0.t().contiguous().numpy().astype(f32).tobytes(), bound.numpy().astype(f32).tobytes(),
        valid.numpy().astype(f32).tobytes(),
        nhats.permute(1, 2, 0).contiguous().numpy().astype(f32).tobytes(),
        ws.t().contiguous().numpy().astype(f32).tobytes(),
    ])
    out = subprocess.run([str(exe)], input=stdin, capture_output=True, check=True,
                         timeout=300).stdout
    n = R * B
    t = np.frombuffer(out[:4 * n], f32).reshape(R, B).T
    logL = np.frombuffer(out[4 * n:8 * n], f32).reshape(R, B).T
    nlike = np.frombuffer(out[8 * n:], np.int32).reshape(R, B).T
    return t, logL, nlike


@pytest.mark.parametrize("caps,capped", [({}, False), ({"max_step": 2, "max_shrink": 3}, False),
                                         ({}, True)])
def test_packet_machine_as_host_cpp_is_bitwise_the_plain_version(packet_host, caps, capped):
    """packet_plan, packet_resolve and the one-thread epoch of
    csrc/packet_machine.cuh, compiled as host C++ with the Gaussian functor
    of likelihoods.cuh: t, logL and nlike bitwise slice_records_packet_plain
    at the default caps, at max_step = 2 and max_shrink = 3 (forced
    accepts), and at a budget that ends lanes inside a packet."""
    B, R = 512, 5
    cls = CappedConfig if capped else EpochConfig
    cfg = cls(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,), **caps)
    calc = make_batched_calculator(UniformPrior([0.0] * D, [1.0] * D), gaussian(D, sigma=SIGMA),
                                   D, 2)
    args = _ball_inputs(B, R, SIGMA, 5.0 if caps else 0.0)
    want = [a.numpy() for a in slice_records_packet_plain(lambda p: calc(p)[2], cfg, (7, 9),
                                                          *args)]
    got = _run_packet_host(packet_host, calc, cfg, (7, 9), *args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    t, logL, nlike = got
    assert (nlike[:100] == 0).all() and (nlike[100:].sum(1) > 0).all()
    if capped:  # lanes stopped inside a repeat, some inside a packet
        assert ((t == 0) & (nlike > 0))[100:].any(1).mean() > 0.5
        assert (nlike[100:].sum(1) <= cfg.step_cap).all()
    if caps:  # the forced accepts happened
        assert (logL[100:] == np.float32(cfg.logzero)).any()
