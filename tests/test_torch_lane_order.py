"""The lane order of the reductions above D = 32, on the CPU.

Above D = 32 a chain of the kernel template holds the 32 lanes of a warp,
and every reduction over coordinates (sums, the shells' sum over d >= 1,
pyramidal's max, eggbox's product; the fused route's ``sum``, ``mean``,
``amax`` and ``logsumexp``) is taken in two stages: lane g folds the
coordinates g, g + 32, g + 64, ... in index order, then a butterfly at
offsets 16, 8, 4, 2, 1 (``csrc/likelihoods.cuh::fold`` on a lane view).  Here a numpy
reimplementation of that order is held bitwise to the zoo's torch forms and
to the fused route's plain version, the index order below 33 is held
unchanged, and the kernels' combines themselves, built by ``g++`` as host
C++ with the warp's shuffles run by 32 threads, are held bitwise to the
torch forms and the plain version (skips without ``g++``).  The kernels on
the card are held to the same plain versions by ``tests/test_torch_cuda.py``.
"""

import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from polychordlite_tpu_torch.experiments import b1_bucket_parts
from polychordlite_tpu_torch.models import examples as ex
from polychordlite_tpu_torch.ops import fused_like
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice_v4 import functor_args
from polychordlite_tpu_torch.ops.precision import real_dtype_scope
from polychordlite_tpu_torch.priors import identity_prior
from polychordlite_tpu_torch.utils import nvcc

torch.set_num_threads(2)

WIDE_AND_STREAM = [33, 40, 64, 65, 128, 129, 160]
F32 = np.float32


# ----------------------------------------------------- the order in numpy
def np_fold(items, op, D):
    """``op`` over the columns of ``items (B, n)`` in the kernels' order for
    a model of D dimensions: index order up to 32, else per-lane partials in
    index order and the xor butterfly, lane 0's value."""
    if D <= 32:
        acc = items[:, 0]
        for k in range(1, items.shape[1]):
            acc = op(acc, items[:, k])
        return acc
    lanes = []
    for g in range(32):
        acc = items[:, g]
        for k in range(g + 32, items.shape[1], 32):
            acc = op(acc, items[:, k])
        lanes.append(acc)
    v = np.stack(lanes, axis=1)
    for m in (16, 8, 4, 2, 1):
        v = op(v, v[:, np.arange(32) ^ m])
    return v[:, 0]


def _torch(fn, x):
    """A torch library call on one numpy column (the forms call it per column)."""
    return fn(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _mix(l1, l2):
    m = np.maximum(l1, l2)
    e = _torch(torch.exp, -np.abs(l1 - l2))
    return (m + _torch(torch.log1p, e)) - F32(math.log(2.0))


def _cols(theta, f):
    return np.stack([f(theta[:, k], k) for k in range(theta.shape[1])], axis=1)


def np_likelihood(name, D, theta):
    """The zoo likelihood ``name`` at D in numpy float32, its reductions in
    the kernels' order, its library calls torch's (elementwise, per column,
    as the torch form makes them)."""
    form = ex.get_likelihood(name, D).device_form
    if name in ("gaussian", "half_gaussian"):
        sigma = F32(form["sigma"])
        mus = [F32(0.0 if (name == "half_gaussian" and k == 0) else form["mu"])
               for k in range(D)]
        z = _cols(theta, lambda t, k: (t - mus[k]) / sigma)
        return F32(form["norm"]) - F32(0.5) * np_fold(z * z, np.add, D)
    if name == "gaussian_shells":
        items = _cols(theta, lambda t, k: np.zeros_like(t) if k == 0 else t * t)
        rest = np_fold(items, np.add, D)
        c1, c2 = theta[:, 0] + F32(form["centre"]), theta[:, 0] - F32(form["centre"])
        out = []
        for c in (c1, c2):
            r = _torch(torch.sqrt, c * c + rest)
            d = r - F32(form["radius"])
            out.append(F32(form["neg_a"]) - (d * d) / F32(form["two_s2"]))
        return _mix(*out)
    if name == "pyramidal":
        m = np_fold(_cols(theta, lambda t, k: np.abs(t - F32(form["mu"])) / F32(form["sigma"])),
                    np.maximum, D)
        return F32(form["norm"]) - (m * m) / F32(form["factor"])
    if name == "rastrigin":
        items = _cols(theta, lambda t, k: (t * t + F32(form["log_norm"]))
                      - _torch(torch.cos, t * F32(form["two_pi"])) * F32(form["A"]))
        return -np_fold(items, np.add, D)
    if name == "twin_gaussian":
        ls = []
        for sign in (-1.0, 1.0):
            z = _cols(theta, lambda t, k: (t - F32(sign * 0.5 if k < 2 else 0.0))
                      / F32(form["sigma"]))
            ls.append(F32(form["norm"]) - F32(0.5) * np_fold(z * z, np.add, D))
        return _mix(*ls)
    if name == "rosenbrock":
        a, b = F32(form["a"]), F32(form["b"])
        items = np.stack([(a - theta[:, k]) * (a - theta[:, k])
                          + ((theta[:, k + 1] - theta[:, k] * theta[:, k])
                             * (theta[:, k + 1] - theta[:, k] * theta[:, k])) * b
                          for k in range(D - 1)], axis=1)
        return F32(form["norm"]) - np_fold(items, np.add, D)
    if name == "eggbox":
        p = np_fold(_cols(theta, lambda t, k: _torch(torch.cos, t / F32(2.0))), np.multiply, D)
        q = p + F32(2.0)
        q2 = q * q
        return -(q * (q2 * q2))
    if name == "gaussian_shell":
        r = _torch(torch.sqrt, np_fold(theta * theta, np.add, D))
        d = r - F32(form["radius"])
        return F32(form["neg_a"]) - (d * d) / F32(form["two_s2"])
    raise KeyError(name)


LANE_FORMS = ("gaussian", "gaussian_shells", "half_gaussian", "pyramidal", "rastrigin",
              "twin_gaussian", "rosenbrock", "eggbox", "gaussian_shell")


def _theta(name, D, n=96, seed=0):
    rng = np.random.default_rng(seed + D)
    lo, hi = {"rastrigin": (-5.12, 5.12), "eggbox": (0.0, 10 * math.pi),
              "gaussian_shells": (-6.0, 6.0), "gaussian_shell": (-6.0, 6.0),
              "rosenbrock": (-5.0, 5.0)}.get(name, (0.0, 1.0))
    return rng.uniform(lo, hi, (n, D)).astype(F32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("D", WIDE_AND_STREAM)
@pytest.mark.parametrize("name", LANE_FORMS)
def test_torch_forms_sum_in_the_lane_order(name, D):
    """Each zoo form whose functor folds over coordinates, above D = 32,
    bitwise the numpy reimplementation of the lane order (rosenbrock's norm
    overflows to nan past D ~ 106: its sum is then checked without it)."""
    theta = _theta(name, D)
    got = ex.get_likelihood(name, D)(torch.from_numpy(theta))
    got = (got[0] if isinstance(got, tuple) else got).numpy()
    want = np_likelihood(name, D, theta)
    if name == "rosenbrock" and not np.isfinite(ex.rosenbrock(D).device_form["norm"]):
        got, want = np.isnan(got), np.isnan(want)
        assert got.all()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name,D", [(name, D) for name in LANE_FORMS for D in (1, 2, 20, 32)
                                    if (name, D) != ("rosenbrock", 1)])  # no summand at 1
def test_torch_forms_keep_the_index_order_up_to_32(name, D):
    """At D <= 32 the forms still sum in index order from the first term."""
    theta = _theta(name, D)
    got = ex.get_likelihood(name, D)(torch.from_numpy(theta))
    got = (got[0] if isinstance(got, tuple) else got).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np_likelihood(name, D, theta)))


@pytest.mark.parametrize("D", [33, 64, 100, 160])
def test_the_lane_order_is_not_the_index_order(D):
    """The two orders do differ above 32 (so the tests above can tell them
    apart): on many points some chi-square sums differ in their last bits."""
    theta = _theta("gaussian", D, n=512)
    z = (theta - F32(0.5)) / F32(0.1)
    assert (_bits(np_fold(z * z, np.add, D)) != _bits(np_fold(z * z, np.add, 1))).any()


def test_coordinate_fold_is_the_numpy_order():
    rng = np.random.default_rng(7)
    for D in [1, 5, 32] + WIDE_AND_STREAM + [255, 256, 257, 512]:
        for op, npop in ((torch.add, np.add), (torch.maximum, np.maximum),
                         (torch.mul, np.multiply)):
            x = rng.uniform(0.5, 1.5, (16, D)).astype(F32)
            got = ex.coordinate_fold(torch.from_numpy(x), op, D).numpy()
            np.testing.assert_array_equal(_bits(got), _bits(np_fold(x, npop, D)))


# ------------------------------------------------ the fused route's order
def per_point_gaussian(theta):
    D = theta.shape[-1]
    return (-0.5 * torch.sum(((theta - 0.5) / 0.1) ** 2)
            - D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)))


def amax_model(theta):
    return -torch.amax(torch.abs(theta - 0.5), -1) * 40.0


def lse_model(theta):
    return torch.logsumexp(-((theta - 0.5) / 0.1) ** 2, -1)


def _np_fused(model, x, D):
    """The three models' logL in numpy in the lowering's dtype (its steps
    as the lowering writes them), reductions in the kernels' order."""
    t = x.dtype.type
    if model is per_point_gaussian:
        z = (x - t(0.5)) / t(0.1)
        s = np_fold(z * z, np.add, D)
        # the lowering folds -0.5 * s and the norm as two rounded steps
        return s * t(-0.5) - t(D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)))
    if model is amax_model:
        return -np_fold(np.abs(x - t(0.5)), np.maximum, D) * t(40.0)
    z = (x - t(0.5)) / t(0.1)
    v = -(z * z)
    m = np_fold(v, np.maximum, D)
    m = np.where(np.abs(m) == np.inf, t(0.0), m)
    e = np.stack([_torch(torch.exp, v[:, k] - m) for k in range(D)], axis=1)
    return _torch(torch.log, np_fold(e, np.add, D)) + m


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [40, 160])
@pytest.mark.parametrize("model", [per_point_gaussian, amax_model, lse_model])
def test_fused_plain_version_folds_in_the_lane_order(model, D, dtype):
    """A per-point torch.sum Gaussian, an amax model and a logsumexp model,
    lowered at D = 40 and 160: one lane reduction a coordinate reduction,
    and the plain version bitwise the numpy lane order (where the lowering
    keeps the model's own steps: the mean's division, logsumexp's shift)."""
    with real_dtype_scope(dtype):
        calc = make_batched_calculator(identity_prior, model, D, 0)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low
    lane_ops = [op for op, _ in low.combine if op in fused_like.LANE_OPS]
    assert lane_ops == {per_point_gaussian: ["lane_add"], amax_model: ["lane_max"],
                        lse_model: ["lane_max", "lane_add"]}[model]
    assert len(low.combine) < 12
    rng = np.random.default_rng(D)
    x = rng.uniform(0.0, 1.0, (64, D)).astype(np.float32 if dtype == torch.float32
                                             else np.float64)
    got = low.plain_logL(torch.from_numpy(x)).numpy()
    want = _np_fused(model, x, D)
    if model is per_point_gaussian:  # the lowering's own steps: compare to the calc too
        np.testing.assert_allclose(got, calc(torch.from_numpy(x))[2].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(_bits(got), _bits(want.astype(x.dtype)))


@pytest.mark.parametrize("D", [1, 20, 32])
def test_fused_source_below_33_is_the_index_order_chain(D):
    """Up to D = 32 the emitted functor is what it was: the combine a chain
    of D - 1 adds in index order, no lane reduction, no shuffle; its hash
    (the library's name) pinned to the tree before the lane order."""
    low = fused_like.lowering(make_batched_calculator(identity_prior, per_point_gaussian, D, 0))
    src = low.source(8)
    assert "fold(" not in src and "STAGED" not in src and "shfl" not in src
    assert not low.lane and all(op not in fused_like.LANE_OPS for op, _ in low.combine)
    assert sum(op == "add" for op, _ in low.combine) == D - 1
    pinned = {1: ("5ea5a85f59d5d9e3", "dea7b1617de172f2"),
              20: ("05a774e757651b54", "123f8ab30da2b7f5"),
              32: ("5528966a0ed5a2bc", "dc46762ef6397147")}[D]
    assert (low.key(1), low.key(32)) == pinned


def test_fused_stream_source_does_not_grow_with_d():
    """In the stream bucket a sum model's functor is the same text at every
    D but the D of its define: one lane reduction, not a statement a
    coordinate."""
    srcs = {D: fused_like.lowering(make_batched_calculator(
        identity_prior, per_point_gaussian, D, 0)).source(32) for D in (160, 512, 2000)}
    lines = {D: [ln for ln in s.splitlines() if not ln.startswith("#define FUSED_D ")]
             for D, s in srcs.items()}
    assert lines[160] == lines[512] == lines[2000]
    assert len(srcs[160].splitlines()) < 60 and srcs[160].count("fold(") == 1
    assert "STAGED = false" in srcs[160]


def test_fused_reads_of_one_coordinate_stage_the_terms():
    """A combine that also reads one coordinate's term (theta[0]) beside a
    lane reduction asks for the staged row (STAGED); a plain sum does not."""
    def mixed(theta):
        return -torch.sum((theta - 0.5) ** 2) + theta[0]

    low = fused_like.lowering(make_batched_calculator(identity_prior, mixed, 40, 0))
    assert "STAGED = true" in low.source(32)
    assert any(r[0] == "t" for _, args in low.combine for r in args)


# -------------------------------- the kernels' combines as host C++ (g++)
_STUB = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#include <string.h>
#include <barrier>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __restrict__
#define __fadd_rn(a, b) ((a) + (b))
#define __fsub_rn(a, b) ((a) - (b))
#define __fmul_rn(a, b) ((a) * (b))
#define __fdiv_rn(a, b) ((a) / (b))
#define __dadd_rn(a, b) ((a) + (b))
#define __dsub_rn(a, b) ((a) - (b))
#define __dmul_rn(a, b) ((a) * (b))
#define __ddiv_rn(a, b) ((a) / (b))
#define __ldg(p) (*(p))
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };

// A warp of 32 host threads: lane_id is the thread's lane, and a shuffle
// posts the lane's value, waits for the warp, reads the source lane's and
// waits again.
static thread_local int lane_id;
static std::barrier<>* warp_barrier;
static unsigned char warp_values[32][8];
template <class T>
static T warp_read(T v, int src) {
    memcpy(warp_values[lane_id], &v, sizeof v);
    warp_barrier->arrive_and_wait();
    T out;
    memcpy(&out, warp_values[src], sizeof out);
    warp_barrier->arrive_and_wait();
    return out;
}
template <class T>
static T __shfl_sync(unsigned, T v, int src, int width = 32) {
    return warp_read(v, (lane_id & ~(width - 1)) + (src & (width - 1)));
}
template <class T>
static T __shfl_xor_sync(unsigned, T v, int m, int width = 32) {
    return warp_read(v, lane_id ^ m);
}
"""

_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
#include <thread>
#include <vector>
#include "likelihoods.cuh"
#ifdef FUSED
#include "fused_ops.cuh"
#include "fused_like.cuh"
#endif

template <class T>
static std::vector<T> take(size_t n) {
    std::vector<T> v(n ? n : 1);
    if (n && fread(v.data(), sizeof(T), n, stdin) != n) exit(1);
    return v;
}

// The logL of B cubes as the kernel's G = 32 like_eval makes it above D = 32:
// lane g makes the terms of its coordinates (into its registers, LaneRegs, and
// the rows, LaneRows), then every lane runs combine on the bucket's view (a
// STAGED functor reads the rows, complete after the barrier); lane 0's result.
template <class Like>
static void run(const Like& like, int B, int D, const std::vector<real_of<Like>>& cube) {
    using Real = real_of<Like>;
    constexpr int NT = Like::NT, MAXD = Like::MAXD;
    constexpr int K = MAXD == SLICE_MAXD_STREAM ? 1 : MAXD / 32;
    std::vector<Real> rows((size_t)NT * D), out(B);
    std::vector<char> inside(32);
    std::barrier<> bar(32);
    warp_barrier = &bar;
    auto lane = [&](int g) {
        lane_id = g;
        for (int b = 0; b < B; ++b) {
            bool in = true;
            Real own[NT][K] = {};
            for (int d = g; d < D; d += 32) {
                const Real x = cube[(size_t)b * D + d];
                in = in && x >= Real(0) && x <= Real(1);
                Real o[NT] = {};
                like.term(rn_add(rn_mul(x, like.prior.s[d]), like.prior.a[d]), d, o);
                for (int j = 0; j < NT; ++j) {
                    rows[(size_t)j * D + d] = o[j];
                    if (MAXD != SLICE_MAXD_STREAM) own[j][d / 32] = o[j];
                }
            }
            inside[g] = in;
            bar.arrive_and_wait();
            Real l;
            if constexpr (MAXD == SLICE_MAXD_STREAM)
                l = like.combine(LaneRows<Real, NT>{rows.data(), g, D}, D);
            else
                l = like.combine(LaneRegs<Real, NT, K>{own, g, D, rows.data(), D}, D);
            bool all = true;
            for (int i = 0; i < 32; ++i) all = all && inside[i];
            if (g == 0) out[b] = like_result(l, all, like.logzero);
            bar.arrive_and_wait();  // every lane is done with the rows
        }
    };
    std::vector<std::thread> lanes;
    for (int g = 0; g < 32; ++g) lanes.emplace_back(lane, g);
    for (auto& t : lanes) t.join();
    fwrite(out.data(), sizeof(Real), B, stdout);
}

// stdin: B, D, id (int32), logzero, the constants (NC), a (D), s (D), the
// cubes (B x D), in the functor's type; stdout: the B logL.
int main() {
    const std::vector<int> n = take<int>(3);
    const int B = n[0], D = n[1];
#ifdef FUSED
    using Real = real_of<FusedLike>;
#else
    using Real = float;
#endif
    const Real logzero = take<Real>(1)[0];
    const std::vector<Real> c = take<Real>(NC), pa = take<Real>(D), ps = take<Real>(D);
    std::vector<Real> dev(pa);
    dev.insert(dev.end(), ps.begin(), ps.end());
    const std::vector<Real> cube = take<Real>((size_t)B * D);
#ifdef FUSED
    run(FusedLike{make_prior<FusedLike::MAXD, Real>(pa.data(), ps.data(), dev.data(), D),
                  c.data(), logzero}, B, D, cube);
    return 0;
#else
    return with_likelihood<BUCKET>(n[2], c.data(), pa.data(), ps.data(), dev.data(), D, logzero,
                                   [&](const auto& like) { run(like, B, D, cube); });
#endif
}
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Build a host program of _MAIN with the given defines (and generated
    header), once per set; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on the PATH")
    tmp = tmp_path_factory.mktemp("lanes_host")
    (tmp / "cuda_runtime.h").write_text(_STUB)
    (tmp / "main.cpp").write_text(_MAIN)
    built = {}

    def build(defines, header=None):
        key = (tuple(defines), header)
        if key not in built:
            d = tmp / f"b{len(built)}"
            d.mkdir()
            if header is not None:
                (d / "fused_like.cuh").write_text(header)
            exe = d / "lanes"
            subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                            *[f"-D{m}" for m in defines], "-I", str(d), "-I", str(tmp), "-I",
                            str(nvcc.CSRC), str(tmp / "main.cpp"), "-o", str(exe)],
                           check=True, capture_output=True, timeout=600)
            built[key] = exe
        return built[key]

    return build


def _run_host(exe, fid, logzero, consts, prior, cube, dtype=np.float32):
    B, D = cube.shape
    stdin = b"".join([np.array([B, D, fid], np.int32).tobytes(),
                      np.asarray([logzero], dtype).tobytes(), np.asarray(consts, dtype).tobytes(),
                      np.asarray(prior[0], dtype).tobytes(), np.asarray(prior[1], dtype).tobytes(),
                      np.ascontiguousarray(cube, dtype).tobytes()])
    out = subprocess.run([str(exe)], input=stdin, capture_output=True, check=True, timeout=600)
    return np.frombuffer(out.stdout, dtype)


#: the functors of arithmetic only (the host's library calls are not torch's)
HOST_FUNCTORS = ("gaussian", "half_gaussian", "pyramidal", "rosenbrock")


@pytest.mark.parametrize("D", [33, 64, 65, 100, 129, 160, 300])
@pytest.mark.parametrize("name", HOST_FUNCTORS)
def test_functor_lane_combine_on_a_host_warp_is_the_torch_form(host_build, name, D):
    """A functor's combine in the 128 bucket (LaneRegs) and the stream
    bucket (LaneRows), on a warp of 32 host threads, bitwise its torch form
    on the same cubes (rosenbrock with its norm replaced by 0 where the
    model's overflows, and its summands then checked against the form's);
    the cubes include points outside [0, 1]^D, which give logzero."""
    calc = make_batched_calculator(identity_prior, ex.get_likelihood(name, D), D, 0)
    fid, consts, pa, ps = functor_args(calc, D)
    consts = consts.copy()
    exe = host_build([f"BUCKET={128 if D <= 128 else 0}", f"NC={len(consts)}"])
    rng = np.random.default_rng(D)
    cube = rng.uniform(0.0, 1.0, (64, D)).astype(F32)
    cube[::8, 3] = 1.25
    finite = np.isfinite(consts).all()
    if not finite:  # rosenbrock past D ~ 106: norm 0
        consts[2] = 0.0
    got = _run_host(exe, fid, -1e30, consts, (pa, ps), cube)
    want = calc(torch.from_numpy(cube))[2].numpy()
    if not finite:  # the form's summands, in its operations, from norm 0
        th = torch.from_numpy(cube)
        terms = []
        for k in range(D - 1):
            u = 1.0 - th[:, k]
            v = th[:, k + 1] - th[:, k] * th[:, k]
            terms.append(u * u + (v * v) * 100.0)
        inside = ((cube >= 0) & (cube <= 1)).all(axis=1)
        want = np.where(inside, (0.0 - ex._coordinate_sum(terms, D)).numpy(), F32(-1e30))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got[::8] == F32(-1e30)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [40, 128, 160])
@pytest.mark.parametrize("model", ["gaussian", "amax", "mixed"])
def test_fused_lane_combine_on_a_host_warp_is_the_plain_version(host_build, model, D, dtype):
    """The emitted functor of a per-point sum Gaussian, an amax model and a
    model that also reads theta[0] (STAGED), on a warp of 32 host threads in
    the 128 and stream buckets, float32 and float64, bitwise its plain
    version."""
    def mixed(theta):
        return -torch.sum((theta - 0.5) ** 2) * 3.0 + theta[0] - torch.amax(theta, -1)

    fn = {"gaussian": per_point_gaussian, "amax": amax_model, "mixed": mixed}[model]
    with real_dtype_scope(dtype):
        calc = make_batched_calculator(identity_prior, fn, D, 0)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low
    assert {op for op, _ in low.term + low.combine + low.lane} <= {
        "add", "sub", "mul", "div", "max", "min", "lt", "le", "gt", "ge", "eq", "ne", "where",
        "neg", "abs", "f32", "lane_add", "lane_max"}
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    exe = host_build(["FUSED", f"NC={max(len(low.consts), 1)}"], low.source(32))
    rng = np.random.default_rng(D + 1)
    cube = rng.uniform(0.0, 1.0, (64, D)).astype(np_dt)
    cube[::8, 5] = -0.25
    consts = np.concatenate([low.consts, np.zeros(1)])[:max(len(low.consts), 1)]
    got = _run_host(exe, 0, low.logzero, consts, low.prior, cube, np_dt)
    want = low.plain_logL(torch.from_numpy(cube)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


# --------------------------------------------------------- the parts study
@pytest.mark.parametrize("variant", b1_bucket_parts.VARIANTS)
def test_parts_study_patches_apply_to_the_template(variant):
    """Each variant of experiments/b1_bucket_parts.py finds every text it
    replaces exactly once in the current slice_epoch.cuh (of the lane-order
    form), and all but whole change it beyond the micro-step count."""
    src = (nvcc.CSRC / "slice_epoch.cuh").read_text()
    assert b1_bucket_parts.form_of(src) == "lanes"
    for old, _ in b1_bucket_parts.patches(src, variant):
        assert src.count(old) == 1, old[:80]
    out = b1_bucket_parts.patched(src, variant)
    assert out.count("(int)s.it") == 2
    assert (variant == "whole") == (len(b1_bucket_parts.patches(src, variant)) == 2)
