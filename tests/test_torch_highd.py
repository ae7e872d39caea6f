"""The port above D = 32, held against the JAX package on the CPU.

The kernel template's wide bucket (32 < D <= 128: B1, B4, B5 and the fused
route at G = 32) and its stream bucket above (the same at G = 32, to the
shared-memory bound), B2's warp-per-basis order above dim 32 and 128, the
plain engine's directions (which never reach B2), a 160-D run, and the
refusals above the bounds.  The same numpy-seeded inputs go through the JAX function (a Pallas
kernel in interpret mode) and its torch counterpart; on the CPU the port's
kernel wrappers run their plain versions.  The kernels themselves are held
to those plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polychordlite_tpu_torch
from polychordlite_tpu.models.examples import gaussian as jax_gaussian
from polychordlite_tpu.ops.directions import _gram_schmidt as jax_xla_gram_schmidt
from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.pallas_dirs import gram_schmidt_lanes as jax_gram_schmidt
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.models.examples import gaussian as pt_gaussian
from polychordlite_tpu_torch.models.examples import random_gaussian, twin_gaussian
from polychordlite_tpu_torch.ops.precision import real_dtype_scope
from polychordlite_tpu_torch.output import PolyChordOutput
from polychordlite_tpu_torch.ops import directions, fused_like, pallas_dirs
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops import pallas_slice_v3, pallas_slice_v4, pallas_slice_v5, slice_kernel
from polychordlite_tpu_torch.ops.directions import make_directions
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, build_epoch_fn
from polychordlite_tpu_torch.priors import UniformPrior, identity_prior

from test_torch_kernels import _jax_draws, _jax_v4_records

torch.set_num_threads(2)

SIGMA = 0.2
H100_SMS = 132


# ----------------------------------------- the plain engine against JAX v4
def _wide_inputs(B, D, seed=0):
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    seeds = (0.5 + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    r0 = 1.5 * SIGMA * math.sqrt(D)
    norm = -D * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))
    bound = np.full((B,), norm - 0.5 * (r0 / SIGMA) ** 2, np.float32)
    chol = np.broadcast_to(SIGMA * np.eye(D, dtype=np.float32), (B, D, D)).copy()
    valid = np.arange(B) >= 64  # a block of invalid lanes
    return key, seeds, bound, chol, valid


@pytest.mark.parametrize("D", [40, 64, 160])
def test_plain_engine_decision_exact_with_v4_above_32(monkeypatch, D):
    """The plain engine (B1's plain version in every bucket) against the JAX
    v4 kernel in interpret mode at D = 40, 64 (the wide bucket) and 160 (the
    stream bucket), B = 1024, R = 4, under the contract of
    ``test_plain_engine_decision_exact_with_v4``: identical nlike, |dt| <=
    1e-6, and fewer than B / 1000 lanes that differ, each only where its
    first divergent probe sat on the contour.  logL agrees to 1e-4, not the
    D = 4 test's 1e-5: the port sums the D chi-square terms in index order
    and jnp.sum in another, and at these magnitudes (|norm| 27.6 at D = 40,
    44.1 at D = 64, 110.4 at D = 160) the two differ by a few float32 ulp
    (2.3e-5 at D = 64; an ulp is 7.6e-6 at 110)."""
    B, R = 1024, 4
    key, seeds, bound, chol, valid = _wide_inputs(B, D, seed=D)
    jcfg = JaxEpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    jcalc = jax_calculator(lambda c: c, jax_gaussian(D, sigma=SIGMA), D, 2)
    t_j, l_j, n_j, _ = _jax_v4_records(monkeypatch, jcalc, jcfg, key, seeds, bound, chol, valid)
    dir_keys, _ = _lane_keys(key, B, None)
    nh, w, _ = jax_make_directions(
        dir_keys, jnp.asarray(chol), grade_dims=(D,), num_repeats=(R,), n_dims=D,
        shared_perm_key=jax.random.fold_in(key, 0x5EED),
    )
    nh, w = (torch.as_tensor(np.array(a)) for a in (nh, w))
    calc = make_batched_calculator(identity_prior, pt_gaussian(D, sigma=SIGMA), D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    t, l, n = pallas_slice_v4.slice_epoch(calc, cfg, pps.key_words(np.asarray(key)),
                                          torch.as_tensor(seeds), torch.as_tensor(bound),
                                          torch.as_tensor(valid), nh, w)
    t, l, n = t.numpy(), l.numpy(), n.numpy().astype(np.int64)
    tol = 1e-4
    lane_ok = (
        (n == n_j).all(1)
        & (np.abs(t - t_j) <= 1e-6).all(1)
        & (np.abs(l - l_j) <= tol).all(1)
    )
    bad = np.nonzero(~lane_ok)[0]
    assert len(bad) < B / 1000, f"{len(bad)} lanes differ"
    for b in bad:
        r = int(np.nonzero((n[b] != n_j[b]) | (np.abs(t[b] - t_j[b]) > 1e-6))[0][0])
        assert abs(float(l_j[b, r]) - float(bound[b])) < tol, (b, r)
    assert (n[:64] == 0).all() and (n[64:].sum(1) > 0).all()


# ----------------------------------------------------------- Gram-Schmidt
def test_wide_plain_cgs2_matches_pallas_interpret():
    """At dim 40 the plain version (the wide kernel's order) against the JAX
    Pallas kernel in interpret mode, atol 1e-5; orthonormal columns."""
    dim = 40
    g = np.random.default_rng(dim).standard_normal((1, dim, dim, 1024)).astype(np.float32)
    want = np.asarray(jax_gram_schmidt(jnp.asarray(g), interpret=True))
    got = pallas_dirs.gram_schmidt_plain(torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pallas_dirs.gram_schmidt_lanes(torch.as_tensor(g)).numpy(),
                                  got)
    qtq = np.einsum("nikb,nijb->nkjb", got, got)
    np.testing.assert_allclose(qtq, np.eye(dim)[None, :, :, None] + 0 * qtq, atol=1e-5)


@pytest.mark.parametrize("dim,atol", [(64, 2e-5), (128, 5e-5), (160, 5e-5)])
def test_wide_plain_cgs2_matches_xla_gram_schmidt(dim, atol):
    """At dims 64, 128 and 160 (past the wide kernel, the long kernel's
    order) the plain version against the JAX package's XLA
    ``_gram_schmidt`` (CGS2 blocked over columns, another order of
    summation): within ``atol`` (2e-5 at 64, 5e-5 at 128 and 160: float32
    sums of dim products in two orders, the error growing with the dim
    and the column index), and QtQ = I to 1e-5."""
    B = 16
    g = np.random.default_rng(dim).standard_normal((1, dim, dim, B)).astype(np.float32)
    want = np.asarray(jax_xla_gram_schmidt(jnp.asarray(g.transpose(0, 3, 1, 2))))
    got = pallas_dirs.gram_schmidt_plain(torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1), rtol=0, atol=atol)
    qtq = np.einsum("nikb,nijb->nkjb", got, got)
    np.testing.assert_allclose(qtq, np.eye(dim)[None, :, :, None] + 0 * qtq, atol=1e-5)


def test_wide_plain_order_is_the_warp_butterfly():
    """The wide order, spelled out for one column pair: each lane's four
    rows summed in order, then lower plus upper half at offsets 16 ... 1
    (rows past dim zero) — bitwise the dot product gram_schmidt_plain uses."""
    rng = np.random.default_rng(3)
    dim = 70
    a, b = (np.zeros((1, 128, 2), np.float32) for _ in range(2))
    a[0, :dim], b[0, :dim] = rng.standard_normal((2, dim, 2)).astype(np.float32)
    lanes = np.zeros((32, 2), np.float32)
    for m in range(4):
        lanes = lanes + a[0, 32 * m:32 * m + 32] * b[0, 32 * m:32 * m + 32]
    off = 16
    while off:
        lanes = lanes[:off] + lanes[off:2 * off]
        off //= 2
    got = pallas_dirs._warp_dot(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got[0], lanes[0])


def test_plain_gram_schmidt_has_no_bound_on_dim():
    """Above dim 128 (B2's long kernel) the plain version keeps the wide
    order with more rows a lane: zero rows change no sum, so padding the
    same columns to 4 or 5 rows a lane gives the same dot products bit for
    bit, and at dim 140 the columns are orthonormal."""
    rng = np.random.default_rng(8)
    a, b = (torch.as_tensor(rng.standard_normal((2, 100, 3)).astype(np.float32))
            for _ in range(2))
    dots = [pallas_dirs._warp_dot(torch.nn.functional.pad(a, (0, 0, 0, rows - 100)),
                                  torch.nn.functional.pad(b, (0, 0, 0, rows - 100)))
            for rows in (128, 160)]
    assert torch.equal(dots[0], dots[1])
    g = torch.as_tensor(rng.standard_normal((1, 140, 140, 2)).astype(np.float32))
    q = pallas_dirs.gram_schmidt_plain(g).numpy()
    qtq = np.einsum("nikb,nijb->nkjb", q, q)
    np.testing.assert_allclose(qtq, np.eye(140)[None, :, :, None] + 0 * qtq, atol=1e-5)


def test_make_directions_matches_jax_at_d40():
    """make_directions at D = 40 (the wide order of B2's plain version)
    against the JAX package's on the same draws."""
    B, n_dims, R = 32, 40, 80
    key = jax.random.PRNGKey(4)
    chain_keys = jax.vmap(lambda i: jax.random.fold_in(key, 2 * i))(jnp.arange(B))
    perm_key = jax.random.fold_in(key, 0x5EED)
    rng = np.random.default_rng(6)
    A = rng.standard_normal((B, n_dims, n_dims)) * 0.1
    chol = np.linalg.cholesky(A @ A.transpose(0, 2, 1) + 0.05 * np.eye(n_dims)).astype(np.float32)
    nh_j, w_j, sp_j = jax_make_directions(
        chain_keys, jnp.asarray(chol), grade_dims=(n_dims,), num_repeats=(R,),
        n_dims=n_dims, shared_perm_key=perm_key,
    )
    gauss, perm = _jax_draws(chain_keys, (n_dims,), (R,), n_dims, perm_key)
    for use_kernel in (True, False):  # on the CPU both take the plain version
        nh, w, sp = make_directions(
            torch.as_tensor(chol), grade_dims=(n_dims,), num_repeats=(R,), n_dims=n_dims,
            gauss=gauss, perm=perm, use_kernel=use_kernel,
        )
        np.testing.assert_allclose(nh.numpy(), np.asarray(nh_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_j))


# ----------------------------------------- C18: the plain engine's directions
def _refuse(*a, **k):
    raise AssertionError("the kernel wrapper was reached")


@pytest.mark.parametrize("engine,reaches", [("torch", False), ("cuda", True), ("cuda3", True)])
def test_plain_engine_directions_never_reach_the_kernel_wrapper(monkeypatch, engine, reaches):
    """engine="torch" asks make_directions for the plain Gram-Schmidt by
    name: with the kernel wrapper made to raise, its epoch still runs, at
    D = 40, and counts no launch; every kernel engine's epoch reaches the
    wrapper."""
    monkeypatch.setattr(directions, "gram_schmidt_lanes", _refuse)
    D, B, R = 40, 64, 3
    calc = make_batched_calculator(identity_prior, pt_gaussian(D), D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,), engine=engine)
    epoch = build_epoch_fn(calc, cfg)
    launches = dict(pallas_dirs.LAUNCHES)
    args = (pps.key_words(pps.seed_key(1)), torch.full((B, D), 0.5), torch.full((B,), -1e3),
            torch.eye(D).expand(B, D, D), torch.ones(B, dtype=torch.bool))
    gen = torch.Generator().manual_seed(2)
    if reaches:
        with pytest.raises(AssertionError, match="kernel wrapper"):
            epoch(*args, generator=gen)
        return
    packed = epoch(*args, generator=gen)
    assert packed.shape[0] == B and torch.isfinite(packed).all()
    assert pallas_dirs.LAUNCHES == launches


def test_plain_run_at_d40_finishes(tmp_path):
    """run(device="cpu", engine="torch") at D = 40: the plain engine and the
    plain Gram-Schmidt, no bound on D; a short run to its max_ndead."""
    out = polychordlite_tpu_torch.run(
        pt_gaussian(40), 40, nDerived=2, nlive=64, num_repeats=4, do_clustering=False,
        read_resume=False, base_dir=str(tmp_path), seed=7, feedback=-1, device="cpu",
        engine="torch", max_ndead=256)
    with open(tmp_path / "test.metrics.jsonl") as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["engine"] == "torch" and not any(last["kernel_launches"].values())
    assert out.ndead >= 256 and math.isfinite(out.logZ)


# -------------------------------------------------------- the group rule
@pytest.mark.parametrize("D", [33, 40, 64, 100, 128])
@pytest.mark.parametrize("B", [128, 512, 8192, 65536])
def test_choose_group_in_the_wide_bucket(D, B):
    """Above D = 32, G >= D / LANE_CAP (at most 4 coordinates a lane): the
    wide bucket's one instantiation, G = 32, at every B; never G = 1."""
    G = pallas_slice_v4.choose_group(B, D, H100_SMS)
    assert G * pallas_slice_v4.LANE_CAP >= D and G > 1
    assert pallas_slice_v4.BUCKET_GROUPS[pallas_slice_v4.SLICE_MAXD_WIDE] == (32,)
    assert G == 32
    assert pallas_slice_v4.bucket(D) == 128


@pytest.mark.parametrize("D", [129, 160, 512, 19370])
@pytest.mark.parametrize("B", [128, 512, 8192])
def test_choose_group_in_the_stream_bucket(D, B):
    """Above D = 128 the stream bucket's one instantiation, G = 32, at every
    B."""
    assert pallas_slice_v4.bucket(D) == pallas_slice_v4.STREAM
    assert pallas_slice_v4.BUCKET_GROUPS[pallas_slice_v4.STREAM] == (32,)
    assert pallas_slice_v4.choose_group(B, D, H100_SMS) == 32


def test_bucket_bounds():
    """32, 128 and the stream bucket to the shared-memory bound: (2 + NT) D
    values of the type in 232,448 bytes (D <= 19,370 in float32 at one term,
    14,528 at two, 7,264 in float64 at two); above, a raise naming the bound
    and engine='torch'."""
    assert pallas_slice_v4.bucket(32) == 32 and pallas_slice_v4.bucket(33) == 128
    assert pallas_slice_v4.bucket(128) == 128 and pallas_slice_v4.bucket(129) == "stream"
    limits = {(1, torch.float32): 19370, (2, torch.float32): 14528,
              (1, torch.float64): 9685, (2, torch.float64): 7264}
    for (nt, dt), limit in limits.items():
        assert pallas_slice_v4.stream_max_d(nt, dt) == limit
        assert pallas_slice_v4.bucket(limit, nt, dt) == "stream"
        with pytest.raises(ValueError, match=f"D <= {limit} .*engine='torch'"):
            pallas_slice_v4.bucket(limit + 1, nt, dt)
    # the 32 bucket's rule is unchanged
    assert [pallas_slice_v4.choose_group(512, D, H100_SMS) for D in (2, 4, 20, 32)] == [
        2, 4, 16, 32]
    assert pallas_slice_v4.choose_group(8192, 20, H100_SMS) == 8


class _OnCard:
    """A stand-in tensor on a CUDA device: its shape only."""

    def __init__(self, *shape):
        self.shape = shape
        self.device = torch.device("cuda", 0)


def test_stream_launches_count_by_bucket_and_group(monkeypatch):
    """On the card, B1 at D = 160 launches at the stream bucket's G = 32 and
    counts by ("stream", 32), its functor's device array of prior and
    matrix made once; G = 16 raises.  The launch is recorded instead of
    made."""
    launched = []

    def record(lib, entry, *a, ints=(), **k):
        launched.append((entry, ints))
        return None, None, None

    monkeypatch.setattr(pallas_slice_v4, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(pallas_slice_v4, "launch_slice_kernel", record)
    monkeypatch.setattr(pallas_slice_v4, "_lib", lambda: None)
    counts = pallas_slice_v4.GROUP_LAUNCHES
    saved = dict(counts)
    try:
        D = 160
        run = (_OnCard(512, D), _OnCard(512), _OnCard(512), _OnCard(512, 4, D), _OnCard(512, 4))
        pallas_slice_v4.slice_epoch(None, None, (0, 0), *run)
        with pytest.raises(ValueError, match="not one of"):
            pallas_slice_v4.slice_epoch(None, None, (0, 0), *run, group=16)
        assert launched == [("slice_epoch_launch", (32,))]
        assert counts["stream", 32] == saved["stream", 32] + 1
    finally:
        counts.update(saved)


def test_functor_device_data_is_prior_then_matrix():
    """The device array of every kernel entry: the prior's a and s, then
    random_gaussian's D x D matrix (read from there in every bucket), made
    once per calc and device."""
    for D in (20, 160):
        calc = make_batched_calculator(UniformPrior(0.0, 1.0), random_gaussian(D), D, 0)
        _, consts, a, s = pallas_slice_v4.functor_args(calc, D)
        data = pallas_slice_v4.functor_device_data(calc, D, torch.device("cpu"))
        np.testing.assert_array_equal(data.numpy(), np.concatenate([a, s, consts[2:]]))
        assert data.numel() == 2 * D + D * D
        assert pallas_slice_v4.functor_device_data(calc, D, torch.device("cpu")) is data
    calc = make_batched_calculator(UniformPrior(0.0, 1.0), pt_gaussian(160), 160, 2)
    assert pallas_slice_v4.functor_device_data(calc, 160, torch.device("cpu")).numel() == 320


def test_wide_launches_count_by_bucket_and_group(monkeypatch):
    """On the card, B1, B4 and B5 at D = 64 launch at the wide bucket's G
    (the rule's, or the one asked for) and count by (128, G); G = 8 and 16
    have no instantiation there and raise.  The launch is recorded instead
    of made."""
    launched = []

    def record(lib, entry, *a, ints=(), **k):
        launched.append((entry, ints))
        return None, None, None

    monkeypatch.setattr(pallas_slice_v4, "_sm_count", lambda dev: H100_SMS)
    for mod in (pallas_slice_v4, pallas_slice_v3):
        monkeypatch.setattr(mod, "launch_slice_kernel", record)
    monkeypatch.setattr(pallas_slice_v4, "_lib", lambda: None)
    monkeypatch.setattr(pallas_slice_v3.nvcc, "load", lambda *a: None)
    monkeypatch.setattr(pps, "_lib", lambda: None)
    monkeypatch.setattr(pps, "v2_repeat_budget", lambda cfg: 48)
    monkeypatch.setattr(pallas_slice_v3, "cap_body", lambda cfg: 12)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    counters = (pallas_slice_v4.GROUP_LAUNCHES, pps.GROUP_LAUNCHES,
                pallas_slice_v3.GROUP_LAUNCHES)
    saved = [dict(c) for c in counters]
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    try:
        D = 64
        run = (_OnCard(512, D), _OnCard(512), _OnCard(512), _OnCard(512, 128, D),
               _OnCard(512, 128))
        bench = (_OnCard(8192, D), _OnCard(8192), _OnCard(8192), _OnCard(8192, 8, D),
                 _OnCard(8192, 8))
        pallas_slice_v4.slice_epoch(None, None, (0, 0), *run)
        pallas_slice_v4.slice_epoch(None, None, (0, 0), *bench)
        pps.slice_epoch_v2(None, None, (0, 0), *run, group=32)
        pallas_slice_v3.slice_epoch_v3(None, None, (0, 0), *bench)
        for G in (8, 16):
            with pytest.raises(ValueError, match="not one of"):
                pallas_slice_v4.slice_epoch(None, None, (0, 0), *run, group=G)
        assert launched == [("slice_epoch_launch", (32,)), ("slice_epoch_launch", (32,)),
                            ("slice_epoch_v2_launch", (32,)), ("slice_epoch_v3_launch", (32,))]
        assert {k: v for k, v in pallas_slice_v4.GROUP_LAUNCHES.items() if v} == {(128, 32): 2}
        assert {k: v for k, v in pps.GROUP_LAUNCHES.items() if v} == {(128, 32): 1}
        assert {k: v for k, v in pallas_slice_v3.GROUP_LAUNCHES.items() if v} == {(128, 32): 1}
    finally:
        for c, old in zip(counters, saved):
            c.update(old)


# ------------------------------------------------------------ the refusals
def _per_point_gaussian(theta):
    D = theta.shape[-1]
    return (-0.5 * torch.sum(((theta - 0.5) / 0.1) ** 2)
            - D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)))


def test_fused_lowers_a_per_point_gaussian_in_the_stream_bucket():
    """At D = 160 the per-point torch Gaussian lowers into the stream
    bucket's header (FUSED_MAXD SLICE_MAXD_STREAM, the prior by pointer from
    the constant buffer's tail), its plain logL within rtol 1e-5 / atol 1e-6
    of the calc's, in float32 and in float64 (rtol = atol = 1e-12)."""
    D = 160
    for dt, tol in ((torch.float32, (1e-5, 1e-6)), (torch.float64, fused_like.F64_TOL)):
        with real_dtype_scope(dt):
            calc = make_batched_calculator(identity_prior, _per_point_gaussian, D, 0)
        low = fused_like.lowering(calc)
        assert isinstance(low, fused_like.Lowered) and low.dtype == dt, low
        cube = torch.as_tensor(np.random.default_rng(D).uniform(0.3, 0.7, (256, D)), dtype=dt)
        torch.testing.assert_close(low.plain_logL(cube), calc(cube)[2], rtol=tol[0],
                                   atol=tol[1])
        src = low.source(32)
        real = "float" if dt == torch.float32 else "double"
        assert "#define FUSED_MAXD SLICE_MAXD_STREAM" in src and f"#define FUSED_D {D}" in src
        assert f"DevicePriorT<{real}> prior;" in src and "AffinePriorT" not in src
        assert f"T[0][{D - 1}]" in src
        prior = low.device_prior(torch.device("cpu"))
        assert prior.numel() == 2 * D and torch.equal(
            prior, low.device_consts(torch.device("cpu"))[-2 * D:])


@pytest.mark.parametrize("D", [64, 128])
def test_fused_lowers_a_per_point_gaussian_in_the_wide_bucket(D):
    """The per-point torch Gaussian lowers at D = 64 and 128 into the wide
    bucket's header, its plain logL within rtol 1e-5 / atol 1e-6 of the
    calc's; the emitted combine reads the terms through any T[j][d]."""
    calc = make_batched_calculator(identity_prior, _per_point_gaussian, D, 0)
    assert calc.form == "per_point"
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low
    cube = torch.as_tensor(np.random.default_rng(D).uniform(0.3, 0.7, (256, D)),
                           dtype=torch.float32)
    got, want = low.plain_logL(cube), calc(cube)[2]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    src = low.source(32)
    assert "#define FUSED_MAXD 128" in src and "combine(const TT& T, int)" in src
    assert f"T[0][{D - 1}]" in src


def test_fused_refuses_above_the_stream_bound_with_its_reason():
    """Past the stream bucket's bound for one term (19,370 in float32, 9,685
    in float64) the lowering refuses before it traces, naming D and the
    bound, and the model takes the traced route, which has none."""
    for dt, limit in ((torch.float32, 19370), (torch.float64, 9685)):
        with real_dtype_scope(dt):
            calc = make_batched_calculator(identity_prior, lambda th: -(th ** 2).sum(-1),
                                           limit + 1, 0)
        low = fused_like.lowering(calc)
        assert isinstance(low, fused_like.Refused), low
        assert f"D = {limit + 1}" in low.reason and f"D <= {limit}" in low.reason
        route, reason = slice_kernel.cuda_route(calc)
        assert route == "slice_step" and f"D <= {limit}" in reason


def test_resolve_engine_refuses_above_the_stream_bound_naming_the_plain_engine(monkeypatch):
    """Above the stream bucket's bound for a functor (the zoo Gaussian, one
    term: D <= 19,370) every kernel engine raises once, in resolve_engine,
    naming the bound and engine='torch'; cuda5 (B3) raises above 32; the
    plain engine takes any D."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = ns.resolve_device("cuda")
    big = make_batched_calculator(UniformPrior(0.0, 1.0), pt_gaussian(19371), 19371, 0)
    for engine in ("auto",) + ns.KERNEL_ENGINES:
        with pytest.raises(ValueError, match="D = 32" if engine == "cuda5"
                           else "D <= 19370 .*engine='torch'"):
            ns.resolve_engine(engine, cuda, big)
    assert ns.resolve_engine("torch", cuda, big) == "torch"
    # two terms a coordinate: the bound is 14,528
    twin = make_batched_calculator(UniformPrior(0.0, 1.0), twin_gaussian(14529), 14529, 0)
    with pytest.raises(ValueError, match="D <= 14528 .*engine='torch'"):
        ns.resolve_engine("cuda", cuda, twin)
    d40 = make_batched_calculator(UniformPrior(0.0, 1.0), pt_gaussian(40), 40, 0)
    for engine in ("cuda", "cuda3", "cuda2"):
        assert ns.resolve_engine(engine, cuda, d40) == engine
    with pytest.raises(ValueError, match="D = 32"):
        ns.resolve_engine("cuda5", cuda, d40)


def test_engines_resolve_at_d160(monkeypatch):
    """At D = 160 "auto" resolves to "cuda" (the functor kernel in the stream
    bucket for the zoo Gaussian, the fused route for a per-point torch
    model), "cuda3" and "cuda2" resolve, graded and host-callback models
    resolve to "scan"; "cuda5" still raises at D = 33."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = ns.resolve_device("cuda")
    D = 160
    zoo = make_batched_calculator(UniformPrior(0.0, 1.0), pt_gaussian(D), D, 2)
    for engine in ("auto", "cuda", "cuda3", "cuda2"):
        assert ns.resolve_engine(engine, cuda, zoo) == ("cuda" if engine == "auto" else engine)
    assert slice_kernel.cuda_route(zoo)[0] == "slice_epoch"
    per_point = make_batched_calculator(identity_prior, _per_point_gaussian, D, 0)
    assert ns.resolve_engine("auto", cuda, per_point) == "cuda"
    assert slice_kernel.cuda_route(per_point)[0] == "slice_epoch_fused"
    host = make_batched_calculator(
        identity_prior, lambda th: float(-np.sum((np.asarray(th) - 0.5) ** 2)), D, 0)
    assert host.uses_callback and ns.resolve_engine("auto", cuda, host) == "scan"
    graded = make_batched_calculator(identity_prior, polychordlite_tpu_torch.GradedLikelihood(
        lambda th: torch.sum((th[..., :16] - 0.5) ** 2, dim=-1),
        lambda aux, th: -(aux + torch.sum((th[..., 16:] - 0.5) ** 2, dim=-1)), 16), D, 0)
    assert graded.graded and ns.resolve_engine("auto", cuda, graded) == "scan"
    d33 = make_batched_calculator(UniformPrior(0.0, 1.0), pt_gaussian(33), 33, 0)
    with pytest.raises(ValueError, match="D = 32"):
        ns.resolve_engine("cuda5", cuda, d33)


def test_packet_kernel_refuses_above_32_naming_its_bound():
    """B3 keeps a chain's coordinates per thread: above D = 32 it raises,
    naming the bound, before any launch (on either device)."""
    D, B = 33, 8
    calc = make_batched_calculator(identity_prior, pt_gaussian(D), D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(1,))
    with pytest.raises(ValueError, match="stops at D = 32"):
        pallas_slice_v5.slice_epoch_v5(
            calc, cfg, (0, 0), torch.full((B, D), 0.5), torch.zeros(B),
            torch.ones(B, dtype=torch.bool), torch.ones((B, 1, D)) / math.sqrt(D),
            torch.ones((B, 1)))


def test_random_gaussian_functor_refuses_above_the_stream_bound():
    """random_gaussian's matrix lives in a device buffer: its functor takes
    D = 40 and 160 (the wide and the stream buckets) on every route and
    forced engine, and refuses only above the stream bucket's bound for one
    term, naming it and the plain engine, where the route is chosen
    (cuda_route, resolve_engine) as well as at launch."""
    for D in (40, 160):
        calc = make_batched_calculator(identity_prior, random_gaussian(D), D, 0)
        fid, consts, _, _ = pallas_slice_v4.functor_args(calc, D)
        assert fid == 10 and consts.size == 2 + D * D
        assert slice_kernel.cuda_route(calc)[0] == "slice_epoch"
        for engine in ("auto", "cuda", "cuda3", "cuda2"):
            assert ns.resolve_engine(engine, torch.device("cuda"), calc) in (engine, "cuda")
    # (a 19,371-D matrix would take 1.5 GB: the check itself)
    with pytest.raises(ValueError, match="D <= 19370 .*engine='torch'"):
        pallas_slice_v4.check_functor_dims("random_gaussian", 19371)
    pallas_slice_v4.check_functor_dims("random_gaussian", 19370)
    with pytest.raises(ValueError, match="D <= 14528 .*engine='torch'"):
        pallas_slice_v4.check_functor_dims("twin_gaussian", 14529)


def test_plain_run_at_d160_writes_its_files(tmp_path):
    """run(device="cpu") at D = 160 on the plain engine: the administrator,
    the clustering and the output files take D > 128.  nlive 170, a short run
    to max_ndead 340; the .txt rows hold weight, -2 logL, the 160 physical
    parameters and the 2 derived ones, the .stats file parses, and the
    .paramnames file names all 162."""
    D = 160
    out = polychordlite_tpu_torch.run(
        pt_gaussian(D, sigma=SIGMA), D, nDerived=2, nlive=170, num_repeats=2,
        do_clustering=True, read_resume=False, base_dir=str(tmp_path), seed=16, feedback=-1,
        device="cpu", max_ndead=340,
        paramnames=[(f"p{i}", f"\\theta_{{{i}}}") for i in range(D)] + [("r", "r"), ("r2", "r^2")])
    assert out.ndead >= 340 and math.isfinite(out.logZ) and math.isfinite(out.logZerr)
    samples = np.loadtxt(tmp_path / "test.txt")
    assert samples.ndim == 2 and samples.shape[1] == 2 + D + 2
    assert np.isfinite(samples).all() and (samples[:, 0] >= 0).all()
    assert ((samples[:, 2:2 + D] >= 0) & (samples[:, 2:2 + D] <= 1)).all()
    dead = np.loadtxt(tmp_path / "test_dead-birth.txt")
    assert dead.shape[1] == D + 2 + 2 and dead.shape[0] >= 340
    parsed = PolyChordOutput(str(tmp_path), "test")
    assert parsed.ndead == out.ndead and math.isclose(parsed.logZ, out.logZ, abs_tol=1e-5)
    names = (tmp_path / "test.paramnames").read_text().splitlines()
    assert len(names) == D + 2
    with open(tmp_path / "test.metrics.jsonl") as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["engine"] == "torch" and not any(last["kernel_launches"].values())
