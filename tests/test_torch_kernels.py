"""The port's kernel modules held against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function and its torch
counterpart.  Where the JAX function reaches a Pallas kernel it runs in
interpret mode.  On the CPU the port's kernel wrappers run their plain
torch versions, which is what these tests check; the CUDA kernels
themselves are compared with the same plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychordlite_tpu.models.examples import gaussian as jax_gaussian
from polychordlite_tpu.ops import pallas_slice as jps
from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.pallas_dirs import gram_schmidt_lanes as jax_gram_schmidt
from polychordlite_tpu.ops.pallas_slice_v4 import build_epoch_fn_pallas_v4
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu.ops.slice_kernel import unpack_epoch as jax_unpack_epoch
from polychordlite_tpu_torch.models.examples import gaussian as pt_gaussian
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops.directions import make_directions
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_dirs import (
    gram_schmidt_lanes,
    gram_schmidt_plain,
)
from polychordlite_tpu_torch.ops.pallas_slice_v4 import slice_epoch, validate_functor
from polychordlite_tpu_torch.ops.slice_kernel import (
    EpochConfig,
    build_epoch_fn,
    unpack_epoch,
)
from polychordlite_tpu_torch.priors import identity_prior

torch.set_num_threads(2)


D = 4
SIGMA = 0.2
NORM = -D * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))


# ---------------------------------------------------------------- murmur3
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_murmur_helpers_bitwise(seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(-(2**31), 2**31, 4096, dtype=np.int64).astype(np.int32)
    k = rng.integers(-(2**31), 2**31, 4096, dtype=np.int64).astype(np.int32)
    want_mix = np.asarray(jps._mix(jnp.asarray(h), jnp.asarray(k))).view(np.uint32)
    want_fmix = np.asarray(jps._fmix(jnp.asarray(h))).view(np.uint32)
    th = torch.as_tensor(h.view(np.uint32).astype(np.int64))
    tk = torch.as_tensor(k.view(np.uint32).astype(np.int64))
    np.testing.assert_array_equal(pps._mix(th, tk).numpy(), want_mix.astype(np.int64))
    np.testing.assert_array_equal(pps._fmix(th).numpy(), want_fmix.astype(np.int64))
    # the scalar (Python int) form gives the same words
    assert pps._mix(int(th[7]), int(tk[7])) == int(want_mix[7])
    assert pps._fmix(int(th[7])) == int(want_fmix[7])


def test_key_words_match_jax():
    key = jax.random.PRNGKey(12345)
    k0, k1 = jps._key_words(key)
    want = (int(np.uint32(np.int32(k0))), int(np.uint32(np.int32(k1))))
    assert pps.key_words(np.asarray(key)) == want
    assert pps.key_words(pps.seed_key(12345)) == want  # same raw-key layout


def test_fold_in_is_deterministic_and_distinct():
    key = pps.seed_key(7)
    a = pps.fold_in(key, 100_000)
    np.testing.assert_array_equal(a, pps.fold_in(key, 100_000))
    assert not np.array_equal(a, pps.fold_in(key, 100_001))
    assert a.dtype == np.uint32 and a.shape == (2,)


# ----------------------------------------------------------- Gram-Schmidt
@pytest.mark.parametrize("dim", [4, 20])
def test_plain_cgs2_matches_pallas_interpret(dim):
    rng = np.random.default_rng(dim)
    g = rng.standard_normal((2, dim, dim, 1024)).astype(np.float32)
    want = np.asarray(jax_gram_schmidt(jnp.asarray(g), interpret=True))
    got = gram_schmidt_plain(torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(gram_schmidt_lanes(torch.as_tensor(g)).numpy(), got)
    qtq = np.einsum("nikb,nijb->nkjb", got, got)
    np.testing.assert_allclose(qtq, np.eye(dim)[None, :, :, None] + 0 * qtq, atol=1e-5)


def _jax_draws(chain_keys, grade_dims, num_repeats, n_dims, perm_key):
    """The JAX package's per-chain Gaussians (chain axis moved minor) and its
    shared slot permutation, drawn exactly as ``make_directions`` draws them."""
    G = len(num_repeats)
    gauss = []
    for g, reps in enumerate(num_repeats):
        sub = n_dims - int(sum(grade_dims[:g]))
        nb = -(-reps // sub)
        draw = jax.vmap(
            lambda ck: jax.random.normal(jax.random.split(ck, G + 1)[g], (nb, sub, sub))  # noqa: B023
        )(chain_keys)
        gauss.append(torch.as_tensor(np.asarray(draw).transpose(1, 2, 3, 0).copy()))
    R = int(sum(num_repeats))
    tail = np.asarray(jax.random.permutation(perm_key, R - 1)) + 1
    return gauss, torch.as_tensor(np.concatenate([[0], tail]).astype(np.int64))


@pytest.mark.parametrize(
    "grade_dims,num_repeats", [((4,), (4,)), ((4,), (9,)), ((2, 2), (3, 5))]
)
def test_make_directions_matches_jax(grade_dims, num_repeats):
    B, n_dims = 64, sum(grade_dims)
    key = jax.random.PRNGKey(3)
    chain_keys = jax.vmap(lambda i: jax.random.fold_in(key, 2 * i))(jnp.arange(B))
    perm_key = jax.random.fold_in(key, 0x5EED)
    rng = np.random.default_rng(5)
    A = rng.standard_normal((B, n_dims, n_dims)) * 0.1
    chol = np.linalg.cholesky(A @ A.transpose(0, 2, 1) + 0.05 * np.eye(n_dims)).astype(np.float32)
    nh_j, w_j, sp_j = jax_make_directions(
        chain_keys, jnp.asarray(chol), grade_dims=grade_dims,
        num_repeats=num_repeats, n_dims=n_dims, shared_perm_key=perm_key,
    )
    gauss, perm = _jax_draws(chain_keys, grade_dims, num_repeats, n_dims, perm_key)
    nh, w, sp = make_directions(
        torch.as_tensor(chol), grade_dims=grade_dims, num_repeats=num_repeats,
        n_dims=n_dims, gauss=gauss, perm=perm,
    )
    np.testing.assert_allclose(nh.numpy(), np.asarray(nh_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_j))


def test_make_directions_from_generator(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    chol = torch.eye(5).expand(16, 5, 5)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    nh, w, sp = make_directions(chol, grade_dims=(5,), num_repeats=(7,), n_dims=5,
                                generator=gen)
    assert torch.backends.cuda.matmul.allow_tf32 is True  # the caller's setting is kept
    assert nh.shape == (16, 7, 5) and w.shape == (16, 7) and sp.shape == (16, 7)
    np.testing.assert_allclose(nh.norm(dim=2).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), 3.0, atol=1e-5)  # identity whitening
    assert (sp == 0).all()


# -------------------------------------------------------------- slice epoch
def _epoch_inputs(B, R, seed=0):
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    seeds = (0.5 + 0.05 * rng.standard_normal((B, D))).astype(np.float32)
    r0 = 1.5 * SIGMA * math.sqrt(D)
    bound = np.full((B,), NORM - 0.5 * (r0 / SIGMA) ** 2, np.float32)
    chol = np.broadcast_to(SIGMA * np.eye(D, dtype=np.float32), (B, D, D)).copy()
    valid = np.arange(B) >= 64  # a block of invalid lanes
    return key, seeds, bound, chol, valid


def _jax_v4_records(monkeypatch, calc, cfg, key, seeds, bound, chol, valid):
    """Run the JAX v4 kernel in interpret mode and capture its raw
    (R, 3, S, 128) [t, logL, nlike] output next to its packed epoch."""
    from polychordlite_tpu.ops import pallas_slice_v4 as v4

    captured = {}
    real = v4.pl.pallas_call

    def capturing(*a, **k):
        f = real(*a, **k)

        def g(*args):
            out = f(*args)
            captured["out"] = out
            return out

        return g

    monkeypatch.setattr(v4.pl, "pallas_call", capturing)
    epoch = build_epoch_fn_pallas_v4(calc, cfg, interpret=True)
    packed = epoch(key, jnp.asarray(seeds), jnp.asarray(bound), jnp.asarray(chol),
                   jnp.asarray(valid))
    out = np.asarray(captured["out"])
    B = seeds.shape[0]
    R = cfg.total_repeats
    t = out[:, 0].reshape(R, B).T
    logL = out[:, 1].reshape(R, B).T
    nlike = out[:, 2].reshape(R, B).T.astype(np.int64)
    return t, logL, nlike, np.asarray(packed)


def test_plain_engine_decision_exact_with_v4(monkeypatch):
    B, R = 1024, 4
    key, seeds, bound, chol, valid = _epoch_inputs(B, R)
    jcfg = JaxEpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    jcalc = jax_calculator(lambda c: c, jax_gaussian(D, sigma=SIGMA), D, 2)
    t_j, l_j, n_j, packed_j = _jax_v4_records(
        monkeypatch, jcalc, jcfg, key, seeds, bound, chol, valid
    )
    # the directions v4 used, fed to the port through its seam
    dir_keys, _ = _lane_keys(key, B, None)
    nh, w, sp = jax_make_directions(
        dir_keys, jnp.asarray(chol), grade_dims=(D,), num_repeats=(R,), n_dims=D,
        shared_perm_key=jax.random.fold_in(key, 0x5EED),
    )
    nh, w, sp = (torch.as_tensor(np.array(a)) for a in (nh, w, sp))
    calc = make_batched_calculator(identity_prior, pt_gaussian(D, sigma=SIGMA), D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    kw = pps.key_words(np.asarray(key))
    t, l, n = slice_epoch(calc, cfg, kw, torch.as_tensor(seeds), torch.as_tensor(bound),
                          torch.as_tensor(valid), nh, w)
    t, l, n = t.numpy(), l.numpy(), n.numpy().astype(np.int64)

    # decision-exact: identical nlike and t on every lane, logL to float noise.
    # A lane may only differ if its first divergent probe sat on the contour
    # (|logL - bound| < 1e-5: the two likelihoods sum chi2 in another order).
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

    # the full epoch through the seam reproduces the JAX packed record
    epoch = build_epoch_fn(calc, cfg)
    packed = epoch(kw, torch.as_tensor(seeds), torch.as_tensor(bound),
                   torch.as_tensor(chol), torch.as_tensor(valid), directions=(nh, w, sp))
    cube, theta, phi, logL, nlike = unpack_epoch(packed.numpy(), cfg)
    cube_j, theta_j, phi_j, logL_j, nlike_j = jax_unpack_epoch(packed_j, jcfg)
    good = lane_ok
    np.testing.assert_allclose(cube[good], cube_j[good], rtol=0, atol=2e-6)
    np.testing.assert_allclose(theta[good], theta_j[good], rtol=0, atol=2e-6)
    np.testing.assert_allclose(phi[good], phi_j[good], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(nlike[good], nlike_j[good])
    # invalid lanes: seed kept, logzero, nothing counted
    assert (nlike[:64] == 0).all() and (logL[:64] == np.float32(cfg.logzero)).all()
    np.testing.assert_array_equal(cube[:64], np.broadcast_to(seeds[:64, None], cube[:64].shape))


def test_validate_functor_runs_on_cpu():
    calc = make_batched_calculator(identity_prior, pt_gaussian(D, sigma=SIGMA), D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(3,))
    validate_functor(calc, cfg, torch.device("cpu"))  # raises on a mismatch

