"""The speculative-packet slice engine (``ops/pallas_slice_v5.py``) on the CPU.

Its plain version, ``slice_records_packet_plain``, is held to the JAX
package's v5 kernel in interpret mode through the same direction seam and
key words that ``tests/test_torch_kernels.py`` uses for v4, and bitwise to
the port's v4 plain engine on the edge cases of the JAX package's own
v5-against-v4 test (``tests/test_pallas_engine.py:191-198``) and on lanes
stopped by the epoch's budget.  The CUDA kernel is compared with the same
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Deviation from the JAX v5 kernel, by design: the budget of an epoch is
v4's, counted in consumed probes (``EpochConfig.step_cap``), so a budget
may stop a lane inside a packet; JAX v5 counts macro-steps
(``pallas_slice_v5.py:115``).  The budget is never reached by these
configurations in the comparison with JAX, only in the capped-lane case
below, where v5 is held to v4's budget instead.
"""

import math

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
from polychordlite_tpu_torch.models.examples import gaussian, gaussian_shells
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops.directions import make_directions
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice_v4 import slice_epoch, validate_functor
from polychordlite_tpu_torch.ops.pallas_slice_v5 import (
    slice_epoch_v5,
    slice_records_packet_plain,
)
from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, slice_records_plain
from polychordlite_tpu_torch.priors import BlockPrior, PriorBlock, UniformPrior, identity_prior

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


def test_shells_likelihood_matches_jax():
    rng = np.random.default_rng(3)
    for n_dims in (2, 5):
        theta = np.concatenate([
            rng.uniform(-6, 6, (2000, n_dims)),
            np.array([3.5, 0.0] + [0.0] * (n_dims - 2)) + rng.normal(0, 1.2, (2000, n_dims)),
        ]).astype(np.float32)
        want = np.asarray(jax_shells(n_dims)(jnp.asarray(theta.T)))
        got = gaussian_shells(n_dims)(torch.as_tensor(theta)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


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
