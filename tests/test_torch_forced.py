"""The forced kernel engines ("cuda5", "cuda3", "cuda2") for every model and
dimension the JAX package's "pallas5", "pallas3" and "pallas2" take, on the
CPU.

B3's plain version (``ops/pallas_slice_v5.py::slice_records_packet_plain``)
runs at any D: it is held to the JAX v5 kernel in interpret mode at D = 40
on a Gaussian that is not a zoo model (written once in jnp and once in
torch, the torch form lowered by ``ops/fused_like.py`` so that the plain
version of the fused route, ``Lowered.plain_logL``, scores the probes), and
bitwise to the v4 plain engine at D = 40 and 136 (the wide and stream
buckets).  The generated headers of the forced engines' fused libraries
carry their own define and hash, and leave B1's and the ring's as they
were.  ``resolve_engine`` takes each forced engine for a model the lowering
takes and refuses one it refuses.  The kernels are held to these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychordlite_tpu.ops.directions import make_directions as jax_make_directions
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.ops.slice_kernel import _lane_keys
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.models.examples import gaussian as pt_gaussian
from polychordlite_tpu_torch.ops import fused_like, pallas_slice, pallas_slice_v3, slice_kernel
from polychordlite_tpu_torch.ops import pallas_slice as pps
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice_v5 import slice_epoch_v5, slice_records_packet_plain
from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, slice_records_plain
from polychordlite_tpu_torch.priors import UniformPrior, identity_prior

from test_torch_v5 import _jax_v5_records

torch.set_num_threads(2)

# an anisotropic Gaussian with a centre and a width per coordinate: not a
# model of the zoo (models/examples.py), so it has no device functor.  The
# JAX form makes its centres and widths from an iota inside the kernel (a
# Pallas kernel takes no captured arrays), the torch form captures the same
# float32 values, made by the same float32 operations
D40 = 40
_I = np.arange(D40, dtype=np.float32)
MU = np.float32(0.4) + np.float32(0.2) * _I / np.float32(D40)
SIG = np.float32(0.08) + np.float32(0.04) * (_I % np.float32(5)) / np.float32(5)
NORM = float(-np.sum(np.log(SIG.astype(np.float64))) - D40 * 0.5 * math.log(2 * math.pi))


def jnp_aniso(theta):
    i = jax.lax.iota(jnp.float32, D40)
    mu = 0.4 + 0.2 * i / 40.0
    sig = 0.08 + 0.04 * (i % 5.0) / 5.0
    d = (theta - mu) / sig
    return NORM - 0.5 * jnp.sum(d * d, axis=0), jnp.zeros(1)


def torch_aniso(theta):
    mu, sig = torch.as_tensor(MU), torch.as_tensor(SIG)
    return NORM - 0.5 * torch.sum(((theta - mu) / sig) ** 2)


def _per_point_gaussian(theta):
    """gaussian.ini's likelihood per point (sigma 0.1, mu 0.5, normalised)."""
    D = theta.shape[-1]
    return (-0.5 * torch.sum(((theta - 0.5) / 0.1) ** 2)
            - D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)))


def _vn_gaussian(theta):
    return -0.5 * (torch.linalg.vector_norm(theta - 0.5, dim=-1) / 0.1) ** 2


def test_packet_plain_on_a_lowered_model_decision_exact_with_jax_v5(monkeypatch):
    """The JAX v5 kernel in interpret mode (B = 1024, R = 2, D = 40, the
    JAX tests' shape) against the port's packet plain version scoring the
    probes with the lowering's plain_logL (the plain version of the
    slice_epoch_v5_fused route): identical nlike, |dt| <= 1e-6, logL to
    1e-4 (the sums run in another order; |norm| ~ 69), and fewer than B /
    1000 lanes that differ, each only where its first divergent probe sat
    on the contour."""
    B, R, D = 1024, 2, D40
    key = jax.random.PRNGKey(40)
    rng = np.random.default_rng(40)
    seeds = np.clip(MU + 0.3 * SIG * rng.standard_normal((B, D)), 0, 1).astype(np.float32)
    r0 = 1.5 * math.sqrt(D)
    bound = np.full((B,), NORM - 0.5 * r0 ** 2, np.float32)
    chol = np.broadcast_to(np.diag(SIG).astype(np.float32), (B, D, D)).copy()
    valid = np.arange(B) >= 64
    jcfg = JaxEpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
    jcalc = jax_calculator(lambda c: c, jnp_aniso, D, 1)
    t_j, l_j, n_j = _jax_v5_records(monkeypatch, jcalc, jcfg, key, seeds, bound, chol, valid)
    dir_keys, _ = _lane_keys(key, B, None)
    nh, w, _ = jax_make_directions(
        dir_keys, jnp.asarray(chol), grade_dims=(D,), num_repeats=(R,), n_dims=D,
        shared_perm_key=jax.random.fold_in(key, 0x5EED),
    )
    nh, w = (torch.as_tensor(np.array(a)) for a in (nh, w))
    calc = make_batched_calculator(identity_prior, torch_aniso, D, 0, device="cpu")
    assert calc.device_spec is None
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    kw = pps.key_words(np.asarray(key))
    args = (torch.as_tensor(seeds), torch.as_tensor(bound), torch.as_tensor(valid), nh, w)
    t, l, n = slice_records_packet_plain(low.plain_logL, cfg, kw, *args)
    t, l, n = t.numpy(), l.numpy(), n.numpy().astype(np.int64)
    tol = 1e-4
    lane_ok = ((n == n_j).all(1) & (np.abs(t - t_j) <= 1e-6).all(1)
               & (np.abs(l - l_j) <= tol).all(1))
    bad = np.nonzero(~lane_ok)[0]
    assert len(bad) < B / 1000, f"{len(bad)} lanes differ"
    for b in bad:
        r = int(np.nonzero((n[b] != n_j[b]) | (np.abs(t[b] - t_j[b]) > 1e-6))[0][0])
        assert abs(float(l_j[b, r]) - float(bound[b])) < tol, (b, r)
    assert (n[:64] == 0).all() and (n[64:].sum(1) > 0).all()


@pytest.mark.parametrize("D", [40, 136])
def test_packet_plain_bitwise_the_plain_engine_above_32(D):
    """B3's plain version at D = 40 (the wide bucket) and 136 (the stream
    bucket) bitwise the v4 plain engine (t, logL, nlike), with invalid
    lanes; and slice_epoch_v5 on CPU tensors is that plain version (no D
    bound on the CPU)."""
    B, R, sigma = 256, 3, 0.2
    calc = make_batched_calculator(UniformPrior(0.0, 1.0), pt_gaussian(D, sigma=sigma), D, 2,
                                   device="cpu")
    gen = torch.Generator().manual_seed(D)
    x0 = 0.5 + 0.05 * torch.randn((B, D), generator=gen)
    norm = -D * (math.log(sigma) + 0.5 * math.log(2 * math.pi))
    bound = torch.full((B,), norm - 0.5 * (1.5 * math.sqrt(D)) ** 2)
    valid = torch.arange(B) % 9 != 4
    nh = torch.randn((B, R, D), generator=gen)
    nh = nh / nh.norm(dim=2, keepdim=True)
    w = torch.full((B, R), 0.3)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    args = (x0, bound, valid, nh, w)
    fn = lambda p: calc(p)[2]  # noqa: E731
    got = slice_records_packet_plain(fn, cfg, (3, 4), *args)
    want = slice_records_plain(fn, cfg, (3, 4), *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[2][~valid] == 0).all() and (got[2][valid].sum(1) > 0).all()
    for a, b in zip(slice_epoch_v5(calc, cfg, (3, 4), *args), got):
        assert torch.equal(a, b)


# B1's fused and ring library names for the per-point Gaussian, as they were
# before the forced engines' libraries were added: (D, G) -> (B1, ring)
B1_LIBRARIES = {
    (20, 16): ("slice_epoch_fused_bf829e4c8f26337e", "slice_epoch_fused_ring_30224cf399eb4551"),
    # above D = 32 the functors fold in the lane order (their headers changed with it)
    (64, 32): ("slice_epoch_fused_3e808b5405a7cf99", "slice_epoch_fused_ring_6c8c964bc22026c5"),
    (160, 32): ("slice_epoch_fused_05c76a4ea3ed7fd8", "slice_epoch_fused_ring_991caaa30d0fc1a8"),
}
DEFINES = {"cuda5": "FUSED_V5", "cuda3": "FUSED_V3", "cuda2": "FUSED_V2"}


@pytest.mark.parametrize("D,G", sorted(B1_LIBRARIES))
def test_forced_fused_headers_carry_their_define_and_hash(D, G):
    """Each forced engine's generated header defines its own macro (and no
    other engine's), and its library name carries a prefix and a hash of
    its own; B1's header defines none of them and B1's and the ring's
    library names (the hash of their headers) are pinned: at D = 20 what
    they were before the lane order, above 32 the lane order's."""
    calc = make_batched_calculator(identity_prior, _per_point_gaussian, D, 0, device="cpu")
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low
    assert (low.library_name(G), low.library_name(G, ring=True)) == B1_LIBRARIES[D, G]
    assert low.library_name(G, "ring") == B1_LIBRARIES[D, G][1]
    b1 = low.source(G)
    assert not any(m in b1 for m in ("FUSED_RING", *DEFINES.values()))
    names = {low.library_name(G, e) for e in ("cuda", "ring", *DEFINES)}
    keys = {low.key(G, e) for e in ("cuda", "ring", *DEFINES)}
    assert len(names) == len(keys) == 5
    for engine, macro in DEFINES.items():
        src = low.source(G, engine)
        assert f"#define {macro} 1" in src
        assert not any(m in src for m in ("FUSED_RING", *set(DEFINES.values()) - {macro}))
        # the header is B1's with the define added, nothing else
        assert src.replace(f"#define {macro} 1\n", "") == b1
        assert low.library_name(G, engine) == (
            f"slice_epoch_fused_v{engine[-1]}_{low.key(G, engine)}")
    with pytest.raises(ValueError, match="no fused library"):
        low.source(G, "scan")


@pytest.mark.parametrize("form", ["per_point", "batched"])
def test_resolve_engine_takes_lowered_models_on_the_forced_engines(monkeypatch, form):
    """On a card, each forced engine resolves for a torch model without a
    device form that the lowering takes (per point or batched), its route the
    engine's fused route with the lowering's summary; a model the lowering
    refuses raises on each forced engine, naming the refusal and
    engine='cuda', which takes it on its traced route; precision='highest'
    still raises on the forced engines."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = ns.resolve_device("cuda")
    D = 6
    like = _per_point_gaussian if form == "per_point" else (
        lambda th: -0.5 * torch.sum(((th - 0.5) / 0.1) ** 2, dim=1))
    calc = make_batched_calculator(identity_prior, like, D, 0, device="cpu")
    assert calc.device_spec is None
    for engine, kernel in slice_kernel.FORCED_KERNELS.items():
        assert ns.resolve_engine(engine, cuda, calc) == engine
        assert slice_kernel.epoch_route(engine, calc, cuda) == kernel + "_fused"
        assert "lowered: 1 per-coordinate term(s)" in slice_kernel.route_reason(engine, calc,
                                                                                 cuda)
    refused = make_batched_calculator(identity_prior, _vn_gaussian, D, 0, device="cpu")
    assert ns.resolve_engine("cuda", cuda, refused) == "cuda"
    assert slice_kernel.cuda_route(refused)[0] == "slice_step"
    for engine in slice_kernel.FORCED_KERNELS:
        with pytest.raises(ValueError, match="linalg_vector_norm.*engine='cuda'"):
            ns.resolve_engine(engine, cuda, refused)
        assert "refused" in slice_kernel.route_reason(engine, refused, cuda)
    from polychordlite_tpu_torch.ops.precision import real_dtype_scope

    with real_dtype_scope(torch.float64):
        f64 = make_batched_calculator(identity_prior, like, D, 0, device="cpu")
    for engine in slice_kernel.FORCED_KERNELS:
        with pytest.raises(ValueError, match="precision='highest'"):
            ns.resolve_engine(engine, cuda, f64)


@pytest.mark.parametrize("D", [6, 40])
def test_forced_wrappers_run_their_plain_versions_on_lowered_models(D):
    """On CPU tensors each forced engine's wrapper runs its own plain version
    for a model without a device form (the calc scores the probes), the
    same t, logL and nlike as the plain engine (B5's cube besides), at D =
    6 and 40; the lowering's plain_logL agrees with the calc on the
    accepted logL to the model-form tolerance."""
    B, R = 128, 3
    calc = make_batched_calculator(identity_prior, _per_point_gaussian, D, 0, device="cpu")
    low = fused_like.lowering(calc)
    gen = torch.Generator().manual_seed(D)
    x0 = (0.5 + 0.03 * torch.randn((B, D), generator=gen)).clamp(0, 1)
    valid = torch.arange(B) >= 16
    nh = torch.randn((B, R, D), generator=gen)
    nh = nh / nh.norm(dim=2, keepdim=True)
    w = torch.full((B, R), 0.2)
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    args = (x0, calc(x0)[2] - 2.0, valid, nh, w)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (1, 2), *args)
    got5 = slice_epoch_v5(calc, cfg, (1, 2), *args)
    got3 = pallas_slice_v3.slice_epoch_v3(calc, cfg, (1, 2), *args)
    got2 = pallas_slice.slice_epoch_v2(calc, cfg, (1, 2), *args)
    for k in range(3):
        for got in (got5, got3, got2):
            assert torch.equal(got[k], want[k]), k
    assert got2[3].shape == (B, R, D)
    last = want[1][:, -1]
    kept = valid & (last > cfg.logzero)  # (a forced accept keeps logzero)
    np.testing.assert_allclose(low.plain_logL(got2[3][kept][:, -1]).numpy(),
                               last[kept].numpy(), rtol=1e-5, atol=1e-5)


def test_ptxas_parity_reads_each_kernels_report():
    """experiments/ptxas_parity.py keys ptxas's report by kernel: the lines
    after a kernel's name (stack frame, registers) and nothing of the next
    kernel's."""
    from polychordlite_tpu_torch.experiments import ptxas_parity

    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z1aIiEvv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1aIiEvv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1bv",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 72 registers, used 0 barriers, 528 bytes smem",
    ])
    got = ptxas_parity.kernels(log)
    assert got == {
        "_Z1aIiEvv": ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                      "Used 56 registers, used 0 barriers"],
        "_Z1bv": ["8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
                  "Used 72 registers, used 0 barriers, 528 bytes smem"]}
