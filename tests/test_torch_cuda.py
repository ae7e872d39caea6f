"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here needs an NVIDIA GPU and nvcc; without a CUDA device each
one skips.  The file imports no JAX, so it also runs on a machine without
it, where the repository's conftest (which imports jax) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import polychordlite_tpu_torch as pt  # noqa: E402
from polychordlite_tpu_torch.models import gaussian, gaussian_shells  # noqa: E402
from polychordlite_tpu_torch.models import LIKELIHOODS  # noqa: E402
from polychordlite_tpu_torch.ops import (  # noqa: E402
    fused_like,
    pallas_dirs,
    pallas_slice,
    pallas_slice_v3,
    pallas_slice_v4,
    pallas_slice_v5,
)
from polychordlite_tpu_torch.ops.directions import make_directions  # noqa: E402
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator  # noqa: E402
from polychordlite_tpu_torch.ops.slice_kernel import (  # noqa: E402
    EpochConfig,
    kernel_wrapper,
    slice_records_plain,
)
from polychordlite_tpu_torch.priors import (  # noqa: E402
    BlockPrior,
    GaussianPrior,
    LogUniformPrior,
    PriorBlock,
    UniformPrior,
    identity_prior,
)

from polychordlite_tpu_torch.utils import nvcc  # noqa: E402
from polychordlite_tpu_torch.utils.inifile import read_ini  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 4, 4, 1000), (5, 20, 20, 2048)])
def test_gram_schmidt_kernel_equals_plain(dev, shape):
    g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(0), device=dev)
    before = pallas_dirs.LAUNCHES["gram_schmidt"]
    q = pallas_dirs.gram_schmidt_lanes(g)
    assert pallas_dirs.LAUNCHES["gram_schmidt"] == before + 1
    assert torch.equal(q, pallas_dirs.gram_schmidt_plain(g))


@pytest.mark.parametrize("shape", [(2, 1, 1, 1000), (2, 2, 2, 1000), (3, 3, 3, 999),
                                   (2, 20, 20, 1000), (2, 32, 32, 999),
                                   (2, 20, 20, 512), (5, 20, 20, 8192)])
def test_gram_schmidt_every_dim_equals_plain(dev, shape):
    """The kernel (one instantiation per dim) bitwise the plain version at
    dim 1, 2, 3, 20, 32, at chain counts that are not multiples of a
    block, and at both main-path shapes (gaussian.ini's and the bench's)."""
    g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(shape[1]), device=dev)
    assert torch.equal(pallas_dirs.gram_schmidt_lanes(g), pallas_dirs.gram_schmidt_plain(g))


@pytest.mark.parametrize("prior", [identity_prior, UniformPrior(0.0, 1.0)])
@pytest.mark.parametrize("D,R,B", [(4, 6, 1000), (20, 8, 1024)])
def test_slice_kernel_equals_plain(dev, prior, D, R, B):
    like = gaussian(D, sigma=0.2)
    calc = make_batched_calculator(prior, like, D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    pallas_slice_v4.validate_functor(calc, cfg, dev)
    gen = torch.Generator(dev).manual_seed(D)
    x0 = 0.5 + 0.05 * torch.randn((B, D), generator=gen, device=dev)
    r0 = 1.5 * 0.2 * math.sqrt(D)
    bound = torch.full((B,), like.device_form["norm"] - 0.5 * (r0 / 0.2) ** 2, device=dev)
    valid = torch.arange(B, device=dev) >= 64
    nh, w, _ = make_directions((0.2 * torch.eye(D, device=dev)).expand(B, D, D),
                               grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=gen)
    args = (x0, bound, valid, nh, w)
    got = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[2][:64] == 0).all() and (got[2][64:].sum(1) > 0).all()


def test_kernel_refuses_model_without_device_form(dev):
    calc = make_batched_calculator(identity_prior, lambda th: -(th ** 2).sum(1), 3, 0)
    cfg = EpochConfig(n_dims=3, n_phi=1, grade_dims=(3,), num_repeats=(2,))
    B = 128
    with pytest.raises(ValueError, match="engine='torch'"):
        pallas_slice_v4.slice_epoch(
            calc, cfg, (0, 0), torch.full((B, 3), 0.5, device=dev),
            torch.zeros(B, device=dev), torch.ones(B, dtype=torch.bool, device=dev),
            torch.ones((B, 2, 3), device=dev) / math.sqrt(3), torch.ones((B, 2), device=dev),
        )


def test_run_on_the_card(dev):
    """run() on the card: the kernel engine and the plain engine give the
    same run, since they share directions and agree bit for bit."""
    results = {}
    for engine in ("cuda", "torch"):
        with tempfile.TemporaryDirectory() as base:
            pallas_slice_v4.LAUNCHES["slice_epoch"] = 0
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # a replay divergence would warn
                out = pt.run(gaussian(4), 4, nDerived=2, nlive=100, num_repeats=8,
                             do_clustering=False, read_resume=False, base_dir=base,
                             seed=3, feedback=-1, device="cuda", engine=engine)
            assert (pallas_slice_v4.LAUNCHES["slice_epoch"] > 1) == (engine == "cuda")
            with open(os.path.join(base, "test.metrics.jsonl")) as f:
                assert json.loads(f.read().splitlines()[-1])["chained_epochs"] is True
            assert abs(out.logZ) < 3 * out.logZerr
            results[engine] = (out.ndead, out.logZ, out.logZerr,
                               np.loadtxt(os.path.join(base, "test.txt")))
    assert results["cuda"][:3] == results["torch"][:3]
    np.testing.assert_array_equal(results["cuda"][3], results["torch"][3])


class CappedConfig(EpochConfig):
    """An epoch budget small enough to stop lanes mid-repeat."""

    @property
    def step_cap(self) -> int:
        return 13


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("D", [1, 2, 3, 20, 32])
@pytest.mark.parametrize("G", pallas_slice_v4.GROUPS)
def test_slice_kernel_every_group(dev, G, D, capped):
    """B1 with G lanes per chain, bitwise its plain version and its G = 1
    form, at dimensions below, at and above G, B = 999 chains (not a
    multiple of a warp), invalid lanes, and a budget that stops lanes
    mid-epoch; one launch counted at G."""
    R, B = 6, 999
    like = gaussian(D, sigma=0.2)
    calc = make_batched_calculator(UniformPrior(0.0, 1.0), like, D, 2)
    cfg = (CappedConfig if capped else EpochConfig)(n_dims=D, n_phi=2, grade_dims=(D,),
                                                     num_repeats=(R,))
    gen = torch.Generator(dev).manual_seed(D)
    x0 = 0.5 + 0.05 * torch.randn((B, D), generator=gen, device=dev)
    r0 = 1.5 * 0.2 * math.sqrt(D)
    bound = torch.full((B,), like.device_form["norm"] - 0.5 * (r0 / 0.2) ** 2, device=dev)
    valid = torch.arange(B, device=dev) % 7 != 3
    nh, w, _ = make_directions((0.2 * torch.eye(D, device=dev)).expand(B, D, D),
                               grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=gen)
    args = (x0, bound, valid, nh, w)
    before = pallas_slice_v4.GROUP_LAUNCHES[32, G]
    got = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args, group=G)
    assert pallas_slice_v4.GROUP_LAUNCHES[32, G] == before + 1
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    one = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args, group=1)
    for a, b, c in zip(got, want, one):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert (got[2][~valid] == 0).all()
    assert bool((got[1][valid] == np.float32(cfg.logzero)).any()) == capped


def _group_args(dev, D, R, B):
    like = gaussian(D, sigma=0.2)
    calc = make_batched_calculator(UniformPrior(0.0, 1.0), like, D, 2)
    gen = torch.Generator(dev).manual_seed(D)
    x0 = 0.5 + 0.05 * torch.randn((B, D), generator=gen, device=dev)
    r0 = 1.5 * 0.2 * math.sqrt(D)
    bound = torch.full((B,), like.device_form["norm"] - 0.5 * (r0 / 0.2) ** 2, device=dev)
    valid = torch.arange(B, device=dev) % 7 != 3
    nh, w, _ = make_directions((0.2 * torch.eye(D, device=dev)).expand(B, D, D),
                               grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=gen)
    return calc, (x0, bound, valid, nh, w)


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("D", [1, 2, 3, 20, 32])
@pytest.mark.parametrize("G", pallas_slice_v5.PACKET_GROUPS)
def test_packet_kernel_every_group(dev, G, D, capped):
    """B3 with G = 4 Gs lanes per chain (one packet slot per sub-group)
    bitwise its plain version and its G = 1 form, at B = 999 chains with
    invalid lanes and a budget that stops lanes inside a packet; one launch
    counted at G."""
    R, B = 6, 999
    calc, args = _group_args(dev, D, R, B)
    cfg = (CappedConfig if capped else EpochConfig)(n_dims=D, n_phi=2, grade_dims=(D,),
                                                     num_repeats=(R,))
    before = pallas_slice_v5.GROUP_LAUNCHES[G]
    got = pallas_slice_v5.slice_epoch_v5(calc, cfg, (5, 6), *args, group=G)
    assert pallas_slice_v5.GROUP_LAUNCHES[G] == before + 1
    want = pallas_slice_v5.slice_records_packet_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    one = pallas_slice_v5.slice_epoch_v5(calc, cfg, (5, 6), *args, group=1)
    for k in range(3):
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], one[k]), k
    assert (got[2][~args[2]] == 0).all()
    assert bool((got[1][args[2]] == np.float32(cfg.logzero)).any()) == capped


@pytest.mark.parametrize("caps", [{}, {"max_step": 2, "max_shrink": 3}])
@pytest.mark.parametrize("D", [1, 2, 3, 20, 32])
@pytest.mark.parametrize("G", pallas_slice_v4.GROUPS)
def test_v2_kernel_every_group(dev, G, D, caps):
    """B5 with G lanes per chain on B1's loop under v2's policy, bitwise its
    plain version (cube included) and its G = 1 form, at B = 999 chains with
    invalid lanes (their cube rows the seed); one launch counted at G."""
    R, B = 6, 999
    calc, args = _group_args(dev, D, R, B)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,), **caps)
    before = pallas_slice.GROUP_LAUNCHES[32, G]
    got = pallas_slice.slice_epoch_v2(calc, cfg, (5, 6), *args, group=G)
    assert pallas_slice.GROUP_LAUNCHES[32, G] == before + 1
    want = pallas_slice.slice_records_lockstep_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    one = pallas_slice.slice_epoch_v2(calc, cfg, (5, 6), *args, group=1)
    for k in range(4):
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], one[k]), k
    invalid = ~args[2]
    assert (got[3][invalid] == args[0][invalid][:, None, :]).all()


@pytest.mark.parametrize("cap", [4, 5])
@pytest.mark.parametrize("G", pallas_slice_v4.GROUPS)
def test_v2_kernel_budget_that_binds(dev, G, cap, monkeypatch):
    """v2's per-repeat budget cut to 4 or 5 micro-steps, so that it binds:
    every G gives the records and cube of E3's one-thread counted kernel and
    of its own G = 1 form under that budget, and at 4, one whole body, those
    of the plain version (v2's loop runs whole bodies of 4, so a budget of 5
    is 8 there); a repeat it ends records t = 0 and logzero and keeps x for
    its cube row, and the chain goes on."""
    D, R, B = 3, 6, 999
    calc, args = _group_args(dev, D, R, B)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    lib = pallas_slice._lib()

    def run(entry, ints=(), counts=()):
        cube = torch.empty((R, D, B), device=dev)
        out = pallas_slice_v4.launch_slice_kernel(lib, entry, calc, cfg, (5, 6), *args, cap=cap,
                                                  extra=(cube, *counts), ints=ints)
        return (*out, cube.permute(2, 0, 1))

    got = run("slice_epoch_v2_launch", ints=(G,))
    one = run("slice_epoch_v2_launch", ints=(1,))
    e3 = run("slice_epoch_v2_counted_launch",
             counts=(torch.empty((R, B), dtype=torch.int32, device=dev),
                     torch.zeros(R, dtype=torch.int32, device=dev)))
    monkeypatch.setattr(pallas_slice, "v2_repeat_budget", lambda cfg: cap)
    want = pallas_slice.slice_records_lockstep_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    refs = {"E3": e3, "G1": one}
    if cap % pallas_slice.BODY == 0:
        refs["plain"] = want
    for name, ref in refs.items():
        for k in range(4):
            assert torch.equal(got[k], ref[k]), (name, k)
    t, logL, nlike, cube = got
    valid = args[2]
    ended = valid[:, None] & (t == 0) & (logL == np.float32(cfg.logzero))
    prev = torch.cat([args[0][:, None, :], cube[:, :-1]], 1)
    assert ended.any() and (~ended & valid[:, None]).any()
    assert (cube == prev).all(2)[ended].all()
    assert (nlike[valid][:, -1] > 0).any()  # chains went on to their last repeat


@pytest.mark.parametrize("caps", [{}, {"max_step": 2, "max_shrink": 3}])
@pytest.mark.parametrize("D", [2, 4, 20, 32])
@pytest.mark.parametrize("G", pallas_slice_v4.GROUPS)
def test_v3_kernel_every_group(dev, G, D, caps):
    """B4 with G lanes per chain on B1's loop under v3's policy, bitwise its
    plain version (v3's windowed grid steps), B1 and its G = 1 form, at
    B = 999 chains with invalid lanes; one launch counted at G."""
    R, B = 6, 999
    calc, args = _group_args(dev, D, R, B)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,), **caps)
    before = pallas_slice_v3.GROUP_LAUNCHES[32, G]
    got = pallas_slice_v3.slice_epoch_v3(calc, cfg, (5, 6), *args, group=G)
    assert pallas_slice_v3.GROUP_LAUNCHES[32, G] == before + 1
    want = pallas_slice_v3.slice_records_window_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    b1 = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args)
    one = pallas_slice_v3.slice_epoch_v3(calc, cfg, (5, 6), *args, group=1)
    for k in range(3):
        for ref in (want, b1, one):
            assert torch.equal(got[k], ref[k]), k
    assert (got[2][~args[2]] == 0).all() and (got[2][args[2]].sum(1) > 0).all()


@pytest.mark.parametrize("cap", [4, 8])
@pytest.mark.parametrize("G", pallas_slice_v4.GROUPS)
def test_v3_kernel_budget_that_binds(dev, G, cap, monkeypatch):
    """B4's per-repeat budget cut to one or two bodies of 4 micro-steps, so
    that it binds (at 4 nearly every chain stops, at 8 some do): every G
    gives v2's plain records under the same per-repeat budget cut at each
    chain's first repeat that the budget ended (the chain stops there: every
    later record is t = 0, logzero, nlike 0), and its own G = 1 form.
    v3's own plain version is no reference here: its budget is per grid
    step, not per repeat, and a lane that overruns it loses its repeat to a
    recycled ring slot (ROADMAP C9)."""
    D, R, B = 3, 6, 999
    calc, args = _group_args(dev, D, R, B)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    lib = nvcc.load("slice_epoch_v3", ["slice_epoch_v3.cu"])

    def run(g):
        return pallas_slice_v4.launch_slice_kernel(lib, "slice_epoch_v3_launch", calc, cfg, (5, 6),
                                                   *args, cap=cap, ints=(g,))

    got, one = run(G), run(1)
    monkeypatch.setattr(pallas_slice, "v2_repeat_budget", lambda cfg: cap)
    t, logL, nlike, _ = pallas_slice.slice_records_lockstep_plain(
        lambda p: calc(p)[2], cfg, (5, 6), *args)
    valid = args[2]
    logzero = np.float32(cfg.logzero)
    ended = valid[:, None] & (t == 0) & (logL == logzero)
    first = torch.where(ended.any(1), ended.int().argmax(1), R)  # R: never ended
    after = torch.arange(R, device=dev)[None, :] > first[:, None]
    want = (t.masked_fill(after, 0.0), logL.masked_fill(after, logzero),
            nlike.masked_fill(after, 0))
    for k in range(3):
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], one[k]), k
    stopped = valid & (first < R)
    assert stopped.any() and (first[stopped] > 0).any()
    if cap == 8:  # at 4 nearly every chain meets a repeat that needs more
        assert (valid & (first == R)).any()  # chains that ran to R


@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_packet_resident_warps(dev, name):
    """Every functor's B3 kernel at every G reports the warps an SM keeps
    resident (one warp a block: 1 to 32), and the G it picks by default at
    the bench's 8,192 chains is one that choose_packet_group allows."""
    s, calc = _ini_calc(name, dev)
    D = s.nDims
    warps = {G: pallas_slice_v5.resident_warps(calc, D, dev, G)
             for G in pallas_slice_v5.PACKET_GROUPS}
    assert all(1 <= w <= 32 for w in warps.values()), warps
    G = pallas_slice_v5.packet_group_for(calc, 8192, D, dev)
    assert G == pallas_slice_v5.choose_packet_group(
        8192, D, torch.cuda.get_device_properties(dev).multi_processor_count, warps.get)


@pytest.mark.parametrize("prior", [identity_prior, UniformPrior([0.0] * 4, [1.0] * 4)])
@pytest.mark.parametrize("max_step,max_shrink,capped", [(200, 100, False), (1, 100, False),
                                                        (200, 2, False), (200, 100, True)])
def test_v5_kernel_equals_plain_and_v4(dev, prior, max_step, max_shrink, capped):
    D, R, B = 4, 6, 1000
    like = gaussian(D, sigma=0.2)
    calc = make_batched_calculator(prior, like, D, 2)
    cls = CappedConfig if capped else EpochConfig
    cfg = cls(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,),
              max_step=max_step, max_shrink=max_shrink)
    pallas_slice_v4.validate_functor(calc, cfg, dev, pallas_slice_v5.slice_epoch_v5)
    gen = torch.Generator(dev).manual_seed(D)
    x0 = 0.5 + 0.05 * torch.randn((B, D), generator=gen, device=dev)
    r0 = 1.5 * 0.2 * math.sqrt(D)
    off = 5.0 if max_shrink == 2 else 0.0
    bound = torch.full((B,), like.device_form["norm"] - 0.5 * (r0 / 0.2) ** 2 + off, device=dev)
    valid = torch.arange(B, device=dev) >= 64
    nh, w, _ = make_directions((0.2 * torch.eye(D, device=dev)).expand(B, D, D),
                               grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=gen)
    args = (x0, bound, valid, nh, w)
    before = pallas_slice_v5.LAUNCHES["slice_epoch_v5"]
    got = pallas_slice_v5.slice_epoch_v5(calc, cfg, (5, 6), *args)
    assert pallas_slice_v5.LAUNCHES["slice_epoch_v5"] == before + 1
    plain = pallas_slice_v5.slice_records_packet_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    v4 = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args)
    for a, b, c in zip(got, plain, v4):
        assert torch.equal(a, b) and torch.equal(a, c)


def _shells_calc():
    blocks = [PriorBlock("uniform", (0, 1), (0, 1), (-6.0, 6.0, -2.5, 2.5))]
    return make_batched_calculator(BlockPrior(blocks, 2), gaussian_shells(2), 2, 0)


def test_shells_functor_through_both_kernels(dev):
    calc = _shells_calc()
    B, R = 512, 10
    cfg = EpochConfig(n_dims=2, n_phi=1, grade_dims=(2,), num_repeats=(R,))
    pallas_slice_v4.validate_functor(calc, cfg, dev)
    pallas_slice_v4.validate_functor(calc, cfg, dev, pallas_slice_v5.slice_epoch_v5)
    gen = torch.Generator(dev).manual_seed(1)
    ang = 2 * math.pi * torch.rand(500, generator=gen, device=dev)
    side = torch.where(torch.rand(500, generator=gen, device=dev) < 0.5, -3.5, 3.5)
    rad = 2.0 + 0.1 * torch.randn(500, generator=gen, device=dev)
    th = torch.stack([side + rad * torch.cos(ang), rad * torch.sin(ang)], 1)
    live = (th - torch.tensor([-6.0, -2.5], device=dev)) / torch.tensor([12.0, 5.0], device=dev)
    live_logL = calc(live)[2]
    pick = torch.randint(0, 500, (B,), generator=gen, device=dev)
    other = torch.randint(0, 500, (B,), generator=gen, device=dev)
    bound = torch.minimum(live_logL[pick], live_logL[other])
    valid = torch.arange(B, device=dev) < 504
    chol = torch.linalg.cholesky(torch.cov(live.T)).expand(B, 2, 2)
    nh, w, _ = make_directions(chol, grade_dims=(2,), num_repeats=(R,), n_dims=2, generator=gen)
    args = (live[pick], bound, valid, nh, w)
    b1 = pallas_slice_v4.slice_epoch(calc, cfg, (3, 4), *args)
    b3 = pallas_slice_v5.slice_epoch_v5(calc, cfg, (3, 4), *args)
    plain = slice_records_plain(lambda p: calc(p)[2], cfg, (3, 4), *args)
    for a, b, c in zip(b1, b3, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_shells_run_cuda5_equals_cuda(dev):
    """A 2-D shells run() with clustering gives the same run on the
    speculative kernel as on the v4 kernel."""
    results = {}
    for engine in ("cuda", "cuda5"):
        with tempfile.TemporaryDirectory() as base:
            pallas_slice_v4.LAUNCHES["slice_epoch"] = 0
            pallas_slice_v5.LAUNCHES["slice_epoch_v5"] = 0
            out = pt.run(gaussian_shells(2), 2, prior=UniformPrior([-6.0, -2.5], [6.0, 2.5]),
                         nlive=125, num_repeats=10, read_resume=False, base_dir=base,
                         seed=17, feedback=-1, device="cuda", engine=engine)
            ran = {"cuda": pallas_slice_v4.LAUNCHES["slice_epoch"],
                   "cuda5": pallas_slice_v5.LAUNCHES["slice_epoch_v5"]}
            assert ran[engine] > 1 and sum(ran.values()) == ran[engine]
            with open(os.path.join(base, "test.metrics.jsonl")) as f:
                recs = [json.loads(ln) for ln in f.read().splitlines()]
            assert recs[-1]["engine"] == engine
            assert max(r.get("ncluster", 0) for r in recs) >= 2
            assert abs(out.logZ + math.log(60.0)) < 3 * out.logZerr
            with open(os.path.join(base, "test.txt"), "rb") as f:
                results[engine] = (out.ndead, out.logZ, out.logZerr, f.read())
    assert results["cuda"] == results["cuda5"]


def _ball_args(dev, D, R, B, max_shrink):
    gen = torch.Generator(dev).manual_seed(D + R)
    like = gaussian(D, sigma=0.2)
    x0 = 0.5 + 0.05 * torch.randn((B, D), generator=gen, device=dev)
    r0 = 1.5 * 0.2 * math.sqrt(D)
    off = 3.0 if max_shrink < 100 else 0.0
    bound = torch.full((B,), like.device_form["norm"] - 0.5 * (r0 / 0.2) ** 2 + off, device=dev)
    valid = torch.arange(B, device=dev) >= 64
    nh, w, _ = make_directions((0.2 * torch.eye(D, device=dev)).expand(B, D, D),
                               grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=gen)
    return like, (x0, bound, valid, nh, w)


@pytest.mark.parametrize("caps", [{}, {"max_step": 2, "max_shrink": 3}])
@pytest.mark.parametrize("D,R,B", [(4, 6, 1000), (20, 8, 1024)])
def test_v3_v2_and_counted_kernels(dev, D, R, B, caps):
    """B4, B5 and E1 against their plain versions and against B1, bit for
    bit (B5's cube too; against B1's rebuilt cube to float noise)."""
    like, args = _ball_args(dev, D, R, B, caps.get("max_shrink", 100))
    calc = make_batched_calculator(UniformPrior(0.0, 1.0), like, D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,), **caps)
    kw = (7, 8)
    fn = lambda p: calc(p)[2]  # noqa: E731
    b1 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
    before = {**pallas_slice.LAUNCHES, **pallas_slice_v3.LAUNCHES, **pallas_slice_v4.LAUNCHES}
    b4 = pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args)
    b5 = pallas_slice.slice_epoch_v2(calc, cfg, kw, *args)
    e1 = pallas_slice_v4.slice_epoch_counted(calc, cfg, kw, *args)
    after = {**pallas_slice.LAUNCHES, **pallas_slice_v3.LAUNCHES, **pallas_slice_v4.LAUNCHES}
    assert {k: after[k] - before[k] for k in after} == {
        "slice_epoch_v2": 1, "slice_epoch_v3": 1, "slice_epoch": 0, "slice_epoch_counted": 1,
        "slice_epoch_v2_counted": 0, "slice_step": 0, "slice_epoch_fused": 0,
        "slice_step_f64": 0, "slice_epoch_fused_f64": 0, "slice_step_graded": 0,
        "slice_step_graded_f64": 0, "slice_step_host": 0, "slice_step_host_f64": 0}
    plain4 = slice_records_plain(fn, cfg, kw, *args, count_steps=True)
    plain3 = pallas_slice_v3.slice_records_window_plain(fn, cfg, kw, *args)
    plain2 = pallas_slice.slice_records_lockstep_plain(fn, cfg, kw, *args)
    for k in range(3):
        for got in (b4[k], b5[k], e1[k], plain4[k], plain3[k], plain2[k]):
            assert torch.equal(got, b1[k]), k
    assert torch.equal(b5[3], plain2[3])
    rebuilt = args[0][:, None, :] + torch.cumsum(b1[0][:, :, None] * args[3], dim=1)
    assert (b5[3] - rebuilt).abs().max().item() <= 2e-6
    assert torch.equal(e1[3], plain4[3])
    assert torch.equal(e1[4], pallas_slice_v4.warp_maxima(plain4[3]))
    assert bool((b1[1][64:] == np.float32(cfg.logzero)).any()) == bool(caps)


def _ini_calc(name, dev):
    s, blocks, *_ = read_ini(os.path.join(REPO, "ini", f"{name}.ini"))
    calc = make_batched_calculator(BlockPrior(blocks, s.nDims), LIKELIHOODS[name](s.nDims),
                                   s.nDims, s.nDerived)
    return s, calc


@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_every_functor_through_every_kernel(dev, name):
    """Each likelihood's functor against its torch calc through all four
    kernels and B1, B3, B4 and B5 at every group size, and one epoch of B1 at
    every group size at the ini's dimension against the plain engine on a
    live set of the ini's prior."""
    s, calc = _ini_calc(name, dev)
    D, R, B = s.nDims, 4, 256
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    for engine in ("cuda", "cuda3", "cuda2", "cuda5"):
        pallas_slice_v4.validate_functor(calc, cfg, dev, kernel_wrapper(engine))
    for G in pallas_slice_v4.GROUPS:  # B1, B4 and B5 at every group size
        for wrapper in (pallas_slice_v4.slice_epoch, pallas_slice_v3.slice_epoch_v3,
                        pallas_slice.slice_epoch_v2):
            pallas_slice_v4.validate_functor(calc, cfg, dev, functools.partial(wrapper, group=G))
    for G in pallas_slice_v5.PACKET_GROUPS:  # B3 at every group size
        pallas_slice_v4.validate_functor(
            calc, cfg, dev, functools.partial(pallas_slice_v5.slice_epoch_v5, group=G))
    gen = torch.Generator(dev).manual_seed(11)
    live = torch.rand((400, D), generator=gen, device=dev)
    live_logL = calc(live)[2]
    pick = torch.randint(0, 400, (B,), generator=gen, device=dev)
    other = torch.randint(0, 400, (B,), generator=gen, device=dev)
    bound = torch.minimum(live_logL[pick], live_logL[other])
    chol = torch.linalg.cholesky(torch.cov(live.T).reshape(D, D)).expand(B, D, D)
    nh, w, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=gen)
    args = (live[pick], bound, torch.ones(B, dtype=torch.bool, device=dev), nh, w)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (1, 2), *args)
    for G in pallas_slice_v4.GROUPS:
        got = pallas_slice_v4.slice_epoch(calc, cfg, (1, 2), *args, group=G)
        for a, b in zip(got, want):
            assert torch.equal(a, b), G


def test_cli_runs_on_the_card_by_default(dev, tmp_path):
    """``python -m polychordlite_tpu_torch`` with no --device runs on the
    card, on the v4 kernel."""
    src = open(os.path.join(REPO, "ini", "himmelblau.ini")).read()
    src = (src.replace("nlive = 500", "nlive = 100")
           .replace("base_dir = chains", f"base_dir = {tmp_path}")
           .replace("feedback = 1", "feedback = 0\nmax_ndead = 400\nseed = 4"))
    ini = tmp_path / "himmelblau.ini"
    ini.write_text(src)
    out = subprocess.run([sys.executable, "-m", "polychordlite_tpu_torch", str(ini)],
                         capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "himmelblau.metrics.jsonl") as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["engine"] == "cuda" and last["kernel_launches"]["slice_epoch"] > 0


# ---- the structure-cost studies: E2, E3, E6, E7 ------------------------

from polychordlite_tpu_torch.experiments import (  # noqa: E402
    prof_grid_overhead,
    prof_pallas_while,
    v3_instr,
)

# (B, R, B_valid): small, the shape run() gives on gaussian.ini, the bench
STUDY_GEOMETRIES = {"small": (1024, 8, 960), "gaussian_ini": (512, 40, 504),
                    "bench": (8192, 100, 8192)}


def _study_args(dev, tag):
    B, R, B_valid = STUDY_GEOMETRIES[tag]
    D = 20
    like, (x0, bound, _, nh, w) = _ball_args(dev, D, R, B, 100)
    valid = torch.arange(B, device=dev) < B_valid
    calc = make_batched_calculator(identity_prior, like, D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    return calc, cfg, (x0, bound, valid, nh, w)


@pytest.mark.parametrize("tag", sorted(STUDY_GEOMETRIES))
def test_v3_instr_and_counted_v2_kernels(dev, tag):
    """E2 (cooperative v3, body counts) and E3 (counted B5) against their
    plain versions and against B4, B5 and B1, bit for bit; E2's skeleton
    runs one body per step."""
    calc, cfg, args = _study_args(dev, tag)
    kw = (9, 10)
    fn = lambda p: calc(p)[2]  # noqa: E731
    b1 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
    b4 = pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args)
    b5 = pallas_slice.slice_epoch_v2(calc, cfg, kw, *args)
    before = (v3_instr.LAUNCHES["slice_epoch_v3_instr"],
              pallas_slice.LAUNCHES["slice_epoch_v2_counted"])
    e2 = v3_instr.slice_epoch_v3_instr(calc, cfg, kw, *args)
    e3 = pallas_slice.slice_epoch_v2_counted(calc, cfg, kw, *args)
    assert (v3_instr.LAUNCHES["slice_epoch_v3_instr"],
            pallas_slice.LAUNCHES["slice_epoch_v2_counted"]) == (before[0] + 1, before[1] + 1)
    plain3 = pallas_slice_v3.slice_records_window_plain(fn, cfg, kw, *args, count_iters=True)
    plain2 = pallas_slice.slice_records_lockstep_plain(fn, cfg, kw, *args, count_steps=True)
    for k in range(3):
        for got in (e2[k], e3[k], b4[k], plain3[k]):
            assert torch.equal(got, b1[k]), k
    assert torch.equal(e2[3], plain3[3])
    for got, want in zip(e3, plain2):
        assert torch.equal(got, want)
    assert torch.equal(e3[3], b5[3])
    cheap = v3_instr.slice_epoch_v3_instr(calc, cfg, kw, *args, cheap=True)
    assert (cheap[3] == 1).all() and (cheap[2] == 0).all() and (cheap[0] == 0).all()


@pytest.mark.parametrize("G", [1, 2, 8, 32])
def test_v3_instr_refuses_a_grid_that_is_not_co_resident(dev, G):
    """At G lanes per chain, one block of 32 lanes more than 132 SMs x 32
    resident blocks can hold: co_resident says no, and the cooperative
    launch raises instead of hanging at its barrier."""
    B = (132 * 32 + 1) * 32 // G
    like = gaussian(2, sigma=0.2)
    calc = make_batched_calculator(identity_prior, like, 2, 2)
    cfg = EpochConfig(n_dims=2, n_phi=2, grade_dims=(2,), num_repeats=(1,))
    args = (torch.full((B, 2), 0.5, device=dev), torch.zeros(B, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev),
            torch.ones((B, 1, 2), device=dev) / math.sqrt(2), torch.ones((B, 1), device=dev))
    assert not v3_instr.co_resident(calc, B, 2, dev, G)
    with pytest.raises(RuntimeError, match="resident"):
        v3_instr.slice_epoch_v3_instr(calc, cfg, (1, 2), *args, group=G)


@pytest.mark.parametrize("D,R,B", [(4, 6, 1000), (20, 8, 1024)])
@pytest.mark.parametrize("G", pallas_slice_v4.GROUPS)
def test_v3_instr_every_group(dev, G, D, R, B):
    """E2 with G lanes per chain (every grid co-resident at these shapes):
    iters bitwise its plain version's, t, logL and nlike bitwise the plain
    version's, B4's at the same G and B1's."""
    like, args = _ball_args(dev, D, R, B, 100)
    calc = make_batched_calculator(UniformPrior(0.0, 1.0), like, D, 2)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    kw = (9, 10)
    assert v3_instr.co_resident(calc, B, D, dev, G)
    got = v3_instr.slice_epoch_v3_instr(calc, cfg, kw, *args, group=G)
    want = pallas_slice_v3.slice_records_window_plain(lambda p: calc(p)[2], cfg, kw, *args,
                                                      count_iters=True)
    b4 = pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args, group=G)
    b1 = pallas_slice_v4.slice_epoch(calc, cfg, kw, *args)
    for k in range(4):
        assert torch.equal(got[k], want[k]), k
    for k in range(3):
        assert torch.equal(got[k], b4[k]) and torch.equal(got[k], b1[k]), k
    assert (got[3] >= 1).all() and (got[2][64:].sum(1) > 0).all()


@pytest.mark.parametrize("variant", prof_grid_overhead.VARIANTS)
def test_grid_steps_kernel_equals_plain(dev, variant):
    stream, head, x0 = prof_grid_overhead.grid_inputs(dev, 7, 5, 8, ones=False, seed=3)
    got = prof_grid_overhead.grid_steps(variant, stream, head, x0)
    assert torch.equal(got, prof_grid_overhead.grid_steps_plain(variant, stream, head, x0))


@pytest.mark.parametrize("variant", prof_pallas_while.VARIANTS)
def test_while_loop_kernel_equals_plain(dev, variant):
    x = torch.rand((64, 128), generator=torch.Generator(dev).manual_seed(5), device=dev)
    x = 0.2 + 0.6 * x  # body20's contour crosses this range
    got = prof_pallas_while.while_loop(variant, x, 700)
    assert torch.equal(got, prof_pallas_while.while_loop_plain(variant, x, 700))


# ---- the prototypes: E4 (whole epoch) and E5 (one repeat) ----------------

from polychordlite_tpu_torch.experiments import (  # noqa: E402
    pallas_epoch_v2,
    pallas_slice_repeat,
)


@pytest.mark.parametrize("D,S,R", [(4, 2, 5), (20, 8, 8)])
def test_proto_epoch_kernel_equals_plain(dev, D, S, R):
    """E4 against its lockstep plain version on the card, bit for bit:
    cube, logL and nlike; one launch counted."""
    args = pallas_epoch_v2.study_inputs(dev, D, S, R, seed=D)
    seed = torch.tensor([31], dtype=torch.int32, device=dev)
    before = pallas_epoch_v2.LAUNCHES["proto_epoch"]
    got = pallas_epoch_v2.proto_epoch(seed, *args)
    assert pallas_epoch_v2.LAUNCHES["proto_epoch"] == before + 1
    want = pallas_epoch_v2.proto_epoch_plain(seed, *args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert (got[1] > -1e30).float().mean() > 0.9


@pytest.mark.parametrize("D,nb", [(4, 1), (20, 2)])
def test_proto_repeat_kernel_equals_plain(dev, D, nb):
    """E5 against its plain version on the card, bit for bit, one repeat
    and a chain of five launches (seed + r, the cube carried)."""
    x0, nh, w, bound = pallas_slice_repeat.study_inputs(dev, D, nb, seed=D)
    seed = torch.tensor([17], dtype=torch.int32, device=dev)
    got = pallas_slice_repeat.proto_repeat(seed, x0, nh, w, bound)
    want = pallas_slice_repeat.proto_repeat_plain(seed, x0, nh, w, bound)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    xs, xp = x0, x0
    for r in range(5):
        xs, ls, ns = pallas_slice_repeat.proto_repeat(seed + r, xs, nh, w, bound)
        xp, lp, n_p = pallas_slice_repeat.proto_repeat_plain(seed + r, xp, nh, w, bound)
        assert torch.equal(xs, xp) and torch.equal(ls, lp) and torch.equal(ns, n_p)


def test_prototype_wrappers_raise_on_other_devices(dev):
    seed = torch.tensor([1], dtype=torch.int32, device=dev)
    args = [a.to("meta") for a in pallas_epoch_v2.study_inputs(dev, 4, 1, 1)]
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_epoch_v2.proto_epoch(seed, *args)
    args = [a.to("meta") for a in pallas_slice_repeat.study_inputs(dev, 4, 1)]
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_slice_repeat.proto_repeat(seed, *args)
    x0, nh, w, bound = pallas_slice_repeat.study_inputs(dev, 4, 1)
    with pytest.raises(ValueError, match="is on cpu"):
        pallas_slice_repeat.proto_repeat(seed, x0, nh, w.cpu(), bound)


# ---- B1's route for a likelihood evaluated in torch (csrc/slice_step.cu)
def _unit_directions(gen, dev, B, R, D):
    """Unit directions without B2."""
    nh = torch.randn((B, R, D), generator=gen, device=dev)
    return nh / nh.norm(dim=2, keepdim=True), torch.full((B, R), 0.3, device=dev)


def _quickstart(theta):
    r2 = torch.sum(theta ** 2)
    return -2.0 * math.log(2 * math.pi * 0.01) - r2 / 2 / 0.01, [r2]


@pytest.mark.parametrize("rounds", [1, 7, 32])
@pytest.mark.parametrize("model", ["per_point", "batched", "zoo", "gaussian_prior_d40"])
def test_traced_route_equals_plain(dev, model, rounds):
    """The kernel route against the plain engine bit for bit, for a per-point
    and a batched torch model, a zoo model (also B1's records), and a model
    beyond B1's SLICE_MAXD (D = 40, a non-affine prior)."""
    D, R, B = {"per_point": (4, 6, 1000), "batched": (20, 8, 1024), "zoo": (20, 8, 1024),
               "gaussian_prior_d40": (40, 4, 700)}[model]
    prior, like, nd = {
        "per_point": (UniformPrior(-1, 1), _quickstart, 1),
        "batched": (identity_prior, lambda th: -0.5 * (((th - 0.5) / 0.1) ** 2).sum(-1), 0),
        "zoo": (identity_prior, gaussian(D), 2),
        "gaussian_prior_d40": (GaussianPrior(0.5, 0.2),
                               lambda th: -0.5 * (((th - 0.5) / 0.1) ** 2).sum(-1), 0),
    }[model]
    calc = make_batched_calculator(prior, like, D, nd, device=dev)
    assert calc.form == ("per_point" if model == "per_point" else "batched")
    gen = torch.Generator(dev).manual_seed(D + rounds)
    x0 = (0.5 + 0.02 * torch.randn((B, D), generator=gen, device=dev)).clamp(0, 1)
    bound = calc(x0)[2] - 2.0
    valid = torch.arange(B, device=dev) >= 64
    nh, w = _unit_directions(gen, dev, B, R, D)
    w = w * 0.1
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    args = (x0, bound, valid, nh, w)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (9, 10), *args)
    before = pallas_slice_v4.LAUNCHES["slice_step"]
    got = pallas_slice_v4.slice_epoch_traced(calc, cfg, (9, 10), *args, rounds=rounds)
    assert pallas_slice_v4.LAUNCHES["slice_step"] > before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (want[2][:64] == 0).all() and (want[2][64:].sum(1) > 0).all()
    if model == "zoo":  # the same decisions as B1's functor kernel
        for a, b in zip(pallas_slice_v4.slice_epoch(calc, cfg, (9, 10), *args), want):
            assert torch.equal(a, b)


def test_traced_route_block_prior_copies_nothing_from_the_host(dev):
    """A block layout without an affine form (Gaussian blocks) runs inside
    the CUDA graph: its parameters and indices stay on the card."""
    blocks = [PriorBlock("gaussian", (0, 1), (1, 0), (0.5, 0.1)),
              PriorBlock("uniform", (2,), (2,), (0.0, 1.0))]
    calc = make_batched_calculator(BlockPrior(blocks, 3), lambda th: -(th ** 2).sum(-1), 3, 0,
                                   device=dev)
    assert calc.device_spec is None and calc.form == "batched"
    B, R = 256, 3
    gen = torch.Generator(dev).manual_seed(0)
    x0 = (0.5 + 0.05 * torch.randn((B, 3), generator=gen, device=dev)).clamp(0, 1)
    nh, w = _unit_directions(gen, dev, B, R, 3)
    args = (x0, calc(x0)[2] - 1.0, torch.ones(B, dtype=torch.bool, device=dev), nh, w)
    cfg = EpochConfig(n_dims=3, n_phi=1, grade_dims=(3,), num_repeats=(R,))
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (1, 2), *args)
    for a, b in zip(pallas_slice_v4.slice_epoch_traced(calc, cfg, (1, 2), *args), want):
        assert torch.equal(a, b)


def test_traced_route_refuses_a_likelihood_that_syncs(dev):
    """A likelihood that reads a value back to the host cannot be captured:
    the route raises, naming the plain engine, and runs nothing uncaptured."""
    def syncing(th):
        if float(th.sum().item()) > 1e30:
            return th.sum(-1)
        return -0.5 * ((th - 0.5) ** 2).sum(-1)

    calc = make_batched_calculator(identity_prior, syncing, 3, 0, device=dev)
    assert calc.form == "batched"
    cfg = EpochConfig(n_dims=3, n_phi=1, grade_dims=(3,), num_repeats=(2,))
    B = 128
    with pytest.raises(ValueError, match="engine='torch'"):
        pallas_slice_v4.slice_epoch_traced(
            calc, cfg, (0, 0), torch.full((B, 3), 0.5, device=dev),
            torch.full((B,), -10.0, device=dev), torch.ones(B, dtype=torch.bool, device=dev),
            torch.ones((B, 2, 3), device=dev) / math.sqrt(3), torch.ones((B, 2), device=dev))
    callback = make_batched_calculator(
        identity_prior, lambda th: float(-np.sum(np.asarray(th) ** 2)), 3, 0)
    with pytest.raises(ValueError, match="engine='torch'"):
        pallas_slice_v4.slice_epoch_traced(
            callback, cfg, (0, 0), torch.full((B, 3), 0.5, device=dev),
            torch.full((B,), -10.0, device=dev), torch.ones(B, dtype=torch.bool, device=dev),
            torch.ones((B, 2, 3), device=dev) / math.sqrt(3), torch.ones((B, 2), device=dev))


def test_quickstart_runs_on_the_card(dev, monkeypatch):
    """The per-point torch quickstart through run(): on the fused route
    (B1 with the lowered likelihood) and B2, and with the lowering refused
    on the traced route and B2, the same run as the plain engine's on the
    card; chained epochs kept (their replay check holds), each within
    3 sigma of -4 log 2."""
    results = {}
    for engine in ("auto", "traced", "torch"):
        with monkeypatch.context() as m:
            if engine == "traced":
                m.setattr(fused_like, "lowering", lambda calc: fused_like.Refused("forced"))
            with tempfile.TemporaryDirectory() as base:
                with warnings.catch_warnings():
                    warnings.simplefilter("error")  # a replay divergence would warn
                    out = pt.run(_quickstart, 4, nDerived=1, prior=UniformPrior(-1, 1),
                                 nlive=100, num_repeats=8, do_clustering=False,
                                 read_resume=False, base_dir=base, seed=5, feedback=-1,
                                 device="cuda", engine="torch" if engine == "torch" else "auto")
                with open(os.path.join(base, "test.metrics.jsonl")) as f:
                    last = json.loads(f.read().splitlines()[-1])
                results[engine] = (out.ndead, out.logZ, out.logZerr,
                                   np.loadtxt(os.path.join(base, "test.txt")))
        assert last["form"] == "per_point" and last["chained_epochs"] is True
        ran = last["kernel_launches"]
        if engine == "auto":
            assert last["engine"] == "cuda" and last["route"] == "slice_epoch_fused"
            assert ran["slice_epoch_fused"] > 0 and ran["gram_schmidt"] > 0
            assert ran["slice_epoch"] == ran["slice_step"] == 0
        if engine == "traced":
            assert last["route"] == "slice_step" and last["route_reason"] == "forced"
            assert ran["slice_step"] > 0 and last["traced_route"]["replays"] > 0
            assert ran["slice_epoch_fused"] == 0
        assert abs(out.logZ + 4 * math.log(2.0)) < 3 * out.logZerr
    assert results["traced"][:3] == results["torch"][:3]
    np.testing.assert_array_equal(results["traced"][3], results["torch"][3])


# ---- B1 with a likelihood lowered from torch (csrc/slice_epoch_fused.cu)
def _fused_models(D, dev):
    """Models for the fused route: gaussian.ini's likelihood in batched
    torch, the per-point quickstart (D = 4), a Gaussian likelihood under
    GaussianPrior (the prior's erfinv lowered into the body), a correlated
    Gaussian (a (D, D) constant), every library call of the op table, and
    a LogUniformPrior (a number to a tensor's power)."""
    def calls(th):
        u = (th - 0.5) * 4.0
        v = (torch.exp(-u * u) + torch.log1p(th) - torch.log(th + 0.1) + torch.expm1(-th)
             + torch.sin(u) * torch.cos(u) + torch.tanh(u) + torch.sqrt(th) + torch.rsqrt(th + 1.0)
             + (th + 0.5) ** 1.5 + torch.special.ndtri(th.clamp(0.01, 0.99)))
        return torch.logsumexp(-v * v, -1) - (u * u).sum(-1)

    a = np.random.default_rng(D).normal(size=(D, D))
    cov = torch.tensor(0.01 * (a @ a.T / D + np.eye(D)), dtype=torch.float32, device=dev)
    return {
        "gaussian_ini": (identity_prior, lambda th: -0.5 * (((th - 0.5) ** 2).sum(-1)) / 0.01),
        "quickstart": (UniformPrior(-1, 1), _quickstart),
        "gaussian_prior": (GaussianPrior(0.5, 0.2),
                           lambda th: -0.5 * (((th - 0.5) / 0.1) ** 2).sum(-1)),
        "correlated": (identity_prior,
                       lambda th: -0.5 * ((th - 0.5) @ torch.linalg.inv(cov) @ (th - 0.5))),
        "library_calls": (identity_prior, calls),
        "log_uniform": (LogUniformPrior(0.1, 10.0),
                        lambda th: -0.5 * (((th - 2.0) / 0.5) ** 2).sum(-1)),
    }


@pytest.mark.parametrize("model", ["gaussian_ini", "quickstart", "gaussian_prior", "correlated",
                                   "library_calls", "log_uniform"])
def test_fused_kernel_every_group_equals_plain(dev, model):
    """The fused kernel at every G, its libraries built in parallel, bitwise
    its plain version (slice_records_plain on Lowered.plain_logL), with
    invalid lanes; the zoo's own Gaussian also bitwise B1's functor."""
    D = {"quickstart": 4, "correlated": 6, "library_calls": 6, "log_uniform": 5}.get(model, 20)
    prior, like = _fused_models(D, dev)[model]
    nd = 1 if model == "quickstart" else 0
    calc = make_batched_calculator(prior, like, D, nd, device=dev)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low
    B, R = 1000, 6
    gen = torch.Generator(dev).manual_seed(D)
    x0 = (0.5 + 0.02 * torch.randn((B, D), generator=gen, device=dev)).clamp(0, 1)
    bound = low.plain_logL(x0) - 2.0
    valid = torch.arange(B, device=dev) >= 64
    nh, w = _unit_directions(gen, dev, B, R, D)
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    args = (x0, bound, valid, nh, w * 0.1)
    want = slice_records_plain(low.plain_logL, cfg, (9, 10), *args)
    groups = [G for G in pallas_slice_v4.GROUPS if G <= 32]
    low.build(groups)
    for G in groups:
        before = pallas_slice_v4.LAUNCHES["slice_epoch_fused"]
        got = pallas_slice_v4.slice_epoch_fused(calc, cfg, (9, 10), *args, group=G)
        assert pallas_slice_v4.LAUNCHES["slice_epoch_fused"] == before + 1
        for k, a, b in zip(("t", "logL", "nlike"), got, want):
            assert torch.equal(a, b), (G, k, int((a != b).sum()))
    assert (want[2][:64] == 0).all() and (want[2][64:].sum(1) > 0).all()
    pallas_slice_v4.validate_fused(calc, cfg, dev, pallas_slice_v4.choose_group(
        B, D, torch.cuda.get_device_properties(dev).multi_processor_count))


def test_fused_kernel_of_the_zoo_gaussian_equals_b1(dev):
    """The zoo's Gaussian lowered from its torch form does B1's functor's
    operations in its order: the fused kernel gives B1's records."""
    D, B, R = 20, 1024, 8
    calc = make_batched_calculator(identity_prior, gaussian(D), D, 2, device=dev)
    assert calc.device_spec is not None
    low = fused_like.lower(calc)  # the lowering takes any torch model
    calc.__dict__["fused"] = low
    gen = torch.Generator(dev).manual_seed(3)
    x0 = (0.5 + 0.02 * torch.randn((B, D), generator=gen, device=dev)).clamp(0, 1)
    nh, w = _unit_directions(gen, dev, B, R, D)
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    args = (x0, calc(x0)[2] - 2.0, torch.ones(B, dtype=torch.bool, device=dev), nh, w * 0.1)
    for a, b in zip(pallas_slice_v4.slice_epoch_fused(calc, cfg, (1, 2), *args),
                    pallas_slice_v4.slice_epoch(calc, cfg, (1, 2), *args)):
        assert torch.equal(a, b)


def test_fused_build_failure_raises(dev, monkeypatch):
    """A generated functor that does not compile raises from nvcc; nothing
    falls back to the traced route."""
    calc = make_batched_calculator(identity_prior, lambda th: -(th ** 2).sum(-1) * 1.25, 3, 0,
                                   device=dev)
    low = fused_like.lowering(calc)
    monkeypatch.setattr(type(low), "emit_functor", lambda self: "struct FusedLike { broken };")
    B = 64
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernel_wrapper("cuda")(
            calc, EpochConfig(n_dims=3, n_phi=1, grade_dims=(3,), num_repeats=(1,)), (0, 0),
            torch.full((B, 3), 0.5, device=dev), torch.full((B,), -10.0, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev),
            torch.ones((B, 1, 3), device=dev) / math.sqrt(3), torch.ones((B, 1), device=dev))


# ---- the wide bucket: 32 < D <= 128 (csrc/slice_epoch.cuh, csrc/gram_schmidt.cu)
WIDE_D = [33, 40, 64, 100, 128]
WIDE_GROUPS = pallas_slice_v4.BUCKET_GROUPS[pallas_slice_v4.SLICE_MAXD_WIDE]


@pytest.mark.parametrize("dim", WIDE_D)
def test_gram_schmidt_wide_kernel_equals_plain(dev, dim):
    """B2's warp-per-basis kernel above dim 32 bitwise its plain version (the
    kernel's order of summation), at a chain count that is not a multiple
    of a warp; one launch counted as the wide kernel's."""
    g = torch.randn((2, dim, dim, 300), generator=torch.Generator(dev).manual_seed(dim),
                    device=dev)
    before = dict(pallas_dirs.LAUNCHES)
    q = pallas_dirs.gram_schmidt_lanes(g)
    assert pallas_dirs.LAUNCHES["gram_schmidt_wide"] == before["gram_schmidt_wide"] + 1
    assert pallas_dirs.LAUNCHES["gram_schmidt"] == before["gram_schmidt"]
    assert torch.equal(q, pallas_dirs.gram_schmidt_plain(g))
    eye = torch.eye(dim, device=dev)[None, :, :, None]
    assert (torch.einsum("nikb,nijb->nkjb", q, q) - eye).abs().max() < 1e-5
    assert pallas_dirs._lib().gram_schmidt_max_dim() == pallas_dirs.MAXD


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("D", WIDE_D)
@pytest.mark.parametrize("G", WIDE_GROUPS)
def test_wide_slice_kernel_every_group(dev, G, D, capped):
    """B1 in the 128 bucket (the terms staged in shared memory) at each of
    its G, bitwise its plain version and G = 32, at B = 999 chains with
    invalid lanes and a budget that stops lanes mid-epoch; one launch
    counted at (128, G); G = 8 is not instantiated and raises."""
    R, B = 4, 999
    calc, args = _group_args(dev, D, R, B)
    cfg = (CappedConfig if capped else EpochConfig)(n_dims=D, n_phi=2, grade_dims=(D,),
                                                     num_repeats=(R,))
    before = pallas_slice_v4.GROUP_LAUNCHES[128, G]
    got = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args, group=G)
    assert pallas_slice_v4.GROUP_LAUNCHES[128, G] == before + 1
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    g32 = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args, group=32)
    for a, b, c in zip(got, want, g32):
        assert torch.equal(a, b) and torch.equal(a, c)
    valid = args[2]
    assert (got[2][~valid] == 0).all() and (got[2][valid].sum(1) > 0).all()
    assert bool((got[1][valid] == np.float32(cfg.logzero)).any()) == capped
    with pytest.raises(ValueError, match="not one of"):
        pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args, group=8)


@pytest.mark.parametrize("D", WIDE_D)
@pytest.mark.parametrize("G", WIDE_GROUPS)
def test_wide_v2_v3_kernels_every_group(dev, G, D):
    """B5 (v2's policy, cube included) and B4 (v3's) in the 128 bucket at
    each of its G, bitwise their plain versions and G = 32, B4 also B1."""
    R, B = 4, 999
    calc, args = _group_args(dev, D, R, B)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    before = (pallas_slice.GROUP_LAUNCHES[128, G], pallas_slice_v3.GROUP_LAUNCHES[128, G])
    v2 = pallas_slice.slice_epoch_v2(calc, cfg, (5, 6), *args, group=G)
    v3 = pallas_slice_v3.slice_epoch_v3(calc, cfg, (5, 6), *args, group=G)
    assert (pallas_slice.GROUP_LAUNCHES[128, G], pallas_slice_v3.GROUP_LAUNCHES[128, G]) == (
        before[0] + 1, before[1] + 1)
    v2_want = pallas_slice.slice_records_lockstep_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    v2_32 = pallas_slice.slice_epoch_v2(calc, cfg, (5, 6), *args, group=32)
    for k in range(4):
        assert torch.equal(v2[k], v2_want[k]) and torch.equal(v2[k], v2_32[k]), k
    v3_want = pallas_slice_v3.slice_records_window_plain(lambda p: calc(p)[2], cfg, (5, 6),
                                                          *args)
    refs = (v3_want, pallas_slice_v3.slice_epoch_v3(calc, cfg, (5, 6), *args, group=32),
            pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args, group=G))
    for k in range(3):
        for ref in refs:
            assert torch.equal(v3[k], ref[k]), k


def _per_point_gaussian(theta):
    """gaussian.ini's likelihood per point (sigma 0.1, mu 0.5, normalised)."""
    D = theta.shape[-1]
    return (-0.5 * torch.sum(((theta - 0.5) / 0.1) ** 2)
            - D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)))


@pytest.mark.parametrize("D", WIDE_D)
def test_wide_fused_kernel_every_group_equals_plain(dev, D):
    """A per-point torch Gaussian lowered into the 128 bucket: the fused
    kernel at each of its G (libraries built in parallel) bitwise its plain
    version, with invalid lanes, and validate_fused at the rule's G."""
    calc = make_batched_calculator(identity_prior, _per_point_gaussian, D, 0, device=dev)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low
    assert "#define FUSED_MAXD 128" in low.source(32)
    B, R = 999, 4
    gen = torch.Generator(dev).manual_seed(D)
    x0 = (0.5 + 0.02 * torch.randn((B, D), generator=gen, device=dev)).clamp(0, 1)
    valid = torch.arange(B, device=dev) >= 64
    nh, w, _ = make_directions((0.05 * torch.eye(D, device=dev)).expand(B, D, D),
                               grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=gen)
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    args = (x0, low.plain_logL(x0) - 2.0, valid, nh, w)
    want = slice_records_plain(low.plain_logL, cfg, (9, 10), *args)
    low.build(WIDE_GROUPS)
    for G in WIDE_GROUPS:
        before = pallas_slice_v4.GROUP_LAUNCHES[128, G]
        got = pallas_slice_v4.slice_epoch_fused(calc, cfg, (9, 10), *args, group=G)
        assert pallas_slice_v4.GROUP_LAUNCHES[128, G] == before + 1
        for k, a, b in zip(("t", "logL", "nlike"), got, want):
            assert torch.equal(a, b), (G, k, int((a != b).sum()))
    assert (want[2][:64] == 0).all() and (want[2][64:].sum(1) > 0).all()
    pallas_slice_v4.validate_fused(calc, cfg, dev, pallas_slice_v4.choose_group(
        B, D, torch.cuda.get_device_properties(dev).multi_processor_count))


@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_every_functor_in_the_wide_bucket(dev, name):
    """Each likelihood's functor at D = 40 against its torch calc through B1,
    B4 and B5 at each of the 128 bucket's G (random_gaussian's matrix read
    from its device array, as in every bucket)."""
    D = 40
    calc = make_batched_calculator(UniformPrior(0.0, 1.0), LIKELIHOODS[name](D), D, 0,
                                   device=dev)
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(2,))
    for G in WIDE_GROUPS:
        for wrapper in (pallas_slice_v4.slice_epoch, pallas_slice_v3.slice_epoch_v3,
                        pallas_slice.slice_epoch_v2):
            pallas_slice_v4.validate_functor(calc, cfg, dev, functools.partial(wrapper, group=G))


def test_plain_engine_launches_no_kernel_on_the_card(dev):
    """engine="torch" on the card at D = 40: its directions come from the
    plain Gram-Schmidt by name, so the run launches no kernel at all, and it
    finishes."""
    launches0 = dict(pallas_dirs.LAUNCHES)
    with tempfile.TemporaryDirectory() as base:
        out = pt.run(gaussian(40), 40, nDerived=2, nlive=100, num_repeats=4,
                     do_clustering=False, read_resume=False, base_dir=base, seed=4,
                     feedback=-1, device="cuda", engine="torch", max_ndead=400)
        with open(os.path.join(base, "test.metrics.jsonl")) as f:
            last = json.loads(f.read().splitlines()[-1])
    assert pallas_dirs.LAUNCHES == launches0
    assert last["engine"] == "torch" and not any(last["kernel_launches"].values())
    assert out.ndead >= 400 and math.isfinite(out.logZ)


def test_wide_run_takes_the_fused_route(dev):
    """A per-point torch Gaussian at D = 40 through run() on the card: the
    fused route in the 128 bucket and B2's wide kernel, chained epochs
    kept."""
    with tempfile.TemporaryDirectory() as base:
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a replay divergence would warn
            out = pt.run(_per_point_gaussian, 40, nlive=100, num_repeats=8,
                         do_clustering=False, read_resume=False, base_dir=base, seed=6,
                         feedback=-1, device="cuda", max_ndead=600)
        with open(os.path.join(base, "test.metrics.jsonl")) as f:
            last = json.loads(f.read().splitlines()[-1])
    ran = last["kernel_launches"]
    assert last["route"] == "slice_epoch_fused" and last["chained_epochs"] is True
    assert ran["slice_epoch_fused"] > 0 and ran["gram_schmidt_wide"] > 0
    assert ran["gram_schmidt"] == ran["slice_epoch"] == ran["slice_step"] == 0
    assert set(last["group_launches"]) == {"128/32"}
    assert out.ndead >= 600 and math.isfinite(out.logZ)


# ---- float64: precision='highest' (B1's fused and traced routes, B2, in double)
def _f64_calc(prior, like, D, nd, dev):
    from polychordlite_tpu_torch.ops.precision import real_dtype_scope

    with real_dtype_scope(torch.float64):
        return make_batched_calculator(prior, like, D, nd, device=dev)


@pytest.mark.parametrize("shape", [(2, 1, 1, 1000), (3, 3, 3, 999), (2, 20, 20, 512),
                                   (5, 20, 20, 2048), (2, 30, 30, 300), (2, 31, 31, 300),
                                   (2, 32, 32, 999), (2, 33, 33, 300), (2, 64, 64, 300),
                                   (2, 128, 128, 64)])
def test_gram_schmidt_f64_equals_plain(dev, shape):
    """Both B2 kernels in double bitwise gram_schmidt_plain in float64: the
    thread-per-basis kernel at 32 chains a block up to dim 30 and 16 above
    (its shared memory), the warp-per-basis kernel above dim 32; each
    launch counted under its _f64 name; columns orthonormal to 1e-12."""
    dim = shape[1]
    g = torch.randn(shape, generator=torch.Generator(dev).manual_seed(dim), device=dev,
                    dtype=torch.float64)
    name = "gram_schmidt_f64" if dim <= pallas_dirs.NARROW_MAXD else "gram_schmidt_wide_f64"
    before = dict(pallas_dirs.LAUNCHES)
    q = pallas_dirs.gram_schmidt_lanes(g)
    assert pallas_dirs.LAUNCHES == {**before, name: before[name] + 1}
    assert q.dtype == torch.float64
    assert torch.equal(q, pallas_dirs.gram_schmidt_plain(g))
    eye = torch.eye(dim, device=dev, dtype=torch.float64)[None, :, :, None]
    assert (torch.einsum("nikb,nijb->nkjb", q, q) - eye).abs().max() < 1e-12


def _big(theta):
    r2 = torch.sum(theta ** 2)
    return 1.0e7 - theta.shape[-1] * math.log(0.1 * math.sqrt(2 * math.pi)) - r2 / 0.02, [r2]


def _f64_args(low, dev, B, R, D, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    x0 = (0.5 + 0.03 * torch.randn((B, D), generator=gen, device=dev,
                                   dtype=torch.float64)).clamp(0, 1)
    nh = torch.randn((B, R, D), generator=gen, device=dev, dtype=torch.float64)
    nh = nh / nh.norm(dim=2, keepdim=True)
    valid = torch.arange(B, device=dev) >= 64
    return (x0, low(x0) - 2.0, valid, nh,
            torch.full((B, R), 0.05, device=dev, dtype=torch.float64))


@pytest.mark.parametrize("model,D,B,R", [("big", 20, 1000, 6), ("big", 4, 512, 8),
                                         ("gaussian", 64, 300, 4)])
def test_fused_f64_kernel_every_group_equals_plain(dev, model, D, B, R):
    """The fused kernel in double at every G of the bucket bitwise its plain
    version (slice_records_plain on the float64 plain_logL), with invalid
    lanes, counted as slice_epoch_fused_f64; validate_fused at float64."""
    like = _big if model == "big" else _per_point_gaussian
    prior = UniformPrior(-1, 1) if model == "big" else identity_prior
    calc = _f64_calc(prior, like, D, 1 if model == "big" else 0, dev)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered) and low.dtype == torch.float64
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    args = _f64_args(low.plain_logL, dev, B, R, D, D)
    want = slice_records_plain(low.plain_logL, cfg, (9, 10), *args)
    groups = [G for G in pallas_slice_v4.BUCKET_GROUPS[pallas_slice_v4.bucket(D)] if G <= max(D, 32)]
    low.build(groups)
    for G in groups:
        before = pallas_slice_v4.LAUNCHES["slice_epoch_fused_f64"]
        got = pallas_slice_v4.slice_epoch_fused(calc, cfg, (9, 10), *args, group=G)
        assert pallas_slice_v4.LAUNCHES["slice_epoch_fused_f64"] == before + 1
        for k, a, b in zip(("t", "logL", "nlike"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (G, k, int((a != b).sum()))
    assert (want[2][:64] == 0).all() and (want[2][64:].sum(1) > 0).all()
    pallas_slice_v4.validate_fused(calc, cfg, dev, groups[-1])


F64_OPS = {
    "exp": lambda th: torch.sum(torch.exp(-3.0 * th)),
    "log": lambda th: torch.sum(torch.log(th + 0.1)),
    "log1p": lambda th: torch.sum(torch.log1p(th)),
    "expm1": lambda th: torch.sum(torch.expm1(th)),
    "sqrt_rsqrt": lambda th: torch.sum(torch.sqrt(th) + torch.rsqrt(th + 1.0)),
    "sin_cos": lambda th: torch.sum(torch.sin(7.0 * th) * torch.cos(5.0 * th)),
    "tanh": lambda th: torch.sum(torch.tanh(3.0 * th - 1.0)),
    "pow": lambda th: torch.sum((th + 0.1) ** 2.5),
    "logsumexp_max": lambda th: torch.logsumexp(-th / 0.1, 0) + torch.amax(th).clamp(0.2, 0.8),
    "matmul": lambda th: -0.5 * (th - 0.5) @ torch.eye(th.shape[-1], dtype=th.dtype,
                                                       device=th.device) @ (th - 0.5),
}


@pytest.mark.parametrize("op", sorted(F64_OPS))
def test_fused_f64_library_calls_equal_torch(dev, op):
    """Every library call of the lowering's table in double: the emitted
    double exp, log, ... agree bitwise with torch's CUDA float64 ops (the
    plain version runs them on the card), through validate_fused."""
    calc = _f64_calc(identity_prior, F64_OPS[op], 4, 0, dev)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered), low.reason
    cfg = EpochConfig(n_dims=4, n_phi=1, grade_dims=(4,), num_repeats=(1,))
    low.build([4])
    pallas_slice_v4.validate_fused(calc, cfg, dev, 4)


def _vn_gaussian(theta):
    return -0.5 * (torch.linalg.vector_norm(theta - 0.5, dim=-1) / 0.1) ** 2


@pytest.mark.parametrize("rounds", [1, 32])
@pytest.mark.parametrize("model,D", [("vector_norm", 20), ("vector_norm", 40),
                                     ("gaussian_prior", 5)])
def test_traced_route_f64_equals_plain(dev, model, D, rounds):
    """The traced route in double (slice_step_launch_f64) bitwise the plain
    engine in float64, for a model the lowering refuses (vector_norm) and
    one it refuses at float64 only (a GaussianPrior's erfinv), counted as
    slice_step_f64."""
    if model == "vector_norm":
        calc = _f64_calc(identity_prior, _vn_gaussian, D, 0, dev)
    else:
        calc = _f64_calc(GaussianPrior(0.5, 0.2), lambda th: -0.5 * (((th - 0.5) / 0.1) ** 2)
                         .sum(-1), D, 0, dev)
    assert isinstance(fused_like.lowering(calc), fused_like.Refused)
    B, R = 700, 5
    cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
    args = _f64_args(lambda p: calc(p)[2], dev, B, R, D, D + rounds)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (3, 4), *args)
    before = pallas_slice_v4.LAUNCHES["slice_step_f64"]
    got = pallas_slice_v4.slice_epoch_traced(calc, cfg, (3, 4), *args, rounds=rounds)
    assert pallas_slice_v4.LAUNCHES["slice_step_f64"] > before
    for k, a, b in zip(("t", "logL", "nlike"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (k, int((a != b).sum()))


def test_highest_run_on_the_card(dev):
    """The big likelihood (|logL| ~ 1e7) through run(precision='highest') on
    the card: the fused route and B2 in double only, dtype float64 in the
    metrics, logZ within 3 sigma + 0.2; the float32 kernels launch nothing;
    a forced float32 engine raises."""
    with tempfile.TemporaryDirectory() as base:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out = pt.run(_big, 4, nDerived=1, prior=UniformPrior(-1, 1), nlive=100,
                         num_repeats=8, do_clustering=False, read_resume=False,
                         base_dir=base, seed=7, feedback=-1, device="cuda",
                         precision="highest", precision_criterion=0.01)
        with open(os.path.join(base, "test.metrics.jsonl")) as f:
            last = json.loads(f.read().splitlines()[-1])
        with pytest.raises(ValueError, match="engine='cuda'"):
            pt.run(_big, 4, nDerived=1, prior=UniformPrior(-1, 1), nlive=100, read_resume=False,
                   base_dir=base, file_root="v3", seed=7, feedback=-1, device="cuda",
                   precision="highest", engine="cuda3")
    ran = {k: v for k, v in last["kernel_launches"].items() if v}
    assert last["dtype"] == "float64" and last["route"] == "slice_epoch_fused"
    assert set(ran) == {"gram_schmidt_f64", "slice_epoch_fused_f64"}, ran
    assert abs(out.logZ - (1.0e7 - 4 * math.log(2))) < 3 * out.logZerr + 0.2


# ---- the graded route (engine "scan"): slice_step.cu's repeat barrier
GRADE_DIMS, GRADE_REPEATS = (6, 14), (3, 9)


def _graded_like(n_slow=6, mu=0.5, sigma=0.1):
    """A batched GradedLikelihood: the slow part r^2 of the slow block
    through 200 steps of c <- c/2 + r^2/2 (exact at every step), the fast
    part adds the rest's chi^2; and its monolithic twin."""
    from polychordlite_tpu_torch import GradedLikelihood

    def slow(th_s):
        r2 = (((th_s - mu) / sigma) ** 2).sum(-1)
        c = r2
        for _ in range(200):
            c = c * 0.5 + r2 * 0.5
        return {"chi2": c}

    def fast(aux, th):
        return -0.5 * (aux["chi2"] + (((th[:, n_slow:] - mu) / sigma) ** 2).sum(-1))

    like = GradedLikelihood(slow, fast, n_slow)
    return like, lambda th: fast(slow(th[:, :n_slow]), th)


def _graded_inputs(calc, dev, B, seed, dtype=torch.float32):
    D = sum(GRADE_DIMS)
    gen = torch.Generator(dev).manual_seed(seed)
    x0 = (0.5 + 0.03 * torch.randn((B, D), generator=gen, device=dev, dtype=dtype)).clamp(0, 1)
    bound = calc(x0)[2] - 3.0
    valid = torch.arange(B, device=dev) >= 64
    chol = (0.05 * torch.eye(D, device=dev, dtype=dtype)).expand(B, D, D)
    nh, w, sp = make_directions(chol, grade_dims=GRADE_DIMS, num_repeats=GRADE_REPEATS,
                                n_dims=D, generator=gen)
    return (x0, bound, valid, nh, w), sp


@pytest.mark.parametrize("rounds", [1, 7, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graded_route_equals_plain_and_traced(dev, dtype, rounds):
    """The graded route (the barrier raised repeat by repeat, the fast graph
    on the cached slow part) bitwise its plain version, the traced route on
    the monolithic model and the plain engine, in float32 and float64
    (slice_step_graded_f64), at 2 grades of 6 + 14 coordinates; lanes that
    wait at the barrier consume nothing, including the first round after it
    opens."""
    from polychordlite_tpu_torch.ops.precision import real_dtype_scope

    like, mono_like = _graded_like()
    with real_dtype_scope(dtype):
        calc = make_batched_calculator(identity_prior, like, 20, 0, device=dev)
        mono = make_batched_calculator(identity_prior, mono_like, 20, 0, device=dev)
    assert calc.graded and calc.form == "batched" and not mono.graded
    args, sp = _graded_inputs(mono, dev, 1000, rounds, dtype)
    cfg = EpochConfig(n_dims=20, n_phi=1, grade_dims=GRADE_DIMS, num_repeats=GRADE_REPEATS)
    want = slice_records_plain(lambda p: mono(p)[2], cfg, (3, 4), *args)
    plain = pallas_slice_v4.slice_records_graded_plain(
        calc, cfg, (3, 4), *args, pallas_slice_v4.repeat_grades(sp), rounds)
    counter = "slice_step_graded" + ("_f64" if dtype == torch.float64 else "")
    before, graded0 = pallas_slice_v4.LAUNCHES[counter], dict(pallas_slice_v4.GRADED)
    got = pallas_slice_v4.slice_epoch_graded(calc, cfg, (3, 4), *args, sp, rounds=rounds)
    assert pallas_slice_v4.LAUNCHES[counter] > before
    ran = {k: v - graded0[k] for k, v in pallas_slice_v4.GRADED.items()}
    assert ran["replays_fast"] > 0 and ran["replays_full"] > 0 and ran["aux_rows"] > 0
    assert ran["openings"] == sum(GRADE_REPEATS) - 1
    traced = pallas_slice_v4.slice_epoch_traced(mono, cfg, (3, 4), *args, rounds=rounds)
    for k, a, b, c, d in zip(("t", "logL", "nlike"), got, plain, traced, want):
        assert a.dtype == d.dtype and torch.equal(a, b) and torch.equal(a, d), k
        assert torch.equal(c, d), k
    assert (want[2][:64] == 0).all() and (want[2][64:].sum(1) > 0).all()


def test_rep_limit_R_is_the_traced_route(dev):
    """The traced route holds the barrier at R: no repeat opening, the
    graded counters untouched, its launches one set-up plus whole replays,
    and its records the plain engine's."""
    _, mono_like = _graded_like()
    mono = make_batched_calculator(identity_prior, mono_like, 20, 0, device=dev)
    args, _ = _graded_inputs(mono, dev, 512, 0)
    cfg = EpochConfig(n_dims=20, n_phi=1, grade_dims=GRADE_DIMS, num_repeats=GRADE_REPEATS)
    want = slice_records_plain(lambda p: mono(p)[2], cfg, (1, 1), *args)
    graded0, traced0 = dict(pallas_slice_v4.GRADED), dict(pallas_slice_v4.TRACED)
    before = pallas_slice_v4.LAUNCHES["slice_step"]
    got = pallas_slice_v4.slice_epoch_traced(mono, cfg, (1, 1), *args)
    runner = mono.traced_epochs[next(iter(mono.traced_epochs))]
    assert int(runner.rep_limit.item()) == sum(GRADE_REPEATS)
    assert pallas_slice_v4.GRADED == graded0
    replays = pallas_slice_v4.TRACED["replays"] - traced0["replays"]
    assert pallas_slice_v4.LAUNCHES["slice_step"] - before == 1 + replays * pallas_slice_v4.ROUNDS
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_graded_graphs_replay_with_aux_in_place(dev):
    """Two epochs on one runner: the full and fast graphs are captured once,
    and the second epoch's cached slow part is refreshed in place in the
    buffer the fast graph reads (its records still bitwise the plain
    engine's)."""
    like, mono_like = _graded_like()
    calc = make_batched_calculator(identity_prior, like, 20, 0, device=dev)
    mono = make_batched_calculator(identity_prior, mono_like, 20, 0, device=dev)
    cfg = EpochConfig(n_dims=20, n_phi=1, grade_dims=GRADE_DIMS, num_repeats=GRADE_REPEATS)
    seen = []
    for seed in (11, 12):
        args, sp = _graded_inputs(mono, dev, 512, seed)
        want = slice_records_plain(lambda p: mono(p)[2], cfg, (seed, 2), *args)  # noqa: B023
        got = pallas_slice_v4.slice_epoch_graded(calc, cfg, (seed, 2), *args, sp)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        (runner,) = calc.traced_epochs.values()
        seen.append((runner.graph, runner.fast_graph, runner.aux["chi2"].data_ptr()))
    assert seen[0] == seen[1] and None not in seen[0]


def test_graded_epoch_record_on_the_card(dev):
    """The "scan" engine's packed epoch record on the card: a fast-grade
    repeat's babies from the fast part on the intermediate that repeat ran
    on (slow_fn on the slow repeats' babies only), and the record bitwise
    the plain engine's on the monolithic model (this model's fast part is
    its full logL bit for bit)."""
    from polychordlite_tpu_torch.ops.slice_kernel import build_epoch_fn

    like, mono_like = _graded_like()
    calc = make_batched_calculator(identity_prior, like, 20, 0, device=dev)
    mono = make_batched_calculator(identity_prior, mono_like, 20, 0, device=dev)
    (x0, bound, valid, nh, w), sp = _graded_inputs(mono, dev, 512, 21)
    cfg = EpochConfig(n_dims=20, n_phi=1, grade_dims=GRADE_DIMS, num_repeats=GRADE_REPEATS)
    chol = (0.05 * torch.eye(20, device=dev)).expand(512, 20, 20)
    graded0 = dict(pallas_slice_v4.GRADED)
    got = build_epoch_fn(calc, cfg._replace(engine="scan"))(
        (5, 6), x0, bound, chol, valid, directions=(nh, w, sp))
    ran = {k: v - graded0[k] for k, v in pallas_slice_v4.GRADED.items()}
    slow_reps = pallas_slice_v4.repeat_grades(sp).count(0)
    assert ran["assembly_rows"] == slow_reps * 512
    assert ran["assembly_fast_rows"] == (sum(GRADE_REPEATS) - slow_reps) * 512
    want = build_epoch_fn(mono, cfg._replace(engine="torch"))(
        (5, 6), x0, bound, chol, valid, directions=(nh, w, sp))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim,NB", [(1, 8), (2, 4), (3, 3), (14, 3), (20, 1)])
def test_gram_schmidt_grade_dims_equal_plain(dev, dim, NB, dtype):
    """B2 at the dims speed grades give it (n_dims minus the earlier grades'
    coordinates: 1, 2 and 3 for grade_dims (2, 1) and (1, 2), 14 and 20 for
    (6, 14)), at the bases a B = 512 epoch draws, bitwise its plain version;
    a dim-1 basis is the sign of its Gaussian."""
    g = torch.randn((NB, dim, dim, 512), generator=torch.Generator(dev).manual_seed(dim),
                    device=dev, dtype=dtype)
    q = pallas_dirs.gram_schmidt_lanes(g)
    assert torch.equal(q, pallas_dirs.gram_schmidt_plain(g))
    if dim == 1:
        assert torch.equal(q, torch.sign(g))


def test_graded_run_on_the_card(dev):
    """A 20-D GradedLikelihood (6 slow + 14 fast coordinates, literal repeats
    8 and 32) through run() on the card: engine "scan" on the graded route,
    B2 and slice_step_graded the only kernels, nlike by grade in the
    metrics, logZ within 3 sigma of 0 (a normalised Gaussian in the cube)."""
    like, _ = _graded_like()
    norm = -20 * (math.log(0.1) + 0.5 * math.log(2 * math.pi))

    def fast_norm(aux, th, fast=like.fast_fn):
        return norm + fast(aux, th)

    graded = pt.GradedLikelihood(like.slow_fn, fast_norm, 6)
    with tempfile.TemporaryDirectory() as base:
        out = pt.run(graded, 20, nlive=100, num_repeats=40, grade_dims=[6, 14],
                     grade_frac=[8, 32], do_clustering=False, read_resume=False,
                     base_dir=base, seed=5, feedback=-1, device="cuda",
                     precision_criterion=0.01)
        with open(os.path.join(base, "test.metrics.jsonl")) as f:
            last = json.loads(f.read().splitlines()[-1])
    ran = {k: v for k, v in last["kernel_launches"].items() if v}
    assert (last["engine"], last["route"]) == ("scan", "slice_step_graded")
    assert set(ran) == {"gram_schmidt", "slice_step_graded"}, ran
    assert last["chained_epochs"] is False and last["graded_route"]["replays_fast"] > 0
    nl = last["nlike_per_grade"]
    assert len(nl) == 2 and nl[1] > nl[0] > 0
    assert abs(out.logZ) < 3 * out.logZerr


# ------------------------------------------------ the host route (callbacks)
HOST_SIGMA_HALF_INV = 50.0  # 1 / (2 sigma^2) at sigma 0.1, exact in binary


def _host_norm(D):
    return -D * math.log(0.1 * math.sqrt(2 * math.pi))


def _numpy_gaussian(D):
    """A normalised Gaussian at 0.5 written with numpy, one point a call:
    a host callback.  Its sum runs over the coordinates in order in
    float64, as :func:`_torch_gaussian`'s does."""
    norm = _host_norm(D)

    def like(theta):
        theta = np.asarray(theta, dtype=np.float64)
        r2 = 0.0
        for d in range(theta.shape[0]):
            x = theta[d] - 0.5
            r2 = r2 + x * x
        return norm - r2 * HOST_SIGMA_HALF_INV

    return like


def _torch_gaussian(D):
    """The same likelihood batched in torch, in float64 and in the same
    order: the same logL bit for bit, rounded to the calc's dtype."""
    norm = _host_norm(D)

    def like(theta):
        t = theta.double()
        r2 = torch.zeros(t.shape[0], dtype=torch.float64, device=t.device)
        for d in range(t.shape[1]):
            x = t[:, d] - 0.5
            r2 = r2 + x * x
        return norm - r2 * HOST_SIGMA_HALF_INV

    return like


def _host_inputs(dev, calc, D, B, R, dtype, B_valid):
    g = torch.Generator(dev).manual_seed(3)
    x0 = (0.5 + 0.06 * torch.randn(B, D, generator=g, device=dev, dtype=dtype)).clamp(0, 1)
    x0[:2, 0] = torch.tensor([0.0, 0.999], dtype=dtype, device=dev)
    bound = calc(x0)[2] - 3.0
    valid = torch.arange(B, device=dev) < B_valid
    chol = (0.06 * torch.eye(D, device=dev, dtype=dtype)).expand(B, D, D)
    nh, w, sp = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D, generator=g)
    return x0, bound, valid, nh, w, sp


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_host_route_equals_plain_engine_and_plain_version(dev, dtype):
    """The host route (csrc/slice_step.cu round by round, the numpy
    likelihood called on the pending probes) against the plain engine and
    its plain version, bit for bit, over two epochs (the second seeded from
    the first's babies); launches counted under slice_step_host (_f64), one
    user call a consumed probe; the babies (the accepted probes) bitwise
    the plain version's, their theta and phi the calc's re-evaluation of
    their cubes, and the epoch record built from them with no user call."""
    from polychordlite_tpu_torch.ops.precision import real_dtype_scope

    D, B, R = 20, 512, 8
    with real_dtype_scope(dtype):
        calc = make_batched_calculator(identity_prior, _numpy_gaussian(D), D, 0, device=dev)
    assert calc.uses_callback and calc.dtype == dtype
    x0, bound, valid, nh, w, sp = _host_inputs(dev, calc, D, B, R, dtype, 504)
    cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
    counter = "slice_step_host" + ("_f64" if dtype == torch.float64 else "")
    for epoch in range(2):
        kw = (11 + epoch, 12)
        *want, steps = slice_records_plain(lambda p: calc(p)[2], cfg, kw, x0, bound, valid,
                                           nh, w, count_steps=True)
        *plain, plain_babies = pallas_slice_v4.slice_records_host_plain(calc, cfg, kw, x0,
                                                                        bound, valid, nh, w)
        before = (pallas_slice_v4.LAUNCHES[counter], dict(pallas_slice_v4.HOST))
        *got, babies = pallas_slice_v4.slice_epoch_host(calc, cfg, kw, x0, bound, valid, nh, w)
        host = {k: v - before[1][k] for k, v in pallas_slice_v4.HOST.items()}
        assert pallas_slice_v4.LAUNCHES[counter] - before[0] == host["rounds"] + 1
        assert host["probe_calls"] == int(steps.sum())
        for a, b, c in zip(got, want, plain):
            assert torch.equal(a, b) and torch.equal(a, c)
        for a, b in zip(babies, plain_babies):
            assert a.device == x0.device and torch.equal(a, b)
        cube, theta, phi = babies
        rows = valid[:, None] & (torch.cummax((got[0] != 0).int(), dim=1).values > 0)
        th_all, ph_all, _ = calc(cube.reshape(B * R, D))
        assert torch.equal(theta[rows], th_all.reshape(B, R, D)[rows])
        assert torch.equal(phi[rows], ph_all.reshape(B, R, 1)[rows])
        calls0 = calc.user_calls
        rec = pallas_slice_v4.assemble_epoch(calc, cfg, x0, valid, nh, sp, *got, cube=cube,
                                             theta_phi=(theta, phi))
        assert calc.user_calls == calls0
        last = rec[:, (R - 1) * (2 * D + 2):(R - 1) * (2 * D + 2) + D]
        x0 = torch.where(valid[:, None], last, x0)
        bound = calc(x0)[2] - 2.0


def test_host_route_equals_traced_route_on_the_torch_form(dev):
    """The numpy likelihood on the host route and its torch form on the
    traced route make the same decisions: t, logL and nlike bit for bit."""
    D, B, R = 20, 512, 8
    calc = make_batched_calculator(identity_prior, _numpy_gaussian(D), D, 0, device=dev)
    form = make_batched_calculator(identity_prior, _torch_gaussian(D), D, 0, device=dev)
    assert calc.uses_callback and not form.uses_callback
    x0, bound, valid, nh, w, _ = _host_inputs(dev, form, D, B, R, torch.float32, 504)
    cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
    *got, _ = pallas_slice_v4.slice_epoch_host(calc, cfg, (5, 6), x0, bound, valid, nh, w)
    want = pallas_slice_v4.slice_epoch_traced(form, cfg, (5, 6), x0, bound, valid, nh, w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_callback_run_on_the_card(dev):
    """run() on a numpy likelihood (the 4-D quickstart) with the default
    engine on the card: engine "scan", the host route and B2 the only
    kernels, host_calls in the metrics, logZ within 3 sigma of -4 log 2;
    a forced chain (chain_epochs 4) drives the host route four times a
    dispatch and its replay check holds (a divergence warns: an error
    here)."""
    def quickstart(theta):
        theta = np.asarray(theta, dtype=np.float64)
        r2 = float(np.sum(theta ** 2))
        return -math.log(2 * math.pi * 0.01) * 2.0 - r2 / 2 / 0.01, [r2]

    for chain in (-1, 4):
        with tempfile.TemporaryDirectory() as base, warnings.catch_warnings():
            warnings.simplefilter("error")
            out = pt.run(quickstart, 4, nDerived=1, prior=UniformPrior(-1, 1), nlive=100,
                         read_resume=False, base_dir=base, seed=9, feedback=-1,
                         chain_epochs=chain, device="cuda")
            with open(os.path.join(base, "test.metrics.jsonl")) as f:
                last = json.loads(f.read().splitlines()[-1])
        ran = {k: v for k, v in last["kernel_launches"].items() if v}
        assert (last["engine"], last["route"]) == ("scan", "slice_step_host")
        assert set(ran) == {"gram_schmidt", "slice_step_host"}, ran
        assert last["chained_epochs"] is (chain > 1)
        assert last["host_calls"] >= last["host_route"]["probe_calls"] > 0
        assert abs(out.logZ + 4 * math.log(2.0)) < 3 * out.logZerr


@pytest.mark.parametrize("name,D", [("fitting", 20), ("object_detection", 12)])
def test_data_driven_traced_route_equals_plain(dev, name, D):
    """The data-driven models with the inis' block priors on the traced
    route (the lowering refuses both) against the plain engine, bit for
    bit, at 504 valid lanes of 512."""
    from polychordlite_tpu_torch.models import get_likelihood

    _, blocks, *_ = read_ini(os.path.join(REPO, "ini", f"{name}.ini"))
    calc = make_batched_calculator(BlockPrior(blocks, D), get_likelihood(
        name, D, data_dir=os.path.join(REPO, "data")), D, 0, device=dev)
    assert calc.form == "batched" and isinstance(fused_like.lowering(calc), fused_like.Refused)
    g = torch.Generator(dev).manual_seed(4)
    live = torch.rand((500, D), generator=g, device=dev)
    logL = calc(live)[2]
    pick = torch.randint(0, 500, (512,), generator=g, device=dev)
    x0, bound = live[pick], logL[pick] - 1.0
    valid = torch.arange(512, device=dev) < 504
    chol = torch.linalg.cholesky(torch.cov(live.T)).expand(512, D, D)
    nh, w, _ = make_directions(chol, grade_dims=(D,), num_repeats=(8,), n_dims=D, generator=g)
    cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(8,))
    got = pallas_slice_v4.slice_epoch_traced(calc, cfg, (1, 2), x0, bound, valid, nh, w)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (1, 2), x0, bound, valid, nh, w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_c_abi_in_process_on_the_card(dev, tmp_path):
    """The port's shim and a C driver loaded with ctypes.PyDLL into this
    process, capi.DEVICE at its default (the card): a 2-D Gaussian through
    polychord_c_interface on the host route."""
    import ctypes
    import shutil

    from polychordlite_tpu_torch import capi
    from polychordlite_tpu_torch.utils import cabi

    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    assert capi.DEVICE is None
    src = tmp_path / "driver.c"
    src.write_text(r"""
#include <math.h>
#include <string.h>
#include "capi.h"
static double loglike(double *theta, int nDims, double *phi, int nDerived) {
    double r2 = 0.0;
    for (int i = 0; i < nDims; i++) { double d = theta[i] - 0.5; r2 += d * d; }
    if (nDerived > 0) phi[0] = sqrt(r2);
    return -r2 / (2 * 0.01) - nDims * log(0.1 * sqrt(2 * M_PI));
}
void run_gaussian(const char *base) {
    char base_dir[256], file_root[16] = "capi";
    strncpy(base_dir, base, 255);
    double grade_frac[1] = {1.0};
    int grade_dims[1] = {2};
    int comm = 0;
    polychord_c_interface(loglike, NULL, NULL, 50, 4, -1, -1, false, 0, 0.01, -1e30, -1, 0.0,
                          true, true, false, false, false, false, true, false, true, false,
                          false, 0.36787944117144233, true, 2, 1, base_dir, file_root, 1,
                          grade_frac, grade_dims, 0, NULL, NULL, 3, &comm);
}
""")
    lib = ctypes.PyDLL(str(cabi.build_in_process("test_cuda_capi_driver", [src])))
    lib.run_gaussian.argtypes = [ctypes.c_char_p]
    chains = tmp_path / "chains"
    (chains / "clusters").mkdir(parents=True)
    lib.run_gaussian(str(chains).encode())
    with open(chains / "capi.metrics.jsonl") as f:
        last = json.loads(f.read().splitlines()[-1])
    assert (last["engine"], last["route"]) == ("scan", "slice_step_host")
    assert last["kernel_launches"]["slice_step_host"] > 0
    out = pt.PolyChordOutput(str(chains), "capi")
    assert abs(out.logZ) < 3 * out.logZerr + 0.2


# ---- the stream bucket: D > 128 (csrc/slice_epoch.cuh; B2's long kernel in
# csrc/gram_schmidt.cu)
STREAM_D = [129, 160, 256]
STREAM = pallas_slice_v4.STREAM


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim", [129, 160, 256, 300])
def test_gram_schmidt_long_kernel_equals_plain(dev, dim, dtype):
    """B2 above dim 128 (ceil(dim / 32) rows a lane) bitwise its plain
    version, the finished columns in shared memory up to dim 240 in float32
    and 169 in float64 and past that partly in the scratch buffer (256 and
    300 in both types); one launch counted as the long kernel's; columns
    orthonormal."""
    g = torch.randn((2, dim, dim, 37), generator=torch.Generator(dev).manual_seed(dim),
                    device=dev, dtype=dtype)
    name = "gram_schmidt_long" + ("_f64" if dtype == torch.float64 else "")
    before = dict(pallas_dirs.LAUNCHES)
    q = pallas_dirs.gram_schmidt_lanes(g)
    assert pallas_dirs.LAUNCHES == {**before, name: before[name] + 1}
    assert torch.equal(q, pallas_dirs.gram_schmidt_plain(g))
    eye = torch.eye(dim, device=dev, dtype=dtype)[None, :, :, None]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert (torch.einsum("nikb,nijb->nkjb", q, q) - eye).abs().max() < tol
    in_smem = {torch.float32: 240, torch.float64: 169}[dtype]
    n_scratch = pallas_dirs._lib().gram_schmidt_scratch_values(2, dim, 37, g.element_size())
    assert (n_scratch > 0) == (dim > in_smem)


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("D", STREAM_D)
def test_stream_slice_kernel_equals_plain(dev, D, capped):
    """B1 in the stream bucket (x0, n-hat and the terms in shared memory)
    bitwise its plain version at B = 300 chains with invalid lanes and a
    budget that stops lanes mid-epoch; one launch counted at ("stream",
    32); the second half of the batch as a shard at lane0 = 150 is the
    whole launch's second half."""
    R, B = 4, 300
    calc, args = _group_args(dev, D, R, B)
    cfg = (CappedConfig if capped else EpochConfig)(n_dims=D, n_phi=2, grade_dims=(D,),
                                                     num_repeats=(R,))
    before = pallas_slice_v4.GROUP_LAUNCHES[STREAM, 32]
    got = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args)
    assert pallas_slice_v4.GROUP_LAUNCHES[STREAM, 32] == before + 1
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    shard = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *(a[150:] for a in args), lane0=150)
    for a, b in zip(shard, got):
        assert torch.equal(a, b[150:])
    valid = args[2]
    assert (got[2][~valid] == 0).all() and (got[2][valid].sum(1) > 0).all()
    assert bool((got[1][valid] == np.float32(cfg.logzero)).any()) == capped


@pytest.mark.parametrize("D", STREAM_D)
def test_stream_v2_v3_kernels_equal_plain(dev, D):
    """B5 (v2's policy, the cube D wide) and B4 (v3's) in the stream bucket,
    bitwise their plain versions, B4 also B1; counted at ("stream", 32)."""
    R, B = 4, 300
    calc, args = _group_args(dev, D, R, B)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    before = (pallas_slice.GROUP_LAUNCHES[STREAM, 32], pallas_slice_v3.GROUP_LAUNCHES[STREAM, 32])
    v2 = pallas_slice.slice_epoch_v2(calc, cfg, (5, 6), *args)
    v3 = pallas_slice_v3.slice_epoch_v3(calc, cfg, (5, 6), *args)
    assert (pallas_slice.GROUP_LAUNCHES[STREAM, 32],
            pallas_slice_v3.GROUP_LAUNCHES[STREAM, 32]) == (before[0] + 1, before[1] + 1)
    v2_want = pallas_slice.slice_records_lockstep_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    assert v2[3].shape == (B, R, D)
    for k in range(4):
        assert torch.equal(v2[k], v2_want[k]), k
    v3_want = pallas_slice_v3.slice_records_window_plain(lambda p: calc(p)[2], cfg, (5, 6),
                                                          *args)
    b1 = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args)
    for k in range(3):
        assert torch.equal(v3[k], v3_want[k]) and torch.equal(v3[k], b1[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", STREAM_D)
def test_stream_fused_kernel_equals_plain(dev, D, dtype):
    """A per-point torch Gaussian lowered into the stream bucket (the prior
    by pointer from the constant buffer), in float32 and float64, bitwise
    its plain version with invalid lanes; validate_fused at G = 32."""
    from polychordlite_tpu_torch.ops.precision import real_dtype_scope

    with real_dtype_scope(dtype):
        calc = make_batched_calculator(identity_prior, _per_point_gaussian, D, 0, device=dev)
    low = fused_like.lowering(calc)
    assert isinstance(low, fused_like.Lowered) and low.dtype == dtype, low
    assert "#define FUSED_MAXD SLICE_MAXD_STREAM" in low.source(32)
    B, R = 300, 4
    gen = torch.Generator(dev).manual_seed(D)
    x0 = (0.5 + 0.02 * torch.randn((B, D), generator=gen, device=dev, dtype=dtype)).clamp(0, 1)
    valid = torch.arange(B, device=dev) >= 64
    nh = torch.randn((B, R, D), generator=gen, device=dev, dtype=dtype)
    nh = nh / nh.norm(dim=2, keepdim=True)
    w = torch.full((B, R), 0.2, device=dev, dtype=dtype)
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    args = (x0, low.plain_logL(x0) - 2.0, valid, nh, w)
    want = slice_records_plain(low.plain_logL, cfg, (9, 10), *args)
    counter = "slice_epoch_fused" + ("_f64" if dtype == torch.float64 else "")
    before = (pallas_slice_v4.GROUP_LAUNCHES[STREAM, 32], pallas_slice_v4.LAUNCHES[counter])
    got = pallas_slice_v4.slice_epoch_fused(calc, cfg, (9, 10), *args)
    assert (pallas_slice_v4.GROUP_LAUNCHES[STREAM, 32],
            pallas_slice_v4.LAUNCHES[counter]) == (before[0] + 1, before[1] + 1)
    for k, a, b in zip(("t", "logL", "nlike"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (k, int((a != b).sum()))
    assert (want[2][:64] == 0).all() and (want[2][64:].sum(1) > 0).all()
    pallas_slice_v4.validate_fused(calc, cfg, dev, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", STREAM_D)
def test_stream_traced_route_equals_plain(dev, D, dtype):
    """The traced route (no compile-time D) above 128 on a model the
    lowering refuses (vector_norm), bitwise the plain engine in float32 and
    float64."""
    from polychordlite_tpu_torch.ops.precision import real_dtype_scope

    with real_dtype_scope(dtype):
        calc = make_batched_calculator(identity_prior, _vn_gaussian, D, 0, device=dev)
    assert isinstance(fused_like.lowering(calc), fused_like.Refused)
    B, R = 300, 4
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    gen = torch.Generator(dev).manual_seed(D)
    x0 = (0.5 + 0.03 * torch.randn((B, D), generator=gen, device=dev, dtype=dtype)).clamp(0, 1)
    nh = torch.randn((B, R, D), generator=gen, device=dev, dtype=dtype)
    args = (x0, calc(x0)[2] - 2.0, torch.arange(B, device=dev) >= 64,
            nh / nh.norm(dim=2, keepdim=True), torch.full((B, R), 0.05, device=dev, dtype=dtype))
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (3, 4), *args)
    counter = "slice_step" + ("_f64" if dtype == torch.float64 else "")
    before = pallas_slice_v4.LAUNCHES[counter]
    got = pallas_slice_v4.slice_epoch_traced(calc, cfg, (3, 4), *args)
    assert pallas_slice_v4.LAUNCHES[counter] > before
    for k, a, b in zip(("t", "logL", "nlike"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (k, int((a != b).sum()))


@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_every_functor_in_the_stream_bucket(dev, name):
    """Each likelihood's functor at D = 160 against its torch calc through
    B1, B4 and B5 (random_gaussian's matrix from its device array), and
    random_gaussian also at D = 64 in the wide bucket."""
    for D in ((64, 160) if name == "random_gaussian" else (160,)):
        calc = make_batched_calculator(UniformPrior(0.0, 1.0), LIKELIHOODS[name](D), D, 0,
                                       device=dev)
        cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(2,))
        for wrapper in (pallas_slice_v4.slice_epoch, pallas_slice_v3.slice_epoch_v3,
                        pallas_slice.slice_epoch_v2):
            pallas_slice_v4.validate_functor(calc, cfg, dev, wrapper)


def test_graded_and_host_routes_at_d160(dev):
    """One epoch of the graded route (grade_dims (16, 144), B2's long kernel
    for the 144-D grade) and of the host route (a numpy Gaussian) at D =
    160, each bitwise its plain version and the plain engine."""
    D, B = 160, 256
    like, mono_like = _graded_like(n_slow=16)
    calc = make_batched_calculator(identity_prior, like, D, 0, device=dev)
    mono = make_batched_calculator(identity_prior, mono_like, D, 0, device=dev)
    gen = torch.Generator(dev).manual_seed(160)
    x0 = (0.5 + 0.03 * torch.randn((B, D), generator=gen, device=dev)).clamp(0, 1)
    bound = mono(x0)[2] - 3.0
    valid = torch.arange(B, device=dev) >= 32
    grades, reps = (16, 144), (2, 4)
    before = pallas_dirs.LAUNCHES["gram_schmidt_long"]
    nh, w, sp = make_directions((0.05 * torch.eye(D, device=dev)).expand(B, D, D),
                                grade_dims=grades, num_repeats=reps, n_dims=D, generator=gen)
    assert pallas_dirs.LAUNCHES["gram_schmidt_long"] > before
    cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=grades, num_repeats=reps)
    args = (x0, bound, valid, nh, w)
    want = slice_records_plain(lambda p: mono(p)[2], cfg, (3, 4), *args)
    plain = pallas_slice_v4.slice_records_graded_plain(
        calc, cfg, (3, 4), *args, pallas_slice_v4.repeat_grades(sp), 8)
    got = pallas_slice_v4.slice_epoch_graded(calc, cfg, (3, 4), *args, sp)
    for k, a, b, c in zip(("t", "logL", "nlike"), got, plain, want):
        assert torch.equal(a, b) and torch.equal(a, c), k
    host = make_batched_calculator(identity_prior, _numpy_gaussian(D), D, 0, device=dev)
    R = 4
    x0, bound, valid, nh, w, _ = _host_inputs(dev, host, D, B, R, torch.float32, 200)
    cfg = EpochConfig(n_dims=D, n_phi=1, grade_dims=(D,), num_repeats=(R,))
    want = slice_records_plain(lambda p: host(p)[2], cfg, (11, 12), x0, bound, valid, nh, w)
    *plain, _ = pallas_slice_v4.slice_records_host_plain(host, cfg, (11, 12), x0, bound, valid,
                                                        nh, w)
    *got, _ = pallas_slice_v4.slice_epoch_host(host, cfg, (11, 12), x0, bound, valid, nh, w)
    for a, b, c in zip(got, want, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("D", [4200, 19370])
def test_stream_slice_kernel_past_48_kb_of_shared_memory(dev, D):
    """B1 in the stream bucket where a block's (2 + NT) D floats pass the
    48 KB a launch gets without the kernel's attribute (D = 4,200: 50,400
    bytes) and at the bucket's bound (D = 19,370: 232,440 of the 232,448
    bytes), bitwise its plain version on unit directions; one more
    coordinate raises before any launch, naming the bound."""
    B, R = 64, 2
    calc = make_batched_calculator(UniformPrior(0.0, 1.0), gaussian(D, sigma=0.2), D, 2,
                                   device=dev)
    gen = torch.Generator(dev).manual_seed(D)
    x0 = (0.5 + 0.01 * torch.randn((B, D), generator=gen, device=dev)).clamp(0, 1)
    nh, w = _unit_directions(gen, dev, B, R, D)
    args = (x0, calc(x0)[2] - 2.0, torch.arange(B, device=dev) >= 8, nh, w * 0.1)
    cfg = EpochConfig(n_dims=D, n_phi=2, grade_dims=(D,), num_repeats=(R,))
    got = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (want[2][8:].sum(1) > 0).all()
    with pytest.raises(ValueError, match="D <= 19370 .*engine='torch'"):
        pallas_slice_v4.bucket(19371)
