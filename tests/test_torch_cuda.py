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
    PriorBlock,
    UniformPrior,
    identity_prior,
)

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
    before = pallas_slice_v4.GROUP_LAUNCHES[G]
    got = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args, group=G)
    assert pallas_slice_v4.GROUP_LAUNCHES[G] == before + 1
    want = slice_records_plain(lambda p: calc(p)[2], cfg, (5, 6), *args)
    one = pallas_slice_v4.slice_epoch(calc, cfg, (5, 6), *args, group=1)
    for a, b, c in zip(got, want, one):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert (got[2][~valid] == 0).all()
    assert bool((got[1][valid] == np.float32(cfg.logzero)).any()) == capped


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
        "slice_epoch_v2_counted": 0, "slice_step": 0}
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
    kernels and B1 at every group size, and one epoch of B1 at every group
    size at the ini's dimension against the plain engine on a live set of
    the ini's prior."""
    s, calc = _ini_calc(name, dev)
    D, R, B = s.nDims, 4, 256
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,))
    for engine in ("cuda", "cuda3", "cuda2", "cuda5"):
        pallas_slice_v4.validate_functor(calc, cfg, dev, kernel_wrapper(engine))
    for G in pallas_slice_v4.GROUPS:  # B1 at every group size
        pallas_slice_v4.validate_functor(
            calc, cfg, dev, functools.partial(pallas_slice_v4.slice_epoch, group=G))
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


def test_v3_instr_refuses_a_grid_that_is_not_co_resident(dev):
    """More blocks of 32 lanes than 132 SMs x 32 resident blocks can hold:
    the cooperative launch raises instead of hanging at its barrier."""
    B = 132 * 32 * 32 + 32
    like = gaussian(2, sigma=0.2)
    calc = make_batched_calculator(identity_prior, like, 2, 2)
    cfg = EpochConfig(n_dims=2, n_phi=2, grade_dims=(2,), num_repeats=(1,))
    args = (torch.full((B, 2), 0.5, device=dev), torch.zeros(B, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev),
            torch.ones((B, 1, 2), device=dev) / math.sqrt(2), torch.ones((B, 1), device=dev))
    with pytest.raises(RuntimeError, match="resident"):
        v3_instr.slice_epoch_v3_instr(calc, cfg, (1, 2), *args)


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
    """Unit directions without B2, whose kernel stops at dim 32."""
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


def test_quickstart_runs_on_the_card(dev):
    """The per-point torch quickstart through run(): the traced route and
    B2, chained epochs kept (their replay check holds), and the same run as
    the plain engine's on the card."""
    results = {}
    for engine in ("auto", "torch"):
        with tempfile.TemporaryDirectory() as base:
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # a replay divergence would warn
                out = pt.run(_quickstart, 4, nDerived=1, prior=UniformPrior(-1, 1), nlive=100,
                             num_repeats=8, do_clustering=False, read_resume=False,
                             base_dir=base, seed=5, feedback=-1, device="cuda", engine=engine)
            with open(os.path.join(base, "test.metrics.jsonl")) as f:
                last = json.loads(f.read().splitlines()[-1])
            assert last["form"] == "per_point" and last["chained_epochs"] is True
            ran = last["kernel_launches"]
            if engine == "auto":
                assert last["engine"] == "cuda" and last["route"] == "slice_step"
                assert ran["slice_step"] > 0 and ran["gram_schmidt"] > 0
                assert ran["slice_epoch"] == 0 and last["traced_route"]["replays"] > 0
            assert abs(out.logZ + 4 * math.log(2.0)) < 3 * out.logZerr
            results[engine] = (out.ndead, out.logZ, out.logZerr,
                               np.loadtxt(os.path.join(base, "test.txt")))
    assert results["auto"][:3] == results["torch"][:3]
    np.testing.assert_array_equal(results["auto"][3], results["torch"][3])
