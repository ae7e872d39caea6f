"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here needs an NVIDIA GPU and nvcc; without a CUDA device each
one skips.  The file imports no JAX, so it also runs on a machine without
it, where the repository's conftest (which imports jax) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import math
import os
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import polychordlite_tpu_torch as pt  # noqa: E402
from polychordlite_tpu_torch.models import gaussian  # noqa: E402
from polychordlite_tpu_torch.ops import pallas_dirs, pallas_slice_v4  # noqa: E402
from polychordlite_tpu_torch.ops.directions import make_directions  # noqa: E402
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator  # noqa: E402
from polychordlite_tpu_torch.ops.slice_kernel import (  # noqa: E402
    EpochConfig,
    slice_records_plain,
)
from polychordlite_tpu_torch.priors import UniformPrior, identity_prior  # noqa: E402

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
