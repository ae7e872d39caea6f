"""The run modes' remaining cases on the port, held against the JAX
package's tests of them: a resume continues a run (``tests/test_run.py:312``),
also under chained epochs (``tests/test_turbo.py:141``); a resume file of
another dimension is refused (``tests/test_run.py:325``); ``cube_samples``
(``tests/test_run.py:303``); and ``do_clustering``'s split bookkeeping and
its sub-dimension case (``tests/test_clustering.py:67-94``), with the JAX
package's clustering run on the same live set beside the port's."""

import json
import math
import os

import numpy as np
import pytest
import torch

import polychordlite_tpu.core.clustering as j_clu
import polychordlite_tpu.core.rti as j_rti
import polychordlite_tpu.settings as j_set
import polychordlite_tpu_torch as pt
import polychordlite_tpu_torch.core.clustering as p_clu
import polychordlite_tpu_torch.core.rti as p_rti
import polychordlite_tpu_torch.settings as p_set
from polychordlite_tpu_torch.ops.logspace import logsumexp
from polychordlite_tpu_torch.priors import UniformPrior
from polychordlite_tpu_torch.utils import resume as resume_mod

torch.set_num_threads(2)

NDIMS = 2
SIGMA = 0.1
ANALYTIC_LOGZ = -NDIMS * math.log(2)


def _gaussian(theta):
    r2 = torch.sum(theta ** 2, dim=-1)
    logL = -math.log(2 * math.pi * SIGMA * SIGMA) * NDIMS / 2.0 - r2 / 2 / SIGMA ** 2
    return logL, r2[..., None]


def run_small(tmp_path, file_root="t", seed=1, **kw):
    """tests/test_run.py's run_small, on the port's plain engine."""
    defaults = dict(nDerived=1, prior=UniformPrior(-1, 1), nlive=60, num_repeats=2 * NDIMS,
                    read_resume=False, base_dir=str(tmp_path), file_root=file_root, seed=seed,
                    feedback=0, precision_criterion=0.01, device="cpu")
    defaults.update(kw)
    return pt.run(_gaussian, NDIMS, **defaults)


def test_cube_samples(tmp_path):
    """The run starts from the given cube points (tests/test_run.py:303)."""
    cube = np.array([[0.1, 0.2], [0.5, 0.6], [0.4, 0.5], [0.52, 0.48]])
    out = run_small(tmp_path, file_root="cube", cube_samples=cube, nlive=40)
    assert np.isfinite(out.logZ)
    s = p_set.PolyChordSettings(NDIMS, 1, nlive=40).finalise()
    from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator

    calc = make_batched_calculator(UniformPrior(-1, 1), _gaussian, NDIMS, 1, device="cpu")
    rti = resume_mod.rti_from_cube_samples(s, cube, calc, 1, torch.device("cpu"))
    assert np.array_equal(rti.live[0][:, s.h], cube)


def test_resume_continues_run(tmp_path):
    """A capped run writes its resume file; the resumed run goes on from it
    to the end, accurately (tests/test_run.py:312)."""
    out1 = run_small(tmp_path, file_root="res", max_ndead=150, read_resume=False)
    assert out1.ndead >= 150
    out2 = run_small(tmp_path, file_root="res", read_resume=True, max_ndead=-1)
    assert out2.ndead > out1.ndead
    assert abs(out2.logZ - ANALYTIC_LOGZ) < 3 * out2.logZerr + 0.2


def test_resume_continues_under_chains(tmp_path):
    """Checkpoint and resume with chained epochs on: a run stopped at
    max_ndead resumes from its checkpoint and completes accurately, the
    epoch key stream going on from the saved epoch index
    (tests/test_turbo.py:141)."""
    def lik(theta):
        return (-torch.sum((theta / 0.1) ** 2, dim=-1) / 2
                - 4 * math.log(0.1 * math.sqrt(2 * math.pi)),
                torch.sum(theta ** 2, dim=-1)[..., None])

    kw = dict(nDerived=1, prior=UniformPrior(-1, 1), nlive=100, num_repeats=8, seed=6,
              feedback=0, base_dir=str(tmp_path), file_root="t", write_resume=True,
              read_resume=True, device="cpu")
    out1 = pt.run(lik, 4, max_ndead=400, **kw)
    assert out1.ndead == 400 + 100
    with open(os.path.join(str(tmp_path), "t.metrics.jsonl")) as f:
        assert json.loads(f.readlines()[-1])["chained_epochs"] is True
    epoch_idx = resume_mod.read_resume_file(
        p_set.PolyChordSettings(4, 1, base_dir=str(tmp_path), file_root="t").finalise(), 1
    )[0].epoch_idx
    assert epoch_idx > 0
    out2 = pt.run(lik, 4, **kw)
    assert out2.ndead > 600
    assert abs(out2.logZ - (-4 * math.log(2))) < 3 * out2.logZerr + 0.25


def test_resume_dimension_mismatch_rejected(tmp_path):
    """A resume file read with a settings object of another dimension
    raises (tests/test_run.py:325)."""
    run_small(tmp_path, file_root="mm", max_ndead=100, read_resume=False)
    s = p_set.PolyChordSettings(NDIMS + 1, 0, num_repeats=4)
    s.base_dir = str(tmp_path)
    s.file_root = "mm"
    s.finalise()
    with pytest.raises(ValueError):
        resume_mod.read_resume_file(s, 1)


def _blobs(seed=1, n_per=30):
    rng = np.random.default_rng(seed)
    return np.concatenate([c + 0.02 * rng.standard_normal((n_per, 2))
                           for c in (np.array([0.2, 0.2]), np.array([0.8, 0.8]))])


def _rti_with_blobs(set_mod, rti_mod):
    s = set_mod.PolyChordSettings(2, 0, nlive=60, num_repeats=4).finalise()
    rti = rti_mod.RunTimeInfo(s, 1)
    pts = _blobs()
    live = np.zeros((60, s.nTotal))
    live[:, s.h] = pts
    live[:, s.p] = pts
    live[:, s.l0] = -((pts - 0.5) ** 2).sum(1)
    rti.live[0] = live
    rti_mod.find_min_loglikelihoods(rti)
    return s, rti


def _both():
    return (_rti_with_blobs(p_set, p_rti)[1], _rti_with_blobs(j_set, j_rti)[1])


def test_split_detected_and_bookkept():
    """Two blobs split into two clusters of 30; the volumes split in
    proportion and sum to the original (log X = 0); the reorganisation
    bumps the epoch; the JAX package's clustering makes the same split
    (tests/test_clustering.py:67-76)."""
    rti, j = _both()
    assert p_clu.do_clustering(rti) and j_clu.do_clustering(j)
    assert rti.ncluster == j.ncluster == 2
    assert sorted(c.shape[0] for c in rti.live) == [30, 30]
    assert np.isclose(logsumexp(np, rti.logXp), 0.0)
    assert rti.epoch == j.epoch == 1
    np.testing.assert_array_equal(rti.logXp, j.logXp)
    for a, b in zip(rti.live, j.live):
        np.testing.assert_array_equal(a, b)


def test_stable_after_split():
    """A second pass finds nothing new (tests/test_clustering.py:78-83)."""
    rti, j = _both()
    p_clu.do_clustering(rti)
    j_clu.do_clustering(j)
    assert not p_clu.do_clustering(rti) and not j_clu.do_clustering(j)
    assert rti.ncluster == j.ncluster == 2


def test_sub_dimension_clustering():
    """Clustering on dimension 0 only still separates the blobs: 1-D data
    may over-fragment, but no cluster spans both blobs; the JAX package's
    clustering gives the same clusters (tests/test_clustering.py:85-94)."""
    rti, j = _both()
    assert p_clu.do_clustering(rti, sub_dimensions=[0])
    assert j_clu.do_clustering(j, sub_dimensions=[0])
    assert rti.ncluster >= 2 and rti.ncluster == j.ncluster
    for c in rti.live:
        side = c[:, 0] > 0.5
        assert side.all() or (~side).all()
    for a, b in zip(rti.live, j.live):
        np.testing.assert_array_equal(a, b)
