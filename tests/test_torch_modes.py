"""The run modes of the port beside precision (ROADMAP A10), on the CPU:
the nlives schedule, the post-run maximiser and the reference's text
resume format, each against the JAX package's tests of the same mode
(``tests/test_run.py:118-180``, ``tests/test_legacy_resume.py``) and, where
both packages can be handed the same state, against the JAX package itself.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polychordlite_tpu.core.maximiser as j_max
import polychordlite_tpu.core.rti as j_rti
import polychordlite_tpu.settings as j_set
import polychordlite_tpu.utils.legacy_resume as j_legacy
import polychordlite_tpu_torch as pt
import polychordlite_tpu_torch.core.maximiser as p_max
import polychordlite_tpu_torch.core.rti as p_rti
import polychordlite_tpu_torch.settings as p_set
import polychordlite_tpu_torch.utils.legacy_resume as p_legacy
import polychordlite_tpu_torch.utils.resume as p_resume
import test_legacy_resume as jax_legacy_cases
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.priors import UniformPrior as JaxUniformPrior
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.priors import UniformPrior
from test_torch_host import _assert_same, _fields

SIGMA = 0.1
NDIMS = 2


def gaussian_likelihood(theta):
    """tests/test_run.py's likelihood, per point in torch."""
    r2 = torch.sum(theta ** 2)
    logL = -math.log(2 * math.pi * SIGMA * SIGMA) * NDIMS / 2.0 - r2 / 2 / SIGMA ** 2
    return logL, [r2]


def jax_gaussian_likelihood(theta):
    r2 = jnp.sum(theta ** 2)
    logL = -math.log(2 * math.pi * SIGMA * SIGMA) * NDIMS / 2.0 - r2 / 2 / SIGMA ** 2
    return logL, [r2]


def run_small(tmp_path, file_root="t", seed=1, **kw):
    """tests/test_run.py's run_small, on the port's plain engine."""
    defaults = dict(
        nDerived=1, prior=UniformPrior(-1, 1), nlive=60, num_repeats=2 * NDIMS,
        read_resume=False, base_dir=str(tmp_path), file_root=file_root, seed=seed,
        feedback=0, precision_criterion=0.01, device="cpu",
    )
    defaults.update(kw)
    return pt.run(gaussian_likelihood, NDIMS, **defaults)


def records(tmp_path, root):
    with open(os.path.join(str(tmp_path), f"{root}.metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------------------- nlives
def test_nlives_schedule(tmp_path):
    """tests/test_run.py::test_nlives_schedule: the live population tracks
    the schedule as the contour rises (60 down towards 25), and no chain
    was dispatched under it."""
    run_small(tmp_path, file_root="sched", nlive=60, nlives={-20.0: 25})
    recs = records(tmp_path, "sched")
    lives = [r["nlive"] for r in recs[:-1]]
    assert max(lives) > 25
    assert min(lives) <= 30
    assert recs[-1]["chained_epochs"] is True and recs[-1]["chains_dispatched"] == 0


def test_chains_run_without_a_schedule(tmp_path):
    """The same run without a schedule dispatches chains: the gate is the
    schedule, not the settings."""
    run_small(tmp_path, file_root="flat", nlive=60)
    assert records(tmp_path, "flat")[-1]["chains_dispatched"] > 0


# ------------------------------------------------------------- maximise
def _maximum_rows(path):
    rows = []
    for line in open(path).read().splitlines():
        try:
            rows.append([float(x) for x in line.split()])
        except ValueError:
            continue
    return [r for r in rows if r]


def test_maximise_writes_maximum_file(tmp_path):
    """tests/test_run.py::test_maximise_writes_maximum_file: the post-run
    Nelder-Mead finds the Gaussian's peak at the origin and writes
    <root>.maximum."""
    run_small(tmp_path, file_root="mx", maximise=True)
    path = os.path.join(str(tmp_path), "mx.maximum")
    text = open(path).read()
    assert "loglikelihood" in text.lower()
    rows = _maximum_rows(path)
    assert any(len(r) >= NDIMS and all(abs(v) < 0.05 for v in r[:NDIMS]) for r in rows), rows
    peak = -math.log(2 * math.pi * SIGMA * SIGMA) * NDIMS / 2.0
    assert abs(rows[0][0] - peak) < 0.01  # the maximum logL


@pytest.mark.parametrize("seed", [0, 1])
def test_maximise_matches_jax_on_the_same_state(seed, monkeypatch):
    """The port's maximiser and the JAX package's, handed the same live set
    and the same model: max logL within 1e-4, the max-likelihood and
    max-posterior points within 1e-3.  Both evaluate in float32 (the JAX
    package always does, C-fault 12), in different frameworks, so the
    Nelder-Mead paths may part on float32 rounding: the tolerances are
    those of the optimum, not of the path."""
    D, nlive = 3, 50
    rng = np.random.default_rng(seed)
    cubes = 0.5 + 0.15 * (rng.uniform(0, 1, (nlive, D)) - 0.5)
    got = {}
    for name, set_mod, rti_mod, max_mod, calc in (
        ("jax", j_set, j_rti, j_max,
         jax_calculator(JaxUniformPrior(-1, 1), jax_gaussian_likelihood, D, 1)),
        ("torch", p_set, p_rti, p_max,
         make_batched_calculator(UniformPrior(-1, 1), gaussian_likelihood, D, 1)),
    ):
        s = set_mod.PolyChordSettings(D, 1, nlive=nlive, base_dir="unused").finalise()
        rti = rti_mod.RunTimeInfo(s, 1)
        rti.live[0] = max_mod._eval_batch(calc, s, cubes)
        captured = {}
        monkeypatch.setattr(max_mod, "write_max_file",
                            lambda s, a, b, dx, c=captured: c.update(a=a, b=b, dx=dx))
        max_mod.maximise(calc, s, rti)
        got[name] = (s, captured)
    (s, j), (_, p) = got["jax"], got["torch"]
    assert abs(j["a"][s.l0] - p["a"][s.l0]) < 1e-4
    np.testing.assert_allclose(p["a"][s.pd], j["a"][s.pd], atol=1e-3)
    np.testing.assert_allclose(p["b"][s.pd], j["b"][s.pd], atol=1e-3)
    assert abs(j["dx"] - p["dx"]) < 1e-3
    assert np.all(np.abs(p["a"][s.p]) < 0.01)  # the peak is at the origin


def test_logP_batch_is_one_calc_call():
    """tests/test_run.py::test_posterior_mode_dispatch_batching: the points
    and all their Jacobian probes in ONE calc call; UniformPrior(-2, 2)'s
    log-Jacobian is 4 log 4."""
    prior = UniformPrior(-2.0, 2.0)

    def like(theta):
        return -torch.sum(theta ** 2) * 5.0

    calls = {"n": 0}
    calc0 = make_batched_calculator(prior, like, 4, 0)

    def counting(cube):
        calls["n"] += 1
        return calc0(cube)

    counting.n_phi, counting.dtype, counting.device = calc0.n_phi, calc0.dtype, calc0.device
    s = p_set.PolyChordSettings(4, 0).finalise()
    cubes = np.full((5, 4), 0.5) + 0.01 * np.arange(20).reshape(5, 4)
    logP, pts, dX = p_max._logP_batch(counting, s, cubes)
    assert calls["n"] == 1, "simplex + Jacobians must be a single call"
    assert logP.shape == (5,) and dX.shape == (5,)
    assert np.allclose(-dX, 4 * math.log(4.0), atol=2e-2)
    assert np.allclose(logP, pts[:, s.l0] - 4 * math.log(4.0), atol=2e-2)


def test_maximiser_evaluates_in_the_calc_dtype():
    """_eval_batch evaluates in the calc's dtype: at float64 a likelihood
    near 1e7 keeps digits that float32 would drop (the JAX package's cast
    to float32 is not copied)."""
    from polychordlite_tpu_torch.ops.precision import real_dtype_scope

    def big(theta):
        return 1.0e7 - torch.sum(theta ** 2)

    with real_dtype_scope(torch.float64):
        calc = make_batched_calculator(UniformPrior(-1, 1), big, 2, 0)
    s = p_set.PolyChordSettings(2, 0).finalise()
    cubes = np.array([[0.5, 0.5], [0.5005, 0.5]])
    logL = p_max._eval_batch(calc, s, cubes)[:, s.l0]
    assert logL[0] == 1.0e7 and logL[1] == 1.0e7 - 0.001 ** 2


# ------------------------------------------------------------- text resume
def test_reads_the_jax_written_text_resume(tmp_path):
    """tests/test_legacy_resume.py's mid-run state, written in the text
    format by the JAX package: the port's read_resume_file gives the same
    RunTimeInfo as the JAX reader, with no generator state or key."""
    s_j, rti = jax_legacy_cases.midrun_state()
    path = tmp_path / "t.resume"
    j_legacy.write_legacy_resume(str(path), s_j, rti)
    want = j_legacy.read_legacy_resume(str(path), s_j, 1)
    s_p = p_set.PolyChordSettings(2, 0, nlive=10, num_repeats=4, base_dir=str(tmp_path),
                                  file_root="t").finalise()
    got, rng_state, key = p_resume.read_resume_file(s_p, 1)
    assert rng_state is None and key is None
    assert type(got).__module__ == "polychordlite_tpu_torch.core.rti"
    _assert_same(_fields(want), _fields(got))
    assert got.ncluster == 2


def test_text_resume_round_trip_and_mismatches(tmp_path):
    """The port's own writer and reader round-trip the JAX case's state
    (test_full_state_round_trip), and a dimension or grade mismatch is
    refused as the JAX reader refuses it."""
    s_j, rti_j = jax_legacy_cases.midrun_state()
    path = str(tmp_path / "t.resume")
    j_legacy.write_legacy_resume(path, s_j, rti_j)
    s = p_set.PolyChordSettings(2, 0, nlive=10, num_repeats=4).finalise()
    rti = p_legacy.read_legacy_resume(path, s, 1)
    p_legacy.write_legacy_resume(str(tmp_path / "u.resume"), s, rti)
    assert open(path).read() == open(tmp_path / "u.resume").read()
    with pytest.raises(ValueError):
        p_legacy.read_legacy_resume(path, p_set.PolyChordSettings(3, 0).finalise(), 1)
    s3 = p_set.PolyChordSettings(2, 0, nlive=10, num_repeats=4)
    s3.grade_dims = [1, 1]
    s3.finalise()
    with pytest.raises(ValueError):
        p_legacy.read_legacy_resume(path, s3, 2)


def test_reads_a_pypolychord_forged_text_resume(tmp_path):
    """The minimal file pypolychord forges for cube_samples, as the JAX test
    writes it, read by the port."""
    jax_legacy_cases.TestForgedResume().test_read_pypolychord_forged_file(tmp_path)
    s = p_set.PolyChordSettings(2, 0, nlive=4, num_repeats=4).finalise()
    rti = p_legacy.read_legacy_resume(str(tmp_path / "forged.resume"), s, 1)
    assert rti.ncluster == 1 and rti.live[0].shape == (2, s.nTotal)
    assert rti.logZ == -1e30 and np.allclose(rti.cholesky[0], np.eye(2))


def test_run_continues_from_a_text_resume(tmp_path):
    """A run of the port stopped at 60 dead, its state rewritten in the
    reference's text format, is continued by run(read_resume=True) to 150
    dead: the text file is read, the run goes on from it."""
    kw = dict(nlive=25, num_repeats=4, do_clustering=False, write_dead=False,
              posteriors=False, equals=False, write_live=False, write_prior=False)
    run_small(tmp_path, file_root="c", max_ndead=60, **kw)
    s = p_set.PolyChordSettings(NDIMS, 1, base_dir=str(tmp_path), file_root="c").finalise()
    rti, _, _ = p_resume.read_resume_file(s, 1)
    p_legacy.write_legacy_resume(p_resume.resume_path(s), s, rti)
    assert open(p_resume.resume_path(s)).read(1) == "="
    out = run_small(tmp_path, file_root="c", max_ndead=150, read_resume=True, **kw)
    assert out.ndead >= 150 and np.isfinite(out.logZ)


def test_synchronous_false_runs_and_warns_of_its_bias(tmp_path):
    """The mode that raised until it was ported, asynchronous dispatch: it
    now runs, and warns of its bias (tests/test_torch_parallel.py holds it
    to the JAX package's tests), with the other modes of the check."""
    with pytest.warns(UserWarning, match="biases logZ high"):
        out = run_small(tmp_path, synchronous=False, max_ndead=120)
    assert out.ndead >= 120 and np.isfinite(out.logZ)
    ns._check_supported(p_set.PolyChordSettings(2, 0, maximise=True, precision="highest",
                                                nlives={-5.0: 10}).finalise())
