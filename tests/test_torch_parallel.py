"""The port's chain batch over several shards on the CPU (the counterpart of
``tests/test_parallel.py``): the runner over ``[cpu] * 2`` and ``[cpu] * 4``
is bitwise the one-shard runner on every engine's plain version, a whole
run over local shards is bitwise the one-shard run, the B rounding is the
JAX package's, every plain version takes a shard's ``lane0``, and
dispatch-ahead mode (``synchronous=False``) against the JAX package's
tests of it (``tests/test_run.py:389-417``)."""

import math
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polychordlite_tpu_torch as pt
from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxEpochConfig
from polychordlite_tpu.parallel.mesh import make_epoch_runner as jax_make_epoch_runner
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.models.graded import GradedLikelihood
from polychordlite_tpu_torch.ops import fused_like
from polychordlite_tpu_torch.ops import pallas_slice, pallas_slice_v3, pallas_slice_v4
from polychordlite_tpu_torch.ops import pallas_slice_v5
from polychordlite_tpu_torch.ops.directions import make_directions
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice import seed_key
from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig, slice_records_plain
from polychordlite_tpu_torch.parallel import distributed, mesh
from polychordlite_tpu_torch.priors import UniformPrior

torch.set_num_threads(2)

CPU = torch.device("cpu")
D = 4


def _loglike(theta):
    return -torch.sum((theta - 0.5) ** 2, dim=-1) * 40.0


def _numpy_loglike(theta):
    return -float(np.sum((np.asarray(theta) - 0.5) ** 2)) * 40.0


def _calc(kind):
    """A 4-D model for each route: its calc and its engine."""
    if kind == "host":
        return make_batched_calculator(lambda c: c, _numpy_loglike, D, 1, device="cpu"), "scan"
    if kind == "graded":
        # the slow part the first two coordinates' sum of squares, carried
        # across the fast-grade repeats
        calc = make_batched_calculator(
            lambda c: c,
            GradedLikelihood(lambda th: torch.sum((th[..., :2] - 0.5) ** 2, dim=-1),
                             lambda aux, th: -(aux + torch.sum((th[..., 2:] - 0.5) ** 2,
                                                               dim=-1)) * 40.0, 2),
            D, 1, device="cpu")
        return calc, "scan"
    calc = make_batched_calculator(lambda c: c, _loglike, D, 1, device="cpu")
    if kind == "traced":
        calc.__dict__["fused"] = fused_like.Refused("forced: the traced route")
        return calc, "cuda"
    return calc, {"plain": "torch", "fused": "cuda"}.get(kind, kind)


ROUTES = ["plain", "fused", "traced", "scan", "graded", "host", "cuda5", "cuda3", "cuda2"]


def _cfg(calc, engine, R=6, grade_dims=(D,), num_repeats=None):
    return EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=grade_dims,
                       num_repeats=num_repeats or (R,), engine=engine)


def _epoch(calc, cfg, batch, devices, seed=7, key=3):
    """One epoch through the runner over ``devices``: the JAX test's inputs
    (seeds at the centre, bound -2, Cholesky 0.05 I)."""
    g = torch.Generator(device=CPU)
    g.manual_seed(seed)
    run, B = mesh.make_epoch_runner(calc, cfg, batch, CPU, g, devices=devices)
    seeds = np.full((B, D), 0.5)
    bound = np.full((B,), -2.0)
    chol = np.broadcast_to(0.05 * np.eye(D), (B, D, D))
    return run(seed_key(key), seeds, bound, chol), B, run


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("batch", [64, 200])
def test_shards_match_one_shard(route, batch):
    """2 and 4 shards give the one-shard epoch bit for bit at the same
    logical B, and 2 shards give what 4 give.  At batch 200 the widths are
    208 and 224, and a shard has 24 or 72 padding lanes of its own."""
    calc, engine = _calc(route)
    grades = ((2, 2), (3, 3)) if route == "graded" else ((D,), None)
    cfg = _cfg(calc, engine, grade_dims=grades[0], num_repeats=grades[1])
    outs = {}
    for n in (2, 4):
        outs[n], B, run = _epoch(calc, cfg, batch, [CPU] * n)
        assert B == -(-batch // (8 * n)) * 8 * n and run.n_shards == n
        one, B1, _ = _epoch(calc, cfg, B, [CPU])
        assert B1 == B
        for a, b in zip(one, outs[n]):
            assert np.array_equal(a, b), f"{n} shards changed the epoch"
        assert one[4].sum() > 0 and np.abs(one[0][:, -1] - 0.5).max() > 0.01  # it moved
    if batch == 64:
        for a, b in zip(outs[2], outs[4]):
            assert np.array_equal(a, b)


def test_b_rounding_is_the_jax_runners():
    """The logical width over n shards equals the JAX make_epoch_runner's
    over n devices, for a grid of batch sizes."""
    jcalc = jax_calculator(lambda c: c, lambda th: -jnp.sum((th - 0.5) ** 2), D, 1)
    jcfg = JaxEpochConfig(n_dims=D, n_phi=jcalc.n_phi, grade_dims=(D,), num_repeats=(2,))
    calc, _ = _calc("plain")
    cfg = _cfg(calc, "torch", R=2)
    g = torch.Generator(device=CPU)
    for n in (1, 2, 4, 8):
        for batch in (1, 7, 8, 9, 33, 63, 64, 65, 100, 200, 500, 512):
            _, jB = jax_make_epoch_runner(jcalc, jcfg, batch, devices=jax.devices()[:n])
            _, B = mesh.make_epoch_runner(calc, cfg, batch, CPU, g, devices=[CPU] * n)
            assert B == jB == mesh.shard_layout(batch, n)[0], (batch, n)
            B, rows, rows_phys = mesh.shard_layout(batch, n)
            assert rows * n == B and rows_phys % mesh.GRANULE == 0 and rows_phys >= rows


def _plain_inputs(B, R, seed=0, lo=0.5):
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(lo + 0.02 * rng.standard_normal((B, D)), dtype=torch.float32)
    bound = torch.full((B,), -2.0)
    valid = torch.as_tensor(rng.uniform(size=B) > 0.1)
    g = torch.Generator().manual_seed(seed)
    chol = torch.as_tensor(np.broadcast_to(0.05 * np.eye(D), (B, D, D)).copy(),
                           dtype=torch.float32)
    nhats, ws, speeds = make_directions(chol, grade_dims=(2, 2), num_repeats=(3, 3),
                                        n_dims=D, generator=g, use_kernel=False)
    return x0, bound, valid, nhats, ws, speeds


def _plain_versions():
    calc, _ = _calc("plain")
    host, _ = _calc("host")
    graded, _ = _calc("graded")
    f = lambda p: calc(p)[2]  # noqa: E731
    return {
        "plain (B1)": lambda cfg, *a, lane0: slice_records_plain(f, cfg, *a[:-1], lane0=lane0),
        "lockstep (B5)": lambda cfg, *a, lane0: pallas_slice.slice_records_lockstep_plain(
            f, cfg, *a[:-1], lane0=lane0)[:3],
        "window (B4)": lambda cfg, *a, lane0: pallas_slice_v3.slice_records_window_plain(
            f, cfg, *a[:-1], lane0=lane0),
        "packet (B3)": lambda cfg, *a, lane0: pallas_slice_v5.slice_records_packet_plain(
            f, cfg, *a[:-1], lane0=lane0),
        "rounds (traced)": lambda cfg, *a, lane0: pallas_slice_v4.slice_records_rounds_plain(
            f, cfg, *a[:-1], rounds=3, lane0=lane0),
        "graded": lambda cfg, *a, lane0: pallas_slice_v4.slice_records_graded_plain(
            graded, cfg, *a[:-1], pallas_slice_v4.repeat_grades(a[-1]), lane0=lane0),
        "host": lambda cfg, *a, lane0: pallas_slice_v4.slice_records_host_plain(
            host, cfg, *a[:-1], lane0=lane0)[:3],
    }


@pytest.mark.parametrize("version", list(_plain_versions()))
def test_lane0_in_every_plain_version(version):
    """A plain version run on lanes lo..lo+n-1 of a batch at lane0 = lo gives
    those lanes' records of the whole batch at lane0 = 0, bit for bit; at
    lane0 = 0 on the slice the records differ (the uniforms moved)."""
    fn = _plain_versions()[version]
    B, lo, n = 96, 40, 24
    calc, _ = _calc("plain")
    cfg = _cfg(calc, "torch", grade_dims=(2, 2), num_repeats=(3, 3))
    x0, bound, valid, nhats, ws, speeds = _plain_inputs(B, 6)
    kw = (11, 12)
    whole = fn(cfg, kw, x0, bound, valid, nhats, ws, speeds, lane0=0)
    cut = (x0[lo:lo + n], bound[lo:lo + n], valid[lo:lo + n], nhats[lo:lo + n], ws[lo:lo + n],
           speeds[lo:lo + n])
    part = fn(cfg, kw, *cut, lane0=lo)
    for a, b in zip(whole, part):
        assert torch.equal(a[lo:lo + n], b)
    moved = fn(cfg, kw, *cut, lane0=0)
    assert not all(torch.equal(a, b) for a, b in zip(part, moved))


def test_kernel_wrappers_pass_lane0(monkeypatch):
    """On the card every wrapper hands ``lane0`` to its kernel's entry (the
    launch is recorded instead of made)."""
    class OnCard:
        def __init__(self, *shape):
            self.shape, self.device = shape, torch.device("cuda")

    launched = []
    for mod in (pallas_slice_v4, pallas_slice_v5, pallas_slice_v3):  # B5 reads v4's
        monkeypatch.setattr(mod, "launch_slice_kernel",
                            lambda lib, entry, *a, lane0=0, **k:
                            launched.append((entry, lane0)) or (None, None, None))
    monkeypatch.setattr(pallas_slice_v4, "_lib", lambda: None)
    monkeypatch.setattr(pallas_slice_v5, "_lib", lambda: None)
    monkeypatch.setattr(pallas_slice, "_lib", lambda: None)
    monkeypatch.setattr(pallas_slice_v3.nvcc, "load", lambda *a: None)
    monkeypatch.setattr(pallas_slice_v4, "_sm_count", lambda dev: 132)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    args = (OnCard(512, 20), OnCard(512), OnCard(512), OnCard(512, 40, 20), OnCard(512, 40))
    cfg = EpochConfig(n_dims=20, n_phi=1, grade_dims=(20,), num_repeats=(40,))
    # a model with a device functor: the forced engines' functor kernels
    calc = SimpleNamespace(device_spec={"likelihood": {"name": "gaussian"}})
    pallas_slice_v4.slice_epoch(calc, cfg, (0, 0), *args, lane0=512)
    pallas_slice_v5.slice_epoch_v5(calc, cfg, (0, 0), *args, group=8, lane0=1024)
    pallas_slice_v3.slice_epoch_v3(calc, cfg, (0, 0), *args, lane0=256)
    pallas_slice.slice_epoch_v2(calc, cfg, (0, 0), *args, lane0=768)
    assert launched == [("slice_epoch_launch", 512), ("slice_epoch_v5_launch", 1024),
                        ("slice_epoch_v3_launch", 256), ("slice_epoch_v2_launch", 768)]


def test_ball_statistics_against_the_jax_runner():
    """The statistics contract of the slice engine (``tests/test_slice.py``):
    inside the contour r < r0 the final babies are uniform in the ball, E[r^2]
    = r0^2 D / (D + 2) and u = (r / r0)^D has mean 1/2, held for the port's
    runner over 2 shards and the JAX package's over 2 devices (its scan
    engine) at B = 64, D = 4."""
    r0, R, B = 0.3, 16, 64
    expect = r0 ** 2 * D / (D + 2)
    seeds, bound = np.full((B, D), 0.5), np.full((B,), -(r0 ** 2))
    chol = np.broadcast_to(np.eye(D), (B, D, D))
    calc = make_batched_calculator(lambda c: c, lambda th: -torch.sum((th - 0.5) ** 2, dim=-1),
                                   D, 1, device="cpu")
    g = torch.Generator(device=CPU)
    g.manual_seed(5)
    run, Bp = mesh.make_epoch_runner(calc, _cfg(calc, "torch", R=R), B, CPU, g,
                                     devices=[CPU] * 2)
    jcalc = jax_calculator(lambda c: c, lambda th: -jnp.sum((th - 0.5) ** 2), D, 1)
    jcfg = JaxEpochConfig(n_dims=D, n_phi=jcalc.n_phi, grade_dims=(D,), num_repeats=(R,))
    jrun, jB = jax_make_epoch_runner(jcalc, jcfg, B, devices=jax.devices()[:2])
    assert Bp == jB == B
    for cube, logL in ((run(seed_key(7), seeds, bound, chol)[0::3]),
                       (jrun(jax.random.PRNGKey(7), seeds, bound, chol)[0::3])):
        assert np.all(logL >= -(r0 ** 2) - 1e-5)
        r2 = ((cube[:, -1] - 0.5) ** 2).sum(-1)
        assert abs(r2.mean() - expect) < 4 * np.std(r2) / np.sqrt(B) + 1e-4
        u = (np.sqrt(r2) / r0) ** D
        assert abs(u.mean() - 0.5) < 4 * (0.29 / np.sqrt(B))


def test_one_process_distributed_is_the_identity():
    assert distributed.initialise_distributed() == 0
    assert distributed.is_root() and distributed.process_count() == 1
    assert distributed.broadcast_from_root(5) == 5
    assert distributed.all_any_flags(True) == (True, True)
    assert distributed.all_any_flags(False) == (False, False)
    rows = np.arange(6.0).reshape(3, 2)
    assert distributed.all_gather_rows(rows) is rows


def test_process_group_that_cannot_start_raises():
    """A group asked for without its address raises; nothing goes on as one
    process."""
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialise_distributed(num_processes=2)


# ------------------------------------------------------- a run over shards
QUICK = dict(nDerived=1, prior=UniformPrior(-1, 1), nlive=50, num_repeats=6, read_resume=False,
             seed=3, feedback=-1, batch_size=64, max_ndead=400, device="cpu")


def _lik(theta):
    r2 = torch.sum(theta ** 2, dim=-1)
    return -r2 / 2 / 0.01 - 2 * math.log(0.1 * math.sqrt(2 * math.pi)), r2[..., None]


@pytest.mark.parametrize("n", [2, 4])
def test_run_over_local_shards_is_the_one_shard_run(tmp_path, monkeypatch, n):
    """A whole run over n local shards (mesh_shape = n, the CPU listed n
    times) is the one-shard run at the same B: the same logZ, ndead and
    nlike, and the same .stats and .txt files, byte for byte.  The
    one-shard run dispatches one epoch at a time (chain_epochs = 0), as a
    sharded run does."""
    one = pt.run(_lik, 2, base_dir=str(tmp_path / "one"), chain_epochs=0, **QUICK)
    monkeypatch.setattr(mesh, "local_devices", lambda device: [device] * 4)
    many = pt.run(_lik, 2, base_dir=str(tmp_path / "many"), mesh_shape=n, **QUICK)
    for k in ("logZ", "logZerr", "ndead", "nlike"):
        assert getattr(one, k) == getattr(many, k), k
    for suffix in (".stats", ".txt"):
        assert ((tmp_path / "one" / f"test{suffix}").read_bytes()
                == (tmp_path / "many" / f"test{suffix}").read_bytes())
    rec = [ln for ln in (tmp_path / "many" / "test.metrics.jsonl").read_text().splitlines()][-1]
    assert f'"shards": {n}' in rec and '"chained_epochs": false' in rec


def test_forced_chain_over_local_shards_raises(tmp_path, monkeypatch):
    """chain_epochs = 4 over two local shards (the CPU listed twice,
    mesh_shape = 2) raises a ValueError before the run that names the shards
    (a chain runs on one shard; it used to be dropped without a word); left
    at auto the same run dispatches per epoch."""
    monkeypatch.setattr(mesh, "local_devices", lambda device: [device] * 2)
    with pytest.raises(ValueError, match=r"chain_epochs=4 .*over 2 shards"):
        pt.run(_lik, 2, base_dir=str(tmp_path / "forced"), mesh_shape=2, chain_epochs=4,
               **QUICK)
    assert not (tmp_path / "forced" / "test.txt").exists()
    out = pt.run(_lik, 2, base_dir=str(tmp_path / "auto"), mesh_shape=2,
                 **{**QUICK, "max_ndead": 100})
    rec = (tmp_path / "auto" / "test.metrics.jsonl").read_text().splitlines()[-1]
    assert out.ndead >= 100 and '"chained_epochs": false' in rec


def test_forced_chain_with_synchronous_false_raises(tmp_path):
    """chain_epochs = 4 with synchronous=False (dispatch-ahead, one epoch at
    a time) raises a ValueError before the run that names the mode."""
    with pytest.raises(ValueError, match=r"chain_epochs=4 .*synchronous=False"):
        pt.run(_lik, 2, base_dir=str(tmp_path), chain_epochs=4, synchronous=False, **QUICK)


# ------------------------------------------------- dispatch-ahead (async)
NDIMS = 2
SIGMA = 0.1
ANALYTIC_LOGZ = -NDIMS * math.log(2)  # a normalised Gaussian over U[-1, 1]^2


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


class TestAsyncStaleness:
    """Dispatch-ahead mode (the JAX package's ``TestAsyncStaleness``): the
    same B = nlive default as synchronous mode, one warning of its bias at
    the start of a run, none in synchronous mode, and an accurate run."""

    def test_batch_default_is_nlive_in_both_modes(self):
        s = pt.PolyChordSettings(4, 0, nlive=200, synchronous=False)
        assert s.resolved_batch_size() == 200
        s_sync = pt.PolyChordSettings(4, 0, nlive=200, synchronous=True)
        assert s_sync.resolved_batch_size() == 200

    def test_async_warns_about_bias(self, tmp_path):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            run_small(tmp_path, file_root="aw", synchronous=False, max_ndead=120)
        assert any("biases logZ high" in str(x.message) for x in w)

    def test_sync_does_not_warn_about_bias(self, tmp_path):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            run_small(tmp_path, file_root="sw", max_ndead=120)
        assert not any("biases logZ high" in str(x.message) for x in w)

    def test_async_default_run_accurate(self, tmp_path):
        with pytest.warns(UserWarning, match="biases logZ high"):
            out = run_small(tmp_path, file_root="ad", synchronous=False)
        assert abs(out.logZ - ANALYTIC_LOGZ) < 3 * out.logZerr + 0.15

    def test_async_dispatches_ahead_and_never_chains(self, tmp_path, monkeypatch):
        """The next epoch is dispatched right after a nursery is collected,
        before the host consumes it (no live point was replaced between the
        collect and the dispatch); in synchronous mode after the host
        consumed it.  No chain runs in dispatch-ahead mode."""
        events = []
        replaced = [0]
        real_replace, real_runner = ns.try_replace_live, mesh.make_epoch_runner

        def replace(*a, **k):
            replaced[0] += 1
            return real_replace(*a, **k)

        def runner(*a, **k):
            run, B = real_runner(*a, **k)
            dispatch, collect = run.dispatch, run.collect

            def d(*x):
                events.append(("d", replaced[0]))
                return dispatch(*x)

            def c(h):
                events.append(("c", replaced[0]))
                return collect(h)

            run.dispatch, run.collect = d, c
            return run, B

        monkeypatch.setattr(ns, "try_replace_live", replace)
        monkeypatch.setattr(ns, "make_epoch_runner", runner)
        with pytest.warns(UserWarning, match="biases logZ high"):
            run_small(tmp_path, file_root="da", synchronous=False, max_ndead=200)
        ahead, events[:] = list(events), []
        run_small(tmp_path, file_root="ds", max_ndead=200, chain_epochs=0)
        for log, same in ((ahead, True), (events, False)):
            pairs = [(log[i - 1], e) for i, e in enumerate(log) if e[0] == "d" and i]
            assert len(pairs) >= 2
            assert all(p[0] == "c" and (p[1] == e[1]) == same for p, e in pairs)
        rec = (tmp_path / "da.metrics.jsonl").read_text().splitlines()[-1]
        assert '"chained_epochs": false' in rec and '"synchronous": false' in rec
