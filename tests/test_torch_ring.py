"""The ring engine (``engine="ring"``) in the port, on the CPU: its plain
version (``slice_records_plain`` with ``ring_cap``) against the plain
engine and at the budget's edge, the flag beside the JAX package's
``build_epoch_fn_ring``, the runner's re-run of an overflowed epoch
(``parallel/mesh.py``) against the ``"torch"`` runner on one shard, over 2
shards and with dispatch-ahead, whole runs against ``engine="torch"`` and
the JAX package's ring, and the engine rules.  ``tests/test_torch_cuda.py``
holds the ring instantiations on the card."""

import json
import math

import numpy as np
import pytest
import torch

import polychordlite_tpu_torch as pt
from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.models.graded import GradedLikelihood
from polychordlite_tpu_torch.ops import fused_like
from polychordlite_tpu_torch.ops import pallas_slice_v4 as v4
from polychordlite_tpu_torch.ops.chained_epoch import build_chained_fn
from polychordlite_tpu_torch.ops.directions import make_directions
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice import seed_key
from polychordlite_tpu_torch.ops.slice_kernel import (
    ENGINES,
    EpochConfig,
    build_epoch_fn,
    epoch_overflowed,
    epoch_route,
    slice_records_plain,
)
from polychordlite_tpu_torch.parallel import mesh
from polychordlite_tpu_torch.priors import UniformPrior, identity_prior
from polychordlite_tpu_torch.settings import PolyChordSettings

torch.set_num_threads(2)

CPU = torch.device("cpu")
KEY = (0x2468ACE0, 0x13579BDF)


def _gaussian(theta):
    return -torch.sum((theta - 0.5) ** 2, dim=-1) / (2 * 0.1 ** 2)


def _numpy_gaussian(theta):
    return -float(np.sum((np.asarray(theta) - 0.5) ** 2)) / (2 * 0.1 ** 2), [0.0]


def _calc(D, kind="torch"):
    if kind == "host":
        return make_batched_calculator(identity_prior, _numpy_gaussian, D, 1, device="cpu")
    return make_batched_calculator(identity_prior, _gaussian, D, 1, device="cpu")


def _inputs(B, R, D, seed=0, spread=0.05, r0=2.0):
    """Seeds about the peak, a ball contour r0 sigma wide, whitened
    directions; a tenth of the lanes invalid."""
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(0.5 + spread * rng.standard_normal((B, D)), dtype=torch.float32)
    bound = torch.full((B,), -0.5 * r0 ** 2 * D / 4)
    valid = torch.as_tensor(rng.uniform(size=B) > 0.1)
    chol = (0.1 * torch.eye(D)).expand(B, D, D)
    g = torch.Generator().manual_seed(seed)
    nhats, ws, _ = make_directions(chol, grade_dims=(D,), num_repeats=(R,), n_dims=D,
                                   generator=g, use_kernel=False)
    return x0, bound, valid, nhats, ws


def _cfg(calc, D, R, engine="ring", ring_factor=12):
    return EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(R,),
                       engine=engine, ring_factor=ring_factor)


@pytest.mark.parametrize("B,R,D", [(64, 11, 2), (48, 6, 20), (32, 4, 40)])
def test_plain_ring_is_the_plain_engine_where_the_flag_is_clear(B, R, D):
    """The ring's plain version gives the plain engine's records bit for bit
    on every lane whose flag is clear (``tests/test_slice.py:129-167``); at
    ring_factor 12 no lane overflows here, so the whole record is equal."""
    calc = _calc(D)
    args = _inputs(B, R, D)
    f = lambda p: calc(p)[2]  # noqa: E731
    cfg = _cfg(calc, D, R)
    want = slice_records_plain(f, cfg, KEY, *args)
    *got, flag = slice_records_plain(f, cfg, KEY, *args, ring_cap=cfg.ring_budget)
    assert flag.dtype == torch.bool and not flag.any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # a starved budget: the clear lanes still agree, and the flagged ones differ
    small = cfg._replace(ring_factor=2)
    *got, flag = slice_records_plain(f, small, KEY, *args, ring_cap=small.ring_budget)
    assert flag.any() and not flag.all()
    clear = ~flag
    for a, b in zip(got, want):
        assert torch.equal(a[clear], b[clear])
    assert not flag[~args[2]].any()  # an invalid lane never overflows


def test_ring_factor_one_flags_in_both_packages():
    """At the JAX test's shape (``tests/test_slice.py:170-200``: D = 2, B =
    16, R = 8, ring_factor 1) the JAX ring flags its epoch, and so does the
    port's ring epoch, whose last column carries the lanes' flags."""
    import jax
    import jax.numpy as jnp

    from polychordlite_tpu.ops.evaluate import make_batched_calculator as jax_calculator
    from polychordlite_tpu.ops.slice_kernel import EpochConfig as JaxConfig
    from polychordlite_tpu.ops.slice_kernel import build_epoch_fn_ring

    D, B, R = 2, 16, 8
    jcalc = jax_calculator(lambda c: c, lambda th: -jnp.sum((th - 0.5) ** 2), D, n_derived=1)
    jcfg = JaxConfig(n_dims=D, n_phi=jcalc.n_phi, grade_dims=(D,), num_repeats=(R,),
                     ring_factor=1)
    packed = np.asarray(jax.jit(build_epoch_fn_ring(jcalc, jcfg))(
        jax.random.PRNGKey(3), jnp.full((B, D), 0.5), jnp.full((B,), -0.04),
        jnp.broadcast_to(jnp.eye(D), (B, D, D)), jnp.ones((B,), bool)))
    assert packed[:, -1].all()

    calc = make_batched_calculator(identity_prior, lambda th: -torch.sum((th - 0.5) ** 2, -1),
                                   D, 1, device="cpu")
    cfg = _cfg(calc, D, R, ring_factor=1)
    epoch = build_epoch_fn(calc, cfg)
    g = torch.Generator().manual_seed(3)
    out = epoch(KEY, torch.full((B, D), 0.5), torch.full((B,), -0.04),
                torch.eye(D).expand(B, D, D), torch.ones(B, dtype=torch.bool), generator=g)
    assert epoch_overflowed(out) and epoch_overflowed(out.numpy()) and out[:, -1].all()
    # the same epoch re-run at the route's own budget: no flag, the torch epoch
    g = torch.Generator().manual_seed(3)
    again = epoch(KEY, torch.full((B, D), 0.5), torch.full((B,), -0.04),
                  torch.eye(D).expand(B, D, D), torch.ones(B, dtype=torch.bool), generator=g,
                  rerun=True)
    g = torch.Generator().manual_seed(3)
    plain = build_epoch_fn(calc, cfg._replace(engine="torch"))(
        KEY, torch.full((B, D), 0.5), torch.full((B,), -0.04), torch.eye(D).expand(B, D, D),
        torch.ones(B, dtype=torch.bool), generator=g)
    assert not epoch_overflowed(again) and torch.equal(again, plain)


def test_budget_edge():
    """A lane of n micro-steps is clear at a budget of n and flagged at
    n - 1: the flags are exactly ``steps > budget`` at any budget.  A lane
    whose budget ends on the micro-step that accepts a repeat other than
    its last is flagged too, with that repeat's record kept."""
    B, R, D = 48, 5, 4
    calc = _calc(D)
    f = lambda p: calc(p)[2]  # noqa: E731
    args = _inputs(B, R, D, seed=2)
    valid = args[2]
    cfg = _cfg(calc, D, R)
    *full, steps = slice_records_plain(f, cfg, KEY, *args, count_steps=True)
    n = int(steps[valid].max())
    for cap in (n, n - 1, int(steps[valid].median()), int(steps[valid].min()) - 1):
        flag = slice_records_plain(f, cfg, KEY, *args, ring_cap=cap)[-1]
        assert torch.equal(flag, steps > cap), cap
    # the micro-steps of repeat 0 alone (the same uniforms and direction)
    one = cfg._replace(num_repeats=(1,))
    x0, bound, valid, nhats, ws = args
    n0 = slice_records_plain(f, one, KEY, x0, bound, valid, nhats[:, :1], ws[:, :1],
                             count_steps=True)[-1]
    lane = int(torch.nonzero(valid)[0])
    cap = int(n0[lane])
    t, logL, nlike, flag = slice_records_plain(f, cfg, KEY, *args, ring_cap=cap)
    assert flag[lane]
    assert t[lane, 0] == full[0][lane, 0] and logL[lane, 0] == full[1][lane, 0]
    assert nlike[lane, 0] == full[2][lane, 0] and nlike[lane, 1:].sum() == 0


@pytest.mark.parametrize("kind", ["rounds", "host", "fused"])
def test_route_plain_versions_under_the_budget(kind):
    """The plain versions of the traced route (in rounds), the host route and
    the fused route under the ring's budget are the ring's plain version,
    flags included (the host route: t, logL, nlike and the flags)."""
    B, R, D = 40, 6, 3
    calc = _calc(D, "host" if kind == "host" else "torch")
    cfg = _cfg(calc, D, R, ring_factor=3)
    args = _inputs(B, R, D, seed=4)
    want = slice_records_plain(lambda p: calc(p)[2], cfg, KEY, *args, ring_cap=cfg.ring_budget)
    assert want[-1].any()
    if kind == "rounds":
        got = v4.slice_records_rounds_plain(lambda p: calc(p)[2], cfg, KEY, *args, rounds=3,
                                            ring_cap=cfg.ring_budget)
    elif kind == "host":
        t, logL, nlike, _, flag = v4.slice_records_host_plain(calc, cfg, KEY, *args,
                                                              ring_cap=cfg.ring_budget)
        got = (t, logL, nlike, flag)
    else:
        assert isinstance(fused_like.lowering(calc), fused_like.Lowered)
        got = v4.slice_epoch_fused(calc, cfg, KEY, *args, ring_cap=cfg.ring_budget)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _runner(calc, engine, ring_factor, devices, batch=64, seed=7):
    D = calc.n_dims
    g = torch.Generator(device=CPU).manual_seed(seed)
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,), num_repeats=(6,),
                      engine=engine, ring_factor=ring_factor)
    return mesh.make_epoch_runner(calc, cfg, batch, CPU, g, devices=devices)


@pytest.mark.parametrize("kind", ["torch", "host"])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("ahead", [False, True])
def test_runner_reruns_are_the_torch_runner(kind, n_shards, ahead):
    """At ring_factor 1 every epoch overflows and is re-run: the ring runner
    gives the ``"torch"`` runner's nurseries bit for bit over three epochs,
    on one shard and over 2, collected one by one or with two epochs
    dispatched before the first is collected, and counts every re-run."""
    D = 4
    calc = _calc(D, kind)
    devices = [CPU] * n_shards
    ring, B = _runner(calc, "ring", 1, devices)
    plain, _ = _runner(calc, "torch", 12, devices)
    seeds = np.full((B, D), 0.5)
    bound = np.full((B,), -2.0)
    chol = np.broadcast_to(0.05 * np.eye(D), (B, D, D))

    def epochs(run):
        outs = []
        if ahead:
            pending = run.dispatch(seed_key(1), seeds, bound, chol)
            for k in (2, 3):
                nxt = run.dispatch(seed_key(k), seeds, bound, chol)
                outs.append(run.collect(pending))
                pending = nxt
            outs.append(run.collect(pending))
        else:
            outs = [run(seed_key(k), seeds, bound, chol) for k in (1, 2, 3)]
        return outs

    got, want = epochs(ring), epochs(plain)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert ring.ring_reruns() == 3 and plain.ring_reruns() == 0
    assert ring.timers["rerun"] > 0


QUICK = dict(nlive=25, max_ndead=150, do_clustering=False, read_resume=False, feedback=0,
             chain_epochs=0)


@pytest.mark.parametrize("model", ["torch", "host"])
@pytest.mark.parametrize("ring_factor", [12, 1])
def test_run_files_are_the_torch_runs(model, ring_factor, tmp_path, monkeypatch):
    """run(engine="ring", device="cpu", chain_epochs=0) writes the
    ``"torch"`` run's .stats, .txt and dead files byte for byte, a torch
    model and a host callback alike; at ring_factor 1 (the configuration's
    default patched) with every epoch re-run, as the final metrics record's
    ``ring_reruns`` says."""
    if ring_factor != 12:
        monkeypatch.setattr(ns, "EpochConfig",
                            lambda **kw: EpochConfig(**kw, ring_factor=ring_factor))
    like = (lambda th: (_gaussian(th), (th ** 2).sum(-1, keepdim=True))) if model == "torch" \
        else _numpy_gaussian
    roots = {}
    for engine in ("ring", "torch"):
        base = tmp_path / engine
        pt.run(like, 3, nDerived=1, prior=UniformPrior(0, 1), base_dir=str(base), seed=4,
               device="cpu", engine=engine, **QUICK)
        roots[engine] = base
    for name in ("test.stats", "test.txt", "test_dead.txt"):
        assert (roots["ring"] / name).read_bytes() == (roots["torch"] / name).read_bytes(), name
    last = json.loads((roots["ring"] / "test.metrics.jsonl").read_text().splitlines()[-1])
    assert last["engine"] == "ring" and last["route"] == "plain"
    assert (last["ring_reruns"] > 0) == (ring_factor == 1)
    assert last["ring_reruns"] == (last["epochs"] if ring_factor == 1 else 0)
    assert last["chained_epochs"] is False


def test_ring_run_against_the_jax_ring(tmp_path):
    """The JAX package's run(engine="ring") and the port's on the 4-D
    quickstart at nlive 50: logZ within 3 combined sigma (the two RNGs
    differ, so the check is statistical), each near -4 log 2."""
    import jax.numpy as jnp

    from polychordlite_tpu import run as jax_run
    from polychordlite_tpu.priors import UniformPrior as JaxUniformPrior

    kw = dict(nDerived=1, nlive=50, seed=3, feedback=0, engine="ring", read_resume=False)
    ref = jax_run(lambda th: (-jnp.sum(th ** 2) / 0.02 - 2 * math.log(2 * math.pi * 0.01),
                              [jnp.sum(th ** 2)]), 4, prior=JaxUniformPrior(-1, 1),
                  base_dir=str(tmp_path / "jax"), **kw)
    out = pt.run(lambda th: (-torch.sum(th ** 2) / 0.02 - 2 * math.log(2 * math.pi * 0.01),
                             [torch.sum(th ** 2)]), 4, prior=UniformPrior(-1, 1),
                 base_dir=str(tmp_path / "port"), device="cpu", **kw)
    combined = math.hypot(out.logZerr, ref.logZerr)
    assert abs(out.logZ - ref.logZ) < 3 * combined, (out.logZ, ref.logZ, combined)
    for r in (out, ref):
        assert abs(r.logZ + 4 * math.log(2)) < 3 * r.logZerr


def test_engine_rules(monkeypatch):
    """"ring" is an engine on the CPU and the card (a host callback too); a
    graded model raises naming "scan"; a forced chain raises; the chained
    epochs' build_chained_fn refuses it; an unknown engine still raises."""
    assert "ring" in ENGINES
    calc = _calc(4)
    host = _calc(4, "host")
    graded = make_batched_calculator(
        identity_prior, GradedLikelihood(lambda ts: torch.sum(ts ** 2, -1),
                                         lambda aux, th: -aux - torch.sum(th[..., 2:] ** 2, -1),
                                         2), 4, 0, device="cpu")
    assert ns.resolve_engine("ring", CPU, calc) == "ring"
    assert ns.resolve_engine("ring", CPU, host) == "ring"
    assert epoch_route("ring", calc, CPU) == "plain" and epoch_route("ring", calc) == "plain"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = torch.device("cuda")
    assert ns.resolve_engine("ring", cuda, calc) == "ring"
    assert ns.resolve_engine("ring", cuda, host) == "ring"
    assert epoch_route("ring", host, cuda) == "slice_step_host"
    assert epoch_route("ring", calc, cuda) == epoch_route("cuda", calc)
    for dev in (CPU, cuda):
        with pytest.raises(ValueError, match="engine='scan'"):
            ns.resolve_engine("ring", dev, graded)
    with pytest.raises(ValueError, match="unknown engine"):
        ns.resolve_engine("rings", CPU, calc)
    s = PolyChordSettings(4, 0, chain_epochs=4)
    with pytest.raises(ValueError, match="engine='ring'"):
        ns.check_chain_request(s, CPU, "ring")
    ns.check_chain_request(s, CPU, "torch")
    ns.check_chain_request(PolyChordSettings(4, 0), CPU, "ring")  # auto: no chain
    with pytest.raises(ValueError, match="ring engine"):
        build_chained_fn(None, _cfg(calc, 4, 4), 8, 128, 2, 8, CPU, None)
    with pytest.raises(ValueError, match="engine='ring'"):
        pt.run(_gaussian, 4, engine="ring", chain_epochs=4, device="cpu", nlive=25,
               write_resume=False, feedback=0)
