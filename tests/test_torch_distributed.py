"""The port over several OS processes on the CPU (the counterpart of
``tests/test_distributed.py``): two processes joined by ``torch.distributed``
over gloo give the one-process epoch bit for bit on every engine's plain
version, and a whole run that every rank computes alike, equal to the
one-process run at the same batch, with files on rank 0 alone.  A resume
file that only rank 0 sees raises the same error on both ranks.  Every
subprocess has a timeout of its own."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, for each subprocess

EPOCH_WORKER = r"""
import sys
rank, n_proc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, %(repo)r)
import numpy as np, torch
torch.set_num_threads(1)
from polychordlite_tpu_torch.models.graded import GradedLikelihood
from polychordlite_tpu_torch.ops import fused_like
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.ops.pallas_slice import seed_key
from polychordlite_tpu_torch.ops.slice_kernel import EpochConfig
from polychordlite_tpu_torch.parallel import distributed, mesh

assert distributed.initialise_distributed(f"127.0.0.1:{port}", n_proc, rank) == rank
assert "jax" not in sys.modules
cpu, D = torch.device("cpu"), 3
lik = lambda th: -torch.sum((th - 0.5) ** 2, dim=-1)
results = {}
for route in ("plain", "fused", "traced", "graded", "host", "cuda5", "cuda3", "cuda2"):
    if route == "host":
        calc = make_batched_calculator(
            lambda c: c, lambda th: -float(np.sum((np.asarray(th) - 0.5) ** 2)), D, 1,
            device="cpu")
    elif route == "graded":
        calc = make_batched_calculator(lambda c: c, GradedLikelihood(
            lambda th: torch.sum((th[..., :1] - 0.5) ** 2, dim=-1),
            lambda aux, th: -(aux + torch.sum((th[..., 1:] - 0.5) ** 2, dim=-1)), 1),
            D, 1, device="cpu")
    else:
        calc = make_batched_calculator(lambda c: c, lik, D, 1, device="cpu")
    if route == "traced":
        calc.__dict__["fused"] = fused_like.Refused("forced: the traced route")
    engine = {"plain": "torch", "fused": "cuda", "traced": "cuda", "graded": "scan",
              "host": "scan"}.get(route, route)
    grades = ((1, 2), (2, 2)) if route == "graded" else ((D,), (4,))
    cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=grades[0], num_repeats=grades[1],
                      engine=engine)
    g = torch.Generator(device=cpu)
    g.manual_seed(5)
    # two local shards a process: 4 shards over two processes, 1 in one
    local = [cpu] * (2 if n_proc > 1 else 1)
    run, B = mesh.make_epoch_runner(calc, cfg, 64, cpu, g, devices=local)
    assert run.n_shards == (4 if n_proc > 1 else 1) and run.n_processes == n_proc
    seeds = np.full((B, D), 0.5)
    bound = np.full((B,), -0.09)
    chol = np.broadcast_to(np.eye(D), (B, D, D))
    cube, theta, phi, logL, nlike = run(seed_key(5), seeds, bound, chol)
    for k, v in (("cube", cube), ("logL", logL), ("nlike", nlike), ("theta", theta)):
        results[f"{route}_{k}"] = v
np.savez(out + f".{rank}.npz", **results)
print("WORKER_OK", rank, flush=True)
"""

RUN_WORKER = r"""
import hashlib, json, math, os, sys, time
base, mode = sys.argv[1], sys.argv[2]
sys.path.insert(0, %(repo)r)
import numpy as np, torch
torch.set_num_threads(1)
import polychordlite_tpu_torch as pt
pt_run = sys.modules["polychordlite_tpu_torch.run"]  # the package's run() hides the module
from polychordlite_tpu_torch.core.generate import generate_live_points
from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
from polychordlite_tpu_torch.parallel import distributed
from polychordlite_tpu_torch.priors import UniformPrior

def lik(theta):
    r2 = torch.sum(theta ** 2, dim=-1)
    return -r2 / 2 / 0.01 - 2 * math.log(0.1 * math.sqrt(2 * math.pi)), r2[..., None]

def lik_numpy(theta):  # the same model as a host callback, one point at a time
    r2 = float(np.sum(np.asarray(theta) ** 2))
    return -r2 / 2 / 0.01 - 2 * math.log(0.1 * math.sqrt(2 * math.pi)), [r2]

kw = dict(nDerived=1, prior=UniformPrior(-1, 1), nlive=50, num_repeats=6, seed=3,
          feedback=-1, batch_size=64, max_ndead=400, device="cpu", base_dir=base,
          file_root="mp", chain_epochs=0)
rank = distributed.initialise_distributed()  # torchrun's environment, or none
if rank == 1:  # a slower host on rank 1: rank 0 waits for it in the gather
    kw["dumper"] = lambda *a: time.sleep(0.1)
# the initial live points, drawn on each rank from the device generator
s = pt.PolyChordSettings(2, 1, nlive=50, seed=3).finalise()
gen = torch.Generator(device="cpu")
gen.manual_seed(3)
calc = make_batched_calculator(UniformPrior(-1, 1), lik, 2, 1, device="cpu")
rti, _, _ = generate_live_points(calc, s, gen, torch.device("cpu"))
live = hashlib.sha256(np.ascontiguousarray(rti.live[0]).tobytes()).hexdigest()
# the administrator's own result (rank 0's run() returns the files' parse)
kept, sampler = {}, pt_run.nested_sampling
pt_run.nested_sampling = lambda *a, **k: kept.setdefault("out", sampler(*a, **k))
try:
    if mode == "resume":
        out = pt.run(lik, 2, read_resume=True, write_resume=True, **kw)
    elif mode == "callback":
        out = pt.run(lik_numpy, 2, read_resume=False, **kw)
    else:
        out = pt.run(lik, 2, read_resume=False, **kw)
except RuntimeError as e:
    print("RAISED " + json.dumps(str(e)), flush=True)
    sys.exit(0)
out = kept["out"]
print("RESULT " + json.dumps({"rank": rank, "logZ": out["logZ"], "logZerr": out["logZerr"],
                              "ndead": out["ndead"], "nlike": out["nlike"], "live": live,
                              "host_calls": out["metrics"]["host_calls"],
                              "device_s": out["metrics"]["device_frac"] * out["metrics"]["wall_s"],
                              "timers": out["metrics"]["epoch_timers"]}), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(extra)
    return env


def _communicate(procs):
    """Each process's (returncode, stdout, stderr), each waited for at most
    TIMEOUT seconds; the others are killed if one times out."""
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _spawn(args, env):
    return subprocess.Popen(args, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_two_processes_give_the_one_process_epoch(tmp_path):
    """Two gloo processes of two local shards each (4 shards) give the
    one-process, one-shard epoch bit for bit on every engine's plain
    version: the plain engine, B1's fused and traced routes, the graded and
    host routes, B3, B4 and B5."""
    script = tmp_path / "epoch_worker.py"
    script.write_text(EPOCH_WORKER % {"repo": REPO})
    port = _free_port()
    ref = _communicate([_spawn([sys.executable, str(script), "0", "1", port,
                                str(tmp_path / "ref")], _env())])
    assert ref[0][0] == 0, ref[0][2][-2000:]
    outs = _communicate([_spawn([sys.executable, str(script), str(i), "2", port,
                                 str(tmp_path / "two")], _env()) for i in range(2)])
    for rc, so, se in outs:
        assert rc == 0 and "WORKER_OK" in so, se[-2000:]
    a = np.load(tmp_path / "ref.0.npz")
    for rank in (0, 1):
        b = np.load(tmp_path / f"two.{rank}.npz")
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 32
        for k in a.files:
            assert np.array_equal(a[k], b[k]), (rank, k)
    assert (a["plain_nlike"] > 0).all()


def _parse(so):
    for line in so.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line in: {so[-2000:]}")


def _torchrun_env(rank, port):
    return _env(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=port)


def test_full_run_two_processes(tmp_path):
    """A whole run on two processes started as torchrun starts them (its
    environment): both ranks compute the same logZ, ndead and nlike, equal to
    the one-process run at the same batch (2-D, nlive 50, batch 64,
    max_ndead 400, the JAX test's settings); each rank draws the same initial
    live points; rank 0 writes the run's .stats and .txt byte for byte as
    the one-process run does, and rank 1 writes no file.  Rank 1's dumper
    sleeps, so rank 0 waits for it in the gather; a rank's device time is
    its collects' fetch and unpack, the gather left out."""
    script = tmp_path / "run_worker.py"
    script.write_text(RUN_WORKER % {"repo": REPO})
    ref = _communicate([_spawn([sys.executable, str(script), str(tmp_path / "ref"), "run"],
                               _env())])[0]
    assert ref[0] == 0, ref[2][-2000:]
    one = _parse(ref[1])
    port = _free_port()
    dirs = [tmp_path / "p0", tmp_path / "p1"]
    outs = _communicate([_spawn([sys.executable, str(script), str(dirs[i]), "run"],
                                _torchrun_env(i, port)) for i in range(2)])
    res = []
    for rc, so, se in outs:
        assert rc == 0, se[-2000:]
        res.append(_parse(so))
    assert [r["rank"] for r in res] == [0, 1] and one["rank"] == 0
    for r in res:
        for k in ("logZ", "logZerr", "ndead", "nlike", "live"):
            assert r[k] == one[k], (r["rank"], k)
        assert r["timers"]["gather"] > 0
        assert r["device_s"] <= r["timers"]["fetch"] + r["timers"]["unpack"] + 0.02, r
    for suffix in (".stats", ".txt"):
        want = (tmp_path / "ref" / f"mp{suffix}").read_bytes()
        assert (dirs[0] / f"mp{suffix}").read_bytes() == want
    assert not [p for p in dirs[1].rglob("*") if p.is_file()]


def test_host_callback_run_splits_its_calls_over_two_processes(tmp_path):
    """A numpy likelihood (a host callback) shards like a torch one: a
    whole run on two processes gives both ranks the one-process run's logZ,
    ndead and nlike, and each rank calls the user's function on its own
    lanes only, so on fewer points than the one process does."""
    script = tmp_path / "run_worker.py"
    script.write_text(RUN_WORKER % {"repo": REPO})
    ref = _communicate([_spawn([sys.executable, str(script), str(tmp_path / "ref"),
                                "callback"], _env())])[0]
    assert ref[0] == 0, ref[2][-2000:]
    one = _parse(ref[1])
    port = _free_port()
    outs = _communicate([_spawn([sys.executable, str(script), str(tmp_path / f"p{i}"),
                                 "callback"], _torchrun_env(i, port)) for i in range(2)])
    res = []
    for rc, so, se in outs:
        assert rc == 0, se[-2000:]
        res.append(_parse(so))
    for r in res:
        for k in ("logZ", "logZerr", "ndead", "nlike"):
            assert r[k] == one[k], (r["rank"], k)
        assert 0 < r["host_calls"] < 0.75 * one["host_calls"], (r["host_calls"], one)


def test_resume_file_on_one_rank_raises_on_both(tmp_path):
    """A resume file that rank 0 sees and rank 1 does not raises the same
    RuntimeError on both ranks, before either samples."""
    script = tmp_path / "run_worker.py"
    script.write_text(RUN_WORKER % {"repo": REPO})
    dirs = [tmp_path / "p0", tmp_path / "p1"]
    first = _communicate([_spawn([sys.executable, str(script), str(dirs[0]), "run"], _env())])[0]
    assert first[0] == 0 and (dirs[0] / "mp.resume").exists(), first[2][-2000:]
    port = _free_port()
    outs = _communicate([_spawn([sys.executable, str(script), str(dirs[i]), "resume"],
                                _torchrun_env(i, port)) for i in range(2)])
    msgs = []
    for rc, so, se in outs:
        assert rc == 0, se[-2000:]
        line = [ln for ln in so.splitlines() if ln.startswith("RAISED ")]
        assert line, so[-2000:]
        msgs.append(json.loads(line[0][len("RAISED "):]))
    assert msgs[0] == msgs[1] and "visible on some processes but not all" in msgs[0]


def test_ini_cli_on_two_processes(tmp_path):
    """``python -m polychordlite_tpu_torch <ini> --device cpu`` started as
    torchrun starts two ranks, on a shrunk copy of the shipped
    gaussian_shells.ini (clustering on) at batch 64: both ranks print the
    same summary line, rank 0 writes the run's files and the paramnames,
    rank 1 writes nothing."""
    src = open(os.path.join(REPO, "ini", "gaussian_shells.ini")).read()
    src = (src.replace("nlive = 500", "nlive = 50").replace("num_repeats = 10", "num_repeats = 4")
           .replace("feedback = 1", "feedback = 0\nmax_ndead = 300\nseed = 2\nbatch_size = 64"))
    port = _free_port()
    procs = []
    for i in range(2):
        ini = tmp_path / f"shells{i}.ini"
        ini.write_text(src.replace("base_dir = chains", f"base_dir = {tmp_path / f'p{i}'}"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "polychordlite_tpu_torch", str(ini), "--device", "cpu"],
            cwd=REPO, env=_torchrun_env(i, port), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    lines = []
    for rc, so, se in _communicate(procs):
        assert rc == 0, se[-2000:]
        lines.append([ln for ln in so.splitlines() if ln.startswith("logZ = ")])
    assert len(lines[0]) == 1 and lines[0] == lines[1]
    assert (tmp_path / "p0" / "gaussian_shells.stats").exists()
    assert (tmp_path / "p0" / "gaussian_shells.paramnames").exists()
    assert not [p for p in (tmp_path / "p1").rglob("*") if p.is_file()]
    last = (tmp_path / "p0" / "gaussian_shells.metrics.jsonl").read_text().splitlines()[-1]
    assert json.loads(last)["processes"] == 2 and json.loads(last)["shards"] == 2
    assert json.loads(last)["epoch_timers"]["gather"] > 0
