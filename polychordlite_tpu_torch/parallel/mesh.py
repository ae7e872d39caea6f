"""The epoch runner: the chain batch over shards and processes
(counterpart of ``polychordlite_tpu/parallel/mesh.py``).

The reference's MPI likelihood farm (``src/polychord/mpi_utils.F90``;
SURVEY §5.8) maps to shards of the chain batch: n = (local devices) x
(processes) shards, each of B / n chains.  The *logical* batch width B (the
nursery the administrator consumes) is rounded to 8 n lanes; each shard is
padded to ``GRANULE`` lanes of its own with invalid lanes (``valid = 0``:
they never move and are dropped before the nursery is returned).  The CUDA
kernels take any width; 128 lanes are whole thread blocks of each.

A run over n shards is bitwise the run over one shard at the same logical
B, on every engine: a lane draws its uniforms from its *logical* index in
the batch (the kernels' ``lane0``, ``ops/pallas_slice.py::lane_hash``), and
its directions from its column of the one-shard draw (every shard draws the
whole batch's Gaussians from the same generator state and keeps its own
columns, ``ops/directions.py::shard_draws``; B2 orthonormalises each
chain's bases alone).  Shards on local devices are launched one after
another with no sync between them (a list may name one device several
times: the test seam, as the JAX tests' ``devices=``); shards of other
processes run there, and the nurseries come back in lane order through a
gloo ``all_gather`` (``parallel/distributed.py``).  Chained epochs run on
one shard only.

Each epoch crosses the host-device boundary as one packed upload a shard
and one fetch of the full epoch record (cube, theta, phi, logL per baby),
in the calc's dtype (float64 at ``precision='highest'``).  Every engine of
``ops/slice_kernel.py`` runs behind the same runner, ``"scan"`` (a graded
model's, and a host callback's host route) included.  A host-callback
model shards like any other: each process calls the user's function on
its own shards' lanes only (the JAX package keeps it on one device, since
``pure_callback`` cannot run under ``shard_map``; nothing here needs that).

The ring engine (``engine="ring"``) runs each epoch under its budget and
flags the lanes it stopped (the record's last column).  When the gathered
record of every shard of every process holds a flag, each shard re-runs
its own rows on the same route at the route's own budget, from the inputs
and the directions' draws its dispatch kept (never from the generator,
which a dispatch-ahead run has moved on), and the gather runs again: the
JAX runner's re-run of an overflowed ring epoch
(``polychordlite_tpu/parallel/mesh.py:296-305``), counted by
``run.ring_reruns()``, not a demotion.  The JAX runner re-runs on its scan
engine; here the re-run is B1's route for a torch model and the host route
for a host callback on the card (B1 takes 0.81 ms an epoch at the bench
against ~169 ms for the lockstep graded route, PERF.md section 6), the
plain engine on the CPU: each is bitwise the port's ``"scan"`` on that
model.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.directions import draw_directions, shard_draws
from ..ops.pallas_slice import key_words
from ..ops.precision import calc_dtype
from ..ops.slice_kernel import (EpochConfig, build_epoch_fn, epoch_overflowed, epoch_route,
                                unpack_epoch)
from . import distributed

GRANULE = 128


def run_group(engine: str, calc, B: int, D: int, device: torch.device):
    """G, the lanes per chain that ``engine``'s kernel picks for B chains of
    D coordinates of ``calc`` on ``device`` (None on the CPU, where the
    wrappers run their plain versions): B1's (``pallas_slice_v4.route_group``)
    where ``"cuda"`` or the ring takes it."""
    if device.type != "cuda":
        return None
    from ..ops.pallas_slice_v4 import _sm_count, choose_group, route_group
    from ..ops.pallas_slice_v5 import packet_group_for

    if engine == "cuda5":
        return packet_group_for(calc, B, D, device)
    if engine in ("cuda", "ring"):
        return route_group(calc, B, D, device)
    return choose_group(B, D, _sm_count(device))


def local_devices(device: torch.device) -> List[torch.device]:
    """The devices this process shards over by default: every card for a
    bare ``"cuda"`` in a process alone; the one device otherwise (a rank of
    a process group takes its own card, ``core/nested_sampling.py::
    resolve_device``; a device with an index, or the CPU, is one device)."""
    if device.type == "cuda" and device.index is None and distributed.process_count() == 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def run_devices(device: torch.device, n_devices: Optional[int] = None) -> List[torch.device]:
    """This process's shards: :func:`local_devices`, cut to the first
    ``n_devices`` (the settings' ``mesh_shape``) when it is given."""
    devices = local_devices(device)
    return devices if n_devices is None else devices[: max(1, int(n_devices))]


def shard_layout(batch_size: int, n_shards: int) -> Tuple[int, int, int]:
    """(B, rows, rows_phys): the logical width, rounded to 8 lanes a shard
    (``polychordlite_tpu/parallel/mesh.py:71``), the logical lanes of one
    shard, and a shard's physical width, padded to :data:`GRANULE`."""
    B = -(-batch_size // (8 * n_shards)) * (8 * n_shards)
    rows = B // n_shards
    return B, rows, -(-rows // GRANULE) * GRANULE


def make_epoch_runner(
    calc: Callable,
    cfg: EpochConfig,
    batch_size: int,
    device: torch.device,
    generator: torch.Generator,
    devices: Optional[List] = None,
    n_devices: Optional[int] = None,
) -> Tuple[Callable, int]:
    """Build ``run(key, seeds, bound, chol) -> (cube, theta, phi, logL,
    nlike)`` (numpy outputs) and the logical chain-batch width B.  ``key`` is
    a raw uint32[2] epoch key (``ops/pallas_slice.py``); ``generator`` is the
    generator on ``device`` the directions are drawn from.

    ``devices`` are this process's shards (default :func:`local_devices`,
    cut to the first ``n_devices``, the settings' ``mesh_shape``).
    ``run.n_shards`` is the count of shards over all processes;
    ``run.ring_reruns()`` the epochs the ring engine re-ran."""
    devices = run_devices(device, n_devices) if devices is None else devices
    devices = [torch.device(d) for d in devices]
    n_proc = distributed.process_count()
    rank = distributed.process_index()
    n_local = len(devices)
    if n_proc > 1:
        counts = distributed.all_gather_rows(np.asarray([n_local], np.int64))
        if (counts != n_local).any():
            raise ValueError(f"the processes shard over different device counts {counts.tolist()}")
    n_shards = n_local * n_proc
    B, rows, rows_phys = shard_layout(batch_size, n_shards)
    B_phys = -(-B // GRANULE) * GRANULE  # the one-shard width, which every shard draws
    first = rank * n_local  # this process's first shard
    D = cfg.n_dims
    stride = 2 * D + cfg.n_phi + 1
    R_tot = cfg.total_repeats
    tail = len(cfg.grade_dims) + 1  # per-grade nlike + overflow flag

    epoch_fn = build_epoch_fn(calc, cfg)
    real = calc_dtype(calc)
    np_real = np.float32 if real == torch.float32 else np.float64
    ring = cfg.engine == "ring"
    route = epoch_route(cfg.engine, calc, devices[0]) if cfg.engine != "torch" else "plain"
    # the functor (or the lowered one), in its kernel, at the (bucket, G) that
    # a shard takes, on each device once (the ring's instantiation and the
    # one its re-run takes); the traced and graded routes evaluate the calc
    # itself, in torch, and the host route on the host
    from ..ops.fused_like import lowering
    from ..ops.pallas_slice_v4 import ring_records, slice_epoch, validate_functor, validate_fused
    from ..ops.slice_kernel import kernel_wrapper

    for dev in dict.fromkeys(devices):
        group = run_group(cfg.engine, calc, rows_phys, D, dev)
        if ring and route == "slice_epoch":
            for r in (False, True):
                validate_functor(calc, cfg, dev, ring_records(slice_epoch, group, r))
        elif route not in ("plain", "slice_epoch_fused", "slice_step", "slice_step_graded",
                           "slice_step_host"):
            # a functor kernel against the calc, or a forced engine's fused
            # route against the lowering's plain version
            wrapper = kernel_wrapper(cfg.engine)
            want = lowering(calc).plain_logL if route.endswith("_fused") else None
            validate_functor(calc, cfg, dev, lambda *a: wrapper(*a, group=group),  # noqa: B023
                             want=want)
        elif cfg.engine in ("cuda", "ring") and dev.type == "cuda" and route == "slice_epoch_fused":
            for r in (False, True) if ring else (False,):
                validate_fused(calc, cfg, dev, group, ring=r)

    # cumulative epoch-phase timers (host clock, seconds); "gather" is the
    # wait for the other processes' shards, host time, not the device's;
    # the ring engine's "rerun", its re-runs of overflowed epochs, enqueue
    # to fetch
    timers = {"pack": 0.0, "enqueue": 0.0, "fetch": 0.0, "gather": 0.0, "unpack": 0.0,
              **({"rerun": 0.0} if ring else {})}
    counts = {"ring_reruns": 0}

    def pack_inputs(seed_cube, bound, chol):
        """The logical lanes' inputs: per lane [cube(D), bound,
        cholesky(D*D), valid]."""
        return np.concatenate(
            [seed_cube, bound[:, None], chol.reshape(B, D * D), np.ones((B, 1))],
            axis=1,
        ).astype(np_real)

    def pad_shard(flat, width):
        """A shard's upload buffer: its lanes and ``width`` - len lanes of
        padding (copies of its first lane) marked invalid."""
        if width == flat.shape[0]:
            return flat
        pad = np.repeat(flat[:1], width - flat.shape[0], axis=0)
        pad[:, -1] = 0.0
        return np.concatenate([flat, pad], axis=0)

    def run_packed(key, packed_in, n_log=B, draws=None, lane0=0, rerun=False):
        """The epoch of one shard's packed batch: the records of its first
        ``n_log`` (logical) lanes, on the batch's device (``rerun``: the
        ring's re-run)."""
        seed_cube = packed_in[:, :D]
        bound = packed_in[:, D]
        chol = packed_in[:, D + 1 : D + 1 + D * D].reshape(-1, D, D)
        valid = packed_in[:, -1] > 0.5
        out = epoch_fn(key_words(key), seed_cube, bound, chol, valid,
                       generator=generator, draws=draws, lane0=lane0, rerun=rerun)
        return out[:n_log]

    def dispatch(key, seed_cube, bound, chol):
        """Upload one epoch's inputs and enqueue it on this process's
        shards, one after the other; returns the handle :func:`collect`
        takes: the shards' outputs and, for the ring engine, the key and
        each shard's arguments (its packed inputs, its draws, its lanes) for
        a re-run."""
        t0 = time.perf_counter()
        packed_in = pack_inputs(
            np.asarray(seed_cube), np.asarray(bound), np.asarray(chol)
        )
        timers["pack"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        if n_shards == 1:
            # the ring draws its directions here, as the epoch would (the
            # same generator calls in the same order), and keeps the draws
            draws = (draw_directions(B_phys, cfg.grade_dims, cfg.num_repeats, D, generator,
                                     devices[0], real) if ring else None)
            shards = [(torch.as_tensor(pad_shard(packed_in, B_phys), device=devices[0]), B,
                       draws, 0)]
        else:
            # the whole batch's draws, from the one generator state every
            # shard of every process shares
            draws = draw_directions(B_phys, cfg.grade_dims, cfg.num_repeats, D, generator,
                                    device, real)
            shards = []
            for i, dev in enumerate(devices):
                lo = (first + i) * rows
                shard = torch.as_tensor(pad_shard(packed_in[lo:lo + rows], rows_phys),
                                        device=dev)
                shards.append((shard, rows, shard_draws(draws, lo, rows, rows_phys, dev), lo))
        outs = [run_packed(key, *sh) for sh in shards]
        timers["enqueue"] += time.perf_counter() - t0
        return (outs, (key, shards) if ring else None)

    def unpack(packed_out):
        t0 = time.perf_counter()
        res = unpack_epoch(packed_out, cfg)
        timers["unpack"] += time.perf_counter() - t0
        return res

    def fetch(outs):
        """The shards' records in lane order, those of every process."""
        t0 = time.perf_counter()
        packed_out = np.concatenate([o.cpu().numpy() for o in outs])
        timers["fetch"] += time.perf_counter() - t0
        if n_proc > 1:
            t0 = time.perf_counter()
            packed_out = distributed.all_gather_rows(packed_out)
            timers["gather"] += time.perf_counter() - t0
        return packed_out

    def collect(handle):
        """Wait for a dispatched epoch, gather its shards in lane order
        (those of every process) and unpack its nursery.  A ring epoch with
        a lane flagged anywhere is re-run on every shard and gathered
        again."""
        outs, kept = handle
        packed_out = fetch(outs)
        if kept is not None and epoch_overflowed(packed_out):
            counts["ring_reruns"] += 1
            t0 = time.perf_counter()
            key, shards = kept
            packed_out = fetch([run_packed(key, *sh, rerun=True) for sh in shards])
            timers["rerun"] += time.perf_counter() - t0
        return unpack(packed_out)

    def run(key, seed_cube, bound, chol):
        return collect(dispatch(key, seed_cube, bound, chol))

    # ---- chained epochs (ops/chained_epoch.py): K epochs and the live-set
    # update in one dispatch, for synchronous one-cluster runs on one shard
    chains = {}

    def dispatch_chain(key, live_cube, live_logL, chol1, K):
        """Upload the live set and enqueue a K-epoch chain."""
        from ..ops.chained_epoch import build_chained_fn

        if n_shards > 1:
            raise ValueError(f"chained epochs run on one shard, not {n_shards}")

        nlive = live_cube.shape[0]
        sig = (int(K), int(nlive))
        if sig not in chains:
            chains[sig] = build_chained_fn(
                run_packed, cfg, B, B_phys, K, nlive, device, generator
            )
        t0 = time.perf_counter()
        on = dict(dtype=real, device=device)
        chol_t = torch.as_tensor(np.asarray(chol1, np_real), **on)
        cube_t = torch.as_tensor(np.asarray(live_cube, np_real), **on)
        logL_t = torch.as_tensor(np.asarray(live_logL, np_real), **on)
        timers["pack"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        flat = chains[sig](key, chol_t, cube_t, logL_t)
        timers["enqueue"] += time.perf_counter() - t0
        return (flat, int(K), int(nlive))

    def collect_chain(handle):
        """Wait for a chain and unpack its K nurseries.  Returns
        (nurseries, (final live logL, final live cube)): nurseries is a
        list of (cube, theta, phi, logL, nlike, bound0) per epoch in order."""
        flat, K, nlive = handle
        W = R_tot * stride + tail
        t0 = time.perf_counter()
        flat = flat.cpu().numpy()
        timers["fetch"] += time.perf_counter() - t0
        packs = flat[: K * B * W].reshape(K, B, W)
        bounds = flat[K * B * W : K * B * W + K]
        final_ll = flat[K * B * W + K : K * B * W + K + nlive]
        final_cube = flat[K * B * W + K + nlive :].reshape(nlive, -1)
        nurseries = [(*unpack(packs[k]), float(bounds[k])) for k in range(K)]
        return nurseries, (final_ll, final_cube)

    run.dispatch = dispatch
    run.collect = collect
    run.dispatch_chain = dispatch_chain
    run.collect_chain = collect_chain
    run.engine_used = lambda: cfg.engine  # the engine that ran: no fallback
    run.ring_reruns = lambda: counts["ring_reruns"]
    run.timers = timers
    run.n_shards, run.n_processes = n_shards, n_proc
    return run, B
