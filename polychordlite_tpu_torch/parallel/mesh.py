"""The epoch runner on one device (counterpart of
``polychordlite_tpu/parallel/mesh.py``, without the multi-device mesh).

The *logical* batch width B (the nursery the administrator consumes) is
rounded to 8 lanes; the engine is fed a *physical* batch padded to
``GRANULE`` lanes with invalid lanes (``valid = 0``: they never move and are
dropped before the nursery is returned).  The CUDA kernels take any width;
128 lanes are whole thread blocks of each.  All engines use the same
granule, so they draw the same directions and, the kernels and their plain
versions agreeing bit for bit, a run gives the same result on any of them.

Each epoch crosses the host-device boundary as one packed upload and one
fetch of the full epoch record (cube, theta, phi, logL per baby).
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.pallas_slice import key_words
from ..ops.slice_kernel import EpochConfig, build_epoch_fn, unpack_epoch

GRANULE = 128


def make_epoch_runner(
    calc: Callable,
    cfg: EpochConfig,
    batch_size: int,
    device: torch.device,
    generator: torch.Generator,
) -> Tuple[Callable, int]:
    """Build ``run(key, seeds, bound, chol) -> (cube, theta, phi, logL,
    nlike)`` (numpy outputs) and the logical chain-batch width B.  ``key`` is
    a raw uint32[2] epoch key (``ops/pallas_slice.py``); ``generator`` is the
    device generator the directions are drawn from."""
    B = -(-batch_size // 8) * 8
    B_phys = -(-B // GRANULE) * GRANULE
    D = cfg.n_dims
    stride = 2 * D + cfg.n_phi + 1
    R_tot = cfg.total_repeats
    tail = len(cfg.grade_dims) + 1  # per-grade nlike + overflow flag

    epoch_fn = build_epoch_fn(calc, cfg)
    if cfg.engine != "torch" and calc.device_spec is not None:  # the functor, in its kernel
        from ..ops.pallas_slice_v4 import validate_functor
        from ..ops.slice_kernel import kernel_wrapper

        validate_functor(calc, cfg, device, kernel_wrapper(cfg.engine))

    # cumulative epoch-phase timers (host clock, seconds)
    timers = {"pack": 0.0, "enqueue": 0.0, "fetch": 0.0, "unpack": 0.0}

    def pack_inputs(seed_cube, bound, chol):
        """One upload buffer: per lane [cube(D), bound, cholesky(D*D), valid],
        padding lanes (copies of lane 0) marked invalid."""
        flat = np.concatenate(
            [seed_cube, bound[:, None], chol.reshape(B, D * D), np.ones((B, 1))],
            axis=1,
        ).astype(np.float32)
        if B_phys == B:
            return flat
        pad = np.repeat(flat[:1], B_phys - B, axis=0)
        pad[:, -1] = 0.0
        return np.concatenate([flat, pad], axis=0)

    def run_packed(key, packed_in):
        seed_cube = packed_in[:, :D]
        bound = packed_in[:, D]
        chol = packed_in[:, D + 1 : D + 1 + D * D].reshape(-1, D, D)
        valid = packed_in[:, -1] > 0.5
        out = epoch_fn(key_words(key), seed_cube, bound, chol, valid,
                       generator=generator)
        return out[:B]

    def dispatch(key, seed_cube, bound, chol):
        """Upload one epoch's inputs and enqueue it on the device."""
        t0 = time.perf_counter()
        packed_in = pack_inputs(
            np.asarray(seed_cube), np.asarray(bound), np.asarray(chol)
        )
        timers["pack"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = run_packed(key, torch.as_tensor(packed_in, device=device))
        timers["enqueue"] += time.perf_counter() - t0
        return out

    def unpack(packed_out):
        t0 = time.perf_counter()
        res = unpack_epoch(packed_out, cfg)
        timers["unpack"] += time.perf_counter() - t0
        return res

    def collect(out):
        """Wait for a dispatched epoch and unpack its nursery."""
        t0 = time.perf_counter()
        packed_out = out.cpu().numpy()
        timers["fetch"] += time.perf_counter() - t0
        return unpack(packed_out)

    def run(key, seed_cube, bound, chol):
        return collect(dispatch(key, seed_cube, bound, chol))

    # ---- chained epochs (ops/chained_epoch.py): K epochs and the live-set
    # update in one dispatch, for synchronous one-cluster runs
    chains = {}

    def dispatch_chain(key, live_cube, live_logL, chol1, K):
        """Upload the live set and enqueue a K-epoch chain."""
        from ..ops.chained_epoch import build_chained_fn

        nlive = live_cube.shape[0]
        sig = (int(K), int(nlive))
        if sig not in chains:
            chains[sig] = build_chained_fn(
                run_packed, cfg, B, B_phys, K, nlive, device, generator
            )
        t0 = time.perf_counter()
        f32 = dict(dtype=torch.float32, device=device)
        chol_t = torch.as_tensor(np.asarray(chol1, np.float32), **f32)
        cube_t = torch.as_tensor(np.asarray(live_cube, np.float32), **f32)
        logL_t = torch.as_tensor(np.asarray(live_logL, np.float32), **f32)
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
    run.timers = timers
    return run, B
