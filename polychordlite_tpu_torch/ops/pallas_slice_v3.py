"""The v3 slice epoch (counterpart of ``polychordlite_tpu/ops/pallas_slice_v3.py``).

:func:`slice_epoch_v3` is the wrapper of the hand-written CUDA kernel
``csrc/slice_epoch_v3.cu`` (B4, the JAX package's ``"pallas3"`` engine):
each chain runs its repeats freely with the state machine it shares with
B1, each repeat under the budget of one v3 grid step; a chain holds G lanes
of a warp, on B1's template under v3's budget policy.  A model without a
device functor whose likelihood ``ops/fused_like.py`` lowers runs the same
template with the lowered functor (``csrc/slice_epoch_fused.cu`` built with
``FUSED_V3``, route ``slice_epoch_v3_fused``; its plain version
:func:`slice_records_window_plain` on ``Lowered.plain_logL``).  For CPU tensors it
runs :func:`slice_records_window_plain`, v3's own structure in plain torch;
for CUDA tensors it launches the kernel or raises.

v3's structure (``pallas_slice_v3.py:93-287``): grid steps r = 0..R-1; in
step r the lanes run through their own repeats up to ``RC - 1 = 3`` ahead
of r (a lane further ahead stalls: the direction window holds repeats
r..r+3 only), in bodies of 4 micro-steps, until every lane has finished
repeat r or ``cap_body`` bodies have run; accepted (t, logL, nlike) go into
a ring of RC slots keyed by repeat, and slot r is flushed to the outputs at
the end of step r.  A lane's uniforms are keyed on its own (repeat,
micro-step), so stalls change nothing it decides: both forms give t, logL
and nlike bitwise equal to the v4 engine's.  ``cap_body`` cannot bind (it
exceeds the micro-steps one repeat can take); if it did, v3 would write the
lagging lane's repeat into a recycled slot (ROADMAP C9) — here the repeat
is recorded unaccepted and the lane stops, as at B1's budget.  Positions
are rebuilt outside as ``seed + cumsum(t n̂)`` (``assemble_epoch``).
"""

from __future__ import annotations

import torch

from ..utils import nvcc
from .pallas_slice import BODY, PH_DONE, PH_INIT_R, LaneMachine, _mix, lane_hash
from .pallas_slice_v4 import (GROUPS, forced_lowering, fused_functor, launch_group,
                               launch_slice_kernel)
from .pallas_slice_v4 import GROUP_LAUNCHES as _B1_GROUP_LAUNCHES

#: kernel launches since the last reset (compare-with-plain launches
#: included): the functor kernel, and the fused route's
LAUNCHES = {"slice_epoch_v3": 0, "slice_epoch_v3_fused": 0}
#: slice_epoch_v3's launches (functor and fused) by (bucket, G) since the last reset (the keys of
#: ``pallas_slice_v4.GROUP_LAUNCHES``), apart from B1's
GROUP_LAUNCHES = dict.fromkeys(_B1_GROUP_LAUNCHES, 0)

RC = 4  # direction-window slots (pallas_slice_v3.py:68)


def cap_body(cfg) -> int:
    """v3's bound on the 4-micro-step bodies of one grid step
    (pallas_slice_v3.py:89)."""
    return (2 + 2 * cfg.max_step + cfg.max_shrink + BODY) // BODY + 4


def slice_records_window_plain(
    logL_fn,
    cfg,
    key_words,
    x0: torch.Tensor,      # (B, D) float32 seed cubes
    bound: torch.Tensor,   # (B,) float32
    valid: torch.Tensor,   # (B,) bool
    nhats: torch.Tensor,   # (B, R, D) float32
    ws: torch.Tensor,      # (B, R) float32
    count_iters: bool = False,
    cheap: bool = False,
    lane0: int = 0,
):
    """v3's windowed epoch in plain torch (see the module docstring).

    Returns (t (B,R), logL (B,R)) float32 and nlike (B,R) int32, as
    ``slice_kernel.slice_records_plain`` does.  With ``count_iters``, also
    the bodies each grid step ran, (R,) int32, as the instrumented v3
    counts them (``experiments/v3_instr.py:274,288``): at least one, at most
    ``cap_body``.  ``cheap`` is that kernel's skeleton (:269-270): a body
    only advances every lane's repeat, and the records stay at their
    initial values."""
    B, D = x0.shape
    R = nhats.shape[1]
    dev = x0.device
    rc = min(RC, R)
    logzero = torch.tensor(cfg.logzero, dtype=torch.float32).item()
    lanes = torch.arange(B, device=dev)
    h_lane = lane_hash(key_words, B, dev, lane0)
    m = LaneMachine(B, dev, logzero)
    m.phase = torch.where(valid, PH_INIT_R, PH_DONE).to(torch.int64)
    rep = torch.where(valid, 0, R).to(torch.int64)
    x = x0.to(torch.float32).clone()
    ring_t = torch.zeros((rc, B), dtype=torch.float32, device=dev)
    ring_l = torch.full((rc, B), logzero, dtype=torch.float32, device=dev)
    ring_n = torch.zeros((rc, B), dtype=torch.int32, device=dev)
    t_out = torch.zeros((B, R), dtype=torch.float32, device=dev)
    l_out = torch.full((B, R), logzero, dtype=torch.float32, device=dev)
    n_out = torch.zeros((B, R), dtype=torch.int32, device=dev)
    iters = torch.zeros(R, dtype=torch.int32, device=dev)
    for r in range(R):
        window_hi = min(r + rc - 1, R - 1)
        for k in range(cap_body(cfg)):
            iters[r] = k + 1
            if cheap:
                rep = rep + 1
            else:
                for _ in range(BODY):
                    active = (m.phase != PH_DONE) & (rep <= window_hi)
                    r_idx = rep.clamp(max=R - 1)
                    t, probe, logL, acc, forced = m.step(
                        logL_fn, cfg, active, _mix(h_lane, rep), ws[lanes, r_idx],
                        nhats[lanes, r_idx], x, bound)
                    slot, rows = (rep % rc)[acc], lanes[acc]
                    ring_t[slot, rows] = t[acc]
                    ring_l[slot, rows] = torch.where(forced, logzero, logL)[acc]
                    ring_n[slot, rows] = m.cnt[acc].to(torch.int32)
                    x = torch.where(acc[:, None], probe, x)
                    rep = torch.where(acc, rep + 1, rep)
                    m.phase = torch.where(acc, torch.where(rep >= R, PH_DONE, PH_INIT_R), m.phase)
                    m.restart(acc)
            if not bool((rep <= r).any()):
                break
        # the step's flush; a lane still in repeat r stops with it unaccepted
        s = r % rc
        late = rep <= r
        ring_n[s] = torch.where(late, m.cnt.to(torch.int32), ring_n[s])
        m.phase = torch.where(late, PH_DONE, m.phase)
        rep = torch.where(late, R, rep)
        t_out[:, r], l_out[:, r], n_out[:, r] = ring_t[s], ring_l[s], ring_n[s]
        ring_t[s], ring_l[s], ring_n[s] = 0.0, logzero, 0
    if count_iters:
        return t_out, l_out, n_out, iters
    return t_out, l_out, n_out


def slice_epoch_v3(calc, cfg, key_words, x0, bound, valid, nhats, ws, group=None, lane0=0):
    """Run the slice repeats of every lane under v3's budget: (t, logL)
    float32 and nlike int32, each (B, R), with the inputs of
    ``pallas_slice_v4.slice_epoch``.  CPU tensors: the plain version; CUDA
    tensors: the kernel, with ``calc.device_spec``'s functor or, for a model
    without one, the likelihood lowered into it (``ops/fused_like.py``; a
    model the lowering refuses raises, naming the reason), with ``group``
    lanes per chain (one of the bucket's ``pallas_slice_v4.BUCKET_GROUPS``;
    ``pallas_slice_v4.choose_group`` by default, as for B1).  Every G gives
    the same result bit for bit.  ``lane0``: ``pallas_slice.lane_hash``."""
    if group is not None and group not in GROUPS:
        raise ValueError(f"group {group} is not one of {GROUPS}")
    if x0.device.type == "cpu":
        return slice_records_window_plain(
            lambda p: calc(p)[2], cfg, key_words, x0, bound, valid, nhats, ws, lane0=lane0
        )
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    B, R, D = nhats.shape
    key = launch_group(B, D, x0.device, group)
    if getattr(calc, "device_spec", None) is None:  # the fused route
        low = forced_lowering(calc, "cuda3")
        out = launch_slice_kernel(
            low.library(key[1], "cuda3"), "slice_epoch_fused_v3_launch", calc, cfg, key_words,
            x0, bound, valid, nhats, ws, cap=cap_body(cfg) * BODY,
            functor=fused_functor(low, key[1], x0.device), lane0=lane0)
        LAUNCHES["slice_epoch_v3_fused"] += 1
    else:
        out = launch_slice_kernel(
            nvcc.load("slice_epoch_v3", ["slice_epoch_v3.cu"]), "slice_epoch_v3_launch",
            calc, cfg, key_words, x0, bound, valid, nhats, ws, cap=cap_body(cfg) * BODY,
            ints=(key[1],), lane0=lane0,
        )
        LAUNCHES["slice_epoch_v3"] += 1
    GROUP_LAUNCHES[key] += 1
    return out
