"""The slice-sampling epoch (counterpart of ``polychordlite_tpu/ops/slice_kernel.py``).

``build_epoch_fn(calc, cfg)`` returns
``epoch(key_words, seed_cube, bound, cholesky, lane_valid)``, which runs R
slice repeats on each of B chains and returns the packed
``(B, R*(2D+n_phi+1) + n_grades + 1)`` record of the JAX package's contract
(``slice_kernel.py:137-149``; see :func:`unpack_epoch`).  Two engines:

* ``"torch"`` — :func:`slice_records_plain`, the per-lane state machine of
  the v4 kernel (``pallas_slice_v4.py:215-348``) vectorised over lanes in
  plain torch.  It runs on any device and is the plain version of the CUDA
  kernel.
* ``"cuda"`` — the hand-written kernel ``csrc/slice_epoch.cu``, through
  ``ops/pallas_slice_v4.py``.

Both produce per (lane, repeat) the accepted chord position t, its logL and
the repeat's likelihood-call count; positions are rebuilt outside as
``seed + cumsum(t n̂)`` (``ops/pallas_slice_v4.py``).  The per-lane state
machine for one repeat (Neal 2003; ``chordal_sampling.f90:163-273``):

    INIT_R  draw u, set the interval [-u w, (1-u) w], evaluate its right end
    INIT_L  evaluate its left end
    STEP_R  expand right in unit-w steps while inside the contour
    STEP_L  expand left likewise
    SHRINK  draw uniformly in (tL, tR); accept if inside, else contract the
            side the draw fell on; after ``max_shrink`` failures the probe
            is accepted with logL = logzero and x0 still moves to it

Uniforms come from the murmur3 counter hash of ``ops/pallas_slice.py``
keyed on (key words, lane, repeat, iteration within the repeat), so a
lane's decisions do not depend on other lanes.  Every float expression is
written as separate operations in the order the CUDA kernel uses, so the
two engines agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .logspace import LOG_ZERO
from .pallas_slice import (
    PH_DONE,
    PH_INIT_L,
    PH_INIT_R,
    PH_SHRINK,
    PH_STEP_L,
    PH_STEP_R,
    _fmix,
    _mix,
    uniform_from_hash,
)

ENGINES = ("torch", "cuda")


class EpochConfig(NamedTuple):
    """Static configuration of the slice engine."""

    n_dims: int
    n_phi: int
    grade_dims: Tuple[int, ...]
    num_repeats: Tuple[int, ...]
    logzero: float = LOG_ZERO
    max_step: int = 200   # stepping-out cap (reference warns past 100 and has no cap)
    max_shrink: int = 100  # shrinkage cap (chordal_sampling.f90:240-271)
    engine: str = "torch"  # "torch" (plain, any device) or "cuda" (kernel)

    @property
    def total_repeats(self) -> int:
        return int(sum(self.num_repeats))

    @property
    def step_cap(self) -> int:
        """Micro-steps a lane may take in one epoch: the v4 kernel's bound
        (``pallas_slice_v4.py:134``: ``cap_iters`` loops of 4 micro-steps)."""
        R = self.total_repeats
        return ((R * (2 * self.max_step + self.max_shrink + 8)) // 4 + 8) * 4


def slice_records_plain(
    logL_fn,
    cfg: EpochConfig,
    key_words: Tuple[int, int],
    x0: torch.Tensor,      # (B, D) float32 seed cubes
    bound: torch.Tensor,   # (B,) float32
    valid: torch.Tensor,   # (B,) bool
    nhats: torch.Tensor,   # (B, R, D) float32
    ws: torch.Tensor,      # (B, R) float32
):
    """The plain torch engine: every lane runs its R repeats freely.

    ``logL_fn(probe (B, D)) -> logL (B,)`` float32.  Returns (t (B,R),
    logL (B,R)) float32 and nlike (B,R) int32 per (lane, repeat); repeats
    never reached keep t = 0, logL = logzero, nlike = 0."""
    B, D = x0.shape
    R = nhats.shape[1]
    dev = x0.device
    f32 = torch.float32
    logzero = torch.tensor(cfg.logzero, dtype=f32).item()
    k0, k1 = key_words
    lanes = torch.arange(B, device=dev)
    h_lane = _mix(_mix(torch.full((B,), k0, dtype=torch.int64, device=dev), k1), lanes)

    def i64(v):
        return torch.full((B,), v, dtype=torch.int64, device=dev)

    rep = torch.where(valid, 0, R).to(torch.int64)
    phase = torch.where(valid, PH_INIT_R, PH_DONE).to(torch.int64)
    it, rstep, lstep, nshrink, cnt, steps = i64(0), i64(1), i64(1), i64(0), i64(0), i64(0)
    need_r = torch.zeros(B, dtype=torch.bool, device=dev)
    need_l = torch.zeros_like(need_r)
    tL = torch.zeros(B, dtype=f32, device=dev)
    tR = torch.zeros_like(tL)
    x = x0.to(f32).clone()
    t_out = torch.zeros((B, R), dtype=f32, device=dev)
    l_out = torch.full((B, R), logzero, dtype=f32, device=dev)
    n_out = torch.zeros((B, R), dtype=torch.int32, device=dev)
    cap = cfg.step_cap

    while bool((phase != PH_DONE).any()):
        active = phase != PH_DONE
        r_idx = rep.clamp(max=R - 1)
        nhat = nhats[lanes, r_idx]
        w = ws[lanes, r_idx]
        u = uniform_from_hash(_fmix(_mix(_mix(h_lane, rep), it))).to(f32)

        is_ir = active & (phase == PH_INIT_R)
        is_il = active & (phase == PH_INIT_L)
        is_sr = active & (phase == PH_STEP_R)
        is_sl = active & (phase == PH_STEP_L)
        is_sh = active & (phase == PH_SHRINK)
        tL = torch.where(is_ir, -u * w, tL)
        tR = torch.where(is_ir, (1.0 - u) * w, tR)
        t = torch.where(is_ir, tR, 0.0)
        t = torch.where(is_il, tL, t)
        t = torch.where(is_sr, w * rstep.to(f32), t)
        t = torch.where(is_sl, -w * lstep.to(f32), t)
        t = torch.where(is_sh, tL + u * (tR - tL), t)

        probe = x + t[:, None] * nhat
        logL = logL_fn(probe)
        inside = (logL >= bound) & (logL > logzero)
        cnt = cnt + (active & (logL > logzero)).to(torch.int64)

        need_r = torch.where(is_ir, inside, need_r)
        need_l = torch.where(is_il, inside, need_l)
        after_il = torch.where(
            need_r, PH_STEP_R, torch.where(need_l, PH_STEP_L, PH_SHRINK)
        )
        done_r = is_sr & (~inside | (rstep >= cfg.max_step))
        done_l = is_sl & (~inside | (lstep >= cfg.max_step))
        tR = torch.where(done_r, t, tR)
        tL = torch.where(done_l, t, tL)
        rstep = torch.where(is_sr & ~done_r, rstep + 1, rstep)
        lstep = torch.where(is_sl & ~done_l, lstep + 1, lstep)

        accept = is_sh & inside
        forced = is_sh & ~inside & (nshrink + 1 >= cfg.max_shrink)
        acc = accept | forced
        contract = is_sh & ~inside & ~forced
        tR = torch.where(contract & (t > 0.0), t, tR)
        tL = torch.where(contract & (t <= 0.0), t, tL)
        nshrink = torch.where(contract | forced, nshrink + 1, nshrink)

        steps = steps + active.to(torch.int64)
        capped = active & ~acc & (steps >= cap)
        rec = acc | capped
        rows, cols = lanes[rec], rep[rec]
        t_out[rows, cols] = torch.where(acc, t, 0.0)[rec]
        l_out[rows, cols] = torch.where(acc & ~forced, logL, logzero)[rec]
        n_out[rows, cols] = cnt[rec].to(torch.int32)
        x = torch.where(acc[:, None], probe, x)

        phase = torch.where(is_ir, PH_INIT_L, phase)
        phase = torch.where(is_il, after_il, phase)
        phase = torch.where(done_r, torch.where(need_l, PH_STEP_L, PH_SHRINK), phase)
        phase = torch.where(done_l, PH_SHRINK, phase)
        rep = torch.where(acc, rep + 1, rep)
        phase = torch.where(acc, torch.where(rep >= R, PH_DONE, PH_INIT_R), phase)
        phase = torch.where(capped | (acc & (steps >= cap)), PH_DONE, phase)

        it = torch.where(acc, 0, torch.where(active, it + 1, it))
        rstep = torch.where(acc, 1, rstep)
        lstep = torch.where(acc, 1, lstep)
        nshrink = torch.where(acc, 0, nshrink)
        cnt = torch.where(acc, 0, cnt)
        need_r = need_r & ~acc
        need_l = need_l & ~acc
        tL = torch.where(acc, 0.0, tL)
        tR = torch.where(acc, 0.0, tR)
    return t_out, l_out, n_out


def build_epoch_fn(calc, cfg: EpochConfig):
    """Build ``epoch(key_words, seed_cube, bound, cholesky, lane_valid,
    generator=None, directions=None)`` for ``cfg.engine``.

    ``generator`` is the device ``torch.Generator`` the directions are drawn
    from; ``directions=(nhats, w, speeds)`` replaces the draw (test seam)."""
    from .directions import make_directions
    from .pallas_slice_v4 import assemble_epoch, slice_epoch

    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}; have {ENGINES}")

    def records(*args):
        if cfg.engine == "cuda":
            return slice_epoch(calc, cfg, *args)
        return slice_records_plain(lambda p: calc(p)[2], cfg, *args)

    def epoch(key_words, seed_cube, bound, cholesky, lane_valid,
              generator=None, directions=None):
        if directions is None:
            directions = make_directions(
                cholesky, grade_dims=cfg.grade_dims, num_repeats=cfg.num_repeats,
                n_dims=cfg.n_dims, generator=generator,
            )
        nhats, ws, speeds = directions
        seed_f = seed_cube.to(torch.float32)
        t_acc, logL, nlike = records(
            key_words, seed_f, bound.to(torch.float32), lane_valid, nhats, ws
        )
        return assemble_epoch(calc, cfg, seed_f, lane_valid, nhats, speeds,
                              t_acc, logL, nlike)

    return epoch


def unpack_epoch(packed, cfg: EpochConfig):
    """Host-side unpack of the packed epoch record.

    Returns (cube (B,R,D), theta (B,R,D), phi (B,R,n_phi), logL (B,R),
    nlike (B, n_grades)) as float64 numpy arrays (nlike int64)."""
    packed = np.asarray(packed, dtype=np.float64)
    D = cfg.n_dims
    R = cfg.total_repeats
    n_grades = len(cfg.grade_dims)
    stride = 2 * D + cfg.n_phi + 1
    B = packed.shape[0]
    per_baby = packed[:, : R * stride].reshape(B, R, stride)
    cube = per_baby[:, :, :D]
    theta = per_baby[:, :, D : 2 * D]
    phi = per_baby[:, :, 2 * D : 2 * D + cfg.n_phi]
    logL = per_baby[:, :, -1]
    nlike = packed[:, R * stride : R * stride + n_grades].astype(np.int64)
    return cube, theta, phi, logL, nlike
