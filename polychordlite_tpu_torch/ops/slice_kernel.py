"""The slice-sampling epoch (counterpart of ``polychordlite_tpu/ops/slice_kernel.py``).

``build_epoch_fn(calc, cfg)`` returns
``epoch(key_words, seed_cube, bound, cholesky, lane_valid)``, which runs R
slice repeats on each of B chains and returns the packed
``(B, R*(2D+n_phi+1) + n_grades + 1)`` record of the JAX package's contract
(``slice_kernel.py:137-149``; see :func:`unpack_epoch`).  Three engines:

* ``"torch"`` — :func:`slice_records_plain`, the per-lane state machine of
  the v4 kernel (``pallas_slice_v4.py:215-348``) vectorised over lanes in
  plain torch.  It runs on any device and is the plain version of the CUDA
  kernel.
* ``"cuda"`` — the hand-written kernel ``csrc/slice_epoch.cu``, through
  ``ops/pallas_slice_v4.py`` (the JAX package's ``"pallas"`` / ``"pallas4"``),
  for a model with a device functor; for any other torch model, the
  traced route of the same module, ``csrc/slice_step.cu`` with the
  likelihood evaluated in torch between its launches (bitwise ``"torch"``).
* ``"cuda5"`` — the speculative-packet kernel ``csrc/slice_epoch_v5.cu``,
  through ``ops/pallas_slice_v5.py`` (the JAX package's forced
  ``"pallas5"``); decision-exact with ``"cuda"``, so a run gives the same
  result on either.
* ``"cuda3"`` — the kernel ``csrc/slice_epoch_v3.cu`` with v3's budget,
  through ``ops/pallas_slice_v3.py`` (the JAX package's forced
  ``"pallas3"``); the same run as ``"cuda"``.
* ``"cuda2"`` — the kernel ``csrc/slice_epoch_v2.cu``, which writes the
  cube as v2 does, through ``ops/pallas_slice.py`` (the JAX package's
  forced ``"pallas2"``); the same decisions, a cube that differs from the
  rebuilt one in the last bits, so another chain, held statistically.

The kernel engines are forced only by name: nothing falls back from one to
another (the JAX package's silent chain, ``slice_kernel.py:162-173``, is
ROADMAP C5).  All produce per (lane, repeat) the accepted chord position t,
its logL and the repeat's likelihood-call count; positions are rebuilt
outside as ``seed + cumsum(t n̂)`` (``ops/pallas_slice_v4.py``) except by
``"cuda2"``.  The per-lane state machine for one repeat (Neal 2003;
``chordal_sampling.f90:163-273``; ``pallas_slice.LaneMachine``):

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
from .pallas_slice import PH_DONE, PH_INIT_R, LaneMachine, _mix, lane_hash, slice_epoch_v2

#: the kernel engines: "cuda" (B1, v4), "cuda5" (B3, v5), "cuda3" (B4, v3)
#: and "cuda2" (B5, v2) — the JAX package's "pallas", "pallas5", "pallas3"
#: and "pallas2"
KERNEL_ENGINES = ("cuda", "cuda5", "cuda3", "cuda2")
ENGINES = ("torch",) + KERNEL_ENGINES


class EpochConfig(NamedTuple):
    """Static configuration of the slice engine."""

    n_dims: int
    n_phi: int
    grade_dims: Tuple[int, ...]
    num_repeats: Tuple[int, ...]
    logzero: float = LOG_ZERO
    max_step: int = 200   # stepping-out cap (reference warns past 100 and has no cap)
    max_shrink: int = 100  # shrinkage cap (chordal_sampling.f90:240-271)
    engine: str = "torch"  # "torch" (plain, any device) or a kernel: "cuda", "cuda5", "cuda3", "cuda2"

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
    count_steps: bool = False,
):
    """The plain torch engine: every lane runs its R repeats freely.

    ``logL_fn(probe (B, D)) -> logL (B,)`` float32.  Returns (t (B,R),
    logL (B,R)) float32 and nlike (B,R) int32 per (lane, repeat); repeats
    never reached keep t = 0, logL = logzero, nlike = 0.  With
    ``count_steps``, also the micro-steps each lane executed, (B,) int32."""
    B, D = x0.shape
    R = nhats.shape[1]
    dev = x0.device
    f32 = torch.float32
    logzero = torch.tensor(cfg.logzero, dtype=f32).item()
    lanes = torch.arange(B, device=dev)
    h_lane = lane_hash(key_words, B, dev)
    m = LaneMachine(B, dev, logzero)
    m.phase = torch.where(valid, PH_INIT_R, PH_DONE).to(torch.int64)
    rep = torch.where(valid, 0, R).to(torch.int64)
    steps = torch.zeros(B, dtype=torch.int64, device=dev)
    x = x0.to(f32).clone()
    t_out = torch.zeros((B, R), dtype=f32, device=dev)
    l_out = torch.full((B, R), logzero, dtype=f32, device=dev)
    n_out = torch.zeros((B, R), dtype=torch.int32, device=dev)
    cap = cfg.step_cap

    while bool((m.phase != PH_DONE).any()):
        active = m.phase != PH_DONE
        r_idx = rep.clamp(max=R - 1)
        t, probe, logL, acc, forced = m.step(
            logL_fn, cfg, active, _mix(h_lane, rep), ws[lanes, r_idx], nhats[lanes, r_idx],
            x, bound)
        steps = steps + active.to(torch.int64)
        capped = active & ~acc & (steps >= cap)
        rec = acc | capped
        rows, cols = lanes[rec], rep[rec]
        t_out[rows, cols] = torch.where(acc, t, 0.0)[rec]
        l_out[rows, cols] = torch.where(acc & ~forced, logL, logzero)[rec]
        n_out[rows, cols] = m.cnt[rec].to(torch.int32)
        x = torch.where(acc[:, None], probe, x)
        rep = torch.where(acc, rep + 1, rep)
        m.phase = torch.where(acc, torch.where(rep >= R, PH_DONE, PH_INIT_R), m.phase)
        m.phase = torch.where(capped | (acc & (steps >= cap)), PH_DONE, m.phase)
        m.restart(acc)
    if count_steps:
        return t_out, l_out, n_out, steps.to(torch.int32)
    return t_out, l_out, n_out


def kernel_wrapper(engine: str):
    """The wrapper of an engine's CUDA kernel: (calc, cfg, key_words, x0,
    bound, valid, nhats, ws) -> (t, logL, nlike[, cube]).  On CPU tensors
    each wrapper runs its own plain version.  ``"cuda"`` chooses by the
    model's form, as the JAX package's one ``"pallas"`` engine does: B1's
    functor kernel for a model with a device form (``calc.device_spec``),
    else the traced route (``csrc/slice_step.cu``), which refuses a
    host-callback model on the card.  The other engines need a functor."""
    from .pallas_slice_v3 import slice_epoch_v3
    from .pallas_slice_v4 import slice_epoch, slice_epoch_traced
    from .pallas_slice_v5 import slice_epoch_v5

    def cuda(calc, cfg, *args):
        if getattr(calc, "device_spec", None) is not None:
            return slice_epoch(calc, cfg, *args)
        return slice_epoch_traced(calc, cfg, *args)

    return {"cuda": cuda, "cuda5": slice_epoch_v5, "cuda3": slice_epoch_v3,
            "cuda2": slice_epoch_v2}[engine]


def epoch_route(engine: str, calc) -> str:
    """The kernel that ``engine`` runs for ``calc`` (the run metrics'
    ``route``): ``"plain"`` for the torch engine, ``"slice_step"`` for
    ``"cuda"`` on a model without a device form, else the engine's kernel."""
    if engine == "torch":
        return "plain"
    if engine == "cuda":
        return "slice_epoch" if getattr(calc, "device_spec", None) is not None else "slice_step"
    return {"cuda5": "slice_epoch_v5", "cuda3": "slice_epoch_v3", "cuda2": "slice_epoch_v2"}[engine]


def build_epoch_fn(calc, cfg: EpochConfig):
    """Build ``epoch(key_words, seed_cube, bound, cholesky, lane_valid,
    generator=None, directions=None)`` for ``cfg.engine``.

    ``generator`` is the device ``torch.Generator`` the directions are drawn
    from; ``directions=(nhats, w, speeds)`` replaces the draw (test seam)."""
    from .directions import make_directions
    from .pallas_slice_v4 import assemble_epoch

    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}; have {ENGINES}")
    if cfg.engine == "torch":
        def records(*args):
            return slice_records_plain(lambda p: calc(p)[2], cfg, *args)
    else:
        kernel = kernel_wrapper(cfg.engine)

        def records(*args):
            return kernel(calc, cfg, *args)

    def epoch(key_words, seed_cube, bound, cholesky, lane_valid,
              generator=None, directions=None):
        if directions is None:
            directions = make_directions(
                cholesky, grade_dims=cfg.grade_dims, num_repeats=cfg.num_repeats,
                n_dims=cfg.n_dims, generator=generator,
            )
        nhats, ws, speeds = directions
        seed_f = seed_cube.to(torch.float32)
        out = records(key_words, seed_f, bound.to(torch.float32), lane_valid, nhats, ws)
        return assemble_epoch(calc, cfg, seed_f, lane_valid, nhats, speeds, *out)

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
