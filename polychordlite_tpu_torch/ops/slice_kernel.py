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
  for a model with a device functor; else, for a torch model whose
  likelihood ``ops/fused_like.py`` lowers, the same kernel with the lowered
  functor (``csrc/slice_epoch_fused.cu``); for any other torch model, the
  traced route of the same module, ``csrc/slice_step.cu`` with the
  likelihood evaluated in torch between its launches (bitwise ``"torch"``).
  :func:`cuda_route` makes the choice once per model, and names its reason.
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

  The three forced engines take what the JAX package's forced engines take
  (``polychordlite_tpu/ops/pallas_slice.py::_validated_tile_logL`` puts any
  traced likelihood in their kernels): a model with a device functor runs
  the engine's functor kernel at any D to the stream bucket's bound, and a
  torch model without one whose likelihood ``ops/fused_like.py`` lowers
  runs the same kernel with the lowered functor, the engine's fused route
  (``slice_epoch_v5_fused``, ``slice_epoch_v3_fused``,
  ``slice_epoch_v2_fused``: ``csrc/slice_epoch_fused.cu`` built with
  ``FUSED_V5``, ``FUSED_V3`` or ``FUSED_V2``).  A model the lowering
  refuses raises, naming the reason and ``engine='cuda'``, whose traced
  route runs it (ROADMAP C27).
* ``"scan"`` — the repeats of an epoch one at a time, in lockstep across
  the batch (the JAX package's ``build_epoch_fn_scan``,
  ``slice_kernel.py:193-428``), each repeat of one grade: for a
  :class:`~polychordlite_tpu_torch.models.graded.GradedLikelihood` the slow
  intermediate ``aux`` is carried from repeat to repeat and a fast-grade
  repeat evaluates only the fast part.  On the card the traced route's
  kernel ``csrc/slice_step.cu`` held at a repeat barrier
  (``ops/pallas_slice_v4.py::slice_epoch_graded``, route
  ``"slice_step_graded"``); on the CPU its plain version.  The same
  decisions as ``"torch"`` on the monolithic form of the model: a graded
  run's only engine (``core/nested_sampling.py::resolve_engine``), and
  open to any torch model.  For a host-callback model (a Python, numpy or
  C likelihood; ``calc.uses_callback``) it is the host route on the card:
  the same kernel driven round by round with no graph, the user's function
  called on the host between two launches on the pending probes only
  (``ops/pallas_slice_v4.py::slice_epoch_host``, route
  ``"slice_step_host"``); on the CPU its plain version.  The same decisions
  as ``"torch"`` on the same model; its babies are the accepted probes
  with the theta and phi they were evaluated to, as the JAX package's scan
  engine keeps them, so a cube differs from the rebuilt one in the last
  bits and a run is another chain, held statistically.  It is
  ``engine="auto"``'s choice for such a model on every device, as the JAX
  package sends it to its scan engine
  (``polychordlite_tpu/core/nested_sampling.py:104-106``).
* ``"ring"`` — the JAX package's ring engine (``build_epoch_fn_ring``,
  ``slice_kernel.py:430-660``): each lane runs its R repeats freely under a
  budget of R ``ring_factor`` micro-steps over the epoch
  (:attr:`EpochConfig.ring_budget`) and raises its overflow flag when the
  budget stops it before its last repeat is accepted; the runner re-runs
  such an epoch with no slot budget (``parallel/mesh.py``).  The JAX ring
  buffer and its sort exist only because a per-lane scatter is costly on
  the TPU; what the engine means is the budget and the flag.  On the card
  it runs B1's route for the model as ``"cuda"`` picks it
  (:func:`cuda_route`) under ``RingPolicy`` (the functor and fused
  kernels' ring instantiations; the traced route with the ring's budget
  as its ``cap``), or the host route for a host-callback model; on the CPU
  the plain engine under the same budget.  The re-run is the same route at
  its own budget ``step_cap``, so a ring epoch is, once re-run where it
  overflowed, bitwise the ``"cuda"`` epoch on the card and the ``"torch"``
  one on the CPU.

At ``precision='highest'`` (``calc.dtype`` float64) ``"cuda"`` takes the
fused route or the traced route, each in double, never the functor kernel:
the device functors are float32 (:func:`cuda_route`); the forced
``"cuda5"``, ``"cuda3"`` and ``"cuda2"`` raise
(``core/nested_sampling.py::resolve_engine``), and ``"torch"`` runs in
float64.  The kernel engines are forced only by name: nothing falls back
from one to another (the JAX package's silent chain, ``slice_kernel.py:162-173``, is
ROADMAP C5).  All produce per (lane, repeat) the accepted chord position t,
its logL and the repeat's likelihood-call count; positions are rebuilt
outside as ``seed + cumsum(t n̂)`` (``ops/pallas_slice_v4.py``) except by
``"cuda2"`` and the host route.  The per-lane state machine for one repeat (Neal 2003;
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
from .precision import calc_dtype

#: the kernel engines: "cuda" (B1, v4), "cuda5" (B3, v5), "cuda3" (B4, v3)
#: and "cuda2" (B5, v2) — the JAX package's "pallas", "pallas5", "pallas3"
#: and "pallas2"
KERNEL_ENGINES = ("cuda", "cuda5", "cuda3", "cuda2")
#: and the lockstep engine of a graded model (the JAX package's "scan"), and
#: the JAX package's ring engine, B1 under the ring's budget
ENGINES = ("torch", "scan", "ring") + KERNEL_ENGINES


class EpochConfig(NamedTuple):
    """Static configuration of the slice engine."""

    n_dims: int
    n_phi: int
    grade_dims: Tuple[int, ...]
    num_repeats: Tuple[int, ...]
    logzero: float = LOG_ZERO
    max_step: int = 200   # stepping-out cap (reference warns past 100 and has no cap)
    max_shrink: int = 100  # shrinkage cap (chordal_sampling.f90:240-271)
    engine: str = "torch"  # "torch" (plain), "scan" (graded), "ring" or "cuda", "cuda5", "cuda3", "cuda2"
    ring_factor: int = 12  # the ring engine's micro-steps per repeat before overflow

    @property
    def total_repeats(self) -> int:
        return int(sum(self.num_repeats))

    @property
    def ring_budget(self) -> int:
        """The ring engine's budget: R ``ring_factor`` micro-steps a lane
        over the epoch, the JAX ring's ``max_total`` (``slice_kernel.py:443``:
        its loop's iterations, in each of which every running lane takes one
        micro-step)."""
        return self.total_repeats * self.ring_factor

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
    x0: torch.Tensor,      # (B, D) seed cubes, float32 or float64
    bound: torch.Tensor,   # (B,)
    valid: torch.Tensor,   # (B,) bool
    nhats: torch.Tensor,   # (B, R, D)
    ws: torch.Tensor,      # (B, R)
    count_steps: bool = False,
    lane0: int = 0,
    ring_cap=None,
):
    """The plain torch engine: every lane runs its R repeats freely.

    Computes in ``x0``'s dtype: float32, or float64 at
    ``precision='highest'`` (the plain version of the double kernels).
    ``logL_fn(probe (B, D)) -> logL (B,)`` of that dtype.  Returns (t (B,R),
    logL (B,R)) of that dtype and nlike (B,R) int32 per (lane, repeat);
    repeats never reached keep t = 0, logL = logzero, nlike = 0.  With
    ``count_steps``, also the micro-steps each lane executed, (B,) int32.
    ``lane0`` is the first lane's index in the whole batch: a shard of
    lanes lane0..lane0+B-1 draws the uniforms of those lanes of the
    one-device batch (``pallas_slice.lane_hash``).

    A lane stops after :attr:`EpochConfig.step_cap` micro-steps over the
    epoch.  With ``ring_cap`` (the ring engine's plain version) it stops
    after ``ring_cap`` instead, and the outputs end with the lanes'
    overflow flags (B,) bool: set where the budget stopped a valid lane
    before its last repeat was accepted (the JAX ring's ``phase != DONE``
    after its loop), also when the budget's last micro-step accepted a
    repeat other than the last."""
    B, D = x0.shape
    R = nhats.shape[1]
    dev = x0.device
    real = x0.dtype if x0.dtype == torch.float64 else torch.float32
    logzero = torch.tensor(cfg.logzero, dtype=real).item()
    lanes = torch.arange(B, device=dev)
    h_lane = lane_hash(key_words, B, dev, lane0)
    m = LaneMachine(B, dev, logzero, real)
    m.phase = torch.where(valid, PH_INIT_R, PH_DONE).to(torch.int64)
    rep = torch.where(valid, 0, R).to(torch.int64)
    steps = torch.zeros(B, dtype=torch.int64, device=dev)
    x = x0.to(real).clone()
    t_out = torch.zeros((B, R), dtype=real, device=dev)
    l_out = torch.full((B, R), logzero, dtype=real, device=dev)
    n_out = torch.zeros((B, R), dtype=torch.int32, device=dev)
    cap = cfg.step_cap if ring_cap is None else int(ring_cap)

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
    out = (t_out, l_out, n_out) + ((steps.to(torch.int32),) if count_steps else ())
    return out + ((rep < R,) if ring_cap is not None else ())


def cuda_route(calc) -> Tuple[str, str]:
    """(route, reason): the kernel that ``engine="cuda"`` runs for ``calc``,
    in this order, as the JAX package's one ``"pallas"`` engine evaluates
    any traced likelihood in its kernel:

    1. ``"slice_epoch"``, B1's functor kernel, for a model with a device
       form (``calc.device_spec``); a functor that cannot take the model's D
       raises here, before the run (above the stream bucket's bound for its
       terms, ``pallas_slice_v4.bucket``);
    2. ``"slice_epoch_fused"``, B1 with the likelihood lowered into it,
       for a model ``ops/fused_like.py`` lowers (once per calc, kept on it);
    3. ``"slice_step"``, the traced route, for any other model; the reason
       is what refused lowering (the op, the condition).  The route itself
       refuses a host-callback model on the card.

    For a calc in float64 (``precision='highest'``) step 1 is skipped: the
    functors are float32, and the reason says so."""
    spec = getattr(calc, "device_spec", None)
    f64 = calc_dtype(calc) == torch.float64
    if spec is not None and not f64:
        from .pallas_slice_v4 import check_functor_dims

        name = spec["likelihood"]["name"]
        check_functor_dims(name, calc.n_dims)
        return "slice_epoch", f"device functor {name!r}"
    from .fused_like import Refused, lowering

    why = ("float64: the device functor "
           f"{spec['likelihood']['name']!r} is float32; " if spec is not None else "")
    low = lowering(calc)
    if isinstance(low, Refused):
        return "slice_step", why + low.reason
    return "slice_epoch_fused", (f"{why}lowered: {low.n_terms} per-coordinate term(s), "
                                 f"{len(low.term)} + {len(low.combine)} statements")


def kernel_wrapper(engine: str):
    """The wrapper of an engine's CUDA kernel: (calc, cfg, key_words, x0,
    bound, valid, nhats, ws, group=None) -> (t, logL, nlike[, cube]).  On
    CPU tensors each wrapper runs its own plain version.  ``"cuda"`` takes
    :func:`cuda_route`'s route, and ``ring_cap=`` runs that route under the
    ring engine's budget, its overflow flags (B,) bool last; each of the
    other engines' wrappers runs its functor kernel for a model with a
    device functor and its fused route for a model the lowering takes
    (:func:`forced_route`)."""
    from .pallas_slice_v3 import slice_epoch_v3
    from .pallas_slice_v4 import slice_epoch, slice_epoch_fused, slice_epoch_traced
    from .pallas_slice_v5 import slice_epoch_v5

    routes = {"slice_epoch": slice_epoch, "slice_epoch_fused": slice_epoch_fused,
              "slice_step": slice_epoch_traced}

    def cuda(calc, cfg, *args, **kw):
        return routes[cuda_route(calc)[0]](calc, cfg, *args, **kw)

    return {"cuda": cuda, "cuda5": slice_epoch_v5, "cuda3": slice_epoch_v3,
            "cuda2": slice_epoch_v2}[engine]


def epoch_route(engine: str, calc, device=None) -> str:
    """The kernel that ``engine`` runs for ``calc`` (the run metrics'
    ``route``): ``"plain"`` for the torch engine, ``"slice_step_graded"``
    for ``"scan"`` (``"slice_step_host"`` for a host-callback calc),
    :func:`cuda_route`'s for ``"cuda"``, for ``"ring"`` the same on a CUDA
    ``device`` (``"slice_step_host"`` for a host-callback calc) and
    ``"plain"`` on the CPU, else the forced engine's kernel."""
    return _route(engine, calc, device)[0]


def route_reason(engine: str, calc, device=None) -> str:
    """Why :func:`epoch_route` chose its kernel (the run metrics'
    ``route_reason``): for the traced route, what refused lowering."""
    return _route(engine, calc, device)[1]


def _route(engine: str, calc, device=None) -> Tuple[str, str]:
    if engine == "ring":
        budget = "engine='ring': B1 under the ring's budget, an overflowed epoch re-run; "
        if device is None or torch.device(device).type != "cuda":
            return "plain", "engine='ring' on the CPU: the plain engine under the ring's budget"
        if getattr(calc, "uses_callback", False):
            route, why = _route("scan", calc)
        else:
            route, why = cuda_route(calc)
        return route, budget + why
    if engine == "torch":
        return "plain", "engine='torch'"
    if engine == "scan" and getattr(calc, "uses_callback", False):
        return "slice_step_host", ("the likelihood is a host function (Python, numpy or C), "
                                   "called on the host between the kernel's launches")
    if engine == "scan":
        why = ("GradedLikelihood: the slow part is cached across fast-grade repeats"
               if getattr(calc, "graded", False) else
               "engine='scan': the repeats run in lockstep, the likelihood in torch")
        return "slice_step_graded", why
    if engine == "cuda":
        return cuda_route(calc)
    return forced_route(engine, calc)


#: the functor kernel of each forced engine (its fused route adds "_fused")
FORCED_KERNELS = {"cuda5": "slice_epoch_v5", "cuda3": "slice_epoch_v3", "cuda2": "slice_epoch_v2"}


def forced_route(engine: str, calc) -> Tuple[str, str]:
    """(route, reason) of a forced engine (``"cuda5"``, ``"cuda3"``,
    ``"cuda2"``): its functor kernel for a model with a device form
    (``calc.device_spec``), else its fused route, with the lowering's
    summary (``"lowered: ..."``) or, for a model the lowering refuses, the
    reason it was refused (``core/nested_sampling.py::resolve_engine``
    raises for such a model before a run)."""
    kernel = FORCED_KERNELS[engine]
    forced = f"engine={engine!r} forced"
    spec = getattr(calc, "device_spec", None)
    if spec is not None:
        return kernel, f"{forced}: device functor {spec['likelihood']['name']!r}"
    from .fused_like import Refused, lowering

    low = lowering(calc)
    if isinstance(low, Refused):
        return f"{kernel}_fused", (f"{forced}: the lowering refused this model: {low.reason}; "
                                   "engine='cuda' runs it")
    return f"{kernel}_fused", (f"{forced}: lowered: {low.n_terms} per-coordinate term(s), "
                               f"{len(low.term)} + {len(low.combine)} statements")


def build_epoch_fn(calc, cfg: EpochConfig):
    """Build ``epoch(key_words, seed_cube, bound, cholesky, lane_valid,
    generator=None, directions=None, draws=None, lane0=0, rerun=False)``
    for ``cfg.engine``.

    ``generator`` is the device ``torch.Generator`` the directions are drawn
    from; ``draws=(gauss, perm)`` gives its draws instead (a shard's columns
    of the one-device draw, ``ops/directions.py::shard_draws``);
    ``directions=(nhats, w, speeds)`` replaces the whole direction step
    (test seam).  ``lane0`` is the batch's first lane in the whole chain
    batch (a shard's; ``pallas_slice.lane_hash``).

    The packed record's last column is the ring engine's overflow flag of
    each lane (:func:`epoch_overflowed`): set where the ring's budget
    stopped a valid lane before its last repeat was accepted, 0 on every
    other engine.  ``rerun`` runs the ring's epoch again on the same route
    at the route's own budget ``step_cap``, with no flag (the runner's
    re-run of an overflowed epoch, on the same draws)."""
    from .directions import make_directions
    from .pallas_slice_v4 import assemble_epoch

    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}; have {ENGINES}")
    if cfg.engine == "torch":
        def records(*args, speeds, lane0):
            return slice_records_plain(lambda p: calc(p)[2], cfg, *args, lane0=lane0)
    elif cfg.engine == "scan" and calc.uses_callback:
        from .pallas_slice_v4 import slice_epoch_host

        def records(*args, speeds, lane0):
            # the babies are the accepted probes the host kept
            t, logL, nlike, (cube, theta, phi) = slice_epoch_host(calc, cfg, *args,
                                                                  lane0=lane0)
            return t, logL, nlike, cube, None, (theta, phi)
    elif cfg.engine == "scan":
        from .pallas_slice_v4 import slice_epoch_graded

        def records(*args, speeds, lane0):
            # no cube (the babies are rebuilt), and the intermediate of each
            # repeat, from which assemble_epoch takes a fast repeat's babies
            t, logL, nlike, aux = slice_epoch_graded(calc, cfg, *args, speeds, with_aux=True,
                                                     lane0=lane0)
            return t, logL, nlike, None, aux
    elif cfg.engine == "ring":
        from .pallas_slice_v4 import slice_epoch_host

        cuda = kernel_wrapper("cuda")

        def records(key_words, x0, *args, speeds, lane0, rerun):
            # the ring's budget, or the route's own for the re-run; the
            # overflow flags go last
            cap = None if rerun else cfg.ring_budget
            if x0.device.type == "cpu":  # the plain engine
                out = slice_records_plain(lambda p: calc(p)[2], cfg, key_words, x0, *args,
                                          lane0=lane0, ring_cap=cap)
            elif calc.uses_callback:  # the host route, its babies the kept probes
                t, logL, nlike, (cube, theta, phi), *flag = slice_epoch_host(
                    calc, cfg, key_words, x0, *args, lane0=lane0, ring_cap=cap)
                out = (t, logL, nlike, cube, None, (theta, phi), *flag)
            else:  # B1's route for the model
                out = cuda(calc, cfg, key_words, x0, *args, lane0=lane0, ring_cap=cap)
            return out
    else:
        kernel = kernel_wrapper(cfg.engine)

        def records(*args, speeds, lane0):
            return kernel(calc, cfg, *args, lane0=lane0)

    dtype = calc_dtype(calc)  # float64 at precision='highest'

    ring = cfg.engine == "ring"

    def epoch(key_words, seed_cube, bound, cholesky, lane_valid,
              generator=None, directions=None, draws=None, lane0=0, rerun=False):
        if directions is None:
            # the plain engine asks for the plain Gram-Schmidt by name: its
            # runs reach no kernel, at any dimension
            gauss, perm = (None, None) if draws is None else draws
            directions = make_directions(
                cholesky.to(dtype), grade_dims=cfg.grade_dims, num_repeats=cfg.num_repeats,
                n_dims=cfg.n_dims, generator=generator, gauss=gauss, perm=perm,
                use_kernel=cfg.engine != "torch",
            )
        nhats, ws, speeds = directions
        seed_f = seed_cube.to(dtype)
        args = (key_words, seed_f, bound.to(dtype), lane_valid, nhats, ws)
        overflow = None
        if ring:
            out = records(*args, speeds=speeds, lane0=lane0, rerun=rerun)
            if not rerun:
                *out, overflow = out
        else:
            out = records(*args, speeds=speeds, lane0=lane0)
        return assemble_epoch(calc, cfg, seed_f, lane_valid, nhats, speeds, *out,
                              overflow=overflow)

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


def epoch_overflowed(packed) -> bool:
    """Whether a ring-engine epoch's packed record (a tensor or an array)
    has a lane whose overflow flag, its last column, is set: the runner then
    re-runs the epoch (``polychordlite_tpu/ops/slice_kernel.py:680-686``)."""
    return bool(packed[:, -1].any())
