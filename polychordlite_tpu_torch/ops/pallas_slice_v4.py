"""The slice-epoch kernel and the epoch built around it
(counterpart of ``polychordlite_tpu/ops/pallas_slice_v4.py``).

:func:`slice_epoch` is the wrapper of the hand-written CUDA kernel
``csrc/slice_epoch.cu``: one chain on a group of G lanes of a warp, each
lane owning the coordinates d = g (mod G) (see the source for its design).
:func:`choose_group` picks G from the chains, the dimension and the card's
SM count.  For CPU tensors it runs the kernel's plain version,
``slice_kernel.slice_records_plain``; for CUDA tensors it launches the
kernel or raises.  The kernel evaluates the likelihood itself through a
device functor of ``csrc/likelihoods.cuh`` (:data:`FUNCTORS`), selected by
``calc.device_spec`` (``ops/evaluate.py``); :func:`validate_functor` checks
that functor against the torch calc, bitwise, through the engine that will
run it, before a run uses it.  :func:`launch_slice_kernel` is shared with
the kernels of ``ops/pallas_slice_v5.py``, ``ops/pallas_slice_v3.py`` and
``ops/pallas_slice.py``.

:func:`slice_epoch_counted` is the wrapper of the same kernel's counted
instantiation at G = 1 (``experiments/v4_instr.py`` at the repository root): B1's
outputs bit for bit, plus the micro-steps each lane executed and the
largest of each warp of 32 lanes, from which :func:`lane_efficiency`
follows.  No run calls it.

:func:`slice_epoch_traced` is B1's route for a model without a device
functor, a likelihood written in torch (the JAX package traces any jnp
likelihood into its kernel): the wrapper of ``csrc/slice_step.cu``, which
runs one micro-step of every chain per launch with the likelihood evaluated
by the torch calc between two launches.  :class:`TracedEpoch` keeps the
kernel's device state and replays ``rounds`` rounds (the calc and one
launch) captured in one CUDA graph until no lane is left running.  Its plain
version is :func:`slice_step_plain` over :class:`StepState`, driven the
same way by :func:`slice_records_rounds_plain`; both are bitwise
``slice_kernel.slice_records_plain`` for the same calc.

Outside the kernel, as in the JAX package (``pallas_slice_v4.py:524-559``):
the baby positions are rebuilt as ``seed + cumsum(t n̂)``, theta and phi
come from one batched evaluation of the calc, and everything is packed into
the epoch record (:func:`assemble_epoch`); ``slice_kernel.build_epoch_fn``
puts the pieces together.
"""

from __future__ import annotations

import ctypes
import gc

import numpy as np
import torch

from ..utils import nvcc
from .pallas_slice import PH_DONE, PH_INIT_R, LaneMachine, _mix, lane_hash
from .slice_kernel import EpochConfig, slice_records_plain

#: the kernels' bound on the dimension (SLICE_MAXD of ``csrc/slice_common.cuh``)
SLICE_MAXD = 32

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"slice_epoch": 0, "slice_epoch_counted": 0, "slice_step": 0}
#: the traced route's CUDA-graph replays and the rounds they ran, since the
#: last reset
TRACED = {"replays": 0, "rounds": 0}
#: rounds (one calc evaluation and one slice_step launch each) in one graph
ROUNDS = 32

WARP = 32  # lanes of a warp: the kernels run one warp per block
#: the lanes a chain may be spread over (the kernel's instantiations)
GROUPS = (1, 2, 4, 8, 16, 32)
#: slice_epoch's launches by G since the last reset
GROUP_LAUNCHES = {g: 0 for g in GROUPS}
#: the warps per SM that choose_group aims for (PERF.md: the epoch's
#: time against G at the bench and gaussian.ini geometries)
TARGET_WARPS_PER_SM = 8

#: device functors of ``csrc/likelihoods.cuh``: the likelihood form's name
#: -> (functor id, the form's constants in the order the functor takes them)
FUNCTORS = {
    "gaussian": (0, ("mu", "sigma", "norm")),
    "gaussian_shells": (1, ("centre", "radius", "two_s2", "neg_a", "log_two")),
    "half_gaussian": (2, ("mu", "sigma", "norm")),
    "pyramidal": (3, ("mu", "sigma", "norm", "factor")),
    "rastrigin": (4, ("log_norm", "A", "two_pi")),
    "twin_gaussian": (5, ("off", "sigma", "norm", "log_two")),
    "himmelblau": (6, ("norm",)),
    "rosenbrock": (7, ("a", "b", "norm")),
    "eggbox": (8, ()),
    "gaussian_shell": (9, ("radius", "two_s2", "neg_a")),
    # the D x D matrix last: the entry copies it to constant memory
    "random_gaussian": (10, ("mu", "norm", "invcov")),
}

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
)


def _lib():
    return nvcc.load("slice_epoch", ["slice_epoch.cu"])


def choose_group(B: int, D: int, n_sm: int) -> int:
    """G, the lanes of a warp that hold one chain: the smallest power of two
    whose B G / 32 warps reach :data:`TARGET_WARPS_PER_SM` on each of the
    card's ``n_sm`` SMs, and never more lanes than coordinates (G <= D, so
    every lane owns one).  More lanes per chain hide the micro-step's
    dependent chain behind more warps, but spend G times the issue slots on
    each chain's state machine and sums."""
    g_max = 1 << (min(D, WARP).bit_length() - 1)
    g = 1
    while g < g_max and B * g < TARGET_WARPS_PER_SM * n_sm * WARP:
        g *= 2
    return g


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _f32(x: float) -> float:
    return float(np.float32(x))


def functor_args(calc, D: int):
    """(functor id, constants, prior a, prior s) — the host float32 arrays a
    kernel entry takes for ``calc.device_spec``, checked against D.  Raises
    for a model without a device form that :data:`FUNCTORS` knows."""
    spec = getattr(calc, "device_spec", None)
    if spec is None or spec["likelihood"]["name"] not in FUNCTORS:
        raise ValueError(
            "the CUDA slice kernels need a prior and likelihood with a device "
            "form (ops/evaluate.py); use engine='torch' for this model"
        )
    name = spec["likelihood"]["name"]
    fid, keys = FUNCTORS[name]
    consts = np.concatenate(
        [np.zeros(0, np.float32)]
        + [np.atleast_1d(np.asarray(spec["likelihood"][k], np.float32)).ravel() for k in keys]
    )
    if name == "random_gaussian" and consts.size != 2 + D * D:
        raise ValueError(f"random_gaussian's matrix is not {D} x {D}")
    prior_a, prior_s = (np.ascontiguousarray(v, dtype=np.float32) for v in spec["prior"])
    if prior_a.shape != (D,) or prior_s.shape != (D,):
        raise ValueError(f"the prior's affine form is not per coordinate of D={D}")
    return fid, consts, prior_a, prior_s


def launch_slice_kernel(lib, entry: str, calc, cfg: EpochConfig, key_words,
                        x0, bound, valid, nhats, ws, cap=None, extra=(), ints=()):
    """Check the inputs of a slice-epoch kernel, launch it on the current
    stream and return (t, logL, nlike), each (B, R).  The model must have a
    device form (``calc.device_spec``) whose functor is in
    :data:`FUNCTORS`.  ``cap`` is the kernel's micro-step budget
    (``cfg.step_cap`` by default); ``extra`` are further output tensors on
    the device and ``ints`` further int arguments, passed after the stream
    in that order."""
    B, R, D = nhats.shape
    if D > SLICE_MAXD:
        raise ValueError(f"D={D} exceeds the kernels' maximum {SLICE_MAXD}")
    fid, consts, prior_a, prior_s = functor_args(calc, D)
    if x0.shape != (B, D) or bound.shape != (B,) or valid.shape != (B,) or ws.shape != (B, R):
        raise ValueError(f"{entry}: inconsistent shapes")
    dev = x0.device
    for name, a in (("bound", bound), ("valid", valid), ("nhats", nhats), ("ws", ws)):
        if a.device != dev:
            raise ValueError(f"{entry}: {name} is on {a.device}, x0 on {dev}")
    f32 = torch.float32
    x0t = x0.to(f32).t().contiguous()
    nhat_t = nhats.to(f32).permute(1, 2, 0).contiguous()
    w_t = ws.to(f32).t().contiguous()
    bound_f = bound.to(f32).contiguous()
    valid_f = valid.to(f32).contiguous()
    t_out = torch.empty((R, B), dtype=f32, device=dev)
    l_out = torch.empty((R, B), dtype=f32, device=dev)
    n_out = torch.empty((R, B), dtype=torch.int32, device=dev)
    for a in extra:
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{entry}: an extra output is not contiguous on {dev}")
    k0, k1 = key_words
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = getattr(lib, entry)
    fn.argtypes = _ARGTYPES + [ctypes.c_void_p] * len(extra) + [ctypes.c_int] * len(ints)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(
            fid, consts.ctypes.data, prior_a.ctypes.data, prior_s.ctypes.data,
            x0t.data_ptr(), bound_f.data_ptr(), valid_f.data_ptr(),
            nhat_t.data_ptr(), w_t.data_ptr(), t_out.data_ptr(),
            l_out.data_ptr(), n_out.data_ptr(), B, D, R,
            int(k0), int(k1), cfg.max_step, cfg.max_shrink,
            cfg.step_cap if cap is None else int(cap), _f32(cfg.logzero), stream,
            *(a.data_ptr() for a in extra), *(int(i) for i in ints),
        )
    nvcc.check(status, entry)
    return t_out.t(), l_out.t(), n_out.t()


def slice_epoch(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws,
                group=None):
    """Run the slice repeats of every lane: (t, logL) float32 and nlike
    int32, each (B, R).  ``x0 (B,D)``, ``bound (B,)``, ``valid (B,)`` bool,
    ``nhats (B,R,D)``, ``ws (B,R)``.  CPU tensors: the plain version; CUDA
    tensors: the kernel, which needs ``calc.device_spec``, with ``group``
    lanes per chain (one of :data:`GROUPS`; :func:`choose_group` by
    default).  Every G gives the same result bit for bit."""
    if group is not None and group not in GROUPS:
        raise ValueError(f"group {group} is not one of {GROUPS}")
    if x0.device.type == "cpu":
        return slice_records_plain(
            lambda p: calc(p)[2], cfg, key_words, x0, bound, valid, nhats, ws
        )
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    B, R, D = nhats.shape
    G = choose_group(B, D, _sm_count(x0.device)) if group is None else group
    out = launch_slice_kernel(_lib(), "slice_epoch_launch", calc, cfg, key_words,
                              x0, bound, valid, nhats, ws, ints=(G,))
    LAUNCHES["slice_epoch"] += 1
    GROUP_LAUNCHES[G] += 1
    return out


def slice_epoch_counted(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws):
    """B1 with its micro-steps counted: (t, logL, nlike, lane_steps,
    warp_max), the first three as :func:`slice_epoch` gives them,
    ``lane_steps (B,)`` int32 the micro-steps each lane executed and
    ``warp_max (ceil(B/32),)`` int32 the largest of each warp's 32 lanes
    (lanes past B count 0).  CPU tensors: the plain engine's own step
    counts; CUDA tensors: the counted kernel."""
    B = x0.shape[0]
    if x0.device.type == "cpu":
        t, l, n, steps = slice_records_plain(
            lambda p: calc(p)[2], cfg, key_words, x0, bound, valid, nhats, ws,
            count_steps=True,
        )
        return t, l, n, steps, warp_maxima(steps)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    steps = torch.empty(B, dtype=torch.int32, device=x0.device)
    wmax = torch.empty(-(-B // WARP), dtype=torch.int32, device=x0.device)
    out = launch_slice_kernel(_lib(), "slice_epoch_counted_launch", calc, cfg, key_words,
                              x0, bound, valid, nhats, ws, extra=(steps, wmax))
    LAUNCHES["slice_epoch_counted"] += 1
    return (*out, steps, wmax)


def warp_maxima(lane_steps: torch.Tensor) -> torch.Tensor:
    """The largest entry of each run of 32 lanes (the last padded with 0)."""
    B = lane_steps.shape[0]
    padded = torch.zeros(-(-B // WARP) * WARP, dtype=torch.int32, device=lane_steps.device)
    padded[:B] = lane_steps.to(torch.int32)
    return padded.view(-1, WARP).amax(dim=1)


def lane_efficiency(lane_steps: torch.Tensor, warp_max: torch.Tensor) -> float:
    """The share of issued lane-steps that did work: a warp runs as long as
    its slowest lane, so sum(lane steps) / (32 * sum(warp max))."""
    issued = WARP * int(warp_max.to(torch.int64).sum())
    return int(lane_steps.to(torch.int64).sum()) / issued if issued else float("nan")


def validate_functor(calc, cfg: EpochConfig, device, records=None) -> None:
    """Check the kernel's likelihood functor against the torch calc on 1280
    cubes, some outside the walls; raise on any difference.

    ``records`` is the wrapper of the engine that will run the functor
    (:func:`slice_epoch` by default; see ``slice_kernel.kernel_wrapper``);
    its second output is the logL.  The kernel is run with zero directions and zero widths,
    so every probe is the seed itself, and with an unbounded contour: the
    lane steps out and shrinks on the spot and accepts its seed with the
    functor's logL (a seed outside the walls is a forced logzero accept)."""
    records = slice_epoch if records is None else records
    D = cfg.n_dims
    rng = np.random.default_rng(20240131)
    pts = np.concatenate([
        rng.uniform(-0.05, 1.05, (1024, D)),
        np.clip(rng.normal(0.5, 0.1, (256, D)), -0.2, 1.2),
    ]).astype(np.float32)
    x0 = torch.as_tensor(pts, device=device)
    B = x0.shape[0]
    # one repeat on the plain configuration (a subclass's budget dropped)
    one = EpochConfig(*cfg)._replace(num_repeats=(1,), grade_dims=(D,))
    got = records(
        calc, one, (0, 0), x0,
        torch.full((B,), -torch.finfo(torch.float32).max, device=device),
        torch.ones(B, dtype=torch.bool, device=device),
        torch.zeros((B, 1, D), device=device), torch.zeros((B, 1), device=device),
    )[1]
    _, _, want = calc(x0)
    if not torch.equal(got[:, 0], want.to(torch.float32)):
        diff = (got[:, 0].double() - want.double()).abs().max().item()
        raise RuntimeError(
            f"the CUDA likelihood functor disagrees with the torch calc "
            f"(max |dlogL| = {diff:.3g}); not running the kernel"
        )


def assemble_epoch(calc, cfg: EpochConfig, seed, valid, nhats, speeds, t_acc, logL, nlike_rep,
                   cube=None):
    """Packed epoch record from the per-(lane, repeat) kernel outputs.  The
    baby positions are ``cube (B, R, D)`` where the engine wrote them (v2),
    else rebuilt as ``seed + cumsum(t n̂)``."""
    B, R, D = nhats.shape
    n_grades = len(cfg.grade_dims)
    if cube is None:
        cube = seed[:, None, :] + torch.cumsum(t_acc[:, :, None] * nhats, dim=1)
    theta, phi, _ = calc(cube.reshape(B * R, D))
    vmask = valid[:, None, None]
    theta = torch.where(vmask, theta.reshape(B, R, D), 0.0)
    phi = torch.where(vmask, phi.reshape(B, R, cfg.n_phi), 0.0)
    babies = torch.cat([cube, theta, phi, logL[:, :, None]], dim=2).reshape(
        B, R * (2 * D + cfg.n_phi + 1)
    )
    onehot = torch.nn.functional.one_hot(speeds.long(), n_grades)  # (B, R, G)
    nlike_g = (onehot * nlike_rep[:, :, None].to(torch.int64)).sum(dim=1)
    return torch.cat([
        babies,
        nlike_g.to(torch.float32),
        torch.zeros((B, 1), dtype=torch.float32, device=seed.device),  # overflow flag (never set)
    ], dim=1)


# ---------------------------------------------------------------------------
# B1's route for a likelihood evaluated in torch (csrc/slice_step.cu)
# ---------------------------------------------------------------------------


class StepState:
    """The lanes of the traced route between two rounds, in torch: the plain
    version of ``csrc/slice_step.cu``'s device state.  Set up as the first
    launch sets it up: a valid lane in ``PH_INIT_R`` of repeat 0, an invalid
    one done; every record t = 0, logL = logzero, nlike = 0."""

    def __init__(self, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws):
        B, R, _ = nhats.shape
        dev = x0.device
        f32 = torch.float32
        self.cfg, self.bound, self.nhats, self.ws = cfg, bound, nhats, ws
        self.logzero = torch.tensor(cfg.logzero, dtype=f32).item()
        self.lanes = torch.arange(B, device=dev)
        self.h_lane = lane_hash(key_words, B, dev)
        self.m = LaneMachine(B, dev, self.logzero)
        self.m.phase = torch.where(valid, PH_INIT_R, PH_DONE).to(torch.int64)
        self.rep = torch.where(valid, 0, R).to(torch.int64)
        self.steps = torch.zeros(B, dtype=torch.int64, device=dev)
        self.x = x0.to(f32).clone()
        self.t_out = torch.zeros((B, R), dtype=f32, device=dev)
        self.l_out = torch.full((B, R), self.logzero, dtype=f32, device=dev)
        self.n_out = torch.zeros((B, R), dtype=torch.int32, device=dev)
        self.t = self.probe = None  # the pending probes


def slice_step_plain(st: StepState, logL=None) -> bool:
    """One launch of ``csrc/slice_step.cu`` in torch.  Unless ``logL`` is
    None (the epoch's first launch), consume it, the (B,) logL of
    ``st.probe``: the transition of every running lane, the records of the
    repeats that accept or meet the epoch's budget, an accepted lane's move
    to its probe and the start of its next repeat.  Then propose: the next
    probes into ``st.probe`` (a lane that is done probes its x with t = 0).
    Returns whether a lane is left running (the kernel's ``active`` flag)."""
    m, cfg = st.m, st.cfg
    R = st.nhats.shape[1]
    if logL is not None:
        active = m.phase != PH_DONE
        acc, forced = m.decide(cfg, active, st.t, logL, st.bound)
        st.steps = st.steps + active.to(torch.int64)
        capped = active & ~acc & (st.steps >= cfg.step_cap)
        rec = acc | capped
        rows, cols = st.lanes[rec], st.rep[rec]
        st.t_out[rows, cols] = torch.where(acc, st.t, 0.0)[rec]
        st.l_out[rows, cols] = torch.where(acc & ~forced, logL, st.logzero)[rec]
        st.n_out[rows, cols] = m.cnt[rec].to(torch.int32)
        st.x = torch.where(acc[:, None], st.probe, st.x)
        st.rep = torch.where(acc, st.rep + 1, st.rep)
        m.phase = torch.where(acc, torch.where(st.rep >= R, PH_DONE, PH_INIT_R), m.phase)
        m.phase = torch.where(capped | (acc & (st.steps >= cfg.step_cap)), PH_DONE, m.phase)
        m.restart(acc)
    active = m.phase != PH_DONE
    r_idx = st.rep.clamp(max=R - 1)
    st.t = m.propose(active, _mix(st.h_lane, st.rep), st.ws[st.lanes, r_idx])
    st.probe = st.x + st.t[:, None] * st.nhats[st.lanes, r_idx]
    return bool(active.any())


def slice_records_rounds_plain(logL_fn, cfg: EpochConfig, key_words, x0, bound, valid,
                               nhats, ws, rounds: int = ROUNDS):
    """The traced route in torch, structured as the kernel route runs it: the
    first launch, then replays of ``rounds`` rounds (``logL_fn(probe)`` and
    one :func:`slice_step_plain`) until the flag of a replay's last round
    reads no lane running.  Returns (t, logL, nlike), each (B, R), bitwise
    ``slice_kernel.slice_records_plain`` for any ``rounds``."""
    st = StepState(cfg, key_words, x0, bound, valid, nhats, ws)
    running = slice_step_plain(st)
    while running:
        for _ in range(rounds):
            running = slice_step_plain(st, logL_fn(st.probe))
    return st.t_out, st.l_out, st.n_out


#: slice_step_launch's arguments: first, 15 device pointers, B, D, R, k0,
#: k1, max_step, max_shrink, cap, logzero, stream
_STEP_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
)
_STATE_INTS, _STATE_FLOATS = 10, 3  # S_INTS and F_FLOATS of slice_step.cu


class TracedEpoch:
    """``csrc/slice_step.cu``'s device state for one calc, configuration and
    (B, R, D), and the CUDA graph of ``rounds`` rounds that replays it.

    The buffers are allocated once; each epoch copies its inputs in, runs the
    first launch, captures the graph on its first use (the calc warmed up on
    a side stream first, as capture asks) and replays it until the kernel's
    ``active`` flag reads 0: one host read per replay.  A calc that cannot
    run inside a graph (a host sync such as ``.item()``, a copy from host
    memory) raises ``ValueError``.  The calc keeps its runners
    (:func:`slice_epoch_traced`), so a runner takes the calc as an argument
    and holds no reference to it: no cycle that only the garbage collector
    could free, at a moment that might fall inside another capture."""

    def __init__(self, cfg: EpochConfig, B: int, R: int, D: int, rounds: int, device):
        self.cfg, self.rounds, self.device = cfg, rounds, device
        self.shape = (B, R, D)
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.x0t, self.valid, self.bound = (torch.zeros((D, B), **f32), torch.zeros(B, **f32),
                                            torch.zeros(B, **f32))
        self.nhat, self.w = torch.zeros((R, D, B), **f32), torch.zeros((R, B), **f32)
        self.logL = torch.zeros(B, **f32)
        self.ist = torch.zeros((_STATE_INTS, B), **i32)
        self.steps = torch.zeros(B, dtype=torch.int64, device=device)
        self.fst, self.x = torch.zeros((_STATE_FLOATS, B), **f32), torch.zeros((D, B), **f32)
        self.probe = torch.zeros((B, D), **f32)
        self.t_out, self.l_out = torch.zeros((R, B), **f32), torch.zeros((R, B), **f32)
        self.n_out, self.active = torch.zeros((R, B), **i32), torch.zeros(1, **i32)
        self.fn = nvcc.load("slice_step", ["slice_step.cu"]).slice_step_launch
        self.fn.argtypes = _STEP_ARGTYPES
        self.fn.restype = ctypes.c_int
        self.graph = None

    def _launch(self, first: bool, key_words=(0, 0)) -> None:
        B, R, D = self.shape
        cfg = self.cfg
        bufs = (self.x0t, self.valid, self.bound, self.nhat, self.w, self.logL, self.ist,
                self.steps, self.fst, self.x, self.probe, self.t_out, self.l_out, self.n_out,
                self.active)
        status = self.fn(
            int(first), *(b.data_ptr() for b in bufs), B, D, R, int(key_words[0]),
            int(key_words[1]), cfg.max_step, cfg.max_shrink, cfg.step_cap, _f32(cfg.logzero),
            torch.cuda.current_stream(self.device).cuda_stream,
        )
        nvcc.check(status, "slice_step_launch")

    def _capture(self, calc) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                calc(self.probe)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a graph that the garbage collector frees while this one is being
        # captured ends the capture: collect now, and not during it
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    for i in range(self.rounds):
                        self.logL.copy_(calc(self.probe)[2])
                        if i == self.rounds - 1:  # the flag then tells of the last round
                            self.active.zero_()
                        self._launch(False)
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            first = e.__context__ or e  # what broke the capture, before capture_end's error
            raise ValueError(
                "the CUDA engine runs a model without a device functor inside a CUDA "
                f"graph, and this likelihood or prior cannot be captured in one ({first}); "
                "pass engine='torch' to run it on the plain engine"
            ) from e
        finally:
            gc.enable()
        self.graph = graph

    def __call__(self, calc, key_words, x0, bound, valid, nhats, ws):
        self.x0t.copy_(x0.t())
        self.valid.copy_(valid)
        self.bound.copy_(bound)
        self.nhat.copy_(nhats.permute(1, 2, 0))
        self.w.copy_(ws.t())
        self.active.zero_()
        self._launch(True, key_words)
        LAUNCHES["slice_step"] += 1
        if self.graph is None:
            self._capture(calc)
        while int(self.active.item()):
            self.graph.replay()
            LAUNCHES["slice_step"] += self.rounds
            TRACED["replays"] += 1
            TRACED["rounds"] += self.rounds
        return self.t_out.t().contiguous(), self.l_out.t().contiguous(), \
            self.n_out.t().contiguous()


def slice_epoch_traced(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws,
                       rounds: int = ROUNDS):
    """Run the slice repeats of every lane for a model without a device
    functor: (t, logL) float32 and nlike int32, each (B, R), with the inputs
    of :func:`slice_epoch`.  CPU tensors: the plain version,
    :func:`slice_records_rounds_plain`; CUDA tensors: ``csrc/slice_step.cu``
    through a :class:`TracedEpoch` kept on the calc, one per configuration,
    shape and ``rounds``.  A host-callback calc raises on the card."""
    B, R, D = nhats.shape
    if x0.shape != (B, D) or bound.shape != (B,) or valid.shape != (B,) or ws.shape != (B, R):
        raise ValueError("slice_epoch_traced: inconsistent shapes")
    if rounds < 1:
        raise ValueError(f"rounds must be at least 1, not {rounds}")
    if x0.device.type == "cpu":
        return slice_records_rounds_plain(lambda p: calc(p)[2], cfg, key_words, x0, bound,
                                          valid, nhats, ws, rounds)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    if getattr(calc, "uses_callback", False):
        raise ValueError(
            "a host-callback likelihood has no route on the card (the CUDA engine needs "
            "a torch likelihood); pass engine='torch' to run it on the plain engine"
        )
    for name, a in (("bound", bound), ("valid", valid), ("nhats", nhats), ("ws", ws)):
        if a.device != x0.device:
            raise ValueError(f"slice_epoch_traced: {name} is on {a.device}, x0 on {x0.device}")
    runners = calc.__dict__.setdefault("traced_epochs", {})
    key = (tuple(cfg), cfg.step_cap, B, R, D, rounds, str(x0.device))
    if key not in runners:
        runners[key] = TracedEpoch(cfg, B, R, D, rounds, x0.device)
    return runners[key](calc, key_words, x0, bound, valid, nhats, ws)
