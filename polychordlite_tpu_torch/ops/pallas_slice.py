"""The v2 slice epoch, the per-lane state machine in plain torch, the murmur3
counter hash and per-epoch key words (counterpart of
``polychordlite_tpu/ops/pallas_slice.py``).

:func:`slice_epoch_v2` is the wrapper of the hand-written CUDA kernel
``csrc/slice_epoch_v2.cu`` (B5, the JAX package's ``"pallas2"`` engine):
each chain runs its R repeats freely under v2's per-repeat budget and the
kernel writes the cube; a chain holds G lanes of a warp, as B1's does.
For CPU tensors it runs
:func:`slice_records_lockstep_plain`, v2's own structure in torch (every
repeat a while loop of 4-micro-step bodies over all lanes, the cube
carried); for CUDA tensors it launches the kernel or raises.  Both make
the v4 engine's decisions (same uniforms, budgets that cannot bind), so t,
logL and nlike are bitwise those of ``slice_kernel.slice_records_plain``;
the cube is the sequential x <- x + t n̂, which differs in the last bits
from the ``seed + cumsum(t n̂)`` the other engines rebuild.

:func:`slice_epoch_v2_counted` is the wrapper of the same kernel's counted
instantiation (E3, ``experiments/prof_lockstep_waste.py`` at the repository
root): B5's outputs bit for bit, plus the micro-steps of every (lane,
repeat) and the micro-steps v2's lockstep loop runs per repeat.  Its study
is ``experiments/prof_lockstep_waste.py`` of this package.

:class:`LaneMachine` is the per-lane state machine of one micro-step
(``csrc/slice_machine.cuh``) vectorised over lanes; the plain versions of
v4 (``slice_kernel.py``), v3 (``pallas_slice_v3.py``) and v2 (here) drive
it, each with its own outer structure.

The slice engines draw their 1-D uniforms from a murmur3 hash keyed on
(epoch key words, global lane, repeat, iteration), so a lane's stream never
depends on how long other lanes run.  The JAX package computes the hash in
int32 with logical shifts; here the same 32-bit words are held in int64
tensors (or Python ints) in [0, 2**32), and every product is split into
16-bit halves so that nothing exceeds 2**63 — the results are bitwise those
of the uint32 formulation, which the CUDA kernel uses directly
(``csrc/slice_epoch.cu``).

Per-epoch key words: the JAX package derives them from a threefry key with
``jax.random.fold_in``.  The port keeps a raw key of the same shape — two
uint32 words, ``[seed >> 32, seed & 0xFFFFFFFF]`` for a seed — and folds an
integer into it with :func:`fold_in`, a murmur3 construction (not the same
bits as threefry; switching the RNG is a seed change, not a change of
statistics).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import nvcc

MASK = 0xFFFFFFFF

# phase constants of the per-lane state machine (pallas_slice.py:64)
PH_INIT_R, PH_INIT_L, PH_STEP_R, PH_STEP_L, PH_SHRINK, PH_DONE = range(6)

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_C3 = 0xE6546B64
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35


def _mul32(a, c: int):
    """(a * c) mod 2**32 for a word ``a`` in [0, 2**32) and a constant c,
    without any intermediate above 2**49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _srl(x, n: int):
    return x >> n  # x is non-negative, so this is the logical shift


def _rotl(x, n: int):
    return ((x << n) & MASK) | _srl(x, 32 - n)


def _mix(h, k):
    """One murmur3 combine round on 32-bit words (wrapping arithmetic)."""
    k = _mul32(k & MASK, _C1)
    k = _rotl(k, 15)
    k = _mul32(k, _C2)
    h = (h & MASK) ^ k
    h = _rotl(h, 13)
    return (_mul32(h, 5) + _C3) & MASK


def _fmix(h):
    """murmur3 avalanche finaliser."""
    h = h & MASK
    h = h ^ _srl(h, 16)
    h = _mul32(h, _F1)
    h = h ^ _srl(h, 13)
    h = _mul32(h, _F2)
    return h ^ _srl(h, 16)


def uniform_from_hash(h):
    """The engines' uniform in [0, 1): the top 24 bits of a hash word times
    2**-24 (``pallas_slice_v4.py:246-248``).  Exact in float32."""
    return _srl(h, 8) * (1.0 / (1 << 24))


def seed_key(seed: int) -> np.ndarray:
    """The raw key of a seed: uint32[2] = [seed >> 32, seed & 0xFFFFFFFF]
    (the layout of a raw ``jax.random.PRNGKey(seed)``)."""
    seed = int(seed)
    return np.array([(seed >> 32) & MASK, seed & MASK], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """Fold an integer into a raw uint32[2] key (murmur3, documented above)."""
    k0, k1 = (int(x) for x in np.asarray(key, dtype=np.uint32).reshape(-1)[[0, -1]])
    d = int(data) & MASK
    h0 = _fmix(_mix(_mix(0x9E3779B9, k0), d))
    h1 = _fmix(_mix(_mix(h0, k1), d))
    return np.array([h0, h1], dtype=np.uint32)


def key_words(key):
    """(k0, k1) Python ints of a raw key: its first and last word, as the
    JAX package's ``_key_words`` takes them."""
    k = np.asarray(key, dtype=np.uint32).reshape(-1)
    return int(k[0]), int(k[-1])


def lane_hash(key_words, B: int, device, lane0: int = 0) -> torch.Tensor:
    """h_lane = mix(mix(k0, k1), lane) of lanes lane0..lane0+B-1, int64
    words: ``lane0`` is a shard's first lane in the whole batch (the
    kernels' ``lane0`` argument), so a shard's lanes draw the uniforms of the
    same lanes of the one-device batch."""
    k0, k1 = key_words
    lanes = torch.arange(lane0, lane0 + B, device=device)
    return _mix(_mix(torch.full((B,), k0, dtype=torch.int64, device=device), k1), lanes)


class LaneMachine:
    """The state of the slice state machine of B lanes in one repeat
    (``csrc/slice_machine.cuh``), as int64, bool and ``dtype`` tensors
    (float32, or float64 for the plain version of the double kernels at
    ``precision='highest'``; the uniforms are the same 24-bit draws, exact
    in either).  All lanes start in ``PH_DONE``; the caller starts the ones
    it runs."""

    def __init__(self, B: int, device, logzero: float, dtype: torch.dtype = torch.float32):
        def i64(v):
            return torch.full((B,), v, dtype=torch.int64, device=device)

        self.logzero, self.dtype = logzero, dtype
        self.phase = i64(PH_DONE)
        self.it, self.rstep, self.lstep, self.nshrink, self.cnt = i64(0), i64(1), i64(1), i64(0), i64(0)
        self.need_r = torch.zeros(B, dtype=torch.bool, device=device)
        self.need_l = torch.zeros_like(self.need_r)
        self.tL = torch.zeros(B, dtype=dtype, device=device)
        self.tR = torch.zeros_like(self.tL)

    def step(self, logL_fn, cfg, active, h_rep, w, nhat, x, bound, u=None):
        """One micro-step of every ``active`` lane on the chord x + t n̂, the
        uniform drawn at (h_rep, it) unless ``u`` (B,) gives it.
        Returns (t, probe, logL, acc, forced); an accepting lane is left for
        the caller to record and restart."""
        t = self.propose(active, h_rep, w, u)
        probe = x + t[:, None] * nhat
        logL = logL_fn(probe)
        acc, forced = self.decide(cfg, active, t, logL, bound)
        return t, probe, logL, acc, forced

    def propose(self, active, h_rep, w, u=None):
        """The first half of :meth:`step` (``slice_propose``): draw the
        uniform, advance ``it`` and return the chord position t (B,) of every
        lane's probe, 0 where a lane is not ``active``."""
        phase = self.phase
        if u is None:
            u = uniform_from_hash(_fmix(_mix(h_rep, self.it))).to(self.dtype)
        self.it = torch.where(active, self.it + 1, self.it)
        is_ir = active & (phase == PH_INIT_R)
        is_il = active & (phase == PH_INIT_L)
        is_sr = active & (phase == PH_STEP_R)
        is_sl = active & (phase == PH_STEP_L)
        is_sh = active & (phase == PH_SHRINK)
        self.tL = torch.where(is_ir, -u * w, self.tL)
        self.tR = torch.where(is_ir, (1.0 - u) * w, self.tR)
        t = torch.where(is_ir, self.tR, 0.0)
        t = torch.where(is_il, self.tL, t)
        t = torch.where(is_sr, w * self.rstep.to(self.dtype), t)
        t = torch.where(is_sl, -w * self.lstep.to(self.dtype), t)
        return torch.where(is_sh, self.tL + u * (self.tR - self.tL), t)

    def decide(self, cfg, active, t, logL, bound):
        """The second half of :meth:`step` (``slice_decide``): the transition
        of every ``active`` lane after its probe at ``t`` scored ``logL``.
        Returns (acc, forced)."""
        logzero = self.logzero
        phase = self.phase
        is_ir = active & (phase == PH_INIT_R)
        is_il = active & (phase == PH_INIT_L)
        is_sr = active & (phase == PH_STEP_R)
        is_sl = active & (phase == PH_STEP_L)
        is_sh = active & (phase == PH_SHRINK)
        tL, tR = self.tL, self.tR
        inside = (logL >= bound) & (logL > logzero)
        self.cnt = self.cnt + (active & (logL > logzero)).to(torch.int64)

        self.need_r = torch.where(is_ir, inside, self.need_r)
        self.need_l = torch.where(is_il, inside, self.need_l)
        after_il = torch.where(
            self.need_r, PH_STEP_R, torch.where(self.need_l, PH_STEP_L, PH_SHRINK)
        )
        done_r = is_sr & (~inside | (self.rstep >= cfg.max_step))
        done_l = is_sl & (~inside | (self.lstep >= cfg.max_step))
        tR = torch.where(done_r, t, tR)
        tL = torch.where(done_l, t, tL)
        self.rstep = torch.where(is_sr & ~done_r, self.rstep + 1, self.rstep)
        self.lstep = torch.where(is_sl & ~done_l, self.lstep + 1, self.lstep)

        accept = is_sh & inside
        forced = is_sh & ~inside & (self.nshrink + 1 >= cfg.max_shrink)
        acc = accept | forced
        contract = is_sh & ~inside & ~forced
        self.tR = torch.where(contract & (t > 0.0), t, tR)
        self.tL = torch.where(contract & (t <= 0.0), t, tL)
        self.nshrink = torch.where(contract | forced, self.nshrink + 1, self.nshrink)

        phase = torch.where(is_ir, PH_INIT_L, phase)
        phase = torch.where(is_il, after_il, phase)
        phase = torch.where(done_r, torch.where(self.need_l, PH_STEP_L, PH_SHRINK), phase)
        self.phase = torch.where(done_l, PH_SHRINK, phase)
        return acc, forced

    def restart(self, mask) -> None:
        """Reset the repeat state of the lanes in ``mask`` (phase aside)."""
        self.it = torch.where(mask, 0, self.it)
        self.rstep = torch.where(mask, 1, self.rstep)
        self.lstep = torch.where(mask, 1, self.lstep)
        self.nshrink = torch.where(mask, 0, self.nshrink)
        self.cnt = torch.where(mask, 0, self.cnt)
        self.need_r = self.need_r & ~mask
        self.need_l = self.need_l & ~mask
        self.tL = torch.where(mask, 0.0, self.tL)
        self.tR = torch.where(mask, 0.0, self.tR)


#: micro-steps per while-loop body of the v2 and v3 kernels
BODY = 4


def v2_repeat_budget(cfg) -> int:
    """v2's micro-steps per repeat: bodies of 4 while the loop counter is
    below max_inner = 2 max_step + max_shrink + 4 (pallas_slice.py:213)."""
    max_inner = 2 * cfg.max_step + cfg.max_shrink + 4
    return -(-max_inner // BODY) * BODY


def slice_records_lockstep_plain(
    logL_fn,
    cfg,
    key_words,
    x0: torch.Tensor,      # (B, D) float32 seed cubes
    bound: torch.Tensor,   # (B,) float32
    valid: torch.Tensor,   # (B,) bool
    nhats: torch.Tensor,   # (B, R, D) float32
    ws: torch.Tensor,      # (B, R) float32
    count_steps: bool = False,
    lane0: int = 0,
):
    """v2's lockstep epoch in plain torch: per repeat, a while loop of
    4-micro-step bodies over all lanes until every lane has accepted or the
    loop counter reaches max_inner; the accepted probe is the baby's cube
    and seeds the next repeat.  A lane that never accepts keeps its x for
    the cube and the next repeat, with t = 0 and logL = logzero.

    Returns (t (B,R), logL (B,R)) float32, nlike (B,R) int32 and cube
    (B,R,D) float32.  With ``count_steps``, also the micro-steps of each
    (lane, repeat), (B,R) int32, and the micro-steps the loop ran in each
    repeat, (R,) int32 — the loop counter the instrumented v2 writes
    (``experiments/prof_lockstep_waste.py:123,144``): whole bodies until
    the slowest valid lane accepts, 0 when no lane is valid."""
    B, D = x0.shape
    R = nhats.shape[1]
    dev = x0.device
    logzero = torch.tensor(cfg.logzero, dtype=torch.float32).item()
    h_lane = lane_hash(key_words, B, dev, lane0)
    x = x0.to(torch.float32).clone()
    t_out = torch.zeros((B, R), dtype=torch.float32, device=dev)
    l_out = torch.full((B, R), logzero, dtype=torch.float32, device=dev)
    n_out = torch.zeros((B, R), dtype=torch.int32, device=dev)
    cube = torch.empty((B, R, D), dtype=torch.float32, device=dev)
    steps = torch.zeros((B, R), dtype=torch.int32, device=dev)
    iters = torch.zeros(R, dtype=torch.int32, device=dev)
    budget = v2_repeat_budget(cfg)
    for r in range(R):
        m = LaneMachine(B, dev, logzero)
        m.phase = torch.where(valid, PH_INIT_R, PH_DONE).to(torch.int64)
        h_rep = _mix(h_lane, r)
        acc_t = torch.zeros(B, dtype=torch.float32, device=dev)
        acc_l = torch.full((B,), logzero, dtype=torch.float32, device=dev)
        acc_x = x
        it = 0
        while it < budget and bool((m.phase != PH_DONE).any()):
            for _ in range(BODY):
                active = m.phase != PH_DONE
                t, probe, logL, acc, forced = m.step(
                    logL_fn, cfg, active, h_rep, ws[:, r], nhats[:, r], x, bound)
                acc_t = torch.where(acc, t, acc_t)
                acc_l = torch.where(acc, torch.where(forced, logzero, logL), acc_l)
                acc_x = torch.where(acc[:, None], probe, acc_x)
                m.phase = torch.where(acc, PH_DONE, m.phase)
                it += 1
        t_out[:, r], l_out[:, r] = acc_t, acc_l
        n_out[:, r] = m.cnt.to(torch.int32)
        cube[:, r] = x = acc_x
        steps[:, r] = m.it.to(torch.int32)
        iters[r] = it
    if count_steps:
        return t_out, l_out, n_out, cube, steps, iters
    return t_out, l_out, n_out, cube


#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"slice_epoch_v2": 0, "slice_epoch_v2_counted": 0}
#: slice_epoch_v2's launches by (bucket, G) since the last reset (the keys of
#: ``pallas_slice_v4.GROUP_LAUNCHES``), apart from B1's
GROUP_LAUNCHES = {(b, g): 0 for b, gs in ((32, (1, 2, 4, 8, 16, 32)), (128, (32,)),
                                           ("stream", (32,))) for g in gs}


def slice_epoch_v2(calc, cfg, key_words, x0, bound, valid, nhats, ws, group=None, lane0=0):
    """Run the slice repeats of every lane with v2's budget and cube:
    (t, logL) float32, nlike int32, each (B, R), and cube (B, R, D)
    float32, with the inputs of ``pallas_slice_v4.slice_epoch``.  CPU
    tensors: the plain version; CUDA tensors: the kernel, which needs
    ``calc.device_spec``, with ``group`` lanes per chain (one of the
    bucket's ``pallas_slice_v4.BUCKET_GROUPS``; ``pallas_slice_v4.
    choose_group`` by default, as for B1).  Every G gives the same result
    bit for bit.  ``lane0`` is the first lane's index in the whole batch
    (a shard's; ``lane_hash``)."""
    if group is not None and group not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"group {group} is not one of (1, 2, 4, 8, 16, 32)")
    if x0.device.type == "cpu":
        return slice_records_lockstep_plain(
            lambda p: calc(p)[2], cfg, key_words, x0, bound, valid, nhats, ws, lane0=lane0
        )
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    # pallas_slice_v4 imports this module
    from .pallas_slice_v4 import launch_group, launch_slice_kernel

    B, R, D = nhats.shape
    key = launch_group(B, D, x0.device, group)
    cube = torch.empty((R, D, B), dtype=torch.float32, device=x0.device)
    t, logL, nlike = launch_slice_kernel(
        _lib(), "slice_epoch_v2_launch", calc, cfg, key_words, x0, bound, valid, nhats, ws,
        cap=v2_repeat_budget(cfg), extra=(cube,), ints=(key[1],), lane0=lane0,
    )
    LAUNCHES["slice_epoch_v2"] += 1
    GROUP_LAUNCHES[key] += 1
    return t, logL, nlike, cube.permute(2, 0, 1)


def _lib():
    return nvcc.load("slice_epoch_v2", ["slice_epoch_v2.cu"])


def slice_epoch_v2_counted(calc, cfg, key_words, x0, bound, valid, nhats, ws):
    """B5 with its micro-steps counted (the port of the instrumented v2,
    ``experiments/prof_lockstep_waste.py::build_instrumented``): (t, logL,
    nlike, cube) as :func:`slice_epoch_v2` gives them, ``steps (B, R)``
    int32 the micro-steps of each (lane, repeat) and ``iters (R,)`` int32
    the micro-steps v2's lockstep loop runs in each repeat.  CPU tensors:
    the plain version's counts; CUDA tensors: the counted kernel."""
    if x0.device.type == "cpu":
        return slice_records_lockstep_plain(
            lambda p: calc(p)[2], cfg, key_words, x0, bound, valid, nhats, ws,
            count_steps=True,
        )
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    from .pallas_slice_v4 import launch_slice_kernel  # it imports this module

    B, R, D = nhats.shape
    cube = torch.empty((R, D, B), dtype=torch.float32, device=x0.device)
    steps = torch.empty((R, B), dtype=torch.int32, device=x0.device)
    iters = torch.zeros(R, dtype=torch.int32, device=x0.device)
    t, logL, nlike = launch_slice_kernel(
        _lib(), "slice_epoch_v2_counted_launch",
        calc, cfg, key_words, x0, bound, valid, nhats, ws,
        cap=v2_repeat_budget(cfg), extra=(cube, steps, iters),
    )
    LAUNCHES["slice_epoch_v2_counted"] += 1
    return t, logL, nlike, cube.permute(2, 0, 1), steps.t(), iters
