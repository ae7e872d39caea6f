"""The speculative slice-epoch kernel (counterpart of
``polychordlite_tpu/ops/pallas_slice_v5.py``).

:func:`slice_epoch_v5` is the wrapper of the hand-written CUDA kernel
``csrc/slice_epoch_v5.cu``: each chain plans a packet of P = 4 probe
positions before any likelihood result (INIT ``[tR, tL, +w, -w]``, the
stepping-out ladders ``±w (step + j)``, the shrink chain under "all
rejected"), evaluates the four, and consumes them in order up to the first
one that diverts its state machine (``csrc/packet_machine.cuh``).  A chain
holds G = 4 Gs lanes of a warp, one sub-group of Gs lanes per packet slot
(G = 1: one thread evaluates the four in turn); :func:`choose_packet_group`
picks G from the card's SMs and the warps each G's kernel keeps resident.
Above D = 32 (the wide bucket to 128, the stream bucket above, to B1's
shared-memory bound) a chain holds a whole warp, G = 32, which evaluates
the four slots in turn (``csrc/packet_epoch.cuh``).  A model without a
device functor whose likelihood ``ops/fused_like.py`` lowers runs the same
kernel with the lowered functor (``csrc/slice_epoch_fused.cu`` built with
``FUSED_V5``, route ``slice_epoch_v5_fused``; its plain version
:func:`slice_records_packet_plain` on ``Lowered.plain_logL``).  For CPU
tensors it runs :func:`slice_records_packet_plain`, the same packet
machine in plain torch vectorised over lanes, at any D; for CUDA tensors
it launches the kernel or raises.

Both are decision-exact with the v4 engines (``ops/pallas_slice_v4.py``,
``ops/slice_kernel.py::slice_records_plain``): the uniform of slot j is
drawn at ``it + j`` with ``it`` the probes the repeat has consumed, and the
accepted position is the evaluated probe, so t, logL and nlike are bitwise
those of v4.  The epoch's budget is v4's, counted in consumed probes
(``EpochConfig.step_cap``), so a budget may end a lane inside a packet; the
JAX v5 kernel counts macro-steps instead (``pallas_slice_v5.py:115``).
The epoch record is assembled as for v4 (``assemble_epoch``).
"""

from __future__ import annotations

import ctypes

import torch

from .pallas_slice import (
    PH_DONE,
    PH_INIT_R,
    PH_SHRINK,
    PH_STEP_L,
    PH_STEP_R,
    _fmix,
    _mix,
    uniform_from_hash,
)
from ..utils import nvcc
from .pallas_slice_v4 import (
    SLICE_MAXD,
    SLICE_MAXD_WIDE,
    STREAM,
    TARGET_WARPS_PER_SM,
    WARP,
    _sm_count,
    bucket,
    forced_lowering,
    functor_args,
    functor_terms,
    fused_functor,
    launch_slice_kernel,
)
from .slice_kernel import EpochConfig

#: kernel launches since the last reset (compare-with-plain launches
#: included): the functor kernel, and the fused route's
LAUNCHES = {"slice_epoch_v5": 0, "slice_epoch_v5_fused": 0}

P = 4  # probes per packet (the INIT plan [tR, tL, +w, -w] needs 4)
#: the lanes a chain may be spread over in the SLICE_MAXD bucket (the
#: kernel's instantiations): one thread, or P sub-groups of 1, 2, 4 or 8
#: lanes
PACKET_GROUPS = (1, 4, 8, 16, 32)
#: the G instantiated in each bucket: above D = 32 a chain holds a warp
PACKET_BUCKET_GROUPS = {SLICE_MAXD: PACKET_GROUPS, SLICE_MAXD_WIDE: (WARP,), STREAM: (WARP,)}
#: slice_epoch_v5's launches (the functor kernel and the fused route) by
#: (bucket, G) since the last reset, keyed as ``pallas_slice_v4.GROUP_LAUNCHES``
GROUP_LAUNCHES = {(b, g): 0 for b, gs in PACKET_BUCKET_GROUPS.items() for g in gs}


def _lib():
    """B3's library of the SLICE_MAXD bucket (D <= 32, every G)."""
    return nvcc.load("slice_epoch_v5", ["slice_epoch_v5.cu"])


def _wide_lib():
    """B3's library of the wide and stream buckets (D > 32, G = 32):
    ``csrc/slice_epoch_v5.cu`` built with ``SLICE_EPOCH_V5_WIDE``
    (``nvcc.DEFINES``)."""
    return nvcc.load("slice_epoch_v5_wide", ["slice_epoch_v5.cu"])


def _lib_for(D: int):
    return _lib() if D <= SLICE_MAXD else _wide_lib()


def check_dims(D: int, n_terms: int = 1) -> None:
    """Raise above B3's bound on the dimension on the card: the stream
    bucket's, as B1's (``pallas_slice_v4.bucket``: a chain's (2 + n_terms)
    D floats in a block's shared memory), naming it and engine='torch'."""
    bucket(D, n_terms)


def packet_groups(D: int):
    """The G the kernel is instantiated at for dimension D."""
    return PACKET_BUCKET_GROUPS[bucket(D)]


def choose_packet_group(B: int, D: int, n_sm: int, resident_warps) -> int:
    """G = P Gs, the lanes of a warp that hold one chain.  Above D = 32 it
    is 32, a whole warp (the wide and stream buckets' one instantiation).
    Up to 32, Gs is the smallest
    power of two whose B P Gs / 32 warps reach ``TARGET_WARPS_PER_SM`` on
    each of the card's ``n_sm`` SMs, with Gs <= min(D, 8) (every lane of a
    sub-group owns a coordinate; four sub-groups fill at most a warp), and
    Gs doubles only while the doubled G's warps fit in one wave of
    ``resident_warps(G)``, the warps of the G kernel that an SM keeps
    resident (PERF.md, section 6: at the bench G = 8's 15.5 warps per SM
    overflow the 12 that its registers allow, and ran 1.2x slower than G = 4
    and G = 16)."""
    if D > SLICE_MAXD:
        return WARP
    gs_max = 1 << (min(D, WARP // P).bit_length() - 1)
    gs = 1
    while (gs < gs_max and B * P * gs < TARGET_WARPS_PER_SM * n_sm * WARP
           and B * P * 2 * gs <= resident_warps(P * 2 * gs) * n_sm * WARP):
        gs *= 2
    return P * gs


def resident_warps(calc, D: int, dev: torch.device, group: int) -> int:
    """The warps of the kernel at ``group`` lanes per chain for
    ``calc.device_spec``'s functor at dimension D (in its bucket) that one
    SM of ``dev`` keeps resident (CUDA's occupancy query; the kernel's
    registers decide, and in the stream bucket its shared memory)."""
    fid, consts, prior_a, prior_s = functor_args(calc, D)
    fn = _lib_for(D).slice_epoch_v5_resident_warps
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        warps = fn(fid, consts.ctypes.data, prior_a.ctypes.data, prior_s.ctypes.data, D,
                   0.0, torch.cuda.current_stream(dev).cuda_stream, group)
    if warps < 0:
        nvcc.check(-warps, "slice_epoch_v5_resident_warps")
    return warps


def fused_resident_warps(low, dev: torch.device, group: int) -> int:
    """:func:`resident_warps` of the fused route's kernel of the lowering
    ``low`` (its library at ``group``, built at first use)."""
    fn = low.library(group, "cuda5").slice_epoch_fused_v5_resident_warps
    fn.argtypes, fn.restype = [], ctypes.c_int
    with torch.cuda.device(dev):
        warps = fn()
    if warps < 0:
        nvcc.check(-warps, "slice_epoch_fused_v5_resident_warps")
    return warps


def packet_group_for(calc, B: int, D: int, dev: torch.device) -> int:
    """The G that :func:`slice_epoch_v5` picks on ``dev`` for B chains of D
    coordinates of ``calc``: by the resident warps of its functor's kernel,
    or, for a model without one, of the fused route's kernel of its
    lowering (the libraries of every G of the bucket built first, one nvcc
    each, all started together)."""
    if D > SLICE_MAXD:
        return WARP
    if getattr(calc, "device_spec", None) is not None:
        return choose_packet_group(B, D, _sm_count(dev),
                                   lambda G: resident_warps(calc, D, dev, G))
    low = forced_lowering(calc, "cuda5")
    low.build(PACKET_GROUPS, "cuda5")
    return choose_packet_group(B, D, _sm_count(dev),
                               lambda G: fused_resident_warps(low, dev, G))


def _ladder(t, ins, step, max_step):
    """First-stop scan of a stepping-out packet: (any_stop, t_stop,
    consumed, consumption position of each slot or -1)."""
    go = torch.ones_like(ins[0])
    any_stop = torch.zeros_like(go)
    t_stop = torch.zeros_like(t[0])
    cons = torch.zeros_like(step)
    pos = []
    for j in range(P):
        use = go
        stop = ~ins[j] | (step + j >= max_step)
        hit = use & stop
        t_stop = torch.where(hit, t[j], t_stop)
        cons = cons + use.to(cons.dtype)
        pos.append(torch.where(use, j, -1))
        any_stop = any_stop | hit
        go = use & ~stop
    return any_stop, t_stop, cons, pos


def slice_records_packet_plain(
    logL_fn,
    cfg: EpochConfig,
    key_words,
    x0: torch.Tensor,      # (B, D) float32 seed cubes
    bound: torch.Tensor,   # (B,) float32
    valid: torch.Tensor,   # (B,) bool
    nhats: torch.Tensor,   # (B, R, D) float32
    ws: torch.Tensor,      # (B, R) float32
    lane0: int = 0,
):
    """The packet machine of ``csrc/slice_epoch_v5.cu`` in plain torch.

    ``logL_fn(probe (n, D)) -> logL (n,)`` float32.  Returns (t (B,R),
    logL (B,R)) float32 and nlike (B,R) int32, as
    ``slice_kernel.slice_records_plain`` does."""
    B, D = x0.shape
    R = nhats.shape[1]
    dev = x0.device
    f32 = torch.float32
    logzero = torch.tensor(cfg.logzero, dtype=f32).item()
    k0, k1 = key_words
    lanes = torch.arange(B, device=dev)
    h_lane = _mix(_mix(torch.full((B,), k0, dtype=torch.int64, device=dev), k1), lanes + lane0)

    def i64(v):
        return torch.full((B,), v, dtype=torch.int64, device=dev)

    rep = torch.where(valid, 0, R).to(torch.int64)
    phase = torch.where(valid, PH_INIT_R, PH_DONE).to(torch.int64)
    it, rstep, lstep, nshrink, cnt, steps = i64(0), i64(1), i64(1), i64(0), i64(0), i64(0)
    need_l = torch.zeros(B, dtype=torch.bool, device=dev)
    tL = torch.zeros(B, dtype=f32, device=dev)
    tR = torch.zeros_like(tL)
    x = x0.to(f32).clone()
    t_out = torch.zeros((B, R), dtype=f32, device=dev)
    l_out = torch.full((B, R), logzero, dtype=f32, device=dev)
    n_out = torch.zeros((B, R), dtype=torch.int32, device=dev)
    cap = cfg.step_cap
    neg1 = i64(-1)

    while bool((phase != PH_DONE).any()):
        active = phase != PH_DONE
        r_idx = rep.clamp(max=R - 1)
        nhat = nhats[lanes, r_idx]
        w = ws[lanes, r_idx]
        h_rep = _mix(h_lane, rep)
        u = [uniform_from_hash(_fmix(_mix(h_rep, it + j))).to(f32) for j in range(P)]
        is_init = active & (phase == PH_INIT_R)
        is_sr = active & (phase == PH_STEP_R)
        is_sl = active & (phase == PH_STEP_L)
        is_sh = active & (phase == PH_SHRINK)

        # ---- plan the packet
        tR0 = (1.0 - u[0]) * w
        tL0 = -u[0] * w
        t_init = [tR0, tL0, w, -w]
        l_sp, r_sp = tL, tR
        t = []
        for j in range(P):
            t_sh = l_sp + u[j] * (r_sp - l_sp)
            pos_side = t_sh > 0.0
            r_sp = torch.where(pos_side, t_sh, r_sp)
            l_sp = torch.where(pos_side, l_sp, t_sh)
            tj = torch.where(is_init, t_init[j], 0.0)
            tj = torch.where(is_sr, w * (rstep + j).to(f32), tj)
            tj = torch.where(is_sl, -w * (lstep + j).to(f32), tj)
            tj = torch.where(is_sh, t_sh, tj)
            t.append(tj)

        # ---- evaluate it
        probes = [x + tj[:, None] * nhat for tj in t]
        logL = logL_fn(torch.cat(probes)).reshape(P, B)
        ins = [(logL[j] >= bound) & (logL[j] > logzero) for j in range(P)]

        # ---- resolve it in order
        # INIT: slots 0, 1 always; 2 iff in_r; 3 iff in_l and STEP_R
        # stopped at slot 2 or never started
        in_r, in_l = ins[0], ins[1]
        if cfg.max_step <= 1:
            stop2 = stop3 = torch.ones_like(in_r)
        else:
            stop2, stop3 = ~ins[2], ~ins[3]
        s2 = in_r
        s3 = in_l & (~in_r | stop2)
        to_sr = s2 & ~stop2
        to_sl = s3 & ~stop3
        init_cons = 2 + s2.to(torch.int64) + s3.to(torch.int64)
        init_pos = [i64(0), i64(1), torch.where(s2, 2, neg1),
                    torch.where(s3, 2 + s2.to(torch.int64), neg1)]
        init_tR = torch.where(s2 & stop2, t[2], tR0)
        init_tL = torch.where(s3 & stop3, t[3], tL0)
        init_phase = torch.where(
            to_sr, PH_STEP_R, torch.where(to_sl, PH_STEP_L, PH_SHRINK)
        )
        sr_stop, sr_t, sr_cons, sr_pos = _ladder(t, ins, rstep, cfg.max_step)
        sl_stop, sl_t, sl_cons, sl_pos = _ladder(t, ins, lstep, cfg.max_step)
        # SHRINK: the first accept or forced accept wins
        go = torch.ones_like(in_r)
        sh_acc = torch.zeros_like(in_r)
        t_acc = torch.zeros_like(tL)
        l_acc = torch.full_like(tL, logzero)
        x_acc = x
        sh_cons = i64(0)
        sh_pos = []
        for j in range(P):
            use = go
            forced = ~ins[j] & (nshrink + (j + 1) >= cfg.max_shrink)
            event = ins[j] | forced
            hit = use & event
            t_acc = torch.where(hit, t[j], t_acc)
            l_acc = torch.where(hit, torch.where(forced, logzero, logL[j]), l_acc)
            x_acc = torch.where(hit[:, None], probes[j], x_acc)
            sh_cons = sh_cons + use.to(torch.int64)
            sh_pos.append(torch.where(use, j, -1))
            sh_acc = sh_acc | hit
            go = use & ~event

        def by_phase(a_init, a_sr, a_sl, a_sh, other):
            v = torch.where(is_init, a_init, other)
            v = torch.where(is_sr, a_sr, v)
            v = torch.where(is_sl, a_sl, v)
            return torch.where(is_sh, a_sh, v)

        cons = by_phase(init_cons, sr_cons, sl_cons, sh_cons, i64(0))
        pos = [by_phase(init_pos[j], sr_pos[j], sl_pos[j], sh_pos[j], neg1) for j in range(P)]

        # ---- count, and stop at the epoch's budget
        rem = cap - steps
        counted = i64(0)
        counted_in_budget = i64(0)
        for j in range(P):
            c = (pos[j] >= 0) & (logL[j] > logzero)
            counted = counted + c.to(torch.int64)
            counted_in_budget = counted_in_budget + (c & (pos[j] < rem)).to(torch.int64)
        trunc = active & (cons > rem)
        go_on = active & ~trunc
        acc = go_on & is_sh & sh_acc
        cnt = torch.where(trunc, cnt + counted_in_budget,
                          torch.where(go_on, cnt + counted, cnt))
        steps = torch.where(trunc, cap, torch.where(go_on, steps + cons, steps))
        capped = active & ~acc & (steps >= cap)
        rec = acc | capped
        rows, cols = lanes[rec], rep[rec]
        t_out[rows, cols] = torch.where(acc, t_acc, 0.0)[rec]
        l_out[rows, cols] = torch.where(acc, l_acc, logzero)[rec]
        n_out[rows, cols] = cnt[rec].to(torch.int32)
        x = torch.where(acc[:, None], x_acc, x)

        # ---- commit the state of the lanes that go on
        st_i, st_r = go_on & is_init, go_on & is_sr
        st_l, st_s = go_on & is_sl, go_on & is_sh
        tR = torch.where(st_i, init_tR, tR)
        tL = torch.where(st_i, init_tL, tL)
        tR = torch.where(st_r & sr_stop, sr_t, tR)
        tL = torch.where(st_l & sl_stop, sl_t, tL)
        tR = torch.where(st_s & ~sh_acc, r_sp, tR)
        tL = torch.where(st_s & ~sh_acc, l_sp, tL)
        need_l = torch.where(st_i, in_l, need_l)
        rstep = torch.where(st_i & to_sr, 2, rstep)
        lstep = torch.where(st_i & to_sl, 2, lstep)
        rstep = torch.where(st_r & ~sr_stop, rstep + P, rstep)
        lstep = torch.where(st_l & ~sl_stop, lstep + P, lstep)
        lstep = torch.where(st_r & sr_stop & need_l, 1, lstep)
        nshrink = torch.where(st_s, nshrink + sh_cons, nshrink)
        phase = torch.where(st_i, init_phase, phase)
        phase = torch.where(
            st_r & sr_stop, torch.where(need_l, PH_STEP_L, PH_SHRINK), phase
        )
        phase = torch.where(st_l & sl_stop, PH_SHRINK, phase)
        it = torch.where(go_on, it + cons, it)

        rep = torch.where(acc, rep + 1, rep)
        phase = torch.where(acc, torch.where(rep >= R, PH_DONE, PH_INIT_R), phase)
        phase = torch.where(capped | (acc & (steps >= cap)), PH_DONE, phase)
        it = torch.where(acc, 0, it)
        rstep = torch.where(acc, 1, rstep)
        lstep = torch.where(acc, 1, lstep)
        nshrink = torch.where(acc, 0, nshrink)
        cnt = torch.where(acc, 0, cnt)
        need_l = need_l & ~acc
        tL = torch.where(acc, 0.0, tL)
        tR = torch.where(acc, 0.0, tR)
    return t_out, l_out, n_out


def slice_epoch_v5(calc, cfg: EpochConfig, key_words, x0, bound, valid, nhats, ws,
                   group=None, lane0=0):
    """Run the slice repeats of every lane in packets: (t, logL) float32
    and nlike int32, each (B, R), with the inputs of
    ``pallas_slice_v4.slice_epoch``.  CPU tensors: the plain version, at
    any D; CUDA tensors: the kernel, with ``calc.device_spec``'s functor or,
    for a model without one, the likelihood lowered into it
    (``ops/fused_like.py``; a model the lowering refuses raises, naming the
    reason and engine='cuda'), with ``group`` lanes per chain (one of the
    bucket's :data:`PACKET_BUCKET_GROUPS`; :func:`packet_group_for` by
    default).  Every G gives the same result bit for bit.  On the card D is
    bounded by the stream bucket's shared memory, as for B1.  ``lane0``:
    ``pallas_slice.lane_hash``."""
    if group is not None and group not in PACKET_GROUPS:
        raise ValueError(f"group {group} is not one of {PACKET_GROUPS}")
    if x0.device.type == "cpu":
        return slice_records_packet_plain(
            lambda p: calc(p)[2], cfg, key_words, x0, bound, valid, nhats, ws, lane0=lane0
        )
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    B, R, D = nhats.shape
    spec = getattr(calc, "device_spec", None)
    low = forced_lowering(calc, "cuda5") if spec is None else None
    check_dims(D, functor_terms(spec["likelihood"]["name"]) if low is None else low.n_terms)
    G = packet_group_for(calc, B, D, x0.device) if group is None else group
    if G not in packet_groups(D):
        raise ValueError(f"group {G} is not one of {packet_groups(D)} at D={D}")
    if low is None:
        out = launch_slice_kernel(_lib_for(D), "slice_epoch_v5_launch", calc, cfg, key_words,
                                  x0, bound, valid, nhats, ws, ints=(G,), lane0=lane0)
        LAUNCHES["slice_epoch_v5"] += 1
    else:
        out = launch_slice_kernel(low.library(G, "cuda5"), "slice_epoch_fused_v5_launch", calc,
                                  cfg, key_words, x0, bound, valid, nhats, ws,
                                  functor=fused_functor(low, G, x0.device), lane0=lane0)
        LAUNCHES["slice_epoch_v5_fused"] += 1
    GROUP_LAUNCHES[bucket(D), G] += 1
    return out
