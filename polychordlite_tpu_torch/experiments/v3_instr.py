"""E2: v3's grid steps on the card, with the body iterations of every step
counted (counterpart of ``experiments/v3_instr.py``).

:func:`slice_epoch_v3_instr` is the wrapper of the hand-written cooperative
CUDA kernel ``csrc/slice_epoch_v3_instr.cu``: one chain on G lanes of a
warp, as B4 holds it, a grid barrier per step, the shared state machine
kept across bodies.  It gives B4's (and B1's) t, logL and nlike bit for bit
and, per grid step, the number of 4-micro-step bodies v3's while loop runs;
``cheap=True`` is the instrumented kernel's skeleton (a body only advances
the repeat; no machine; one lane per chain).  For CPU tensors it runs the
plain version, ``ops/pallas_slice_v3.py::slice_records_window_plain`` with
``count_iters``; for CUDA tensors it launches the kernel or raises — also
when the blocks cannot all be resident at once, which the barrier needs
(:func:`co_resident`), and when a step would need more bodies than v3's
``cap_body`` (ROADMAP C9).  No run calls it: its study is
``prof_v3_iters``.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.pallas_slice_v3 import cap_body, slice_records_window_plain
from ..ops.pallas_slice_v4 import (
    GROUPS,
    _sm_count,
    choose_group,
    functor_args,
    launch_slice_kernel,
)
from ..utils import nvcc

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"slice_epoch_v3_instr": 0}

LIBRARY = ("slice_epoch_v3_instr", ["slice_epoch_v3_instr.cu"])


def slice_epoch_v3_instr(calc, cfg, key_words, x0, bound, valid, nhats, ws, cheap=False,
                         check=True, group=None):
    """(t, logL) float32 and nlike int32, each (B, R), and iters (R,) int32,
    the bodies each grid step ran, with the inputs of
    ``pallas_slice_v4.slice_epoch``.  On the card a chain holds ``group``
    lanes (one of ``pallas_slice_v4.GROUPS``; by default the G that B4
    takes at the same B and D); the skeleton runs at G = 1 only.
    ``check=False`` leaves out the wait for the kernel's overflow flag (for
    timing) and returns it as a fifth output, a (1,) int32 device tensor
    that must be 0."""
    groups = (1,) if cheap else GROUPS
    if group is not None and group not in groups:
        raise ValueError(f"group {group} is not one of {groups}")
    if x0.device.type == "cpu":
        out = slice_records_window_plain(lambda p: calc(p)[2], cfg, key_words, x0, bound,
                                         valid, nhats, ws, count_iters=True, cheap=cheap)
        return out if check else (*out, torch.zeros(1, dtype=torch.int32))
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    B, R, D = nhats.shape
    if cheap:
        G = 1
    else:
        G = choose_group(B, D, _sm_count(x0.device)) if group is None else group
    iters = torch.zeros(R, dtype=torch.int32, device=x0.device)
    overflow = torch.zeros(1, dtype=torch.int32, device=x0.device)
    entry = "slice_epoch_v3_cheap_launch" if cheap else "slice_epoch_v3_instr_launch"
    t, logL, nlike = launch_slice_kernel(
        nvcc.load(*LIBRARY), entry, calc, cfg, key_words, x0, bound, valid, nhats, ws,
        cap=cap_body(cfg), extra=(iters, overflow), ints=(G,),
    )
    LAUNCHES["slice_epoch_v3_instr"] += 1
    if not check:
        return t, logL, nlike, iters, overflow
    if int(overflow.item()):
        raise RuntimeError(
            "slice_epoch_v3_instr: a grid step would need more than cap_body bodies; "
            "v3 would write that repeat into a recycled ring slot (ROADMAP C9)"
        )
    return t, logL, nlike, iters


def resident_blocks(calc, D: int, dev: torch.device, group: int) -> int:
    """The one-warp blocks of E2's kernel at ``group`` lanes per chain for
    ``calc.device_spec``'s functor that one SM of ``dev`` keeps resident
    (CUDA's occupancy query, which the launch reads)."""
    fid, consts, prior_a, prior_s = functor_args(calc, D)
    fn = nvcc.load(*LIBRARY).slice_epoch_v3_instr_resident_blocks
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        blocks = fn(fid, consts.ctypes.data, prior_a.ctypes.data, prior_s.ctypes.data, D,
                    0.0, torch.cuda.current_stream(dev).cuda_stream, group)
    if blocks < 0:
        nvcc.check(-blocks, "slice_epoch_v3_instr_resident_blocks")
    return blocks


def co_resident(calc, B: int, D: int, dev: torch.device, group: int) -> bool:
    """Whether the B G / 32 one-warp blocks of E2 at ``group`` lanes per
    chain can all be resident on ``dev`` at once, as its barrier needs."""
    return -(-B * group // 32) <= resident_blocks(calc, D, dev, group) * _sm_count(dev)
