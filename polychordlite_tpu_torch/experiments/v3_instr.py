"""E2: v3's grid steps on the card, with the body iterations of every step
counted (counterpart of ``experiments/v3_instr.py``).

:func:`slice_epoch_v3_instr` is the wrapper of the hand-written cooperative
CUDA kernel ``csrc/slice_epoch_v3_instr.cu``: one thread per chain, a grid
barrier per step, the shared state machine kept across bodies.  It gives B4's
(and B1's) t, logL and nlike bit for bit and, per grid step, the number of
4-micro-step bodies v3's while loop runs; ``cheap=True`` is the instrumented
kernel's skeleton (a body only advances the repeat; no machine).  For CPU
tensors it runs the plain version, ``ops/pallas_slice_v3.py::
slice_records_window_plain`` with ``count_iters``; for CUDA tensors it
launches the kernel or raises — also when the blocks cannot all be resident
at once, which the barrier needs, and when a step would need more bodies
than v3's ``cap_body`` (ROADMAP C9).  No run calls it: its study is
``prof_v3_iters``.
"""

from __future__ import annotations

import torch

from ..ops.pallas_slice_v3 import cap_body, slice_records_window_plain
from ..ops.pallas_slice_v4 import launch_slice_kernel
from ..utils import nvcc

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"slice_epoch_v3_instr": 0}

LIBRARY = ("slice_epoch_v3_instr", ["slice_epoch_v3_instr.cu"])


def slice_epoch_v3_instr(calc, cfg, key_words, x0, bound, valid, nhats, ws, cheap=False,
                         check=True):
    """(t, logL) float32 and nlike int32, each (B, R), and iters (R,) int32,
    the bodies each grid step ran, with the inputs of
    ``pallas_slice_v4.slice_epoch``.  ``check=False`` leaves out the
    wait for the kernel's overflow flag (for timing) and returns it as a
    fifth output, a (1,) int32 device tensor that must be 0."""
    if x0.device.type == "cpu":
        out = slice_records_window_plain(lambda p: calc(p)[2], cfg, key_words, x0, bound,
                                         valid, nhats, ws, count_iters=True, cheap=cheap)
        return out if check else (*out, torch.zeros(1, dtype=torch.int32))
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    R = nhats.shape[1]
    iters = torch.zeros(R, dtype=torch.int32, device=x0.device)
    overflow = torch.zeros(1, dtype=torch.int32, device=x0.device)
    entry = "slice_epoch_v3_cheap_launch" if cheap else "slice_epoch_v3_instr_launch"
    t, logL, nlike = launch_slice_kernel(
        nvcc.load(*LIBRARY), entry, calc, cfg, key_words, x0, bound, valid, nhats, ws,
        cap=cap_body(cfg), extra=(iters, overflow),
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
