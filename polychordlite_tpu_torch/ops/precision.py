"""Run-precision selection (counterpart of ``polychordlite_tpu/ops/precision.py``).

The floating dtype of the evaluate/directions/slice-engine path is a
thread-local ``torch.dtype``, float32 by default, so a run on one thread
does not change the dtype seen by a run on another.  ``precision='highest'``
sets it to float64 for the run (``core/nested_sampling.py``, through
:func:`real_dtype_scope`, which restores the previous dtype on exit), as the
JAX package sets ``jax.enable_x64`` and its own thread-local dtype.

Unlike the JAX package, whose Mosaic kernels are float32-only and send a
float64 run to its XLA scan engine, the card has a float64 vector path: a
float64 run takes B1's fused route (``csrc/slice_epoch_fused.cu``) or its
traced route (``csrc/slice_step.cu``) and B2 (``csrc/gram_schmidt.cu``),
each instantiated in double; the plain engine (``engine="torch"``) runs in
float64 anywhere.  The device functors of ``csrc/likelihoods.cuh`` and the
forced kernels B3, B4, B5 stay float32 (``core/nested_sampling.py::
resolve_engine`` raises for the forced ones at float64).

The calc records :func:`real_dtype` when it is made (``calc.dtype``,
``ops/evaluate.py``), and that is the run's dtype from then on: every
function given a calc reads it through :func:`calc_dtype`, and every
function given only tensors (the plain versions, ``make_directions``)
computes in theirs.

A float32 run raises when the best live point of the generation phase has
|logL| beyond ``F32_SAFE_LOGL``; its message names ``precision='highest'``.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# |logL| beyond which the f32 contour comparison starts losing shells
# (ulp(1e6) ~ 0.06: comparable to a tight contour's shell spacing)
F32_SAFE_LOGL = 1e6

#: the dtype of each ``precision`` setting
PRECISIONS = {"single": torch.float32, "highest": torch.float64}

_STATE = threading.local()


def set_real_dtype(dtype: torch.dtype) -> None:
    _STATE.dtype = dtype


def real_dtype() -> torch.dtype:
    """The floating dtype of the evaluate/directions/engine path
    (per-thread; default f32)."""
    return getattr(_STATE, "dtype", torch.float32)


def calc_dtype(calc) -> torch.dtype:
    """The dtype ``calc`` computes in: float32, or float64 for a calc made
    at precision='highest'.  A likelihood function with no recorded dtype
    (a test's stand-in calc) computes in float32."""
    return getattr(calc, "dtype", torch.float32)


@contextlib.contextmanager
def real_dtype_scope(dtype: torch.dtype):
    """:func:`real_dtype` is ``dtype`` on this thread inside the block, and
    what it was before after it, however the block ends."""
    before = real_dtype()
    set_real_dtype(dtype)
    try:
        yield
    finally:
        set_real_dtype(before)
