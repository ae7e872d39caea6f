"""Run-precision selection (counterpart of ``polychordlite_tpu/ops/precision.py``).

The floating dtype of the evaluate/directions/slice-engine path is a
thread-local ``torch.dtype``, float32 by default, so a run on one thread
does not change the dtype seen by a run on another.  ``precision='highest'``
(float64 on every device path) is not ported yet: ``nested_sampling`` raises
``NotImplementedError`` for it.  A run raises when the best live point of
the generation phase has |logL| beyond ``F32_SAFE_LOGL``.
"""

from __future__ import annotations

import threading

import torch

# |logL| beyond which the f32 contour comparison starts losing shells
# (ulp(1e6) ~ 0.06: comparable to a tight contour's shell spacing)
F32_SAFE_LOGL = 1e6

_STATE = threading.local()


def set_real_dtype(dtype: torch.dtype) -> None:
    _STATE.dtype = dtype


def real_dtype() -> torch.dtype:
    """The floating dtype of the evaluate/directions/engine path
    (per-thread; default f32)."""
    return getattr(_STATE, "dtype", torch.float32)
