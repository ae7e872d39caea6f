"""Log-domain arithmetic kernel.

Backend-agnostic (works on numpy float64 host arrays and on any array module
with the same API): every function takes the array module as behaviour is
identical.

Semantics match the reference log-space kernel (PolyChordLite
``src/polychord/utils.F90:362-442``): values at or below ``LOG_ZERO`` represent
log(0) and must short-circuit rather than propagate -inf/nan.
"""

from __future__ import annotations

import numpy as np

#: The canonical "log of zero" sentinel (reference ``settings.f90:22`` default).
LOG_ZERO = -1e30


def logsumexp_small(a) -> float:
    """Scalar ``logsumexp`` over a small 1-D host array via ``math``.

    The administrator calls logsumexp once or twice per dead point on the
    per-cluster volume vector (1-8 entries), where the numpy version's call
    overhead dominates.  Same LOG_ZERO semantics."""
    import math

    vals = a.tolist() if hasattr(a, "tolist") else list(a)
    m = LOG_ZERO
    for v in vals:
        if v > m:
            m = v
    if m <= LOG_ZERO:
        return LOG_ZERO
    t = 0.0
    for v in vals:
        if v > LOG_ZERO:
            t += math.exp(v - m)
    return m + math.log(t)


def logsumexp(xp, a, axis=None, where=None):
    """log(sum(exp(a))) along ``axis``, safe against all-LOG_ZERO inputs.

    ``where`` optionally masks out entries (treated as log(0)).
    Reference: ``utils.F90:362-374``.
    """
    if where is not None:
        a = xp.where(where, a, LOG_ZERO)
    amax = xp.max(a, axis=axis, keepdims=True)
    # Guard: if everything is LOG_ZERO the result is LOG_ZERO, not nan.
    amax_safe = xp.where(amax > LOG_ZERO, amax, 0.0)
    # Clamp the sum away from 0 before the log: all-LOG_ZERO slices would
    # otherwise emit divide-by-zero warnings for a value the final `where`
    # discards anyway.
    total = xp.maximum(xp.sum(xp.exp(a - amax_safe), axis=axis), 1e-300)
    out = xp.log(total) + xp.squeeze(
        amax_safe, axis=axis if axis is not None else None
    )
    collapsed_max = xp.squeeze(amax, axis=axis if axis is not None else None)
    return xp.where(collapsed_max > LOG_ZERO, out, LOG_ZERO)


def logaddexp(xp, a, b):
    """log(exp(a) + exp(b)) elementwise. Reference: ``utils.F90:376-402``."""
    lo = xp.minimum(a, b)
    hi = xp.maximum(a, b)
    out = hi + xp.log1p(xp.exp(lo - hi))
    return xp.where(hi > LOG_ZERO, xp.where(lo > LOG_ZERO, out, hi), LOG_ZERO)


def logsubexp(xp, a, b):
    """log(exp(a) - exp(b)); requires a >= b. Reference: ``utils.F90:404-417``."""
    valid = (a > b) & (a > LOG_ZERO)
    diff = xp.where(valid, a + xp.log1p(-xp.exp(xp.minimum(b - a, 0.0))), LOG_ZERO)
    return xp.where(valid, diff, LOG_ZERO)


def logincexp(xp, accum, *terms):
    """Functional form of the reference's in-place ``logincexp``
    (``utils.F90:419-442``): returns log(exp(accum) + sum_i exp(term_i))."""
    out = accum
    for t in terms:
        out = logaddexp(xp, out, t)
    return out
