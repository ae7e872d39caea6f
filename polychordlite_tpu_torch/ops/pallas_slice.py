"""murmur3 counter hash and per-epoch key words
(counterpart of the helpers in ``polychordlite_tpu/ops/pallas_slice.py``).

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
