"""B2 above dim 128 on the CPU: the long path's plain order (blocked CGS2 in
panels of 32 columns, reorthogonalised), held against an order spelled out
by hand in numpy and against the JAX package's XLA ``_gram_schmidt``, and
the orders at dims <= 128 held to orders spelled out here.

The kernel itself (``csrc/gram_schmidt.cu::gram_schmidt_long_kernel``) is
held bit for bit to this plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``, whose plain checks run
it on the host's CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polychordlite_tpu.ops.directions import _gram_schmidt as jax_xla_gram_schmidt
from polychordlite_tpu_torch.ops import pallas_dirs, precision


def _lanes_dot(a, b):
    """A dot product over axis 0 in the warp order, spelled out: row i goes
    to lane i % 32, each lane adds its rows in order from 0, then lower
    half plus upper half at offsets 16, 8, 4, 2, 1."""
    lanes = np.zeros((32,) + a.shape[1:], a.dtype)
    for i in range(a.shape[0]):
        lanes[i % 32] = lanes[i % 32] + a[i] * b[i]
    off = 16
    while off:
        lanes = lanes[:off] + lanes[off:2 * off]
        off //= 2
    return lanes[0]


def _spelled_long(x):
    """The long path's order on (dim, dim, n) numpy matrices, one scalar sum
    at a time (vectorised over the n bases only)."""
    dim, _, n = x.shape
    zero = np.zeros(n, x.dtype)
    q = x.copy()
    for j0 in range(0, dim, 32):
        pe = min(32, dim - j0)
        v = q[:, j0:j0 + pe].copy()
        for _ in range(2 if j0 else 1):
            if j0:  # C = Q^T V over the rows in order, then V - Q C over k in order
                c = np.zeros((j0, pe, n), x.dtype)
                for k in range(j0):
                    for jj in range(pe):
                        s = zero
                        for i in range(dim):
                            s = s + q[i, k] * v[i, jj]
                        c[k, jj] = s
                for i in range(dim):
                    for jj in range(pe):
                        u = zero
                        for k in range(j0):
                            u = u + q[i, k] * c[k, jj]
                        v[i, jj] = v[i, jj] - u
            for jj in range(pe):  # the panel's columns one by one
                for _ in range(2 if jj else 0):
                    coef = [_lanes_dot(v[:, t], v[:, jj]) for t in range(jj)]
                    for i in range(dim):
                        u = zero
                        for t in range(jj):
                            u = u + v[i, t] * coef[t]
                        v[i, jj] = v[i, jj] - u
                den = np.maximum(np.sqrt(_lanes_dot(v[:, jj], v[:, jj])), x.dtype.type(1e-30))
                v[:, jj] = v[:, jj] / den
        q[:, j0:j0 + pe] = v
    return q


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_long_plain_order_is_spelled_out_on_one_panel(dtype):
    """At dim 40 (one full panel, then a panel of 8 columns against its 32
    finished ones: both passes of C = Q^T V and V - Q C, and the panel's own
    CGS2 with a first column) the long plain version bitwise the order
    spelled out by hand, in float32 and float64."""
    x = np.random.default_rng(11).standard_normal((40, 40, 3)).astype(dtype)
    got = pallas_dirs._long_plain_bases(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, _spelled_long(x))


def test_long_plain_column_pair_is_the_warp_order():
    """One column pair of 70 rows (the last lane group ragged): the panel's
    dot product, :func:`pallas_dirs._lane_dot`, bitwise the lane sums spelled
    out, and bitwise itself on the same columns padded with zero rows to 96
    (the +0 rows the wide kernel holds past dim)."""
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 70, 2)).astype(np.float32)
    got = pallas_dirs._lane_dot(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got, _lanes_dot(a, b))
    pa, pb = np.zeros((96, 2), np.float32), np.zeros((96, 2), np.float32)
    pa[:70], pb[:70] = a, b
    padded = pallas_dirs._lane_dot(torch.as_tensor(pa), torch.as_tensor(pb)).numpy()
    np.testing.assert_array_equal(got, padded)


@pytest.mark.parametrize("dim", [129, 200])
def test_plain_gram_schmidt_takes_the_long_order_above_128(dim):
    """Above dim 128 gram_schmidt_plain is the long order on every basis
    (nb, b), chunk by chunk on the CPU, and the wrapper runs it on a CPU
    tensor, counting no launch."""
    g = np.random.default_rng(dim).standard_normal((2, dim, dim, 3)).astype(np.float32)
    got = pallas_dirs.gram_schmidt_plain(torch.as_tensor(g)).numpy()
    x = torch.as_tensor(g.transpose(1, 2, 0, 3).reshape(dim, dim, 6).copy())
    want = pallas_dirs._long_plain_bases(x).numpy().reshape(dim, dim, 2, 3).transpose(2, 0, 1, 3)
    np.testing.assert_array_equal(got, want)
    before = dict(pallas_dirs.LAUNCHES)
    np.testing.assert_array_equal(pallas_dirs.gram_schmidt_lanes(torch.as_tensor(g)).numpy(), got)
    assert pallas_dirs.LAUNCHES == before


def test_long_plain_chunks_give_the_same_bits(monkeypatch):
    """The bases the CPU works on at a time change no bit."""
    g = torch.as_tensor(np.random.default_rng(5).standard_normal((1, 140, 140, 5))
                        .astype(np.float32))
    want = pallas_dirs.gram_schmidt_plain(g)
    monkeypatch.setattr(pallas_dirs, "_LONG_CHUNK", 2)
    assert torch.equal(pallas_dirs.gram_schmidt_plain(g), want)


def _orth_err(q):
    q = q.astype(np.float64)
    dim = q.shape[1]
    return np.abs(np.einsum("nikb,nijb->nkjb", q, q) - np.eye(dim)[None, :, :, None]).max()


@pytest.mark.parametrize("dim", [256, 300])
def test_long_plain_matches_xla_gram_schmidt(dim):
    """At dims 256 and 300 (past what a block's shared memory holds of a
    float32 basis) the plain version against the JAX package's XLA
    ``_gram_schmidt`` (blocked CGS2 in blocks of 5, its sums in another
    order) within 5e-5 — float32 sums of dim products in two orders, and
    the XLA order's own loss of orthogonality on an ill-conditioned basis,
    up to ~1e-5 — and QtQ = I to 1e-6."""
    g = np.random.default_rng(dim).standard_normal((1, dim, dim, 8)).astype(np.float32)
    want = np.asarray(jax_xla_gram_schmidt(jnp.asarray(g.transpose(0, 3, 1, 2))))
    got = pallas_dirs.gram_schmidt_plain(torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1), rtol=0, atol=5e-5)
    assert _orth_err(got) < 1e-6


@pytest.mark.parametrize("dim", [160, 256])
def test_long_plain_float64_matches_xla_gram_schmidt_x64(dim):
    """The same in float64 under ``jax.enable_x64`` at dims 160 and 256,
    within 1e-11 (float64 sums in two orders and the XLA order's loss of
    orthogonality, both ~1e-16 times the basis's condition), QtQ = I to
    1e-14."""
    g = np.random.default_rng(dim).standard_normal((1, dim, dim, 4))
    got = pallas_dirs.gram_schmidt_plain(torch.as_tensor(g)).numpy()
    assert got.dtype == np.float64
    with jax.enable_x64(True):
        want = np.asarray(jax_xla_gram_schmidt(jnp.asarray(g.transpose(0, 3, 1, 2))))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1), rtol=0, atol=1e-11)
    assert _orth_err(got) < 1e-14


def test_long_order_keeps_orthogonality_where_one_pass_loses_it():
    """The second pass of each panel: on a basis whose columns 32 .. 63 lie
    within 1e-4 of the span of the first 32, the long order keeps QtQ = I to
    1e-6, while both sweeps against Q followed by one panel step (the XLA
    path's order, spelled here with the same sums) loses it."""
    rng = np.random.default_rng(2)
    dim = 160
    g = rng.standard_normal((dim, dim, 1)).astype(np.float32)
    mix = rng.standard_normal((32, 32, 1)).astype(np.float32)
    g[:, 32:64] = np.einsum("ikn,kjn->ijn", g[:, :32], mix) + 1e-4 * g[:, 32:64]
    got = pallas_dirs._long_plain_bases(torch.as_tensor(g)).numpy()
    assert _orth_err(got.transpose(2, 0, 1)[..., None]) < 1e-6
    # one pass: the same sums, the panel step after both sweeps
    x = torch.as_tensor(g)
    q = x.clone()
    for j0 in range(0, dim, 32):
        v = q[:, j0:j0 + 32].clone()
        for _ in range(2 if j0 else 0):
            fin = q[:, :j0]
            c = torch.zeros((j0, 32, 1))
            for i in range(dim):
                c = c + fin[i, :, None] * v[i, None]
            u = torch.zeros_like(v)
            for k in range(j0):
                u = u + fin[:, k, None] * c[k, None]
            v = v - u
        pallas_dirs._long_plain_panel(v)
        q[:, j0:j0 + 32] = v
    assert _orth_err(q.numpy().transpose(2, 0, 1)[..., None]) > 1e-5


def test_sqrt_rn_is_the_rounded_root_on_the_cpu():
    """The plain version's square root on the CPU is numpy's, the rounded
    root, in both types, whatever the CPU's torch.sqrt rounds to."""
    for dtype in (np.float32, np.float64):
        x = (np.random.default_rng(1).random(100_000) * 300).astype(dtype)
        got = precision.sqrt_rn(torch.as_tensor(x))
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), np.sqrt(x))


# ---- dims <= 128: the narrow order, and the wide order spelled out


def _narrow_spelled(x, root=np.sqrt):
    """The thread-per-basis order on (dim, dim, n) numpy matrices (rows,
    columns, bases): every dot product summed over the rows in index order,
    one column at a time; v over max(root(|v|^2), 1e-30), numpy's root
    unless told."""
    dim = x.shape[0]
    q = np.empty_like(x)
    for j in range(dim):
        v = x[:, j].copy()
        for _ in range(2):
            for k in range(j):
                c = np.zeros_like(v[0])
                for i in range(dim):
                    c = c + q[i, k] * v[i]
                v = v - c * q[:, k]
        norm = np.zeros_like(v[0])
        for i in range(dim):
            norm = norm + v[i] * v[i]
        q[:, j] = v / np.maximum(root(norm), x.dtype.type(1e-30))
    return q


def _wide_spelled(x, root=np.sqrt):
    """The wide kernel's order (classical CGS2 column by column) on (dim,
    dim, n) numpy matrices: for column j two sweeps (none at j = 0), each
    taking every coefficient against the same v by the lane sums, then
    u = sum_k q_k c_k over k in order from +0 and v - u; then v over
    max(root(the lane sum of v^2), 1e-30), numpy's root unless told."""
    dim = x.shape[0]
    q = x.copy()
    for j in range(dim):
        v = q[:, j].copy()
        for _ in range(2 if j else 0):
            coef = _lanes_dot(q[:, :j], v[:, None])  # (j, n)
            u = np.zeros_like(v)
            for k in range(j):
                u = u + q[:, k] * coef[k]
            v = v - u
        q[:, j] = v / np.maximum(root(_lanes_dot(v, v)), x.dtype.type(1e-30))
    return q


@pytest.mark.parametrize("dim,dtype", [(20, np.float32), (64, np.float32), (128, np.float32),
                                       (40, np.float64), (40, np.float32), (65, np.float32),
                                       (97, np.float64)])
def test_orders_up_to_128_keep_their_bits(dim, dtype):
    """gram_schmidt_plain at dim 20 (one thread a basis) bitwise the narrow
    order, and at dims 40, 64, 65 (three rows a lane), 128 and in float64
    at 40 and 97 bitwise the wide kernel's classical CGS2, both spelled out
    in numpy on the rounded root."""
    g = np.random.default_rng(dim).standard_normal((2, dim, dim, 3)).astype(dtype)
    x = g.transpose(1, 2, 0, 3).reshape(dim, dim, 6)
    want = (_narrow_spelled if dim <= 32 else _wide_spelled)(x)
    got = pallas_dirs.gram_schmidt_plain(torch.as_tensor(g)).numpy()
    np.testing.assert_array_equal(got.transpose(1, 2, 0, 3).reshape(dim, dim, 6), want)
