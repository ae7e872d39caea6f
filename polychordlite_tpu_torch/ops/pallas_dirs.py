"""Lane-batched Gram-Schmidt: the Haar bases of the slice directions
(counterpart of ``polychordlite_tpu/ops/pallas_dirs.py``).

:func:`gram_schmidt_lanes` takes the JAX package's layout — a batch of
``(dim, dim)`` Gaussian matrices stored ``(n_bases, dim, dim, B)`` with the
chain axis minor — and returns their CGS2-orthonormalised columns in the
same layout.  On a CUDA tensor it launches the hand-written kernels of
``csrc/gram_schmidt.cu`` (see the source): up to dim :data:`NARROW_MAXD`,
one thread per basis with the finished columns in shared memory; up to
:data:`WIDE_MAXD`, one warp per basis, column by column, each sweep's
coefficients reduced across its lanes together, several chains' bases a
block in shared memory; above, up to :data:`MAXD`, the long path: blocked
CGS2 in panels of :data:`LONG_PANEL` columns, four warps a basis, the
bases transposed into a column-major scratch buffer in device memory that
this wrapper allocates and streamed through shared memory (the card's
free memory bounds dim before :data:`MAXD` does, and the time grows as dim
cubed).
On a CPU tensor it runs :func:`gram_schmidt_plain`, the same sweeps in
plain torch with each kernel's order of summation.  Float32, as in the
reference, and float64 for a run at ``precision='highest'`` (every kernel
instantiated in double, entry ``gram_schmidt_f64``; their launches counted
apart, under the names with ``_f64``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc
from .precision import sqrt_rn

#: kernel launches since the last reset (compare-with-plain launches
#: included): the thread-per-basis kernel, the wide kernel (a warp a basis)
#: above dim 32 and the long path above dim 128 (its transpose in, blocked CGS2
#: and transpose out counted as one launch), in float32 and in float64
LAUNCHES = {"gram_schmidt": 0, "gram_schmidt_wide": 0, "gram_schmidt_long": 0,
            "gram_schmidt_f64": 0, "gram_schmidt_wide_f64": 0, "gram_schmidt_long_f64": 0}
#: the entry of each dtype
_ENTRIES = {torch.float32: "gram_schmidt_f32", torch.float64: "gram_schmidt_f64"}
#: the largest dim of the thread-per-basis kernel, of the wide kernel (at
#: most four rows a lane), and of all (GS_MAXD, GS_MAXD_WIDE and GS_MAXD_LONG of
#: ``csrc/gram_schmidt.cu``, whose ``gram_schmidt_max_dim()`` the library
#: is checked against when it loads: ``nvcc.SMEM_MAX`` // 8).  The long
#: path's scratch buffer, NB B ld (dim + 32) values with ld = dim rounded up
#: to 32, bounds dim first: 22 GB at dim 2,048 for 5 bases of 256 chains in
#: float32; the wrapper raises before it allocates more than the card has
#: free
NARROW_MAXD, WIDE_MAXD, MAXD = 32, 128, nvcc.SMEM_MAX // 8
#: the columns of a panel of the long path (GSL_P of ``csrc/gram_schmidt.cu``)
LONG_PANEL = 32
#: the lanes of a warp
_LANES = 32
#: the bases a CPU call of the long plain version works on at a time, so that
#: its products stay in the processor's caches
_LONG_CHUNK = 256


def gram_schmidt_plain(gauss_t: torch.Tensor) -> torch.Tensor:
    """CGS2 of the columns (axis 2) of ``(n_bases, dim, dim, B)`` matrices:
    for each column j, two sweeps of v -= (q_k . v) q_k over k < j, then
    q_j = v / max(|v|, 1e-30) (``pallas_dirs.py:60-69``).

    Up to dim :data:`NARROW_MAXD` every dot product is summed over the rows
    in index order, one rounded operation at a time, as the thread-per-basis
    kernel does; up to :data:`WIDE_MAXD` in the wide kernel's order
    (:func:`_gram_schmidt_wide_plain`); above it in blocked CGS2, the long
    path's order (:func:`_gram_schmidt_long_plain`).  So the kernels and
    their plain version agree bit for bit on the card, and above
    :data:`WIDE_MAXD` on the CPU too."""
    dim = gauss_t.shape[1]
    if dim > WIDE_MAXD:
        return _gram_schmidt_long_plain(gauss_t)
    if dim > NARROW_MAXD:
        return _gram_schmidt_wide_plain(gauss_t)
    q = torch.empty_like(gauss_t)
    for j in range(dim):
        v = [gauss_t[:, i, j] for i in range(dim)]  # rows of column j, (NB, B) each
        for _ in range(2):
            for k in range(j):
                qk = [q[:, i, k] for i in range(dim)]
                c = torch.zeros_like(v[0])
                for i in range(dim):
                    c = c + qk[i] * v[i]
                v = [v[i] - c * qk[i] for i in range(dim)]
        norm = torch.zeros_like(v[0])
        for i in range(dim):
            norm = norm + v[i] * v[i]
        den = torch.clamp_min(sqrt_rn(norm), 1e-30)
        for i in range(dim):
            q[:, i, j] = v[i] / den
    return q


def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The warp kernels' dot product over axis 0 of ``(rows, ...)`` tensors
    (broadcast against each other): lane l sums its rows l + 32 m in order
    from +0, then the butterfly over the lanes, lower half plus upper half at
    offsets 16, 8, 4, 2, 1.  The rows past ``rows`` are the zeros the kernels
    skip: a sum that starts at +0 is never -0, so adding +0 changes none."""
    rows = a.shape[0]
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    c = torch.zeros((_LANES,) + shape, dtype=a.dtype, device=a.device)
    for m in range(0, rows, _LANES):
        n = min(_LANES, rows - m)
        c[:n] = c[:n] + a[m:m + n] * b[m:m + n]
    off = _LANES // 2
    while off:
        c = c[:off] + c[off:2 * off]
        off //= 2
    return c[0]


def _gram_schmidt_wide_plain(gauss_t: torch.Tensor) -> torch.Tensor:
    """:func:`gram_schmidt_plain` at dims 33 to 128, in the order of
    ``csrc/gram_schmidt.cu``'s wide kernel: classical CGS2 column by column
    on the whole basis, :func:`_long_plain_panel` (each sweep's coefficients
    from one v by :func:`_lane_dot`, the update summed over the finished
    columns in order), on the bases in chunks of :data:`_LONG_CHUNK` on the
    CPU."""
    return _by_bases(gauss_t, _wide_plain_bases)


def _wide_plain_bases(x: torch.Tensor) -> torch.Tensor:
    """The wide order on ``(dim, dim, n)`` matrices (rows, columns, bases)."""
    q = x.clone()
    _long_plain_panel(q)
    return q


def _gram_schmidt_long_plain(gauss_t: torch.Tensor) -> torch.Tensor:
    """:func:`gram_schmidt_plain` above dim :data:`WIDE_MAXD`, in the long
    path's order (``csrc/gram_schmidt.cu``): blocked CGS2 in panels of
    :data:`LONG_PANEL` columns (:func:`_long_plain_bases`), on the bases in
    chunks of :data:`_LONG_CHUNK` on the CPU."""
    return _by_bases(gauss_t, _long_plain_bases)


def _by_bases(gauss_t: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` on the ``(dim, dim, n)`` matrices (rows, columns, bases) of
    ``(n_bases, dim, dim, B)``, :data:`_LONG_CHUNK` bases at a time on the
    CPU, all at once on the card."""
    NB, dim, _, B = gauss_t.shape
    x = gauss_t.permute(1, 2, 0, 3).reshape(dim, dim, NB * B)  # [i][j][basis]
    step = _LONG_CHUNK if x.device.type == "cpu" else NB * B
    q = torch.cat([fn(x[:, :, s:s + step].contiguous()) for s in range(0, NB * B, step)], dim=2)
    return q.reshape(dim, dim, NB, B).permute(2, 0, 1, 3).contiguous()


def _long_plain_bases(x: torch.Tensor) -> torch.Tensor:
    """The long path on ``(dim, dim, n)`` matrices (rows, columns, bases):
    reorthogonalised block CGS2 (BCGS2) in panels of :data:`LONG_PANEL`
    columns.  A panel V against the finished columns Q (j0 of them) takes
    two passes (one where j0 = 0) of: C = Q^T V, each C[k][jj] summed over
    the rows in index order from +0, and V = V - Q C, each product summed
    over k in index order from +0; then :func:`_long_plain_panel`.  The
    second pass restores what the first pass's panel step loses to
    cancellation: a column that shrinks by a factor s there grows its
    remaining error along Q by 1 / s."""
    dim, _, n = x.shape
    q = x.clone()
    for j0 in range(0, dim, LONG_PANEL):
        v = q[:, j0:j0 + LONG_PANEL].clone()  # (dim, pe, n)
        pe = v.shape[1]
        fin = q[:, :j0]  # (dim, j0, n)
        prod = torch.empty((j0, pe, n), dtype=x.dtype, device=x.device)
        upd = torch.empty_like(v)
        for _ in range(2 if j0 else 1):
            if j0:
                c = torch.zeros_like(prod)
                for i in range(dim):
                    torch.mul(fin[i, :, None], v[i, None], out=prod)
                    c.add_(prod)
                u = torch.zeros_like(v)
                for k in range(j0):
                    torch.mul(fin[:, k, None], c[k, None], out=upd)
                    u.add_(upd)
                v = v - u
            _long_plain_panel(v)
        q[:, j0:j0 + pe] = v
    return q


def _long_plain_panel(v: torch.Tensor) -> None:
    """CGS2 of a panel's ``(dim, pe, n)`` columns in place, one by one: two
    sweeps against its earlier columns t (coefficients by :func:`_lane_dot`,
    the update summed over t in order from +0), the norm by
    :func:`_lane_dot`, v / max(sqrt(norm), 1e-30)."""
    for jj in range(v.shape[1]):
        col = v[:, jj]
        for _ in range(2 if jj else 0):
            coef = _lane_dot(v[:, :jj], col[:, None])  # (jj, n)
            u = torch.zeros_like(col)
            for t in range(jj):
                u = u + v[:, t] * coef[t]
            col = col - u
        den = torch.clamp_min(sqrt_rn(_lane_dot(col, col)), 1e-30)
        v[:, jj] = col / den


def _lib():
    lib = nvcc.load("gram_schmidt", ["gram_schmidt.cu"])
    if not getattr(lib, "_typed", False):
        for entry in _ENTRIES.values():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.gram_schmidt_max_dim.argtypes = []
        lib.gram_schmidt_max_dim.restype = ctypes.c_int
        lib.gram_schmidt_scratch_values.argtypes = [ctypes.c_int] * 4
        lib.gram_schmidt_scratch_values.restype = ctypes.c_longlong
        lib.gram_schmidt_long_resident_warps.argtypes = [ctypes.c_int] * 2
        lib.gram_schmidt_long_resident_warps.restype = ctypes.c_int
        lib.gram_schmidt_wide_blocks.argtypes = [ctypes.c_int] * 4
        lib.gram_schmidt_wide_blocks.restype = ctypes.c_int
        if lib.gram_schmidt_max_dim() != MAXD:
            raise RuntimeError(f"gram_schmidt.cu's largest dim {lib.gram_schmidt_max_dim()} is "
                               f"not pallas_dirs.MAXD = {MAXD}")
        lib._typed = True
    return lib


def wide_blocks(n_bases: int, dim: int, B: int, dtype=torch.float32):
    """(bases a block, blocks resident on an SM) of the wide kernel at a
    launch on ``(n_bases, dim, dim, B)`` in ``dtype`` on the current card
    (``csrc/gram_schmidt.cu::gsw_choose``); (0, 0) outside dims 33 to 128."""
    r = _lib().gram_schmidt_wide_blocks(n_bases, dim, B, 8 if dtype == torch.float64 else 4)
    nvcc.check(-r if r < 0 else 0, "gram_schmidt_wide_blocks")
    return divmod(r, 100)


def _kernel_name(dim: int) -> str:
    if dim <= NARROW_MAXD:
        return "gram_schmidt"
    return "gram_schmidt_wide" if dim <= WIDE_MAXD else "gram_schmidt_long"


def gram_schmidt_lanes(gauss_t: torch.Tensor) -> torch.Tensor:
    """CGS2-orthonormalise the columns of ``(n_bases, dim, dim, B)`` float32
    or float64 matrices (chain axis minor): the kernel of that dtype for a
    CUDA tensor, the plain version for a CPU tensor."""
    if gauss_t.dim() != 4 or gauss_t.shape[1] != gauss_t.shape[2]:
        raise ValueError(f"expected (n_bases, dim, dim, B), got {tuple(gauss_t.shape)}")
    if gauss_t.dtype not in _ENTRIES:
        raise TypeError(f"gram_schmidt_lanes takes float32 or float64, not {gauss_t.dtype}")
    if gauss_t.device.type == "cpu":
        return gram_schmidt_plain(gauss_t)
    if gauss_t.device.type != "cuda":
        raise ValueError(f"unsupported device {gauss_t.device}")
    NB, dim, _, B = gauss_t.shape
    if dim > MAXD:
        raise ValueError(f"dim {dim} exceeds the Gram-Schmidt kernels' maximum {MAXD}; "
                         "engine='torch' draws its directions with the plain version")
    lib = _lib()
    g = gauss_t.contiguous()
    q = torch.empty_like(g)
    n_scratch = lib.gram_schmidt_scratch_values(NB, dim, B, g.element_size())
    if n_scratch:
        need, (free, _) = n_scratch * g.element_size(), torch.cuda.mem_get_info(g.device)
        if need > free:
            raise ValueError(
                f"B2's long path at dim {dim} keeps its bases and their coefficients in a "
                f"scratch buffer of {n_scratch} values ({need / 2**30:.1f} GiB for {NB} x {B} "
                f"bases), more than the card's {free / 2**30:.1f} GiB free; run fewer chains "
                "(nlive) or engine='torch'")
    scratch = torch.empty(max(n_scratch, 1), dtype=g.dtype, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    entry = _ENTRIES[g.dtype]
    with torch.cuda.device(g.device):
        status = getattr(lib, entry)(g.data_ptr(), q.data_ptr(), scratch.data_ptr(), NB, dim, B,
                                     stream)
    nvcc.check(status, entry)
    name = _kernel_name(dim)
    LAUNCHES[name if g.dtype == torch.float32 else name + "_f64"] += 1
    return q
