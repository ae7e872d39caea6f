"""Lane-batched Gram-Schmidt: the Haar bases of the slice directions
(counterpart of ``polychordlite_tpu/ops/pallas_dirs.py``).

:func:`gram_schmidt_lanes` takes the JAX package's layout — a batch of
``(dim, dim)`` Gaussian matrices stored ``(n_bases, dim, dim, B)`` with the
chain axis minor — and returns their CGS2-orthonormalised columns in the
same layout.  On a CUDA tensor it launches the hand-written kernels of
``csrc/gram_schmidt.cu`` (see the source): up to dim :data:`NARROW_MAXD`,
one thread per basis with the finished columns in shared memory; up to
:data:`MAXD`, one warp per basis with the dot products reduced across its
lanes.  On a CPU tensor it runs :func:`gram_schmidt_plain`, the same sweeps
in plain torch with each kernel's order of summation.  Float32, as in the
reference, and float64 for a run at ``precision='highest'`` (both kernels
instantiated in double, entry ``gram_schmidt_f64``; their launches counted
apart, under the names with ``_f64``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc

#: kernel launches since the last reset (compare-with-plain launches
#: included): the thread-per-basis kernel, and the warp-per-basis kernel
#: above dim 32, in float32 and in float64
LAUNCHES = {"gram_schmidt": 0, "gram_schmidt_wide": 0, "gram_schmidt_f64": 0,
            "gram_schmidt_wide_f64": 0}
#: the entry of each dtype
_ENTRIES = {torch.float32: "gram_schmidt_f32", torch.float64: "gram_schmidt_f64"}
#: the largest dim of the thread-per-basis kernel, and of both
#: (GS_MAXD and GS_MAXD_WIDE of ``csrc/gram_schmidt.cu``)
NARROW_MAXD, MAXD = 32, 128
#: the lanes of a warp, and the rows each lane holds in the wide kernel
_LANES, _ROWS = 32, MAXD // 32


def gram_schmidt_plain(gauss_t: torch.Tensor) -> torch.Tensor:
    """CGS2 of the columns (axis 2) of ``(n_bases, dim, dim, B)`` matrices:
    for each column j, two sweeps of v -= (q_k . v) q_k over k < j, then
    q_j = v / max(|v|, 1e-30) (``pallas_dirs.py:60-69``).

    Up to dim :data:`NARROW_MAXD` every dot product is summed over the rows
    in index order, one rounded operation at a time, as the thread-per-basis
    kernel does; above it in the wide kernel's order
    (:func:`_gram_schmidt_wide_plain`).  So the kernels and their plain
    version agree bit for bit on the card."""
    dim = gauss_t.shape[1]
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
        den = torch.clamp_min(torch.sqrt(norm), 1e-30)
        for i in range(dim):
            q[:, i, j] = v[i] / den
    return q


def _warp_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The wide kernel's dot product of columns held as ``(NB, M * 32, B)``
    (row i = lane + 32 m; M = 4 in the kernel): each lane's M rows in order,
    then the butterfly over the lanes, lower half plus upper half at offsets
    16, 8, 4, 2, 1."""
    nb, rows, B = a.shape
    m_rows = rows // _LANES
    a4, b4 = a.view(nb, m_rows, _LANES, B), b.view(nb, m_rows, _LANES, B)
    c = torch.zeros((nb, _LANES, B), dtype=a.dtype, device=a.device)
    for m in range(m_rows):
        c = c + a4[:, m] * b4[:, m]
    off = _LANES // 2
    while off:
        c = c[:, :off] + c[:, off:2 * off]
        off //= 2
    return c[:, 0]


def _gram_schmidt_wide_plain(gauss_t: torch.Tensor) -> torch.Tensor:
    """:func:`gram_schmidt_plain` above dim 32, in the order of
    ``csrc/gram_schmidt.cu::gram_schmidt_wide_kernel``: the column padded
    with zeros to 4 * 32 rows and every dot product by :func:`_warp_dot`.
    Above dim 128, where no kernel exists, the same order with as many rows
    a lane as the dim needs (a zero row adds +0 to a partial sum that is
    never -0, so it changes no sum: the plain engine has no bound on D)."""
    NB, dim, _, B = gauss_t.shape
    pad = max(_ROWS, -(-dim // _LANES)) * _LANES
    g = torch.zeros((NB, pad, dim, B), dtype=gauss_t.dtype, device=gauss_t.device)
    g[:, :dim] = gauss_t
    q = torch.zeros_like(g)
    for j in range(dim):
        v = g[:, :, j]
        for _ in range(2):
            for k in range(j):
                qk = q[:, :, k]
                v = v - _warp_dot(qk, v)[:, None] * qk
        den = torch.clamp_min(torch.sqrt(_warp_dot(v, v)), 1e-30)
        q[:, :, j] = v / den[:, None]
    return q[:, :dim].contiguous()


def _lib():
    lib = nvcc.load("gram_schmidt", ["gram_schmidt.cu"])
    if not getattr(lib, "_typed", False):
        for entry in _ENTRIES.values():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.gram_schmidt_max_dim.argtypes = []
        lib.gram_schmidt_max_dim.restype = ctypes.c_int
        lib._typed = True
    return lib


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
    stream = torch.cuda.current_stream(g.device).cuda_stream
    entry = _ENTRIES[g.dtype]
    with torch.cuda.device(g.device):
        status = getattr(lib, entry)(g.data_ptr(), q.data_ptr(), NB, dim, B, stream)
    nvcc.check(status, entry)
    name = "gram_schmidt" if dim <= NARROW_MAXD else "gram_schmidt_wide"
    LAUNCHES[name if g.dtype == torch.float32 else name + "_f64"] += 1
    return q
