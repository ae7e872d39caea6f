"""Lane-batched Gram-Schmidt: the Haar bases of the slice directions
(counterpart of ``polychordlite_tpu/ops/pallas_dirs.py``).

:func:`gram_schmidt_lanes` takes the JAX package's layout — a batch of
``(dim, dim)`` Gaussian matrices stored ``(n_bases, dim, dim, B)`` with the
chain axis minor — and returns their CGS2-orthonormalised columns in the
same layout.  On a CUDA tensor it launches the hand-written kernels of
``csrc/gram_schmidt.cu`` (see the source): up to dim :data:`NARROW_MAXD`,
one thread per basis with the finished columns in shared memory; up to
:data:`WIDE_MAXD`, one warp per basis with the dot products reduced across
its lanes; above, up to :data:`MAXD`, the same warp per basis with
ceil(dim / 32) rows a lane, the working column and as many finished columns
as fit in shared memory and the others in a scratch buffer in device memory
that this wrapper allocates (all of them in shared memory up to dim 240 in
float32 and 169 in float64; past that the card's free memory bounds dim
before :data:`MAXD` does, and the time grows as dim cubed).  On a CPU tensor it runs
:func:`gram_schmidt_plain`, the same sweeps in plain torch with each
kernel's order of summation.  Float32, as in the reference, and float64 for
a run at ``precision='highest'`` (every kernel instantiated in double, entry
``gram_schmidt_f64``; their launches counted apart, under the names with
``_f64``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc

#: kernel launches since the last reset (compare-with-plain launches
#: included): the thread-per-basis kernel, the warp-per-basis kernel above
#: dim 32 and its run-time-rows form above dim 128, in float32 and in float64
LAUNCHES = {"gram_schmidt": 0, "gram_schmidt_wide": 0, "gram_schmidt_long": 0,
            "gram_schmidt_f64": 0, "gram_schmidt_wide_f64": 0, "gram_schmidt_long_f64": 0}
#: the entry of each dtype
_ENTRIES = {torch.float32: "gram_schmidt_f32", torch.float64: "gram_schmidt_f64"}
#: the largest dim of the thread-per-basis kernel, of the wide kernel's
#: four rows a lane, and of all (GS_MAXD, GS_MAXD_WIDE and GS_MAXD_LONG of
#: ``csrc/gram_schmidt.cu``, whose ``gram_schmidt_max_dim()`` the library
#: is checked against when it loads: the long kernel's working column fills
#: a block's ``nvcc.SMEM_MAX`` bytes of shared memory in float64).  Past dim
#: 240 in float32 and 169 in float64 the scratch buffer, NB B (dim - k) dim
#: values for the k columns shared memory keeps, bounds dim first: 21 GB at
#: dim 2,048 for 5 bases of 256 chains in float32; the wrapper raises before
#: it allocates more than the card has free
NARROW_MAXD, WIDE_MAXD, MAXD = 32, 128, nvcc.SMEM_MAX // 8
#: the lanes of a warp
_LANES = 32


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
    ``csrc/gram_schmidt.cu``'s warp-per-basis kernels: the column padded
    with zeros to ceil(dim / 32) * 32 rows and every dot product by
    :func:`_warp_dot` (the wide kernel pads to 4 * 32 rows up to dim 128,
    the long kernel skips the rows past dim: a zero row adds +0 to a partial
    sum that is never -0, so it changes no sum, and any dim gives the
    kernels' bits)."""
    NB, dim, _, B = gauss_t.shape
    pad = -(-dim // _LANES) * _LANES
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
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.gram_schmidt_max_dim.argtypes = []
        lib.gram_schmidt_max_dim.restype = ctypes.c_int
        lib.gram_schmidt_scratch_values.argtypes = [ctypes.c_int] * 4
        lib.gram_schmidt_scratch_values.restype = ctypes.c_longlong
        if lib.gram_schmidt_max_dim() != MAXD:
            raise RuntimeError(f"gram_schmidt.cu's largest dim {lib.gram_schmidt_max_dim()} is "
                               f"not pallas_dirs.MAXD = {MAXD}")
        lib._typed = True
    return lib


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
                f"B2's long kernel at dim {dim} keeps the columns past shared memory's in a "
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
