"""Lane-batched Gram-Schmidt: the Haar bases of the slice directions
(counterpart of ``polychordlite_tpu/ops/pallas_dirs.py``).

:func:`gram_schmidt_lanes` takes the JAX package's layout — a batch of
``(dim, dim)`` Gaussian matrices stored ``(n_bases, dim, dim, B)`` with the
chain axis minor — and returns their CGS2-orthonormalised columns in the
same layout.  On a CUDA tensor it launches the hand-written kernel
``csrc/gram_schmidt.cu`` (one thread per basis, the finished columns in
shared memory; see the source); on a CPU tensor it runs
:func:`gram_schmidt_plain`, the same sweeps in plain torch.  Float32 only,
as in the reference.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import nvcc

#: kernel launches since the last reset (compare-with-plain launches included)
LAUNCHES = {"gram_schmidt": 0}


def gram_schmidt_plain(gauss_t: torch.Tensor) -> torch.Tensor:
    """CGS2 of the columns (axis 2) of ``(n_bases, dim, dim, B)`` matrices:
    for each column j, two sweeps of v -= (q_k . v) q_k over k < j, then
    q_j = v / max(|v|, 1e-30) (``pallas_dirs.py:60-69``).

    Every dot product is summed over the rows in index order, one rounded
    operation at a time, as the CUDA kernel does, so the two agree bit for
    bit on the card."""
    dim = gauss_t.shape[1]
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


def _lib():
    lib = nvcc.load("gram_schmidt", ["gram_schmidt.cu"])
    if not getattr(lib, "_typed", False):
        lib.gram_schmidt_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.gram_schmidt_f32.restype = ctypes.c_int
        lib.gram_schmidt_max_dim.argtypes = []
        lib.gram_schmidt_max_dim.restype = ctypes.c_int
        lib._typed = True
    return lib


def gram_schmidt_lanes(gauss_t: torch.Tensor) -> torch.Tensor:
    """CGS2-orthonormalise the columns of ``(n_bases, dim, dim, B)`` float32
    matrices (chain axis minor): the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if gauss_t.dim() != 4 or gauss_t.shape[1] != gauss_t.shape[2]:
        raise ValueError(f"expected (n_bases, dim, dim, B), got {tuple(gauss_t.shape)}")
    if gauss_t.dtype != torch.float32:
        raise TypeError(f"gram_schmidt_lanes is float32-only, got {gauss_t.dtype}")
    if gauss_t.device.type == "cpu":
        return gram_schmidt_plain(gauss_t)
    if gauss_t.device.type != "cuda":
        raise ValueError(f"unsupported device {gauss_t.device}")
    lib = _lib()
    NB, dim, _, B = gauss_t.shape
    if dim > lib.gram_schmidt_max_dim():
        raise ValueError(f"dim {dim} exceeds the kernel's maximum {lib.gram_schmidt_max_dim()}")
    g = gauss_t.contiguous()
    q = torch.empty_like(g)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        status = lib.gram_schmidt_f32(g.data_ptr(), q.data_ptr(), NB, dim, B, stream)
    nvcc.check(status, "gram_schmidt_f32")
    LAUNCHES["gram_schmidt"] += 1
    return q
