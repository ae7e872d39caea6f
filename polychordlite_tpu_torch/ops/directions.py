"""Whitened chord directions for the slice engines
(counterpart of ``polychordlite_tpu/ops/directions.py``).

As in the reference (``chordal_sampling.f90:94-145``,
``random_utils.F90:381-437``):

* per speed grade g, directions span the subspace of dimensions
  [start(g), nDims), drawn as the columns of stacked Haar-random orthonormal
  bases (Gram-Schmidt of Gaussian matrices, ``ops/pallas_dirs.py``);
* the R = sum(num_repeats) slots are shuffled by ONE permutation shared by
  the whole batch, keeping slot 0 on the first slow-grade direction;
* each direction is whitened by the cluster Cholesky L, normalised, and
  the initial slice width is w = 3 |L n̂| (``chordal_sampling.f90:73-82``).

The bases come from the Gram-Schmidt kernels (``use_kernel``, every kernel
engine) or from their plain version (the plain engine, on any device and
at any dimension); the two agree bit for bit where a kernel exists, so the
choice changes no run.  The Gaussians and the permutation come from an
explicit ``torch.Generator`` on the run's device.  :func:`make_directions`
also takes them precomputed (``gauss``, ``perm``), which lets tests feed it
the JAX package's draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .pallas_dirs import gram_schmidt_lanes, gram_schmidt_plain


def shared_permutation(R: int, generator: torch.Generator, device) -> torch.Tensor:
    """Slot order shared by the batch: slot 0 stays first, slots 1..R-1 are
    shuffled (``directions.py:137-145``)."""
    head = torch.zeros(1, dtype=torch.int64, device=device)
    if R == 1:
        return head
    tail = torch.randperm(R - 1, generator=generator, device=device) + 1
    return torch.cat([head, tail])


def draw_gaussians(
    B: int,
    grade_dims: Sequence[int],
    num_repeats: Sequence[int],
    n_dims: int,
    generator: torch.Generator,
    device,
    dtype: torch.dtype = torch.float32,
) -> List[torch.Tensor]:
    """Per grade, (n_bases, sub, sub, B) standard normals of ``dtype``
    (chain axis minor)."""
    out = []
    for g, reps in enumerate(num_repeats):
        sub = n_dims - int(sum(grade_dims[:g]))
        n_bases = -(-reps // sub)
        out.append(torch.randn((n_bases, sub, sub, B), generator=generator,
                               device=device, dtype=dtype))
    return out


def draw_directions(
    B: int,
    grade_dims: Sequence[int],
    num_repeats: Sequence[int],
    n_dims: int,
    generator: torch.Generator,
    device,
    dtype: torch.dtype = torch.float32,
):
    """(gauss, perm): what :func:`make_directions` draws from ``generator``
    for a batch of B chains, in the same order."""
    gauss = draw_gaussians(B, grade_dims, num_repeats, n_dims, generator, device, dtype)
    return gauss, shared_permutation(int(sum(num_repeats)), generator, device)


def shard_draws(draws, lo: int, n: int, width: int, device):
    """A shard's part of :func:`draw_directions`'s draws for the whole
    batch: the Gaussians of chains lo..lo+n-1, padded to ``width`` chains
    with copies of chain lo (the shard's invalid lanes), on ``device``, and
    the shared permutation.  Gram-Schmidt works on each chain's bases alone,
    so the shard's directions are its chains' directions of the whole
    batch, bit for bit."""
    gauss, perm = draws
    out = []
    for g in gauss:
        cols = g[..., lo:lo + n]
        if width > n:
            cols = torch.cat([cols, cols[..., :1].expand(*cols.shape[:-1], width - n)], dim=-1)
        out.append(cols.to(device).contiguous())
    return out, perm.to(device)


def make_directions(
    cholesky: torch.Tensor,  # (B, D, D) per-chain cluster Cholesky
    *,
    grade_dims: Tuple[int, ...],
    num_repeats: Tuple[int, ...],
    n_dims: int,
    generator: Optional[torch.Generator] = None,
    gauss: Optional[List[torch.Tensor]] = None,
    perm: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
):
    """Whitened slice directions for a batch of chains.

    Returns (nhats (B,R,D) unit directions in cube space, w (B,R) initial
    widths, speeds (B,R) int64 grade of each slot).  ``gauss`` (per grade,
    ``(n_bases, sub, sub, B)``) and ``perm`` (R,) replace the draws from
    ``generator`` when given.  ``use_kernel`` (``directions.py:127-134``)
    orthonormalises through :func:`gram_schmidt_lanes`, the kernel on a
    CUDA tensor (up to ``pallas_dirs.MAXD``; above, it raises); ``False`` asks for
    :func:`gram_schmidt_plain` on any device, as the plain engine does.
    Everything is computed in the dtype of ``cholesky``: float32, or float64
    for a run at ``precision='highest'`` (the Gaussians drawn in float64, B2
    in double)."""
    B = cholesky.shape[0]
    device, dtype = cholesky.device, cholesky.dtype
    R = int(sum(num_repeats))
    if gauss is None:
        gauss = draw_gaussians(B, grade_dims, num_repeats, n_dims, generator, device, dtype)
    if perm is None:
        perm = shared_permutation(R, generator, device)

    blocks = []
    for g, reps in enumerate(num_repeats):
        start = int(sum(grade_dims[:g]))
        sub = n_dims - start
        # (NB, sub, sub, B), orthonormal columns
        qt = (gram_schmidt_lanes if use_kernel else gram_schmidt_plain)(gauss[g])
        n_bases = qt.shape[0]
        dirs = qt.permute(3, 0, 2, 1).reshape(B, n_bases * sub, sub)[:, :reps]
        full = torch.zeros((B, reps, n_dims), dtype=dtype, device=device)
        full[:, :, start:] = dirs
        blocks.append(full)
    nhats = torch.cat(blocks, dim=1)[:, perm]
    speeds_r = torch.cat([
        torch.full((reps,), g, dtype=torch.int64, device=device)
        for g, reps in enumerate(num_repeats)
    ])
    speeds = speeds_r[perm].expand(B, R)

    # Whiten: the chord direction in cube space is L n̂, and the initial
    # width is 3x its length.  Full precision: TF32 is switched off for this
    # product and the caller's setting restored after it.  (The JAX package
    # computes it at the TPU's default matmul precision, bf16 operands; the
    # port does not copy that.)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        whitened = torch.matmul(nhats, cholesky.transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    norms = torch.sqrt(torch.sum(whitened * whitened, dim=2))
    unit = whitened / torch.clamp_min(norms, torch.finfo(dtype).tiny)[:, :, None]
    return unit, 3.0 * norms, speeds
