"""Linear-algebra helpers for the sampler.

Mirrors the semantics of the reference numerics layer
(``src/polychord/utils.F90:621-711``) with batched formulations:
covariances via a single Gram matmul, Cholesky with the same
"fall back to sqrt(trace/D) * I when not positive definite" behaviour.
"""

from __future__ import annotations

import numpy as np


def calc_cholesky_np(covmat: np.ndarray) -> np.ndarray:
    """Lower Cholesky of ``covmat`` with degeneracy fallback.

    If the matrix is not positive-definite, returns sqrt(mean-diagonal) * I,
    matching reference ``utils.F90:621-649`` (which scales the identity by
    sqrt(trace/D)).
    """
    try:
        return np.linalg.cholesky(covmat)
    except np.linalg.LinAlgError:
        d = covmat.shape[0]
        scale = np.sqrt(max(np.trace(covmat) / d, 0.0))
        if scale <= 0.0:
            scale = 1.0
        return np.eye(d) * scale


def calc_covmat_np(points: np.ndarray) -> np.ndarray:
    """Population covariance of rows of ``points`` (n, D).

    Reference ``utils.F90:651-687`` / ``run_time_info.f90:601-641`` semantics:
    normalised by n (not n-1).
    """
    n = points.shape[0]
    if n == 0:
        return np.eye(points.shape[1])
    mean = points.mean(axis=0)
    centred = points - mean
    return centred.T @ centred / n


def similarity_matrix_np(points: np.ndarray) -> np.ndarray:
    """Pairwise squared distances via the Gram trick.

    d_ij = |v_i|^2 + |v_j|^2 - 2 v_i.v_j  (reference ``calculate.f90:94-109``).
    ``points`` is (n, D); returns (n, n).
    """
    sq = np.einsum("ij,ij->i", points, points)
    sim = sq[:, None] + sq[None, :] - 2.0 * points @ points.T
    np.fill_diagonal(sim, 0.0)
    return np.maximum(sim, 0.0)
