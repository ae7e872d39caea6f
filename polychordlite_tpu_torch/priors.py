"""Prior transforms in torch (counterpart of ``polychordlite_tpu/priors.py``).

A prior is a callable mapping a ``(B, D)`` hypercube tensor to a ``(B, D)``
physical tensor.  This module holds the two transforms the port supports so
far: the identity (the default prior of ``run()``) and ``UniformPrior``.
Each carries an ``affine`` descriptor ``(a, b)``, meaning
``theta = a + (b - a) * cube`` per coordinate, which the CUDA slice kernel
applies inside its likelihood functor (``ops/pallas_slice_v4.py``).  The
other transforms of the reference are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def identity_prior(cube: torch.Tensor) -> torch.Tensor:
    """theta = cube (the reference's default prior)."""
    return cube


identity_prior.affine = (0.0, 1.0)


class UniformPrior:
    """theta = a + (b - a) * cube (pypolychord ``UniformPrior``).

    ``a`` and ``b`` may be scalars or per-coordinate sequences; only the
    scalar form has an ``affine`` descriptor for the CUDA kernel.
    """

    def __init__(self, a, b):
        self.a = a
        self.b = b
        scalar = np.ndim(a) == 0 and np.ndim(b) == 0
        self.affine = (float(a), float(b)) if scalar else None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.affine is not None:
            return self.a + (self.b - self.a) * x
        a = torch.as_tensor(np.asarray(self.a, np.float64), dtype=x.dtype, device=x.device)
        b = torch.as_tensor(np.asarray(self.b, np.float64), dtype=x.dtype, device=x.device)
        return a + (b - a) * x
