"""Decomposed fast/slow likelihoods — the speed-grade payoff
(counterpart of ``polychordlite_tpu/models/graded.py``).

The reference's speed-grade machinery exists to *win* on hierarchical
(CosmoMC-style) likelihoods: it times real partial evaluations per grade
and apportions slice repeats accordingly
(``src/polychord/generate.F90:330-455``), and fast-grade slice directions
span only the fast-parameter subspace
(``src/polychord/chordal_sampling.f90:94-145``) so fast-parameter moves
re-evaluate only the cheap part.  In Fortran the caching is implicit (the
user's likelihood keeps its own slow-part state between calls); in a
sampler that evaluates whole batches of probes the decomposition must be
explicit:

    GradedLikelihood(slow_fn, fast_fn, n_slow)

* ``slow_fn(theta_slow) -> aux`` — the expensive intermediate, a function
  of the first ``n_slow`` physical parameters only (a tensor, or a dict,
  list or tuple of tensors);
* ``fast_fn(aux, theta) -> logL`` or ``(logL, derived)`` — the cheap
  completion given the cached intermediate and the FULL parameter vector.

Both are read as the port reads any likelihood (``ops/evaluate.py``):
written for one point (``theta (D,)``, as in the reference), or batched
(``theta (B, D)``, ``theta_slow (B, n_slow)``, every tensor of ``aux``
with the chain axis first).  Calling the object itself is the per-point
contract, ``fast_fn(slow_fn(theta[:n_slow]), theta)``.

The engine exploits the grade structure (``ops/slice_kernel.py``, engine
``"scan"``): along a fast-grade chord the slow parameters are constant, so
``aux`` is computed from the chains' positions only after a slow-grade
repeat moved them, and every fast-grade probe calls only ``fast_fn`` — the
slow cost drops from every probe to about one evaluation per slow repeat.
``time_speeds`` (``core/generate.py``) measures the real fast/slow cost
ratio to apportion per-grade repeats as the reference does.

Requirements (documented deviations from the single-callable API):

* the prior must be block-structured: ``prior(cube)[:n_slow]`` may depend
  only on ``cube[:n_slow]`` (true for every per-coordinate prior in
  ``priors.py``; the reference assumes the same for its grade blocks,
  ``priors.f90:671-749``);
* ``grade_dims[0]`` must equal ``n_slow``;
* graded runs use the ``"scan"`` engine, the only one that carries ``aux``
  from repeat to repeat: on the card, B1's traced route held at a barrier
  after every repeat (``csrc/slice_step.cu``), the likelihood evaluated in
  torch between its launches; the kernels that evaluate the likelihood
  inside themselves see a plain callable and have no place for a cache.
  The slice-slot shuffle is shared across the chain batch, so each repeat
  is grade-uniform.
"""

from __future__ import annotations

from typing import Callable


class GradedLikelihood:
    """Two-grade decomposed likelihood (see module docstring)."""

    def __init__(self, slow_fn: Callable, fast_fn: Callable, n_slow: int):
        if n_slow < 1:
            raise ValueError("n_slow must be >= 1")
        self.slow_fn = slow_fn
        self.fast_fn = fast_fn
        self.n_slow = int(n_slow)

    def __call__(self, theta):
        """Full evaluation of one point — the plain-likelihood contract used
        by generation, the maximiser and any non-graded code path."""
        return self.fast_fn(self.slow_fn(theta[: self.n_slow]), theta)
