"""Chained device epochs with the live-set update on the device
(counterpart of ``polychordlite_tpu/ops/chained_epoch.py``).

One dispatch runs K epochs, the device itself evolving the live set:

    for k in 1..K:
        bound  = min(live_logL)                      # the rising contour
        seeds  = live_cube[randint(nlive, B)]        # uniform live picks
        babies = slice epoch(seeds, bound, cholesky)
        live   = top-nlive of live ∪ last babies     # = replace-min in order

This is exactly the synchronous algorithm, run on the device; the host
then replays the same decisions through the ordinary bookkeeping
(evidence recurrences, phantoms, posteriors, files) and checks its live
set against the device's final state (``core/nested_sampling.py``).

Replace-min over the babies in order keeps the live set equal to the
nlive largest of {initial live} ∪ {babies so far}, so the device update is
one ``torch.topk`` over the union.  Seeds and directions come from the
device generator; epoch k's murmur key words are ``fold_in(key, k)``.

A run of a :class:`~polychordlite_tpu_torch.models.graded.GradedLikelihood`
is never chained (``core/nested_sampling.py`` refuses a forced
``chain_epochs > 1`` for one, ROADMAP C1): the chain carries the live set
from epoch to epoch, and no slow intermediate.

The chain runs in the dtype of the live set it is given, which is the
run's: float64 at ``precision='highest'``, blob included.  (The JAX
package's blob is always float32, so its replay check compares a float64
run's live set in float32: reference fault C2, not copied.)
"""

from __future__ import annotations

import torch

from .pallas_slice import fold_in
from .slice_kernel import EpochConfig


def build_chained_fn(run_packed, cfg: EpochConfig, B_log: int, B_phys: int,
                     K: int, nlive: int, device, generator: torch.Generator):
    """Build ``fn(key, chol (D,D), live_cube (nlive,D), live_logL (nlive,))
    -> flat`` where ``flat`` = [K nursery records | K bounds | final
    live logL | final live cube], one tensor on the device of the live
    set's dtype (the run's: float32, or float64).

    ``run_packed(key, packed_in)`` is the runner's epoch on a packed input
    batch of ``B_phys`` lanes ([cube, bound, cholesky, valid] per lane); it
    returns the epoch records of the ``B_log`` logical lanes."""
    D = cfg.n_dims
    R = cfg.total_repeats
    rec_w = R * (2 * D + cfg.n_phi + 1)  # baby records: cube, theta, phi, logL

    def fn(key, chol, live_cube, live_logL):
        lc, ll = live_cube, live_logL
        chol_rows = chol.reshape(1, D * D).expand(B_phys, D * D)
        valid = (torch.arange(B_phys, device=device) < B_log).to(ll.dtype)
        packs, bounds = [], []
        for k in range(K):
            bound0 = ll.min()
            idx = torch.randint(0, nlive, (B_log,), generator=generator, device=device)
            seeds = lc[idx]
            if B_phys > B_log:
                seeds = torch.cat([seeds, seeds[:1].expand(B_phys - B_log, D)])
            packed_in = torch.cat(
                [seeds, bound0.expand(B_phys, 1), chol_rows, valid[:, None]], dim=1
            )
            cpacked = run_packed(fold_in(key, k), packed_in)
            last = cpacked[:, :rec_w].reshape(B_log, R, -1)[:, -1]
            all_logL = torch.cat([ll, last[:, -1]])
            all_cube = torch.cat([lc, last[:, :D]])
            ll, top_idx = torch.topk(all_logL, nlive)
            lc = all_cube[top_idx]
            packs.append(cpacked.reshape(-1))
            bounds.append(bound0.reshape(1))
        return torch.cat([*packs, *bounds, ll, lc.reshape(-1)])

    return fn
