"""The ring engine's study: its epoch against ``"cuda"`` and ``"scan"`` on the
same inputs (counterpart of ``experiments/prof_ring.py``).

For each chain batch B (8,192, 32,768 and 65,536 by default) it draws one
epoch of the 20-D Gaussian at R = 100 (``bench_geometry.slice_inputs``) and
runs, on the same inputs and directions:

* the ring: B1 under ``RingPolicy`` with the ring's budget R ``ring_factor``
  = 1,200 micro-steps a lane (``slice_epoch(..., ring_cap=)``), and, where
  a lane overflowed, the runner's re-run, B1 at its own budget;
* ``"cuda"``: B1 (``slice_epoch``);
* ``"scan"``: the lockstep engine (``slice_epoch_graded``, the traced route
  held at a barrier after every repeat).

Each is timed with CUDA events.  Also: whether the ring overflowed and how
many lanes did, the re-run's share of the ring's time, and the slowest
lane's micro-steps against the budget (B1's counted form,
``slice_epoch_counted``, the same decisions).  The ring's records are
checked against B1's where no lane overflowed, and the re-run's always.

    python -m polychordlite_tpu_torch.experiments.prof_ring [--device cpu] [--Bs 8192,32768]

On the CPU (``--device cpu``, small sizes such as ``--Bs 64 --R 4 --D 4``)
the plain versions run and every time is ``null``.
"""

from __future__ import annotations

import json

import torch

from ..ops.pallas_slice_v4 import slice_epoch, slice_epoch_counted, slice_epoch_graded
from .bench_geometry import BENCH, argument_parser, device_label, device_ms, slice_inputs, study_device

BATCHES = (8192, 32768, 65536)


def main(device=None, Bs=BATCHES, R=BENCH["R"], D=BENCH["D"], reps=3, seed=0, ring_factor=12):
    dev = study_device(device)
    Bs = tuple(int(b) for b in (Bs.split(",") if isinstance(Bs, str) else Bs))
    out = {"study": "prof_ring", "device": device_label(dev), "R": R, "D": D,
           "ring_factor": ring_factor, "by_B": {}}
    for B in Bs:
        calc, cfg, kw, args = slice_inputs(dev, B, R, D, seed)
        cfg = cfg._replace(ring_factor=ring_factor)
        budget = cfg.ring_budget
        speeds = torch.zeros((B, R), dtype=torch.int64, device=dev)
        *ring, flag = slice_epoch(calc, cfg, kw, *args, ring_cap=budget)
        want = slice_epoch(calc, cfg, kw, *args)
        overflowed = bool(flag.any())
        if not overflowed and not all(torch.equal(a, b) for a, b in zip(ring, want)):
            raise AssertionError(f"B = {B}: the ring's records differ from B1's without overflow")
        steps = slice_epoch_counted(calc, cfg, kw, *args)[3]
        ring_ms = device_ms(lambda: slice_epoch(calc, cfg, kw, *args,  # noqa: B023
                                                ring_cap=budget), reps, dev)  # noqa: B023
        cuda_ms = device_ms(lambda: slice_epoch(calc, cfg, kw, *args), reps, dev)  # noqa: B023
        scan_ms = device_ms(lambda: slice_epoch_graded(calc, cfg, kw, *args,  # noqa: B023
                                                       speeds), 1, dev)  # noqa: B023
        rerun_ms = cuda_ms if overflowed else 0.0  # the re-run is B1 at its own budget
        total = None if ring_ms is None else ring_ms + rerun_ms
        out["by_B"][str(B)] = {
            "B": B, "budget": budget, "overflow": overflowed,
            "lanes_overflowed": int(flag.sum()),
            "slowest_lane_steps": int(steps.max()), "mean_lane_steps": float(steps.float().mean()),
            "ring_ms": ring_ms, "rerun_ms": None if ring_ms is None else rerun_ms,
            "ring_total_ms": total,
            "rerun_share": None if not total else rerun_ms / total,
            "cuda_ms": cuda_ms, "scan_ms": scan_ms,
            "ring_over_cuda": None if total is None else total / cuda_ms,
            "evals": int(want[2].sum()),
        }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    parser = argument_parser(__doc__, R=BENCH["R"], D=BENCH["D"], reps=3, seed=0, ring_factor=12)
    parser.add_argument("--Bs", default=",".join(map(str, BATCHES)),
                        help="the chain batches, comma-separated")
    main(**vars(parser.parse_args()))
