"""What the ``lane0`` argument costs B1: its epoch at the bench geometry
(B = 8192, R = 100, D = 20, the inputs of ``bench_geometry.slice_inputs``),
timed on the card, with the package found first on ``sys.path``.  Run it
once with a checkout of the tree and once with a checkout of its parent
(whose kernel has no ``lane0``), in turns in one call on the same card:

    PYTHONPATH=<checkout> python \
        <checkout of the tree>/polychordlite_tpu_torch/experiments/b1_lane0_cost.py

It prints one JSON line: the package's path, the card, the mean ms of B1's
epoch at lane0 = 0 over ``reps`` (20) launches after a warm-up, and, where the
kernel takes it, at lane0 = B (a second shard's), with the decisions at the
two lane0 counted apart (they differ: the uniforms moved) and, from the
plain version (the kernel's decisions bit for bit), the micro-steps of all
chains and of the slowest chain at each lane0: the epoch lasts as long as
its slowest chain.
"""

from __future__ import annotations

import inspect
import json


def main(B=8192, R=100, D=20, reps=20, seed=0):
    # absolute imports: the package is the one first on the path, the parent's or the tree's
    import polychordlite_tpu_torch
    from polychordlite_tpu_torch.experiments.bench_geometry import (
        device_label,
        device_ms,
        slice_inputs,
        study_device,
    )
    from polychordlite_tpu_torch.ops.pallas_slice_v4 import slice_epoch
    from polychordlite_tpu_torch.ops.slice_kernel import slice_records_plain

    dev = study_device(None)
    calc, cfg, kw, args = slice_inputs(dev, B, R, D, seed)
    rec = {"study": "b1_lane0_cost", "package": polychordlite_tpu_torch.__path__[0],
           "device": device_label(dev), "B": B, "R": R, "D": D, "reps": reps,
           "ms_lane0_0": device_ms(lambda: slice_epoch(calc, cfg, kw, *args), reps, dev)}
    if "lane0" in inspect.signature(slice_epoch).parameters:
        rec["ms_lane0_B"] = device_ms(lambda: slice_epoch(calc, cfg, kw, *args, lane0=B),
                                      reps, dev)
        t0, _, n0 = slice_epoch(calc, cfg, kw, *args)
        t1, _, n1 = slice_epoch(calc, cfg, kw, *args, lane0=B)
        rec["lanes_whose_records_moved"] = int(((t0 != t1) | (n0 != n1)).any(1).sum())
        for lane0 in (0, B):
            steps = slice_records_plain(lambda p: calc(p)[2], cfg, kw, *args, count_steps=True,
                                        lane0=lane0)[3]
            rec[f"steps_lane0_{lane0}"] = {"all": int(steps.sum()), "slowest": int(steps.max())}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
