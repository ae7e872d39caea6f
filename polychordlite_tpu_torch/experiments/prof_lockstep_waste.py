"""E3's study: the lockstep waste of the v2 epoch on the card (counterpart
of ``experiments/prof_lockstep_waste.py``).

v2 runs every repeat as one while loop over the whole batch, in bodies of 4
micro-steps, until its slowest lane has accepted; a lane that has accepted
idles.  The counted B5 (``ops/pallas_slice.py::slice_epoch_v2_counted``)
writes the micro-steps of every (lane, repeat) and the micro-steps that
loop runs per repeat, ``iters``; so the batch issues B * sum(iters)
hardware probes, of which the counted likelihood calls are the useful
ones: their ratio is v2's lane efficiency, the headroom a design that lets
lanes run freely (v3, v4) recovers.  It prints what the JAX study prints
(:225-239).

``iters`` is already in micro-steps.  The JAX study multiplies it by 4
once more (:221; ROADMAP C11), which cuts its lane efficiency and raises
its probe rate fourfold; the record gives that formula's value beside the
right one, labelled C11.

    python -m polychordlite_tpu_torch.experiments.prof_lockstep_waste [--device cpu] [--B 8192] ...
"""

from __future__ import annotations

import json

import torch

from ..ops.pallas_slice import slice_epoch_v2_counted
from .bench_geometry import (
    BENCH,
    argument_parser,
    device_label,
    device_ms,
    slice_inputs,
    study_device,
)


def main(device=None, B=BENCH["B"], R=BENCH["R"], D=BENCH["D"], reps=5, seed=0):
    dev = study_device(device)
    calc, cfg, kw, args = slice_inputs(dev, B, R, D, seed)
    _, _, nlike, _, steps, iters = slice_epoch_v2_counted(calc, cfg, kw, *args)
    ms = device_ms(lambda: slice_epoch_v2_counted(calc, cfg, kw, *args), reps, dev)
    nl = nlike.to(torch.float64).cpu()
    it = iters.to(torch.int64).cpu()
    probes = B * int(it.sum())          # hardware probes: every lane, every micro-step
    counted = int(nl.sum())
    per_s = (lambda n: None) if ms is None else (lambda n: n / (ms / 1e3))
    rec = {
        "study": "lockstep_waste", "device": device_label(dev), "B": B, "R": R, "D": D,
        "ms": ms,
        "iters_per_repeat": {"mean": float(it.float().mean()), "min": int(it.min()),
                             "max": int(it.max()), "unit": "micro-steps"},
        "bodies_per_repeat_mean": float(it.float().mean()) / 4,
        "counted_evals_per_lane_repeat": {
            "mean": float(nl.mean()), "p50": float(torch.quantile(nl.flatten(), 0.5)),
            "p99": float(torch.quantile(nl.flatten(), 0.99)), "max": int(nl.max())},
        "hardware_probes": probes, "counted_evals": counted,
        "lane_steps": int(steps.to(torch.int64).sum()),
        "lane_efficiency": counted / probes if probes else float("nan"),
        "step_efficiency": int(steps.to(torch.int64).sum()) / probes if probes else float("nan"),
        "hardware_probes_per_s": per_s(probes), "counted_evals_per_s": per_s(counted),
        "C11_jax_formula": {  # prof_lockstep_waste.py:221: iters taken for bodies
            "lane_efficiency": counted / (4 * probes) if probes else float("nan"),
            "hardware_probes_per_s": per_s(4 * probes)},
        "repeats": [{"repeat": r, "iters": int(it[r]), "bodies": int(it[r]) // 4,
                     "mean_nlike": float(nl[:, r].mean()), "max_nlike": int(nl[:, r].max())}
                    for r in range(0, R, 25)],
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(**vars(argument_parser(__doc__, B=BENCH["B"], R=BENCH["R"], D=BENCH["D"],
                                reps=5, seed=0).parse_args()))
