"""E2's study: v3's body iterations and its barrier skeleton on the card
(counterpart of ``experiments/prof_v3_iters.py``).

At the bench geometry (B = 8192, D = 20, R = 100) it runs the cooperative
v3 kernel (``v3_instr.slice_epoch_v3_instr``) twice: real, and ``cheap``
(a body that only advances the repeat: R grid steps of one barrier each
and no machine).  For each: its time (CUDA events), the body iterations of
all steps, the micro-steps (4 per body), the counted likelihood calls and
the time per body.  B4 (``ops/pallas_slice_v3.py``) makes the same
decisions with no grid steps, so its time in the same call sets the real
kernel's price for its barriers.

    python -m polychordlite_tpu_torch.experiments.prof_v3_iters [--device cpu] [--B 8192] ...
"""

from __future__ import annotations

import json

from ..ops.pallas_slice_v3 import slice_epoch_v3
from .bench_geometry import (
    BENCH,
    argument_parser,
    device_label,
    device_ms,
    slice_inputs,
    study_device,
)
from .v3_instr import slice_epoch_v3_instr


def main(device=None, B=BENCH["B"], R=BENCH["R"], D=BENCH["D"], reps=5, seed=0):
    dev = study_device(device)
    calc, cfg, kw, args = slice_inputs(dev, B, R, D, seed)
    rec = {"study": "v3_iters", "device": device_label(dev), "B": B, "R": R, "D": D}
    for form, cheap in (("real", False), ("cheap", True)):
        _, _, nlike, iters = slice_epoch_v3_instr(calc, cfg, kw, *args, cheap=cheap)
        ms = device_ms(lambda: slice_epoch_v3_instr(calc, cfg, kw, *args,  # noqa: B023
                                                    cheap=cheap, check=False), reps, dev)
        bodies = int(iters.sum())
        rec[form] = {
            "ms": ms, "body_iters": bodies, "micro_steps": 4 * bodies,
            "iters_min": int(iters.min()), "iters_max": int(iters.max()),
            "evals": int(nlike.sum()),
            "us_per_body": None if ms is None else ms * 1e3 / bodies,
            "us_per_step": None if ms is None else ms * 1e3 / R,
        }
    b4_ms = device_ms(lambda: slice_epoch_v3(calc, cfg, kw, *args), reps, dev)
    rec["b4_ms"] = b4_ms
    rec["barrier_us_per_step"] = (
        None if b4_ms is None else (rec["real"]["ms"] - b4_ms) * 1e3 / R)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(**vars(argument_parser(__doc__, B=BENCH["B"], R=BENCH["R"], D=BENCH["D"],
                                reps=5, seed=0).parse_args()))
