"""E2's study: v3's body iterations and its barrier skeleton on the card
(counterpart of ``experiments/prof_v3_iters.py``).

At the bench geometry (B = 8192, D = 20, R = 100) it runs the cooperative
v3 kernel (``v3_instr.slice_epoch_v3_instr``) three times: real at G lanes
per chain (B4's G at this B and D unless ``group`` names one), real at
G = 1, and ``cheap`` (a body that only advances the repeat: R grid steps of
one barrier each and no machine; one lane per chain).  For each: its time
(CUDA events), the body iterations of all steps, the micro-steps (4 per
body), the counted likelihood calls and the time per body.  B4
(``ops/pallas_slice_v3.py``) makes the same decisions with no grid steps,
so its time at the same G in the same call sets the real kernel's price
for its steps: (E2(G) - B4(G)) / R per step, beside the same at G = 1.

    python -m polychordlite_tpu_torch.experiments.prof_v3_iters [--device cpu] [--group 8] ...
"""

from __future__ import annotations

import json

from ..ops.pallas_slice_v3 import slice_epoch_v3
from ..ops.pallas_slice_v4 import _sm_count, choose_group
from .bench_geometry import (
    BENCH,
    argument_parser,
    device_label,
    device_ms,
    slice_inputs,
    study_device,
)
from .v3_instr import slice_epoch_v3_instr


def main(device=None, B=BENCH["B"], R=BENCH["R"], D=BENCH["D"], reps=5, seed=0, group=None):
    dev = study_device(device)
    calc, cfg, kw, args = slice_inputs(dev, B, R, D, seed)
    if group is None and dev.type == "cuda":
        group = choose_group(B, D, _sm_count(dev))
    rec = {"study": "v3_iters", "device": device_label(dev), "B": B, "R": R, "D": D,
           "group": group}
    for form, cheap, G in (("real", False, group), ("real_g1", False, 1), ("cheap", True, 1)):
        _, _, nlike, iters = slice_epoch_v3_instr(calc, cfg, kw, *args, cheap=cheap, group=G)
        ms = device_ms(lambda: slice_epoch_v3_instr(  # noqa: B023
            calc, cfg, kw, *args, cheap=cheap, check=False, group=G), reps, dev)  # noqa: B023
        bodies = int(iters.sum())
        rec[form] = {
            "ms": ms, "body_iters": bodies, "micro_steps": 4 * bodies,
            "iters_min": int(iters.min()), "iters_max": int(iters.max()),
            "evals": int(nlike.sum()),
            "us_per_body": None if ms is None else ms * 1e3 / bodies,
            "us_per_step": None if ms is None else ms * 1e3 / R,
        }
    for key, G in (("b4_ms", group), ("b4_g1_ms", 1)):
        rec[key] = device_ms(lambda: slice_epoch_v3(calc, cfg, kw, *args, group=G),  # noqa: B023
                             reps, dev)
    for key, form, b4 in (("barrier_us_per_step", "real", "b4_ms"),
                          ("barrier_us_per_step_g1", "real_g1", "b4_g1_ms")):
        rec[key] = None if rec[b4] is None else (rec[form]["ms"] - rec[b4]) * 1e3 / R
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    parser = argument_parser(__doc__, B=BENCH["B"], R=BENCH["R"], D=BENCH["D"], reps=5, seed=0)
    parser.add_argument("--group", type=int, default=None, help="E2's and B4's lanes per chain")
    main(**vars(parser.parse_args()))
