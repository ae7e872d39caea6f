"""B1, B4, B5, B3 and the fused route in the kernel template's three
buckets, timed on the card with the package found first on ``sys.path``:
run it once with a checkout of a tree and once with a checkout of its
parent, in turns in one call on the same card (parent, tree, tree,
parent), to compare a change to the template with the parent's times:

    PYTHONPATH=<checkout> python \
        <checkout of the tree>/polychordlite_tpu_torch/experiments/bucket_times.py <tag>

At the bench geometry (B 8192, R 100, D 20) and gaussian.ini's shape (512,
40, 20) in the 32 bucket, the 128 bucket's (512, 128, 64) and the 64-D
run's (256, 128, 64), and the stream
bucket's (512, 320, 160), the 160-D run's (256, 800, 160) and (512, 1024,
512), the inputs of ``bench_geometry.slice_inputs`` (seed 1), at
``choose_group``'s G: each kernel's mean ms over 20 launches after a
warm-up (CUDA events; 5 at D = 512), B1 twice.  The fused route runs a
per-point torch Gaussian (sigma 0.1 at 0.5), also in float64 (``fused_f64``)
above D = 32; B3 (``slice_epoch_v5``) runs above D = 32.  Prints one JSON
line.
"""

from __future__ import annotations

import json
import math
import sys


def per_point_gaussian(theta):
    import torch

    D = theta.shape[-1]
    return (-0.5 * torch.sum(((theta - 0.5) / 0.1) ** 2)
            - D * (math.log(0.1) + 0.5 * math.log(2 * math.pi)))


def main(tag="tree", reps=20):
    # absolute imports: the package is the one first on the path, the parent's or the tree's
    import torch

    import polychordlite_tpu_torch
    from polychordlite_tpu_torch.experiments.bench_geometry import (
        device_label,
        device_ms,
        slice_inputs,
        study_device,
    )
    from polychordlite_tpu_torch.ops import fused_like, pallas_slice, pallas_slice_v3
    from polychordlite_tpu_torch.ops import pallas_slice_v4, pallas_slice_v5
    from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator
    from polychordlite_tpu_torch.ops.precision import real_dtype_scope
    from polychordlite_tpu_torch.priors import identity_prior

    dev = study_device(None)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"study": "bucket_times", "tree": tag, "package": polychordlite_tpu_torch.__path__[0],
           "device": device_label(dev)}
    for name, (B, R, D), only in (
            ("bench", (8192, 100, 20), None), ("gaussian_ini", (512, 40, 20), None),
            ("d64", (512, 128, 64), None), ("d64_run", (256, 128, 64), None),
            ("d160", (512, 320, 160), None),
            ("d160_run", (256, 800, 160), ("fused",)), ("d512", (512, 1024, 512), None)):
        calc, cfg, kw, args = slice_inputs(dev, B, R, D, seed=1)
        pp = make_batched_calculator(identity_prior, per_point_gaussian, D, 0, device=dev)
        low = fused_like.lowering(pp)
        G = pallas_slice_v4.choose_group(B, D, n_sm)
        low.build([G])
        kernels = {
            "B1": lambda: pallas_slice_v4.slice_epoch(calc, cfg, kw, *args),  # noqa: B023
            "B4": lambda: pallas_slice_v3.slice_epoch_v3(calc, cfg, kw, *args),  # noqa: B023
            "B5": lambda: pallas_slice.slice_epoch_v2(calc, cfg, kw, *args),  # noqa: B023
            "fused": lambda: pallas_slice_v4.slice_epoch_fused(pp, cfg, kw, *args),  # noqa: B023
        }
        if D > 32:
            with real_dtype_scope(torch.float64):
                p64 = make_batched_calculator(identity_prior, per_point_gaussian, D, 0,
                                              device=dev)
            kernels["fused_f64"] = (
                lambda: pallas_slice_v4.slice_epoch_fused(p64, cfg, kw, *args))  # noqa: B023
            kernels["B3"] = (
                lambda: pallas_slice_v5.slice_epoch_v5(calc, cfg, kw, *args))  # noqa: B023
        n = 5 if D > 256 else reps
        r = {"G": G, **{k: device_ms(fn, n, dev) for k, fn in kernels.items()
                        if only is None or k in only}}
        if only is None:
            r["B1_again"] = device_ms(kernels["B1"], n, dev)
        out[name] = r
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:2])
