"""Reference evidences of the analytic example inis from the JAX package.

    JAX_PLATFORMS=cpu python scripts/zoo_reference_logz.py [--seed N] [NAME ...]

Runs each shipped ``ini/<name>.ini`` of the analytic zoo through the JAX
package's sampler (``polychordlite_tpu.core.nested_sampling``) at its
shipped settings, with only ``base_dir`` (a temporary directory), a fixed
``seed`` and ``feedback = 0`` changed, and prints one JSON line per ini:
name, logZ, logZerr, ndead, wall seconds and the JAX backend.  The prior is
the ini's all-uniform block layout written as the traced affine map
``lo + (hi - lo) * cube``: the JAX ini driver's ``hypercube_to_physical``
closure is not traceable and sends every point through a host callback,
which takes hours at these settings on the CPU.  The PyTorch port's
``chip_smoke.py`` holds its own runs of the same inis to these values
(within 3 combined sigma).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = ("eggbox", "gaussian_shell", "half_gaussian", "himmelblau", "pyramidal",
       "random_gaussian", "rastrigin", "rosenbrock", "twin_gaussian")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(ZOO))
    ap.add_argument("--seed", type=int, default=20250101)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import jax
    import jax.numpy as jnp

    from polychordlite_tpu.core.nested_sampling import default_dumper, nested_sampling
    from polychordlite_tpu.models import get_likelihood
    from polychordlite_tpu.utils.inifile import read_ini

    for name in args.names:
        with open(os.path.join(HERE, "ini", f"{name}.ini")) as f:
            src = f.read()
        with tempfile.TemporaryDirectory() as base:
            src = src.replace("base_dir = chains", f"base_dir = {base}\nseed = {args.seed}")
            src = src.replace("feedback = 1", "feedback = 0")
            ini = os.path.join(base, f"{name}.ini")
            with open(ini, "w") as f:
                f.write(src)
            os.makedirs(os.path.join(base, "clusters"), exist_ok=True)
            settings, blocks, *_ = read_ini(ini)
            lo = [0.0] * settings.nDims
            hi = [0.0] * settings.nDims
            for b in blocks:  # uniform blocks: (a, b) per parameter, interleaved
                assert b.prior_type == "uniform", b
                for k, (i, j) in enumerate(zip(b.hypercube_indices, b.physical_indices)):
                    assert i == j
                    lo[j], hi[j] = b.parameters[2 * k], b.parameters[2 * k + 1]
            lo_j, hi_j = jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32)
            t0 = time.perf_counter()
            out = nested_sampling(get_likelihood(name, settings.nDims),
                                  lambda c: lo_j + (hi_j - lo_j) * c,  # noqa: B023
                                  default_dumper, settings)
            wall = time.perf_counter() - t0
        print(json.dumps({
            "name": name, "logZ": float(out["logZ"]), "logZerr": float(out["logZerr"]),
            "ndead": int(out["ndead"]), "wall_s": wall, "seed": args.seed,
            "backend": jax.default_backend(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
