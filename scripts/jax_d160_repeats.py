"""The 160-D Gaussian run of ``chip_smoke.py`` (``run_gaussian_d160``) in the
JAX package, on the CPU, at a chosen seed, num_repeats and nlive.

    JAX_PLATFORMS=cpu python scripts/jax_d160_repeats.py SEED NUM_REPEATS NLIVE

A Gaussian of sigma 0.2 at 0.5 on the unit cube in 160 dimensions (logZ =
160 log erf(2.5 / sqrt 2) = -1.9995), the JAX package's ``run()`` with no
clustering into a new temporary directory; one JSON line: logZ, its error,
its pull from the analytic value, ndead and the wall seconds.  It shows
whether the port's evidence at a num_repeats is the sampler's or the
port's: the port's own run is ``chip_smoke.d160_run`` with the same
arguments.  Some 8 minutes at num_repeats 320 and nlive 200 on four CPU
cores.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIGMA, D = 0.2, 160


def main(seed: int, num_repeats: int, nlive: int) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import polychordlite_tpu

    def loglikelihood(theta):
        return (-0.5 * jnp.sum(((theta - 0.5) / SIGMA) ** 2)
                - D * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))), []

    truth = D * math.log(math.erf(0.5 / (SIGMA * math.sqrt(2.0))))
    base = tempfile.mkdtemp(prefix=f"jax_d160_{seed}_{num_repeats}_")
    t0 = time.time()
    out = polychordlite_tpu.run(loglikelihood, D, nlive=nlive, num_repeats=num_repeats,
                                do_clustering=False, read_resume=False, base_dir=base,
                                seed=seed, feedback=0)
    rec = {"seed": seed, "num_repeats": num_repeats, "nlive": nlive, "logZ": out.logZ,
           "logZerr": out.logZerr, "pull": (out.logZ - truth) / out.logZerr,
           "ndead": getattr(out, "ndead", None), "wall_s": time.time() - t0, "truth": truth}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
