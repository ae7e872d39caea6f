"""Run any example-zoo likelihood through the Python API (counterpart of
``examples/run_example.py``, the analogue of the reference's per-problem
runner scripts ``Python_Functions/run_pypolychord_<name>.py``).

    python -m polychordlite_tpu_torch.examples.run_example gaussian_shells --nlive 200
    python -m polychordlite_tpu_torch.examples.run_example --list
    python -m polychordlite_tpu_torch.examples.run_example himmelblau --device cpu

Each zoo model carries a device functor, so on the card it runs inside the
slice kernel itself.
"""

from __future__ import annotations

import argparse
import sys

# standard prior boxes per problem (the reference's ini domains)
DOMAINS = {
    "gaussian": (0.0, 1.0),
    "half_gaussian": (0.0, 1.0),
    "pyramidal": (0.0, 1.0),
    "twin_gaussian": (0.0, 1.0),
    "random_gaussian": (0.0, 1.0),
    "rastrigin": (-5.12, 5.12),
    "himmelblau": (-5.0, 5.0),
    "rosenbrock": (-5.0, 10.0),
    "eggbox": (0.0, 31.4159265),
    "gaussian_shell": (-6.0, 6.0),
    "gaussian_shells": (-6.0, 6.0),
}
MULTIMODAL = {"gaussian_shells", "twin_gaussian", "rastrigin", "eggbox", "himmelblau"}


def main(argv=None) -> int:
    import polychordlite_tpu_torch as pt
    from polychordlite_tpu_torch.models import LIKELIHOODS, get_likelihood
    from polychordlite_tpu_torch.priors import UniformPrior

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("likelihood", nargs="?", default="gaussian")
    ap.add_argument("--list", action="store_true", help="list problems and exit")
    ap.add_argument("--ndims", type=int, default=None)
    ap.add_argument("--nlive", type=int, default=None)
    ap.add_argument("--max-ndead", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--base-dir", default="chains")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--engine", default="auto")
    args = ap.parse_args(argv)

    if args.list:
        print("\n".join(sorted(LIKELIHOODS)))
        return 0

    name = args.likelihood
    n_dims = args.ndims or (2 if name in DOMAINS and DOMAINS[name] != (0.0, 1.0) else 4)
    lo, hi = DOMAINS.get(name, (0.0, 1.0))
    like = get_likelihood(name, n_dims)

    output = pt.run(
        like,
        n_dims,
        prior=UniformPrior(lo, hi),
        nlive=args.nlive or 25 * n_dims,
        max_ndead=args.max_ndead,
        do_clustering=name in MULTIMODAL,
        base_dir=args.base_dir,
        file_root=name,
        seed=args.seed,
        read_resume=False,
        device=args.device,
        engine=args.engine,
    )
    print(f"{name}: logZ = {output.logZ:.4f} +/- {output.logZerr:.4f} "
          f"(ndead={output.ndead}, nlike={output.nlike})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
