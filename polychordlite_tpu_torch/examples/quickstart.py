"""4-D Gaussian quickstart (counterpart of ``examples/quickstart.py`` and of
the reference ``quickstart.py``): spherical Gaussian, sigma = 0.1, one
derived parameter (r^2), uniform prior on [-1, 1]^4.  Analytic answer:
logZ = -4 log 2 = -2.7726.

The likelihood is written in torch for one point; the sampler evaluates it
for the whole chain batch, and on the card lowers it into its slice kernel
(the fused route).

    python -m polychordlite_tpu_torch.examples.quickstart [--device cpu] [--nlive 200]
"""

import argparse
import math

import numpy as np
import torch

import polychordlite_tpu_torch as pt
from polychordlite_tpu_torch.priors import UniformPrior

nDims = 4
nDerived = 1
sigma = 0.1


def likelihood(theta):
    """Simple Gaussian likelihood of one point ``theta (nDims,)``."""
    r2 = torch.sum(theta**2)
    logL = -math.log(2 * math.pi * sigma * sigma) * nDims / 2.0 - r2 / 2 / sigma**2
    return logL, [r2]


def prior(hypercube):
    """Uniform prior from [-1,1]^D."""
    return UniformPrior(-1, 1)(hypercube)


def dumper(live, dead, logweights, logZ, logZerr):
    print("Last dead point:", dead[-1])


paramnames = [(f"p{i}", rf"\theta_{i}") for i in range(nDims)] + [("r*", "r")]


def corner_plot(path, base_dir="chains", file_root="gaussian"):
    """A corner-style plot of the equally weighted posterior samples with
    matplotlib (reference ``quickstart.py:62-70``); returns the file
    written, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no posterior plot")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.loadtxt(f"{base_dir}/{file_root}_equal_weights.txt")
    theta = data[:, 2 : 2 + nDims]
    fig, axes = plt.subplots(nDims, nDims, figsize=(8, 8))
    for i in range(nDims):
        for j in range(nDims):
            ax = axes[i, j]
            if i == j:
                ax.hist(theta[:, i], bins=30, density=True)
            elif i > j:
                ax.plot(theta[:, j], theta[:, i], ".", ms=1, alpha=0.4)
            else:
                ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"wrote {path}")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--nlive", type=int, default=200)
    ap.add_argument("--max-ndead", type=int, default=-1)
    ap.add_argument("--base-dir", default="chains")
    ap.add_argument("--seed", type=int, default=-1)
    ap.add_argument("--no-plot", action="store_true")
    args = ap.parse_args(argv)
    output = pt.run(
        likelihood,
        nDims,
        nDerived=nDerived,
        prior=prior,
        dumper=dumper,
        file_root="gaussian",
        base_dir=args.base_dir,
        nlive=args.nlive,
        max_ndead=args.max_ndead,
        seed=args.seed,
        do_clustering=True,
        read_resume=False,
        paramnames=paramnames,
        device=args.device,
    )
    print(output)
    print("analytic logZ =", -nDims * math.log(2.0))
    if not args.no_plot:
        corner_plot("posterior.png", args.base_dir)
    return output


if __name__ == "__main__":
    main()
