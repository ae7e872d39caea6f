"""The ini-file CLI: ``python -m polychordlite_tpu_torch ini/gaussian_shells.ini``.

Counterpart of ``polychordlite_tpu/__main__.py`` (the reference's compiled
ini programs, ``src/drivers/polychord_examples.f90`` ->
``run_polychord_ini``, ``interfaces.F90:232-276``): parse the ini, build
the block priors and grade layout, pick the example likelihood (by
``--likelihood`` or the file_root name), run on the device that
``--device`` names (``cuda`` by default, which needs a card; the JAX CLI
picks its backend through ``JAX_PLATFORMS``), and print the summary line of
the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import sys

from .core.nested_sampling import resolve_device
from .inidriver import run_ini
from .models import EXAMPLES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="polychordlite_tpu_torch",
        description="nested sampling on PyTorch and CUDA (PolyChordLite-compatible)",
    )
    ap.add_argument("inifile", help="ini configuration file")
    ap.add_argument(
        "--likelihood",
        default=None,
        help="example likelihood name (default: inferred from file_root); "
        f"available: {', '.join(sorted(EXAMPLES))}",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="torch device of the run (default: cuda; it needs a CUDA card)",
    )
    args = ap.parse_args(argv)

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    try:
        out = run_ini(args.inifile, likelihood_name=args.likelihood, device=args.device)
    except ValueError as e:
        ap.error(str(e))
    print(
        "logZ = %.6f +/- %.6f | ndead = %d | nlike = %d"
        % (out["logZ"], out["logZerr"], out["ndead"], out["nlike"])
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
