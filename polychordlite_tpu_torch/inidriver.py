"""Running from an ini file (counterpart of ``polychordlite_tpu/inidriver.py``;
the reference's ``run_polychord_ini`` path, ``interfaces.F90:232-276``):
parse the ini, build the block priors and grade layout, resolve the
likelihood, run.

The prior is a :class:`~polychordlite_tpu_torch.priors.BlockPrior`, so an
all-uniform layout carries the affine form the CUDA slice kernels apply
themselves.  Every example likelihood can be named: the analytic zoo
(``models/examples.py``) and the data-driven ``fitting`` and
``object_detection`` (``models/data_driven.py``), which read their data
from the ini's ``data_dir`` key or else from a ``data/`` directory beside
the ini's own directory (the reference's relative ``data/`` paths), as the
JAX package's driver does.  The user-template inis (``my_likelihood``,
``gaussian_CC``) name no example; the C ABI's ini entry passes its own
likelihood (``capi.run_from_c_ini``).
"""

from __future__ import annotations

import os

from .core.nested_sampling import default_dumper, nested_sampling
from .models import EXAMPLES, get_likelihood
from .priors import BlockPrior, identity_prior
from .utils import io as io_mod
from .utils.inifile import read_ini


def data_dir(inifile: str, kv: dict):
    """The data directory of a data-driven example: the ini's ``data_dir``
    key, else ``../data`` beside the ini if it holds ``data.dat``, else
    None (the model's synthetic data)."""
    found = kv.get("data_dir")
    if found is None:
        candidate = os.path.join(os.path.dirname(os.path.abspath(inifile)), "..", "data")
        if os.path.exists(os.path.join(candidate, "data.dat")):
            found = candidate
    return found


def run_ini(inifile: str, likelihood_name=None, loglikelihood=None, device=None):
    """Run from an ini file.

    ``loglikelihood(theta, nDerived) -> (logL, phi)``, if given, overrides
    the example-zoo lookup.  Otherwise the zoo likelihood is picked by
    ``likelihood_name`` / the ini's ``likelihood`` key / ``file_root``.
    ``device`` is the torch device: ``None`` means ``"cuda"`` (the run
    raises without a card); ``"cpu"`` runs on the CPU.
    """
    settings, blocks, paramnames, derived, kv = read_ini(inifile)

    if loglikelihood is not None:
        n_derived = settings.nDerived

        def like(theta):
            return loglikelihood(theta, n_derived)

    else:
        name = likelihood_name or kv.get("likelihood") or settings.file_root
        if name not in EXAMPLES:
            raise ValueError(
                f"no example likelihood named {name!r}; available: "
                f"{', '.join(sorted(EXAMPLES))}"
            )
        kwargs = {}
        if name in ("fitting", "object_detection"):
            kwargs["data_dir"] = data_dir(inifile, kv)
        like = get_likelihood(name, settings.nDims, **kwargs)

    prior = BlockPrior(blocks, settings.nDims) if blocks else identity_prior

    if settings.write_paramnames and paramnames:
        io_mod.write_paramnames_file(settings, list(paramnames) + list(derived))

    return nested_sampling(like, prior, default_dumper, settings, device=device)
