"""Running from an ini file (counterpart of ``polychordlite_tpu/inidriver.py``;
the reference's ``run_polychord_ini`` path, ``interfaces.F90:232-276``):
parse the ini, build the block priors and grade layout, resolve the
likelihood, run.

The prior is a :class:`~polychordlite_tpu_torch.priors.BlockPrior`, so an
all-uniform layout carries the affine form the CUDA slice kernels apply
themselves.  Every analytic example likelihood (``models/examples.py``)
can be named; the data-driven examples (``fitting``, ``object_detection``)
are not ported yet, and the user-template inis (``my_likelihood``,
``gaussian_CC``) name no example.
"""

from __future__ import annotations

from .core.nested_sampling import default_dumper, nested_sampling
from .models import LIKELIHOODS, get_likelihood
from .priors import BlockPrior, identity_prior
from .utils import io as io_mod
from .utils.inifile import read_ini


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
        if name not in LIKELIHOODS:
            raise ValueError(
                f"no example likelihood named {name!r}; available: "
                f"{', '.join(sorted(LIKELIHOODS))}"
            )
        like = get_likelihood(name, settings.nDims)

    prior = BlockPrior(blocks, settings.nDims) if blocks else identity_prior

    if settings.write_paramnames and paramnames:
        io_mod.write_paramnames_file(settings, list(paramnames) + list(derived))

    return nested_sampling(like, prior, default_dumper, settings, device=device)
