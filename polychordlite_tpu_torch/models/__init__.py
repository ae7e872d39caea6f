"""The example likelihoods: the analytic zoo (``examples.py``,
:data:`LIKELIHOODS`, each with a device functor) and the data-driven
``fitting`` and ``object_detection`` (``data_driven.py``).  The ini driver
names them through :data:`EXAMPLES`, both together, as the JAX package
names them through its one registry (it adds the data-driven two to its
zoo's dict, ``polychordlite_tpu/models/__init__.py:22-25``); the port keeps
the zoo's dict to the models with a device functor."""

from .data_driven import fitting, object_detection
from .examples import (
    LIKELIHOODS,
    eggbox,
    gaussian,
    gaussian_shell,
    gaussian_shells,
    half_gaussian,
    himmelblau,
    pyramidal,
    random_gaussian,
    rastrigin,
    rosenbrock,
    twin_gaussian,
)

#: every example likelihood by name: the zoo and the data-driven examples
EXAMPLES = {**LIKELIHOODS, "fitting": fitting, "object_detection": object_detection}


def get_likelihood(name: str, n_dims: int, **kwargs):
    """The example likelihood ``name`` of :data:`EXAMPLES` at ``n_dims``
    (``data_dir=`` for the data-driven two)."""
    if name not in EXAMPLES:
        raise KeyError(f"unknown likelihood {name!r}; have {sorted(EXAMPLES)}")
    return EXAMPLES[name](n_dims, **kwargs)


__all__ = [
    "EXAMPLES", "LIKELIHOODS", "eggbox", "fitting", "gaussian", "gaussian_shell",
    "gaussian_shells", "get_likelihood", "half_gaussian", "himmelblau", "object_detection",
    "pyramidal", "random_gaussian", "rastrigin", "rosenbrock", "twin_gaussian",
]
