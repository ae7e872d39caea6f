"""The analytic example likelihoods (see ``examples.py``)."""

from .examples import (
    LIKELIHOODS,
    eggbox,
    gaussian,
    gaussian_shell,
    gaussian_shells,
    get_likelihood,
    half_gaussian,
    himmelblau,
    pyramidal,
    random_gaussian,
    rastrigin,
    rosenbrock,
    twin_gaussian,
)

__all__ = [
    "LIKELIHOODS", "eggbox", "gaussian", "gaussian_shell", "gaussian_shells",
    "get_likelihood", "half_gaussian", "himmelblau", "pyramidal", "random_gaussian",
    "rastrigin", "rosenbrock", "twin_gaussian",
]
