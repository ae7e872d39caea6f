"""Example likelihoods ported so far (see ``examples.py``)."""

from .examples import LIKELIHOODS, gaussian, gaussian_shells, get_likelihood

__all__ = ["LIKELIHOODS", "gaussian", "gaussian_shells", "get_likelihood"]
