"""Example likelihoods ported so far (see ``examples.py``)."""

from .examples import LIKELIHOODS, gaussian, get_likelihood

__all__ = ["LIKELIHOODS", "gaussian", "get_likelihood"]
