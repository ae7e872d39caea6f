"""polychordlite_tpu_torch — the nested sampler on PyTorch and CUDA.

The port of ``polychordlite_tpu`` (JAX on a TPU) to PyTorch, with
hand-written CUDA kernels for an NVIDIA Hopper card.  It imports torch and
numpy, never jax.  Module paths mirror the JAX package, so each module here
has exactly one counterpart there: the numpy host modules (settings,
run-time info, clustering, file products) are copies, and the device path
(evaluate, directions, slice engines, runner, main loop) is rewritten in
torch, with the CUDA sources in ``csrc/``.
"""

__version__ = "0.1.0"

from .models.graded import GradedLikelihood
from .output import PolyChordOutput
from .run import run, run_polychord
from .settings import PolyChordSettings

__all__ = [
    "GradedLikelihood",
    "run",
    "run_polychord",
    "PolyChordSettings",
    "PolyChordOutput",
    "__version__",
]
