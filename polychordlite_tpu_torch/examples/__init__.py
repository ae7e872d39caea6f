"""The port's example scripts and notebooks (counterparts of the top-level
``examples/``): ``quickstart.py``, ``run_example.py``,
``graded_likelihood.py``, ``quickstart.ipynb`` and
``run_polychordlite_tpu.ipynb``.  Each runs on the card by default and on
the CPU with ``--device cpu`` (the scripts) or ``device="cpu"`` (the
notebooks' run call)."""
