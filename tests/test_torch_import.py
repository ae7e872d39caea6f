"""The port imports without JAX, and importing a module runs nothing.
Checked in a fresh interpreter, because the test process itself has already
imported jax (tests/conftest.py)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "polychordlite_tpu_torch",
    "polychordlite_tpu_torch.core.nested_sampling",
    "polychordlite_tpu_torch.ops.pallas_slice_v4",
    "polychordlite_tpu_torch.ops.pallas_slice_v5",
    "polychordlite_tpu_torch.inidriver",
    "polychordlite_tpu_torch.priors",
    "polychordlite_tpu_torch.ops.chained_epoch",
    "polychordlite_tpu_torch.utils.resume",
    "polychordlite_tpu_torch.models",
    "polychordlite_tpu_torch.experiments.prof_v3_iters",
    "polychordlite_tpu_torch.experiments.prof_lockstep_waste",
    "polychordlite_tpu_torch.experiments.prof_grid_overhead",
    "polychordlite_tpu_torch.experiments.prof_pallas_while",
    "polychordlite_tpu_torch.experiments.sim_iter_distribution",
]


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(module):
    code = (
        f"import importlib, sys; importlib.import_module({module!r}); "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'polychordlite_tpu.'))]; "
        "assert not bad, bad"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""  # importing runs nothing (the studies print their records)
