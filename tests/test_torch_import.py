"""The port imports without JAX, and importing a module runs nothing.
Checked in a fresh interpreter, because the test process itself has already
imported jax (tests/conftest.py).  And no test file of the port defines a
test twice: pytest collects only the later definition of a name."""

import ast
import glob
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
    "polychordlite_tpu_torch.ops.fused_like",
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
    "polychordlite_tpu_torch.experiments.pallas_epoch_v2",
    "polychordlite_tpu_torch.experiments.pallas_slice_repeat",
    "polychordlite_tpu_torch.experiments.prof_ring",
    "polychordlite_tpu_torch.experiments.ptxas_parity",
    "polychordlite_tpu_torch.experiments.gs_long_parts",
    "polychordlite_tpu_torch.experiments.gs_wide_times",
    "polychordlite_tpu_torch.experiments.fused_data_times",
    "polychordlite_tpu_torch.experiments.data_ini_runs",
    "polychordlite_tpu_torch.experiments.b1_bucket_parts",
    "polychordlite_tpu_torch.experiments.cpu_ops_rounding",
    "polychordlite_tpu_torch.examples.quickstart",
    "polychordlite_tpu_torch.examples.run_example",
    "polychordlite_tpu_torch.examples.graded_likelihood",
    "polychordlite_tpu_torch.models.data_driven",
    "polychordlite_tpu_torch.capi",
    "polychordlite_tpu_torch.utils.cabi",
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


def test_lowering_leaves_jax_out():
    """Tracing and lowering a torch model for the fused route (make_fx)
    imports no JAX either."""
    code = (
        "import sys, torch; from polychordlite_tpu_torch.ops import fused_like; "
        "from polychordlite_tpu_torch.ops.evaluate import make_batched_calculator; "
        "calc = make_batched_calculator(lambda c: c, lambda t: -(t ** 2).sum(-1), 3, 0); "
        "assert isinstance(fused_like.lowering(calc), fused_like.Lowered); "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'polychordlite_tpu.'))]; "
        "assert not bad, bad"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr


def test_c_sources_import_only_the_port():
    """The port's C shim embeds an interpreter and imports modules by name:
    each name is the port's, never the JAX package's."""
    import re

    names = []
    for path in glob.glob(os.path.join(REPO, "polychordlite_tpu_torch", "cabi", "*")):
        with open(path) as f:
            names += re.findall(r'PyImport_ImportModule\("([^"]+)"\)', f.read())
    assert names and all(n.split(".")[0] == "polychordlite_tpu_torch" for n in names), names


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports neither jax nor anything of the JAX package,
    at the top or inside a function."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "polychordlite_tpu")]
    assert mods and not bad, bad


PORT_TESTS = sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))


@pytest.mark.parametrize("name", PORT_TESTS)
def test_no_test_is_defined_twice(name):
    """A second top-level definition of a test's name shadows the first,
    which then never runs; each test_* name is defined once per file."""
    with open(os.path.join(REPO, "tests", name)) as f:
        tree = ast.parse(f.read(), name)
    seen, twice = set(), []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith(("test_", "Test")):
                if node.name in seen:
                    twice.append(f"{node.name} (line {node.lineno})")
                seen.add(node.name)
    assert not twice, f"{name} defines again: {twice}"
