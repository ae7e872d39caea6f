"""The port's examples (``polychordlite_tpu_torch/examples/``, the counterparts
of the top-level ``examples/``) run on the CPU at reduced sizes: the two
notebooks' code cells (as ``tests/test_models.py::
test_quickstart_notebook_executes`` runs the JAX package's quickstart
notebook), ``quickstart.py``, ``run_example.py`` and
``graded_likelihood.py``; and none of them imports JAX or the JAX package.
The card runs them in ``tests/test_torch_cuda.py``."""

import ast
import glob
import json
import math
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "polychordlite_tpu_torch", "examples")
NOTEBOOKS = ("quickstart.ipynb", "run_polychordlite_tpu.ipynb")


def notebook_source(name: str) -> str:
    """The notebook's code cells, joined."""
    with open(os.path.join(EXAMPLES, name)) as f:
        nb = json.load(f)
    return "\n".join("".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code")


def reduced(src: str) -> str:
    """The notebook cut to a seeded CPU run, by text substitution as the
    JAX package's test cuts its notebook."""
    out = (src.replace("nlive=200", "nlive=60").replace("settings.nlive = 200",
                                                          "settings.nlive = 60")
           .replace("device=None", 'device="cpu"')
           .replace("read_resume=False,", "read_resume=False,\n    max_ndead=400,\n    seed=5,")
           .replace("settings.read_resume = False",
                    "settings.read_resume = False\nsettings.max_ndead = 400\nsettings.seed = 5"))
    assert out.count('device="cpu"') == 1 and "max_ndead" in out
    return out


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_executes(name, tmp_path, monkeypatch):
    """The notebook's code cells run end to end on the CPU, seeded, and its
    evidence is the quickstart's -4 log 2 within 4 sigma."""
    monkeypatch.chdir(tmp_path)
    scope = {}
    exec(compile(reduced(notebook_source(name)), name, "exec"), scope)
    assert (tmp_path / "chains" / "gaussian.stats").exists()
    out = scope["output"]
    assert abs(out.logZ + 4 * math.log(2)) < 4 * out.logZerr + 0.1
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert (tmp_path / "posterior.png").exists() or (tmp_path / "posterior.pdf").exists()
    if name == "run_polychordlite_tpu.ipynb":
        assert (tmp_path / "chains" / "gaussian.paramnames").exists()


def test_quickstart_script(tmp_path, monkeypatch):
    from polychordlite_tpu_torch.examples import quickstart

    monkeypatch.chdir(tmp_path)
    out = quickstart.main(["--device", "cpu", "--nlive", "60", "--max-ndead", "400",
                           "--seed", "3"])
    assert (tmp_path / "chains" / "gaussian.stats").exists()
    assert abs(out.logZ + 4 * math.log(2)) < 4 * out.logZerr + 0.1


def test_run_example_list_and_one_problem(tmp_path, monkeypatch, capsys):
    from polychordlite_tpu_torch.examples import run_example
    from polychordlite_tpu_torch.models import LIKELIHOODS

    monkeypatch.chdir(tmp_path)
    assert run_example.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == sorted(LIKELIHOODS)
    assert run_example.main(["himmelblau", "--device", "cpu", "--nlive", "40",
                             "--max-ndead", "200"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("himmelblau: logZ = ") and "ndead=" in line
    assert (tmp_path / "chains" / "himmelblau.stats").exists()


def test_graded_likelihood_script(tmp_path, monkeypatch, capsys):
    """Both runs at a reduced size, the graded one spending fewer likelihood
    calls on the slow grade than the monolithic one spends on its calls of
    the whole likelihood, and both printed."""
    from polychordlite_tpu_torch.examples import graded_likelihood as gl

    monkeypatch.chdir(tmp_path)
    res = gl.main(["--device", "cpu", "--loops", "20", "--nlive", "30", "--max-ndead", "150"])
    printed = capsys.readouterr().out
    assert "graded:" in printed and "monolithic:" in printed and "ratio" in printed
    for out, wall in res.values():
        assert math.isfinite(out.logZ) and wall > 0
    slow, fast = gl.nlike_per_grade(res["graded"][0])
    assert 0 < slow < fast


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_examples_import_no_jax():
    """Nothing under polychordlite_tpu_torch/examples/ (scripts and the
    notebooks' code cells) imports jax or the JAX package, and each imports
    the port."""
    files = sorted(glob.glob(os.path.join(EXAMPLES, "*.py")))
    sources = {os.path.basename(p): open(p).read() for p in files}
    sources.update({n: notebook_source(n) for n in NOTEBOOKS})
    assert {"quickstart.py", "run_example.py", "graded_likelihood.py"} <= set(sources)
    for name, src in sources.items():
        mods = list(_imports(ast.parse(src)))
        bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "polychordlite_tpu")]
        assert not bad, (name, bad)
        if name != "__init__.py":
            assert any(m.split(".")[0] == "polychordlite_tpu_torch" for m in mods), name
