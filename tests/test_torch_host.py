"""The port's copies of the numpy host modules, held bitwise to the originals.

Each case builds the same run-time state in both packages from one numpy
seed, applies the same operations, and requires identical arrays, labels
and file bytes.  One case reads, with the port, a checkpoint written by a
short run of the JAX package and continues that run; the last holds the
copied sources to the originals' code.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

import polychordlite_tpu.core.clustering as j_clu
import polychordlite_tpu.core.rti as j_rti
import polychordlite_tpu.settings as j_set
import polychordlite_tpu.utils.io as j_io
import polychordlite_tpu_torch.core.clustering as p_clu
import polychordlite_tpu_torch.core.rti as p_rti
import polychordlite_tpu_torch.settings as p_set
import polychordlite_tpu_torch.utils.io as p_io
from polychordlite_tpu.ops.linalg import similarity_matrix_np

torch.set_num_threads(2)

N_DIMS, N_DERIVED, NLIVE = 3, 1, 40
PKGS = {"jax": (j_rti, j_set), "torch": (p_rti, p_set)}


def _point_rows(rng, n, s, lo=-5.0, hi=0.0):
    pts = np.zeros((n, s.nTotal))
    pts[:, s.h] = rng.uniform(0, 1, (n, s.nDims))
    pts[:, s.p] = pts[:, s.h] * 2.0 - 1.0
    pts[:, s.d] = rng.normal(size=(n, s.nDerived))
    pts[:, s.b0] = s.logzero
    pts[:, s.l0] = np.sort(rng.uniform(lo, hi, n))
    return pts


def _state(which, seed=0):
    rti_mod, set_mod = PKGS[which]
    s = set_mod.PolyChordSettings(N_DIMS, N_DERIVED, nlive=NLIVE, base_dir="unused")
    s.finalise()
    rti = rti_mod.RunTimeInfo(s, 1)
    rng = np.random.default_rng(seed)
    rti.live[0] = _point_rows(rng, NLIVE, s)[rng.permutation(NLIVE)]
    rti.num_repeats = np.array([6])
    rti.thin_posterior = 1.0
    rti.nlike[0] = NLIVE
    rti_mod.find_min_loglikelihoods(rti)
    return rti_mod, rti, s


def _babies(s, seed, n):
    rng = np.random.default_rng(100 + seed)
    rows = _point_rows(rng, n, s, lo=-3.0, hi=1.0)
    return rows[rng.permutation(n)]


def _fields(rti):
    """Every array of the run-time state, as numpy (RowStores by data)."""
    out = {}
    for name, val in vars(rti).items():
        if name in ("settings", "_rng"):
            continue
        if hasattr(val, "copy_array"):
            out[name] = val.copy_array()
        elif isinstance(val, list):
            out[name] = [
                v.copy_array() if hasattr(v, "copy_array") else np.asarray(v)
                for v in val
            ]
        else:
            out[name] = np.asarray(val)
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, list):
            assert len(va) == len(vb), k
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_array_equal(va, vb, err_msg=k)


def _apply(op, rti_mod, rti, s):
    """Run one scripted sequence of host operations; returns its outputs."""
    outs = []
    babies = _babies(s, 0, 60)
    if op == "update_evidence":
        for _ in range(15):
            outs.append(rti_mod.update_evidence(rti, 0))
            rti_mod.delete_outermost_point(rti)
    elif op == "replace_point":
        for i in range(20):
            chain = np.stack([babies[i], babies[i + 20], babies[i + 40]])
            outs.append(rti_mod.replace_point(rti, chain, 0))
    elif op == "try_replace_live":
        rti_mod.append_phantoms_batch(rti, babies[40:], np.zeros(20, dtype=int))
        for i in range(40):
            outs.append(rti_mod.try_replace_live(rti, babies[i], 0, True))
    elif op == "calculate_logZ_estimate":
        for i in range(30):
            rti_mod.try_replace_live(rti, babies[i], 0, True)
            outs.append(rti_mod.calculate_logZ_estimate(rti))
    elif op == "calculate_covmats":
        for i in range(25):
            rti_mod.try_replace_live(rti, babies[i], 0, True)
        rti_mod.calculate_covmats(rti)
        rti_mod.update_posteriors(rti)
    return outs


@pytest.mark.parametrize(
    "op",
    ["update_evidence", "replace_point", "try_replace_live",
     "calculate_logZ_estimate", "calculate_covmats"],
)
def test_rti_operations_bitwise(op):
    results = {}
    for which in PKGS:
        rti_mod, rti, s = _state(which)
        outs = _apply(op, rti_mod, rti, s)
        results[which] = (outs, _fields(rti))
    (o_j, f_j), (o_p, f_p) = results["jax"], results["torch"]
    assert repr(o_j) == repr(o_p)
    _assert_same(f_j, f_p)


def _snapshots():
    here = os.path.dirname(__file__)
    paths = sorted(glob.glob(os.path.join(here, "data", "clustering_snapshot_*.npy")))
    assert len(paths) >= 4, "snapshot files missing"
    return paths


@pytest.mark.parametrize("case", list(range(6)) + ["blobs", "stress"])
def test_nn_clustering_bitwise(case):
    from clustering_oracle import nn_clustering as oracle, partition_key

    if isinstance(case, int):
        sims = [np.load(_snapshots()[case])]
    elif case == "blobs":
        rng = np.random.default_rng(0)
        pts = np.vstack([rng.normal(c, 0.03, (40, 2)) for c in ([0.2, 0.2], [0.8, 0.8])])
        sims = [similarity_matrix_np(pts)]
    else:
        sims = []
        for seed in range(6):
            rng = np.random.default_rng(100 + seed)
            pts = np.vstack([
                rng.normal(rng.uniform(0, 1, 2), rng.uniform(0.02, 0.12),
                           (int(rng.integers(8, 30)), 2))
                for _ in range(int(rng.integers(1, 5)))
            ])
            sims.append(similarity_matrix_np(pts))
    for sim in sims:
        lab_p = p_clu.nn_clustering(sim.copy())
        np.testing.assert_array_equal(lab_p, j_clu.nn_clustering(sim.copy()))
        lab_o, _ = oracle(sim.copy())
        assert partition_key(lab_o) == partition_key(lab_p)


@pytest.mark.parametrize(
    "writer",
    ["write_stats_file", "write_dead_points", "write_phys_live_points",
     "write_posterior_files"],
)
def test_file_products_bytewise(writer, tmp_path):
    texts = {}
    for which, io_mod in (("jax", j_io), ("torch", p_io)):
        rti_mod, rti, s = _state(which)
        s.base_dir = str(tmp_path / which)
        io_mod.check_directories(s)
        _apply("calculate_covmats", rti_mod, rti, s)
        if writer == "write_stats_file":
            io_mod.write_stats_file(s, rti, np.array([123]))
        else:
            getattr(io_mod, writer)(s, rti)
        texts[which] = {
            os.path.relpath(p, s.base_dir): open(p).read()
            for p in sorted(glob.glob(os.path.join(s.base_dir, "**", "*"), recursive=True))
            if os.path.isfile(p)
        }
    assert texts["jax"] and texts["jax"] == texts["torch"]


def test_port_reads_jax_checkpoint(tmp_path):
    """A checkpoint written by a short JAX-package run reads into the port's
    state with every field equal to the JAX reader's."""
    import polychordlite_tpu
    import polychordlite_tpu.utils.resume as j_res
    import polychordlite_tpu_torch.utils.resume as p_res
    from polychordlite_tpu.models.examples import gaussian

    base = str(tmp_path / "jax_run")
    polychordlite_tpu.run(
        gaussian(2), 2, nDerived=2, nlive=25, num_repeats=4, max_ndead=60,
        do_clustering=False, read_resume=False, base_dir=base, seed=3,
        feedback=-1, mesh_shape=1, write_dead=False, posteriors=False,
        equals=False, write_live=False, write_prior=False,
    )
    got = {}
    for name, res_mod, set_mod in (("jax", j_res, j_set), ("torch", p_res, p_set)):
        s = set_mod.PolyChordSettings(2, 2, base_dir=base).finalise()
        rti, rng_state, key = res_mod.read_resume_file(s, 1)
        assert type(rti).__module__.startswith(
            "polychordlite_tpu_torch" if name == "torch" else "polychordlite_tpu."
        )
        got[name] = (_fields(rti), rng_state, np.asarray(key))
    _assert_same(got["jax"][0], got["torch"][0])
    assert got["jax"][1] == got["torch"][1]
    np.testing.assert_array_equal(got["jax"][2], got["torch"][2])
    assert got["torch"][2].dtype == np.uint32 and got["torch"][2].shape == (2,)
    assert got["torch"][0]["ndead"] >= 60

    # the port continues the reference's run from its checkpoint
    import polychordlite_tpu_torch
    from polychordlite_tpu_torch.models import gaussian as pt_gaussian

    out = polychordlite_tpu_torch.run(
        pt_gaussian(2), 2, nDerived=2, nlive=25, num_repeats=4, max_ndead=150,
        do_clustering=False, read_resume=True, base_dir=base, seed=3,
        feedback=-1, write_dead=False, posteriors=False, equals=False,
        write_live=False, write_prior=False, device="cpu",
    )
    assert out.ndead >= 150
    s = p_set.PolyChordSettings(2, 2, base_dir=base).finalise()
    rti, _, key = p_res.read_resume_file(s, 1)
    assert rti.epoch_idx > int(got["torch"][0]["epoch_idx"])
    np.testing.assert_array_equal(key, got["jax"][2])  # the root key carries on


COPIED = [
    "settings.py", "output.py", "ops/logspace.py", "ops/linalg.py",
    "core/rti.py", "core/clustering.py", "utils/io.py", "utils/feedback.py",
    "utils/metrics.py", "utils/writebehind.py", "utils/native.py",
    "params.py", "utils/inifile.py", "utils/legacy_resume.py", "models/graded.py",
    # the maximiser's functions but _eval_batch (which evaluates through the
    # port's calc in the run's dtype, where the JAX package casts to float32)
    "core/maximiser.py::_eval_point", "core/maximiser.py::_nelder_mead",
    "core/maximiser.py::_jacobian_probes", "core/maximiser.py::_logP_batch",
    "core/maximiser.py::_dXdtheta", "core/maximiser.py::maximise",
]


# String constants the port rewords: the console banner names the backend.
REWORDED = {
    "utils/feedback.py": {
        "TPU-native nested sampling (JAX/XLA)": "nested sampling on PyTorch and CUDA",
    },
}


def _code(source: str, reworded=None, function=None) -> str:
    """The module's syntax tree without docstrings (comments are never in
    it), with the ``reworded`` string constants mapped back; or only the
    tree of its top-level ``function``."""
    tree = ast.parse(source)
    if function is not None:
        (tree,) = [n for n in tree.body if getattr(n, "name", None) == function]
    back = {v: k for k, v in (reworded or {}).items()}
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (
            isinstance(body, list) and body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            body[0].value.value = ""
        if isinstance(node, ast.Constant) and node.value in back:
            node.value = back[node.value]
    return ast.dump(tree)


@pytest.mark.parametrize("path", COPIED)
def test_host_copies_kept_in_step(path):
    """The copied host modules (or, for ``file::function``, functions) are
    the reference's code: the same syntax tree, docstrings aside.  Their
    docstrings and comments may differ, so that the port carries none of
    the JAX package's TPU measurements."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path, _, function = path.partition("::")
    with open(os.path.join(repo, "polychordlite_tpu", path)) as f:
        ref = _code(f.read(), function=function or None)
    with open(os.path.join(repo, "polychordlite_tpu_torch", path)) as f:
        assert _code(f.read(), REWORDED.get(path), function or None) == ref
