"""The port's multimodal path on the CPU: gaussian_shells with clustering,
at the settings of the JAX package's oracle test (tests/test_multimodal.py),
against the analytic evidence, per shell, and against the JAX package on
the same configuration; plus the chain-discard rule after a cluster
reorganisation (ROADMAP C4)."""

import math
from collections import deque

import numpy as np
import pytest
import torch

from polychordlite_tpu_torch.core import nested_sampling as ns
from polychordlite_tpu_torch.models import gaussian_shells
from polychordlite_tpu_torch.priors import UniformPrior

torch.set_num_threads(2)

ANALYTIC = -math.log(12.0 * 5.0)  # normalised shells over the box
SETTINGS = dict(
    nlive=125, num_repeats=10, read_resume=False, file_root="shells", seed=17,
    feedback=0, do_clustering=True, equals=False, posteriors=True,
    cluster_posteriors=True, write_dead=True, write_live=False, write_prior=False,
)


def _summary(res, rti_mod):
    """logZ, its error, each retired cluster's local logZ and the x_1 of its
    posterior mass (as tests/test_multimodal.py collects them)."""
    rti = res["rti"]
    _, _, _, _, logZp_dead, _ = rti_mod.calculate_logZ_estimate(rti)
    means = []
    for post in rti.posterior_dead:
        if post.shape[0]:
            w = np.exp(post[:, 2] + post[:, 1] - (post[:, 2] + post[:, 1]).max())
            means.append(float((w * post[:, 4]).sum() / w.sum()))
        else:
            means.append(0.0)
    return {"logZ": res["logZ"], "logZerr": res["logZerr"], "ndead": res["ndead"],
            "logZp_dead": np.asarray(logZp_dead), "cluster_x": np.asarray(means)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp

    import polychordlite_tpu.core.nested_sampling as jns
    import polychordlite_tpu.core.rti as j_rti
    import polychordlite_tpu.settings as j_set
    from polychordlite_tpu.models import gaussian_shells as jax_shells
    from polychordlite_tpu_torch.core import rti as p_rti
    from polychordlite_tpu_torch.settings import PolyChordSettings

    s = PolyChordSettings(2, 0, base_dir=str(tmp_path_factory.mktemp("port")), **SETTINGS)
    port = ns.nested_sampling(gaussian_shells(2), UniformPrior([-6.0, -2.5], [6.0, 2.5]),
                              ns.default_dumper, s, device="cpu")
    lo, hi = jnp.asarray([-6.0, -2.5]), jnp.asarray([6.0, 2.5])
    sj = j_set.PolyChordSettings(2, 0)
    for k, v in {**SETTINGS, "base_dir": str(tmp_path_factory.mktemp("jax"))}.items():
        setattr(sj, k, v)
    ref = jns.nested_sampling(jax_shells(2), lambda c: lo + (hi - lo) * c,
                              lambda *a: None, sj)
    return _summary(port, p_rti), _summary(ref, j_rti), port


def test_logz_matches_analytic(runs):
    port, _, _ = runs
    assert abs(port["logZ"] - ANALYTIC) < 2 * port["logZerr"] + 0.05, port


def test_per_shell_local_evidence(runs):
    """Each shell (x_1 = -3.5, +3.5) carries Z/2: retired clusters are
    grouped by the shell their posterior mass sits on."""
    port, _, _ = runs
    lz, x = port["logZp_dead"], port["cluster_x"]
    ok = np.isfinite(lz) & (lz > -1e29)
    expected = port["logZ"] - math.log(2.0)
    for side in (-1, 1):
        sel = ok & (np.sign(x) == side)
        assert sel.any(), f"no cluster found on the x={3.5 * side} shell"
        v = lz[sel]
        local = v.max() + math.log(np.sum(np.exp(v - v.max())))
        assert abs(local - expected) < 2 * port["logZerr"] + 0.25, (side, local, expected)


def test_local_evidences_sum_to_global(runs):
    port, _, res = runs
    lzs = port["logZp_dead"]
    lzs = lzs[np.isfinite(lzs) & (lzs > -1e29)]
    assert len(lzs) >= 2  # the run split into clusters
    total = lzs.max() + np.log(np.sum(np.exp(lzs - lzs.max())))
    assert abs(total - port["logZ"]) < 0.5
    assert res["metrics"]["engine_used"] == "torch"


def test_port_agrees_with_jax_package(runs):
    port, ref, _ = runs
    sigma = math.sqrt(port["logZerr"] ** 2 + ref["logZerr"] ** 2)
    assert abs(port["logZ"] - ref["logZ"]) < 3 * sigma, (port["logZ"], ref["logZ"], sigma)


@pytest.mark.parametrize("queued", [0, 3])
def test_reorganisation_during_a_chain_voids_it(queued):
    """A reorganisation during a chained dispatch discards the chain's queued
    nurseries, voids its replay check and sets the cooldown — in its last
    nursery too (``queued = 0``).  The JAX package tests the queue instead
    (``nested_sampling.py:661``) and so leaves the cooldown unset and the
    check pending there (ROADMAP C4); the port follows the documented
    contract."""
    turbo = {"enabled": True, "K": 8, "verify": np.zeros(10, np.float32), "cooldown": 0,
             "voided": 0}
    queue = deque(range(queued))
    ns._end_chain_on_reorganisation(turbo, queue, reorganised=True)
    assert turbo["cooldown"] == ns.CHAIN_COOLDOWN == 4
    assert turbo["verify"] is None and not queue and turbo["enabled"]
    assert turbo["voided"] == 1

    # no reorganisation: the chain goes on and is checked at its end
    turbo = {"enabled": True, "K": 8, "verify": np.zeros(10, np.float32), "cooldown": 0,
             "voided": 0}
    queue = deque(range(queued))
    ns._end_chain_on_reorganisation(turbo, queue, reorganised=False)
    assert turbo["cooldown"] == 0 and turbo["verify"] is not None and len(queue) == queued

    # a single nursery (no chain) is never discarded
    turbo = {"enabled": True, "K": 8, "verify": None, "cooldown": 0, "voided": 0}
    queue = deque(range(queued))
    ns._end_chain_on_reorganisation(turbo, queue, reorganised=True)
    assert turbo["cooldown"] == 0 and len(queue) == queued
