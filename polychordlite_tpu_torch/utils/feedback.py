"""Console feedback (reference ``src/polychord/feedback.f90``).

Four levels (utils.F90:22-26): 0 = title only, 1 = normal, 2 = fancy,
3 = verbose.  Progress quantities mirror write_intermediate_results:
ndead, live-evidence fraction, per-cluster evidence, nlike breakdown.
"""

from __future__ import annotations

import math
import sys

TITLE_FB = 0
NORMAL_FB = 1
FANCY_FB = 2
VERBOSE_FB = 3


def _emit(msg: str) -> None:
    print(msg, flush=True)


def write_opening_statement(settings, version: str, platform: str) -> None:
    """Banner (feedback.f90:19-60; gated at normal level so feedback=0 runs
    are fully quiet — minor deviation from the reference's title level)."""
    if settings.feedback < NORMAL_FB:
        return
    _emit("=" * 50)
    _emit(f"PolyChordLite-TPU {version}")
    _emit("nested sampling on PyTorch and CUDA")
    _emit("=" * 50)
    if settings.feedback >= NORMAL_FB:
        _emit(f"platform: {platform}")
        _emit(f"nDims    : {settings.nDims}")
        _emit(f"nDerived : {settings.nDerived}")
        _emit(f"nlive    : {settings.nlive}")
        _emit(f"num_repeats: {settings.num_repeats}")
        _emit(f"do_clustering: {settings.do_clustering}")
        _emit(f"precision: {settings.precision_criterion}")
        _emit("-" * 50)


def write_started_generating(feedback: int) -> None:
    if feedback >= NORMAL_FB:
        _emit("generating live points")


def write_finished_generating(feedback: int) -> None:
    if feedback >= NORMAL_FB:
        _emit("live points generated")


def write_started_sampling(feedback: int) -> None:
    if feedback >= NORMAL_FB:
        _emit("started sampling")


def write_num_repeats(num_repeats, feedback: int) -> None:
    if feedback >= NORMAL_FB:
        _emit(f"num_repeats per grade: {list(num_repeats)}")


def write_intermediate_results(settings, rti, nlikesum, logZ, varlogZ, live_frac) -> None:
    """Progress block (feedback.f90 write_intermediate_results):
    normal = one line; fancy (2) adds the per-cluster evidence table;
    verbose (3) adds per-cluster phantom/posterior occupancy."""
    if settings.feedback < NORMAL_FB:
        return
    _emit(
        f"ndead: {rti.ndead:8d} | logZ: {logZ:10.3f} +/- "
        f"{math.sqrt(abs(varlogZ)):6.3f} | nclusters: {rti.ncluster} | "
        f"live frac: {live_frac:.3e} | nlike: {int(rti.nlike.sum())}"
    )
    if settings.feedback >= FANCY_FB:
        from ..core.rti import calculate_logZ_estimate

        _, _, logZp, varlogZp, logZpd, varlogZpd = calculate_logZ_estimate(rti)
        _emit(" cluster |      log(Z_p) +/- sigma | nlive | logX_p")
        _emit(" --------+-------------------------+-------+--------")
        for p in range(rti.ncluster):
            _emit(
                f"  {p + 1:6d} | {logZp[p]:13.3f} +/- {math.sqrt(abs(varlogZp[p])):7.3f} |"
                f" {rti.live[p].shape[0]:5d} | {rti.logXp[p]:7.2f}"
            )
        for p in range(rti.ncluster_dead):
            _emit(
                f"  {rti.ncluster + p + 1:5d}+ | {logZpd[p]:13.3f} +/-"
                f" {math.sqrt(abs(varlogZpd[p])):7.3f} |     0 |    ---"
            )
    if settings.feedback >= VERBOSE_FB:
        for p in range(rti.ncluster):
            _emit(
                f"   cluster {p + 1}: nphantom {len(rti.phantom[p])}, "
                f"posterior stack {len(rti.posterior_stack[p])}, "
                f"maxlogweight {rti.maxlogweight[p]:.3f}"
            )
        _emit(
            f"   nlike by grade: {rti.nlike.tolist()} "
            f"(since last update: {list(map(int, nlikesum))})"
        )


def write_final_results(logZ, varlogZ, ndead, nlike, seconds, feedback: int) -> None:
    if feedback >= NORMAL_FB:
        _emit("-" * 50)
        _emit(
            f"Finished: logZ = {logZ:.4f} +/- {math.sqrt(abs(varlogZ)):.4f} | "
            f"ndead {ndead} | nlike {list(nlike)} | {seconds:.1f}s"
        )
