"""The port's C ABI (``polychordlite_tpu_torch/cabi``, ``capi.py``,
``utils/cabi.py``) on the CPU: the shim and a C driver compiled with gcc
into one shared object and loaded into this process with ``ctypes.PyDLL``
(the shim calls the Python API, so the GIL stays held across the call),
``capi.DEVICE = "cpu"``: ``polychord_c_interface`` on a 2-D Gaussian and
``polychord_c_interface_ini``, the analogue of the JAX package's
``tests/test_capi.py``; the shipped C++ example and the reference's MPI
overloads compiled against the port's headers.  On the card,
``chip_smoke.py`` runs ``examples/cc/gaussian_cc.cpp`` as a program that
embeds the interpreter."""

import ctypes
import json
import math
import os
import shutil
import subprocess

import pytest

from polychordlite_tpu_torch import capi
from polychordlite_tpu_torch.output import PolyChordOutput
from polychordlite_tpu_torch.utils import cabi

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None or shutil.which("g++") is None,
                                reason="no C toolchain")

DRIVER = r"""
#include <math.h>
#include <stdio.h>
#include <string.h>
#include "capi.h"

/* 2-D normalised gaussian at 0.5, sigma 0.1 */
static int like_calls = 0;
static double loglike(double *theta, int nDims, double *phi, int nDerived) {
    double r2 = 0.0;
    like_calls++;
    for (int i = 0; i < nDims; i++) {
        double d = theta[i] - 0.5;
        r2 += d * d;
    }
    if (nDerived > 0) phi[0] = sqrt(r2);
    return -r2 / (2 * 0.01) - nDims * log(0.1 * sqrt(2 * M_PI));
}

static void prior(double *cube, double *theta, int nDims) {
    for (int i = 0; i < nDims; i++) theta[i] = cube[i]; /* unit cube */
}

static int dumper_calls = 0;
static double last_logZ = 1e30;
static void dumper(int ndead, int nlive, int npars, double *live,
                   double *dead, double *logweights, double logZ,
                   double logZerr) {
    (void)live; (void)dead; (void)logweights; (void)logZerr;
    (void)ndead; (void)nlive; (void)npars;
    dumper_calls++;
    last_logZ = logZ;
}

double run_gaussian(const char *base) {
    char base_dir[256], file_root[16] = "capi";
    strncpy(base_dir, base, 255);
    double grade_frac[1] = {1.0};
    int grade_dims[1] = {2};
    int comm = 0;
    polychord_c_interface(
        loglike, prior, dumper,
        /*nlive*/ 50, /*num_repeats*/ 4, /*nprior*/ -1, /*nfail*/ -1,
        /*do_clustering*/ false, /*feedback*/ 0,
        /*precision_criterion*/ 0.01, /*logzero*/ -1e30, /*max_ndead*/ -1,
        /*boost_posterior*/ 0.0, /*posteriors*/ true, /*equals*/ true,
        /*cluster_posteriors*/ false, /*write_resume*/ false,
        /*write_paramnames*/ false, /*read_resume*/ false,
        /*write_stats*/ true, /*write_live*/ false, /*write_dead*/ true,
        /*write_prior*/ false, /*maximise*/ false,
        /*compression_factor*/ 0.36787944117144233, /*synchronous*/ true,
        /*nDims*/ 2, /*nDerived*/ 1, base_dir, file_root,
        /*nGrade*/ 1, grade_frac, grade_dims,
        /*n_nlives*/ 0, NULL, NULL, /*seed*/ 3, &comm);
    return last_logZ;
}

static int setup_called = 0;
static void setup(void) { setup_called = 1; }

int run_ini(const char *ini) {
    char path[512];
    strncpy(path, ini, 511);
    int comm = 0;
    polychord_c_interface_ini(loglike, setup, path, &comm);
    return setup_called;
}

int dumper_count(void) { return dumper_calls; }
int like_count(void) { return like_calls; }
"""

INI = """
[ algorithm settings ]
nlive = 50
num_repeats = 4
do_clustering = F
precision_criterion = 0.01
[ output settings ]
base_dir = %(base)s
file_root = capini
write_resume = F
read_resume = F
feedback = 0
seed = 4
max_ndead = 400
[ prior settings ]
P : p1 | \\theta_{1} | 1 | uniform | 1 | 0.0 1.0
P : p2 | \\theta_{2} | 1 | uniform | 1 | 0.0 1.0
"""


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    """The shim and DRIVER in one shared object, loaded with PyDLL."""
    src = tmp_path_factory.mktemp("capi") / "driver.c"
    src.write_text(DRIVER)
    lib = ctypes.PyDLL(str(cabi.build_in_process("test_capi_driver", [src])))
    lib.run_gaussian.restype = ctypes.c_double
    lib.run_gaussian.argtypes = [ctypes.c_char_p]
    lib.run_ini.argtypes = [ctypes.c_char_p]
    return lib


def test_c_interface_end_to_end(driver, tmp_path, monkeypatch):
    """polychord_c_interface: the C likelihood, prior and dumper through
    the port on the CPU, on the host route's plain version (engine "scan"),
    every call of the C likelihood counted by the run; logZ near the
    analytic 0, the dumper seeing the run's evidence."""
    monkeypatch.setattr(capi, "DEVICE", "cpu")
    chains = tmp_path / "chains"
    (chains / "clusters").mkdir(parents=True)
    calls0 = driver.like_count()
    logZ = driver.run_gaussian(str(chains).encode())
    po = PolyChordOutput(str(chains), "capi")
    assert driver.dumper_count() >= 2 and abs(logZ - po.logZ) < 1e-9
    assert abs(po.logZ) < 3 * po.logZerr + 0.2
    last = json.loads((chains / "capi.metrics.jsonl").read_text().splitlines()[-1])
    assert (last["engine"], last["route"]) == ("scan", "slice_step_host")
    assert 0 < last["host_calls"] <= driver.like_count() - calls0


def test_c_interface_ini(driver, tmp_path, monkeypatch):
    """polychord_c_interface_ini: settings and the block prior from the ini
    (a torch prior, run on the host as a batch), the C likelihood, the
    setup hook called first."""
    monkeypatch.setattr(capi, "DEVICE", "cpu")
    chains = tmp_path / "chains"
    (chains / "clusters").mkdir(parents=True)
    ini = tmp_path / "run.ini"
    ini.write_text(INI % {"base": chains})
    assert driver.run_ini(str(ini).encode()) == 1
    po = PolyChordOutput(str(chains), "capini")
    assert math.isfinite(po.logZ) and po.ndead >= 400


def test_device_is_the_card_by_default():
    assert capi.DEVICE is None


def test_cc_example_and_mpi_overloads_compile(tmp_path):
    """examples/cc/gaussian_cc.cpp, unchanged, and the reference's MPI
    overload set (a pointer and an integer communicator, as in the JAX
    package's test) compile against the port's polychord.hpp."""
    src = tmp_path / "comm_shim.cpp"
    src.write_text(r"""
#include "polychord.hpp"
struct fake_ompi_comm_t {};
typedef fake_ompi_comm_t *PtrComm;
typedef int IntComm;
static double lik(double *, int, double *, int) { return 0.0; }
static void pri(double *c, double *t, int n) { for (int i=0;i<n;i++) t[i]=c[i]; }
static void dmp(int, int, int, double *, double *, double *, double, double) {}
static void setup() {}
template <typename C> void call_all(C &comm) {
    Settings s(2, 0);
    run_polychord(lik, pri, dmp, s, comm);
    run_polychord(lik, dmp, s, comm);
    run_polychord(lik, pri, s, comm);
    run_polychord(lik, s, comm);
    run_polychord(lik, setup, std::string("x.ini"), comm);
}
int main() {
    PtrComm pc = nullptr; IntComm ic = 42;
    if (false) { call_all(pc); call_all(ic); }
    return 0;
}
""")
    for cpp in (src, cabi.EXAMPLE):
        subprocess.run(["g++", "-fsyntax-only", "-I", str(cabi.CABI), str(cpp)], check=True,
                       capture_output=True, timeout=120)


def test_embedded_commands_name_the_port():
    """The embedded-mode commands (the Makefile's targets) compile the
    port's shim and the unchanged example against the port's headers, and
    link the running interpreter's libpython."""
    cmds = cabi.commands("cc_example")
    flat = " ".join(" ".join(c) for c in cmds)
    assert str(cabi.CABI / "capi.c") in flat and str(cabi.EXAMPLE) in flat
    assert f"-I{cabi.CABI}" in cmds[-1] and any(a.startswith("-lpython") for a in cmds[-1])
    assert os.path.basename(cmds[-1][cmds[-1].index("-o") + 1]) == "gaussian_cc"
