/* C ABI of polychordlite_tpu_torch — embeds CPython (or runs inside the
 * Python process that loaded it) and forwards to
 * polychordlite_tpu_torch.capi.run_from_c / run_from_c_ini.
 *
 * Mirrors the reference's polychord_c_interface (interfaces.F90:285-436):
 * the three C callbacks cross into Python as raw addresses and are wrapped
 * by ctypes on the Python side, where a run calls them on the host between
 * the slice kernel's launches.  The interpreter is initialised on the
 * first call unless it is running already (a process that loaded this
 * library through ctypes.PyDLL, which holds the GIL across the call), and
 * kept alive.  The device of the run is polychordlite_tpu_torch.capi.DEVICE
 * (None: the CUDA card).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdbool.h>
#include <stdio.h>

static int ensure_python(void) {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0); /* PYTHONPATH must reach the package */
    }
    return Py_IsInitialized() ? 0 : -1;
}

static PyObject *get_entry(const char *name) {
    PyObject *mod = PyImport_ImportModule("polychordlite_tpu_torch.capi");
    if (!mod) {
        PyErr_Print();
        return NULL;
    }
    PyObject *fn = PyObject_GetAttrString(mod, name);
    Py_DECREF(mod);
    if (!fn) PyErr_Print();
    return fn;
}

void polychord_c_interface(
    double (*loglikelihood)(double *, int, double *, int),
    void (*prior)(double *, double *, int),
    void (*dumper)(int, int, int, double *, double *, double *, double, double),
    int nlive, int num_repeats, int nprior, int nfail, bool do_clustering,
    int feedback, double precision_criterion, double logzero, int max_ndead,
    double boost_posterior, bool posteriors, bool equals,
    bool cluster_posteriors, bool write_resume, bool write_paramnames,
    bool read_resume, bool write_stats, bool write_live, bool write_dead,
    bool write_prior, bool maximise, double compression_factor,
    bool synchronous, int nDims, int nDerived, char *base_dir,
    char *file_root, int nGrade, double *grade_frac, int *grade_dims,
    int n_nlives, double *loglikes, int *nlives, int seed, int *comm) {
    (void)comm; /* one process drives the card: no MPI */
    if (ensure_python()) {
        fprintf(stderr, "polychord_c_interface: Python init failed\n");
        return;
    }
    PyObject *fn = get_entry("run_from_c");
    if (!fn) return;
    PyObject *res = PyObject_CallFunction(
        fn,
        "LLL iiii i i dd i d iiiiiiiiiii d i ii ss iLL iLL i",
        (long long)(intptr_t)loglikelihood, (long long)(intptr_t)prior,
        (long long)(intptr_t)dumper, nlive, num_repeats, nprior, nfail,
        (int)do_clustering, feedback, precision_criterion, logzero, max_ndead,
        boost_posterior, (int)posteriors, (int)equals, (int)cluster_posteriors,
        (int)write_resume, (int)write_paramnames, (int)read_resume,
        (int)write_stats, (int)write_live, (int)write_dead, (int)write_prior,
        (int)maximise, compression_factor, (int)synchronous, nDims, nDerived,
        base_dir, file_root, nGrade, (long long)(intptr_t)grade_frac,
        (long long)(intptr_t)grade_dims, n_nlives,
        (long long)(intptr_t)loglikes, (long long)(intptr_t)nlives, seed);
    Py_DECREF(fn);
    if (!res) PyErr_Print();
    Py_XDECREF(res);
}

void polychord_c_interface_ini(
    double (*loglikelihood)(double *, int, double *, int),
    void (*setup_loglikelihood)(void), char *inifile, int *comm) {
    (void)comm;
    if (ensure_python()) {
        fprintf(stderr, "polychord_c_interface_ini: Python init failed\n");
        return;
    }
    if (setup_loglikelihood) setup_loglikelihood();
    PyObject *fn = get_entry("run_from_c_ini");
    if (!fn) return;
    PyObject *res = PyObject_CallFunction(
        fn, "Ls", (long long)(intptr_t)loglikelihood, inifile);
    Py_DECREF(fn);
    if (!res) PyErr_Print();
    Py_XDECREF(res);
}
