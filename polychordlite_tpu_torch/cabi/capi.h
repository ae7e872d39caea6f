/* C interface to the polychordlite_tpu_torch nested sampler.
 *
 * Drop-in analogue of the reference's C ABI (PolyChordLite
 * src/polychord/interfaces.h / interfaces.F90:285 polychord_c_interface):
 * same callback signatures, same 38-argument order.  The trailing
 * communicator argument is accepted for source compatibility and ignored:
 * one process drives the card, not MPI.
 *
 * The implementation embeds a CPython interpreter (capi.c), so the
 * linking application must be able to resolve libpython (link with
 * `python3-config --embed --ldflags`) and PYTHONPATH must reach the
 * polychordlite_tpu_torch package and its dependencies (torch, numpy).
 * The callbacks run on the host; the run goes to the CUDA card unless
 * polychordlite_tpu_torch.capi.DEVICE says otherwise.
 */
#pragma once
#include <stdbool.h>

#ifdef __cplusplus
extern "C" {
#endif

void polychord_c_interface(
    /* loglikelihood(theta, nDims, phi, nDerived) -> logL */
    double (*loglikelihood)(double *, int, double *, int),
    /* prior(cube, theta, nDims): fill theta from unit hypercube */
    void (*prior)(double *, double *, int),
    /* dumper(ndead, nlive, npars, live, dead, logweights, logZ, logZerr) */
    void (*dumper)(int, int, int, double *, double *, double *, double, double),
    int nlive,
    int num_repeats,
    int nprior,
    int nfail,
    bool do_clustering,
    int feedback,
    double precision_criterion,
    double logzero,
    int max_ndead,
    double boost_posterior,
    bool posteriors,
    bool equals,
    bool cluster_posteriors,
    bool write_resume,
    bool write_paramnames,
    bool read_resume,
    bool write_stats,
    bool write_live,
    bool write_dead,
    bool write_prior,
    bool maximise,
    double compression_factor,
    bool synchronous,
    int nDims,
    int nDerived,
    char *base_dir,
    char *file_root,
    int nGrade,
    double *grade_frac,
    int *grade_dims,
    int n_nlives,
    double *loglikes,
    int *nlives,
    int seed,
    int *comm /* ignored */);

/* ini-file variant (interfaces.F90:496 polychord_c_interface_ini):
 * settings, priors and parameter names come from the ini file. */
void polychord_c_interface_ini(
    double (*loglikelihood)(double *, int, double *, int),
    void (*setup_loglikelihood)(void),
    char *inifile,
    int *comm /* ignored */);

#ifdef __cplusplus
}
#endif
