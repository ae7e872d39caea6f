/* C++ API for the polychordlite_tpu_torch nested sampler.
 *
 * Typed analogue of the reference's C++ layer (PolyChordLite
 * src/polychord/interfaces.hpp Settings + the run_polychord overload set,
 * c_interface.cpp:44-208), implemented over this package's flat C ABI
 * (capi.h).  Differences by design:
 *
 *  - ONE set of defaults across every surface (SURVEY §5.6): this Settings
 *    carries the Python layer's defaults (nlive = 25*nDims, clustering on,
 *    writes on, maximise off) instead of the reference C++ layer's divergent
 *    set (c_interface.cpp:6-39: nlive=500, writes off, maximise=true).
 *  - No MPI_Comm overloads: one process drives the card.  A trailing
 *    `void* comm` is accepted and ignored on every overload for source
 *    compatibility with reference call sites.
 */
#pragma once
#include <map>
#include <string>
#include <vector>

struct Settings {
    int nDims;
    int nDerived;
    int nlive;
    int num_repeats;
    int nprior;
    int nfail;
    bool do_clustering;
    int feedback;
    double precision_criterion;
    double logzero;
    int max_ndead;
    double boost_posterior;
    bool posteriors;
    bool equals;
    bool cluster_posteriors;
    bool write_resume;
    bool write_paramnames;
    bool read_resume;
    bool write_stats;
    bool write_live;
    bool write_dead;
    bool write_prior;
    bool maximise;
    double compression_factor;
    bool synchronous;
    std::string base_dir;
    std::string file_root;
    std::vector<double> grade_frac;
    std::vector<int> grade_dims;
    /* variable-nlive schedule: logL threshold -> target nlive
     * (settings.f90 nlives/loglikes pair, kept as one map here) */
    std::map<double, int> nlives;
    int seed;

    Settings(int nDims = 0, int nDerived = 0);
};

typedef double (*pc_loglikelihood)(double *, int, double *, int);
typedef void (*pc_prior)(double *, double *, int);
typedef void (*pc_dumper)(int, int, int, double *, double *, double *,
                          double, double);

/* full form + convenience overloads (reference interfaces.hpp set) */
void run_polychord(pc_loglikelihood loglikelihood, pc_prior prior,
                   pc_dumper dumper, Settings s, void *comm = nullptr);
void run_polychord(pc_loglikelihood loglikelihood, pc_dumper dumper,
                   Settings s, void *comm = nullptr);
void run_polychord(pc_loglikelihood loglikelihood, pc_prior prior,
                   Settings s, void *comm = nullptr);
void run_polychord(pc_loglikelihood loglikelihood, Settings s,
                   void *comm = nullptr);
/* ini-file form: settings, priors and parameter names from the ini file
 * (reference c_interface.cpp:168-206 -> polychord_c_interface_ini) */
void run_polychord(pc_loglikelihood loglikelihood,
                   void (*setup_loglikelihood)(), std::string inifile,
                   void *comm = nullptr);

double default_loglikelihood(double *, int, double *, int);
void default_prior(double *, double *, int);
void default_dumper(int, int, int, double *, double *, double *, double,
                    double);

/* Source-compat shims for the reference's USE_MPI overload set
 * (interfaces.hpp:67-88: the same five signatures with a trailing
 * `MPI_Comm &comm`).  One process drives the card, so the communicator
 * is accepted and IGNORED — but as a template
 * the shims compile against any MPI implementation's MPI_Comm (pointer
 * typedefs like OpenMPI's and integer typedefs like MPICH's alike)
 * without this header depending on <mpi.h>.  Porting a reference C++
 * driver is zero-diff. */
template <typename Comm>
inline void run_polychord(pc_loglikelihood loglikelihood, pc_prior prior,
                          pc_dumper dumper, Settings s, Comm &comm) {
    (void)comm;
    run_polychord(loglikelihood, prior, dumper, s);
}
template <typename Comm>
inline void run_polychord(pc_loglikelihood loglikelihood, pc_dumper dumper,
                          Settings s, Comm &comm) {
    (void)comm;
    run_polychord(loglikelihood, dumper, s);
}
template <typename Comm>
inline void run_polychord(pc_loglikelihood loglikelihood, pc_prior prior,
                          Settings s, Comm &comm) {
    (void)comm;
    run_polychord(loglikelihood, prior, s);
}
template <typename Comm>
inline void run_polychord(pc_loglikelihood loglikelihood, Settings s,
                          Comm &comm) {
    (void)comm;
    run_polychord(loglikelihood, s);
}
template <typename Comm>
inline void run_polychord(pc_loglikelihood loglikelihood,
                          void (*setup_loglikelihood)(), std::string inifile,
                          Comm &comm) {
    (void)comm;
    run_polychord(loglikelihood, setup_loglikelihood, inifile);
}
