/* C++ API implementation: marshal the typed Settings into the flat C ABI
 * (capi.h polychord_c_interface — the 38-argument order of the
 * reference's interfaces.F90:285 bind(c) routine). */
#include "polychord.hpp"

#include <vector>

extern "C" {
#include "capi.h"
}

Settings::Settings(int _nDims, int _nDerived)
    : nDims{_nDims},
      nDerived{_nDerived},
      nlive{25 * _nDims},
      num_repeats{5 * _nDims},
      nprior{-1},
      nfail{-1},
      do_clustering{true},
      feedback{1},
      precision_criterion{0.001},
      logzero{-1e30},
      max_ndead{-1},
      boost_posterior{0.0},
      posteriors{true},
      equals{true},
      cluster_posteriors{true},
      write_resume{true},
      write_paramnames{false},
      read_resume{true},
      write_stats{true},
      write_live{true},
      write_dead{true},
      write_prior{true},
      maximise{false},
      compression_factor{0.36787944117144233},
      synchronous{true},
      base_dir{"chains"},
      file_root{"test"},
      grade_frac{1.0},
      grade_dims{_nDims},
      nlives{},
      seed{-1} {}

void run_polychord(pc_loglikelihood loglikelihood, pc_prior prior,
                   pc_dumper dumper, Settings s, void * /*comm*/) {
    std::vector<char> base_dir(s.base_dir.begin(), s.base_dir.end());
    base_dir.push_back('\0');
    std::vector<char> file_root(s.file_root.begin(), s.file_root.end());
    file_root.push_back('\0');

    std::vector<double> loglikes;
    std::vector<int> nlives;
    for (const auto &kv : s.nlives) {
        loglikes.push_back(kv.first);
        nlives.push_back(kv.second);
    }
    int comm = 0;

    polychord_c_interface(
        loglikelihood, prior, dumper, s.nlive, s.num_repeats, s.nprior,
        s.nfail, s.do_clustering, s.feedback, s.precision_criterion,
        s.logzero, s.max_ndead, s.boost_posterior, s.posteriors, s.equals,
        s.cluster_posteriors, s.write_resume, s.write_paramnames,
        s.read_resume, s.write_stats, s.write_live, s.write_dead,
        s.write_prior, s.maximise, s.compression_factor, s.synchronous,
        s.nDims, s.nDerived, base_dir.data(), file_root.data(),
        static_cast<int>(s.grade_frac.size()), s.grade_frac.data(),
        s.grade_dims.data(), static_cast<int>(loglikes.size()),
        loglikes.data(), nlives.data(), s.seed, &comm);
}

void run_polychord(pc_loglikelihood loglikelihood, pc_dumper dumper,
                   Settings s, void *comm) {
    run_polychord(loglikelihood, default_prior, dumper, s, comm);
}

void run_polychord(pc_loglikelihood loglikelihood, pc_prior prior,
                   Settings s, void *comm) {
    run_polychord(loglikelihood, prior, default_dumper, s, comm);
}

void run_polychord(pc_loglikelihood loglikelihood, Settings s, void *comm) {
    run_polychord(loglikelihood, default_prior, default_dumper, s, comm);
}

void run_polychord(pc_loglikelihood loglikelihood,
                   void (*setup_loglikelihood)(), std::string inifile,
                   void * /*comm*/) {
    std::vector<char> ini(inifile.begin(), inifile.end());
    ini.push_back('\0');
    int comm = 0;
    polychord_c_interface_ini(loglikelihood, setup_loglikelihood, ini.data(),
                              &comm);
}

double default_loglikelihood(double *, int, double *, int) { return 0.0; }

void default_prior(double *cube, double *theta, int nDims) {
    for (int i = 0; i < nDims; i++) theta[i] = cube[i];
}

void default_dumper(int, int, int, double *, double *, double *, double,
                    double) {}
