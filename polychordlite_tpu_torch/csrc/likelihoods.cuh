// Likelihood functors of the slice-epoch kernels (slice_epoch.cu,
// slice_epoch_v5.cu).
//
// A functor returns the logL of the probe x0 + t n̂ with calculate_point's
// semantics: a probe outside the unit cube, or a NaN, gives logzero.  Each
// one applies a per-coordinate affine prior, theta[d] = a[d] + s[d] * cube[d]
// (priors.py), and then does the float operations of its torch likelihood
// (models/examples.py) in the same order: every add, multiply and divide is
// an explicitly rounded intrinsic (and the files are built with
// --fmad=false); sqrtf, expf and log1pf are the full-precision library
// calls, as torch's own kernels call them.  So a functor agrees with the
// torch calc bit for bit, which ops/pallas_slice_v4.py::validate_functor
// checks before a run uses it.
#pragma once

#include "slice_common.cuh"

// theta[d] = a[d] + s[d] * cube[d]; entries past D are unused.
struct AffinePrior {
    float a[SLICE_MAXD];
    float s[SLICE_MAXD];
};

// The normalised Gaussian (models/examples.py::gaussian): the chi-square
// summed over coordinates 0..D-1 in index order.
struct GaussianLike {
    AffinePrior prior;
    float mu, sigma, norm, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float chi2 = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float p = __fadd_rn(x0[d], __fmul_rn(t, n[d]));
                inside = inside && (p >= 0.0f) && (p <= 1.0f);
                const float th = __fadd_rn(__fmul_rn(p, prior.s[d]), prior.a[d]);
                const float z = __fdiv_rn(__fsub_rn(th, mu), sigma);
                chi2 = __fadd_rn(chi2, __fmul_rn(z, z));
            }
        }
        float logL = __fsub_rn(norm, __fmul_rn(0.5f, chi2));
        if (logL != logL) logL = logzero;
        return inside ? logL : logzero;
    }
};

// Two Gaussian shells centred at x_1 = -centre and +centre
// (models/examples.py::gaussian_shells): rest = sum of theta_d^2 over
// d = 1..D-1 in index order, the two radii, each shell's logL, and
// logaddexp spelled out as max + log1p(exp(-|l1 - l2|)), minus log 2.
struct GaussianShellsLike {
    AffinePrior prior;
    float centre, radius, two_s2, neg_a, log_two, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float th0 = 0.0f, rest = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float p = __fadd_rn(x0[d], __fmul_rn(t, n[d]));
                inside = inside && (p >= 0.0f) && (p <= 1.0f);
                const float th = __fadd_rn(__fmul_rn(p, prior.s[d]), prior.a[d]);
                if (d == 0)
                    th0 = th;
                else
                    rest = __fadd_rn(rest, __fmul_rn(th, th));
            }
        }
        const float c1 = __fadd_rn(th0, centre);
        const float c2 = __fsub_rn(th0, centre);
        const float r1 = sqrtf(__fadd_rn(__fmul_rn(c1, c1), rest));
        const float r2 = sqrtf(__fadd_rn(__fmul_rn(c2, c2), rest));
        const float d1 = __fsub_rn(r1, radius);
        const float d2 = __fsub_rn(r2, radius);
        const float l1 = __fsub_rn(neg_a, __fdiv_rn(__fmul_rn(d1, d1), two_s2));
        const float l2 = __fsub_rn(neg_a, __fdiv_rn(__fmul_rn(d2, d2), two_s2));
        const float m = fmaxf(l1, l2);
        const float e = expf(-fabsf(__fsub_rn(l1, l2)));
        float logL = __fsub_rn(__fadd_rn(m, log1pf(e)), log_two);
        if (logL != logL) logL = logzero;
        return inside ? logL : logzero;
    }
};

// Functor ids of the extern "C" entries (ops/pallas_slice_v4.py::FUNCTORS).
enum { LIKE_GAUSSIAN = 0, LIKE_GAUSSIAN_SHELLS = 1 };

// Build the functor `id` from host arrays — its constants c[], the prior's
// a[D] and s[D] — and call launch(functor).  Returns 0, or
// cudaErrorInvalidValue for an unknown id.
template <class Launch>
int with_likelihood(int id, const float* c, const float* prior_a,
                    const float* prior_s, int D, float logzero, Launch&& launch) {
    AffinePrior prior;
    for (int d = 0; d < SLICE_MAXD; ++d) {
        prior.a[d] = d < D ? prior_a[d] : 0.0f;
        prior.s[d] = d < D ? prior_s[d] : 0.0f;
    }
    switch (id) {
        case LIKE_GAUSSIAN:
            launch(GaussianLike{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_GAUSSIAN_SHELLS:
            launch(GaussianShellsLike{prior, c[0], c[1], c[2], c[3], c[4], logzero});
            return 0;
        default:
            return (int)cudaErrorInvalidValue;
    }
}
