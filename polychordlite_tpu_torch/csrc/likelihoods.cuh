// Likelihood functors of the slice-epoch kernels (slice_epoch.cu,
// slice_epoch_v2.cu, slice_epoch_v3.cu, slice_epoch_v3_instr.cu,
// slice_epoch_v5.cu).
//
// A functor returns the logL of the probe x0 + t n̂ with calculate_point's
// semantics: a probe outside the unit cube, or a NaN, gives logzero.  Each
// one applies a per-coordinate affine prior, theta[d] = a[d] + s[d] * cube[d]
// (priors.py), and then does the float operations of its torch likelihood
// (models/examples.py) in the same order: every add, multiply and divide is
// an explicitly rounded intrinsic (and the files are built with
// --fmad=false); sqrtf, expf, log1pf and cosf are the full-precision
// library calls, as torch's own kernels call them.  So a functor agrees with
// the torch calc bit for bit, which ops/pallas_slice_v4.py::validate_functor
// checks before a run uses it.  Sums run over coordinates in index order,
// starting from the first term where the torch form does.
#pragma once

#include "slice_common.cuh"

// theta[d] = a[d] + s[d] * cube[d]; entries past D are unused.
struct AffinePrior {
    float a[SLICE_MAXD];
    float s[SLICE_MAXD];
};

// random_gaussian's inverse covariance, row-major D x D: 4 KB at D = 32,
// too large for the functor (kernel parameters), so it is copied into
// constant memory on the launch's stream before the kernel.
__constant__ float c_like_matrix[SLICE_MAXD * SLICE_MAXD];

// theta_d of the probe x0 + t n̂; clears `inside` if its cube coordinate
// leaves [0, 1].
__device__ __forceinline__ float probe_theta(const AffinePrior& prior, const float* x0,
                                             const float* n, float t, int d,
                                             bool& inside) {
    const float p = __fadd_rn(x0[d], __fmul_rn(t, n[d]));
    inside = inside && (p >= 0.0f) && (p <= 1.0f);
    return __fadd_rn(__fmul_rn(p, prior.s[d]), prior.a[d]);
}

__device__ __forceinline__ float like_result(float logL, bool inside, float logzero) {
    if (logL != logL) logL = logzero;
    return inside ? logL : logzero;
}

// logaddexp(l1, l2) - log 2, spelled out as torch's form does it.
__device__ __forceinline__ float mix_of_two(float l1, float l2, float log_two) {
    const float m = fmaxf(l1, l2);
    const float e = expf(-fabsf(__fsub_rn(l1, l2)));
    return __fsub_rn(__fadd_rn(m, log1pf(e)), log_two);
}

// cosf once per call site: kept out of line so that the unrolled loops over
// SLICE_MAXD coordinates do not copy its range reduction 32 times.
__device__ __noinline__ float like_cosf(float x) { return cosf(x); }

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
                const float th = probe_theta(prior, x0, n, t, d, inside);
                const float z = __fdiv_rn(__fsub_rn(th, mu), sigma);
                chi2 = __fadd_rn(chi2, __fmul_rn(z, z));
            }
        }
        return like_result(__fsub_rn(norm, __fmul_rn(0.5f, chi2)), inside, logzero);
    }
};

// Two Gaussian shells centred at x_1 = -centre and +centre
// (models/examples.py::gaussian_shells): rest = sum of theta_d^2 over
// d = 1..D-1 in index order, the two radii, each shell's logL, and their
// mixture.
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
                const float th = probe_theta(prior, x0, n, t, d, inside);
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
        return like_result(mix_of_two(l1, l2, log_two), inside, logzero);
    }
};

// models/examples.py::half_gaussian: the Gaussian with the first
// coordinate's mean at 0 (a half-Gaussian on [0, 1]).
struct HalfGaussianLike {
    AffinePrior prior;
    float mu, sigma, norm, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float chi2 = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float th = probe_theta(prior, x0, n, t, d, inside);
                const float z = __fdiv_rn(__fsub_rn(th, d == 0 ? 0.0f : mu), sigma);
                chi2 = __fadd_rn(chi2, __fmul_rn(z, z));
            }
        }
        return like_result(__fsub_rn(norm, __fmul_rn(0.5f, chi2)), inside, logzero);
    }
};

// models/examples.py::pyramidal: norm - max_d(|theta_d - mu| / sigma)^2 / factor.
struct PyramidalLike {
    AffinePrior prior;
    float mu, sigma, norm, factor, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float m = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float th = probe_theta(prior, x0, n, t, d, inside);
                const float z = __fdiv_rn(fabsf(__fsub_rn(th, mu)), sigma);
                m = d == 0 ? z : fmaxf(m, z);
            }
        }
        const float q = __fdiv_rn(__fmul_rn(m, m), factor);
        return like_result(__fsub_rn(norm, q), inside, logzero);
    }
};

// models/examples.py::rastrigin: -sum_d (log_norm + theta_d^2 - A cos(2 pi theta_d)),
// with 2 pi the float32 of the torch form's Python constant.
struct RastriginLike {
    AffinePrior prior;
    float log_norm, A, two_pi, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float total = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float th = probe_theta(prior, x0, n, t, d, inside);
                const float c = like_cosf(__fmul_rn(th, two_pi));
                const float term =
                    __fsub_rn(__fadd_rn(__fmul_rn(th, th), log_norm), __fmul_rn(c, A));
                total = d == 0 ? term : __fadd_rn(total, term);
            }
        }
        return like_result(-total, inside, logzero);
    }
};

// models/examples.py::twin_gaussian: an equal mixture of two Gaussians at
// (-off, -off, 0, ...) and (+off, +off, 0, ...).
struct TwinGaussianLike {
    AffinePrior prior;
    float off, sigma, norm, log_two, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float c1 = 0.0f, c2 = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float th = probe_theta(prior, x0, n, t, d, inside);
                const float z1 = __fdiv_rn(__fsub_rn(th, d < 2 ? -off : 0.0f), sigma);
                const float z2 = __fdiv_rn(__fsub_rn(th, d < 2 ? off : 0.0f), sigma);
                c1 = d == 0 ? __fmul_rn(z1, z1) : __fadd_rn(c1, __fmul_rn(z1, z1));
                c2 = d == 0 ? __fmul_rn(z2, z2) : __fadd_rn(c2, __fmul_rn(z2, z2));
            }
        }
        const float l1 = __fsub_rn(norm, __fmul_rn(0.5f, c1));
        const float l2 = __fsub_rn(norm, __fmul_rn(0.5f, c2));
        return like_result(mix_of_two(l1, l2, log_two), inside, logzero);
    }
};

// models/examples.py::himmelblau: norm - (x^2 + y - 11)^2 - (x + y^2 - 7)^2
// on the first two coordinates.
struct HimmelblauLike {
    AffinePrior prior;
    float norm, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float th0 = 0.0f, th1 = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float th = probe_theta(prior, x0, n, t, d, inside);
                if (d == 0) th0 = th;
                if (d == 1) th1 = th;
            }
        }
        const float a = __fsub_rn(__fadd_rn(__fmul_rn(th0, th0), th1), 11.0f);
        const float b = __fsub_rn(__fadd_rn(th0, __fmul_rn(th1, th1)), 7.0f);
        const float logL = __fsub_rn(__fsub_rn(norm, __fmul_rn(a, a)), __fmul_rn(b, b));
        return like_result(logL, inside, logzero);
    }
};

// models/examples.py::rosenbrock: norm - sum_{d<D-1} ((a - theta_d)^2 +
// b (theta_{d+1} - theta_d^2)^2).
struct RosenbrockLike {
    AffinePrior prior;
    float a, b, norm, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float prev = 0.0f, total = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float th = probe_theta(prior, x0, n, t, d, inside);
                if (d > 0) {
                    const float u = __fsub_rn(a, prev);
                    const float v = __fsub_rn(th, __fmul_rn(prev, prev));
                    const float term = __fadd_rn(__fmul_rn(u, u), __fmul_rn(__fmul_rn(v, v), b));
                    total = d == 1 ? term : __fadd_rn(total, term);
                }
                prev = th;
            }
        }
        return like_result(__fsub_rn(norm, total), inside, logzero);
    }
};

// models/examples.py::eggbox: -(2 + prod_d cos(theta_d / 2))^5, the fifth
// power as q * (q^2)^2 (JAX's integer_pow order).
struct EggboxLike {
    AffinePrior prior;
    float logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float p = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float th = probe_theta(prior, x0, n, t, d, inside);
                const float c = like_cosf(__fdiv_rn(th, 2.0f));
                p = d == 0 ? c : __fmul_rn(p, c);
            }
        }
        const float q = __fadd_rn(p, 2.0f);
        const float q2 = __fmul_rn(q, q);
        const float q5 = __fmul_rn(q, __fmul_rn(q2, q2));
        return like_result(-q5, inside, logzero);
    }
};

// models/examples.py::gaussian_shell: one shell at the origin,
// -A - (|theta| - radius)^2 / (2 sigma^2).
struct GaussianShellLike {
    AffinePrior prior;
    float radius, two_s2, neg_a, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d) {
            if (d < D) {
                const float th = probe_theta(prior, x0, n, t, d, inside);
                s = d == 0 ? __fmul_rn(th, th) : __fadd_rn(s, __fmul_rn(th, th));
            }
        }
        const float dr = __fsub_rn(sqrtf(s), radius);
        const float logL = __fsub_rn(neg_a, __fdiv_rn(__fmul_rn(dr, dr), two_s2));
        return like_result(logL, inside, logzero);
    }
};

// models/examples.py::random_gaussian: norm - q / 2 with the quadratic form
// q = sum_i d_i (sum_j M_ij d_j), d = theta - mu, both sums in index order
// from 0, M = c_like_matrix.  The d_j are indexed at run time, so they go
// to local memory (this functor only).
struct RandomGaussianLike {
    AffinePrior prior;
    float mu, norm, logzero;

    __device__ __forceinline__ float operator()(const float* x0, const float* n,
                                                float t, int D) const {
        bool inside = true;
        float dv[SLICE_MAXD];
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d)
            if (d < D) dv[d] = __fsub_rn(probe_theta(prior, x0, n, t, d, inside), mu);
        float q = 0.0f;
        for (int i = 0; i < D; ++i) {
            float row = 0.0f;
            for (int j = 0; j < D; ++j)
                row = __fadd_rn(row, __fmul_rn(c_like_matrix[i * D + j], dv[j]));
            q = __fadd_rn(q, __fmul_rn(dv[i], row));
        }
        return like_result(__fsub_rn(norm, __fmul_rn(0.5f, q)), inside, logzero);
    }
};

// Functor ids of the extern "C" entries (ops/pallas_slice_v4.py::FUNCTORS).
enum {
    LIKE_GAUSSIAN = 0,
    LIKE_GAUSSIAN_SHELLS = 1,
    LIKE_HALF_GAUSSIAN = 2,
    LIKE_PYRAMIDAL = 3,
    LIKE_RASTRIGIN = 4,
    LIKE_TWIN_GAUSSIAN = 5,
    LIKE_HIMMELBLAU = 6,
    LIKE_ROSENBROCK = 7,
    LIKE_EGGBOX = 8,
    LIKE_GAUSSIAN_SHELL = 9,
    LIKE_RANDOM_GAUSSIAN = 10,
};

// Build the functor `id` from host arrays — its constants c[], the prior's
// a[D] and s[D] — and call launch(functor).  random_gaussian's c[] ends
// with its D x D matrix, which goes to c_like_matrix on `stream` first.
// Returns 0, a CUDA error of that copy, or cudaErrorInvalidValue for an
// unknown id.
template <class Launch>
int with_likelihood(int id, const float* c, const float* prior_a,
                    const float* prior_s, int D, float logzero, cudaStream_t stream,
                    Launch&& launch) {
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
        case LIKE_HALF_GAUSSIAN:
            launch(HalfGaussianLike{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_PYRAMIDAL:
            launch(PyramidalLike{prior, c[0], c[1], c[2], c[3], logzero});
            return 0;
        case LIKE_RASTRIGIN:
            launch(RastriginLike{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_TWIN_GAUSSIAN:
            launch(TwinGaussianLike{prior, c[0], c[1], c[2], c[3], logzero});
            return 0;
        case LIKE_HIMMELBLAU:
            launch(HimmelblauLike{prior, c[0], logzero});
            return 0;
        case LIKE_ROSENBROCK:
            launch(RosenbrockLike{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_EGGBOX:
            launch(EggboxLike{prior, logzero});
            return 0;
        case LIKE_GAUSSIAN_SHELL:
            launch(GaussianShellLike{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_RANDOM_GAUSSIAN: {
            const cudaError_t e = cudaMemcpyToSymbolAsync(
                c_like_matrix, c + 2, sizeof(float) * D * D, 0, cudaMemcpyHostToDevice,
                stream);
            if (e != cudaSuccess) return (int)e;
            launch(RandomGaussianLike{prior, c[0], c[1], logzero});
            return 0;
        }
        default:
            return (int)cudaErrorInvalidValue;
    }
}
