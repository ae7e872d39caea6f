// Likelihood functors of the slice-epoch kernels (slice_epoch.cu,
// slice_epoch_v2.cu, slice_epoch_v3.cu, slice_epoch_v3_instr.cu,
// slice_epoch_v5.cu; the Gaussian also of prototypes.cu).
//
// A functor gives the logL of the probe x0 + t n̂ with calculate_point's
// semantics: a probe outside the unit cube, or a NaN, gives logzero.  Each
// one applies a per-coordinate affine prior, theta[d] = a[d] + s[d] * cube[d]
// (priors.py), and then does the float operations of its torch likelihood
// (models/examples.py) in the same order: every add, multiply and divide is
// an explicitly rounded intrinsic (and the files are built with
// --fmad=false); sqrtf, expf, log1pf and cosf are the full-precision
// library calls, as torch's own kernels call them.  So a functor agrees with
// the torch calc bit for bit, which ops/pallas_slice_v4.py::validate_functor
// checks before a run uses it.  Up to D = 32 sums (products, maxima) run
// over coordinates in index order, starting from the first term where the
// torch form does; above, in the lane order below.
//
// Each functor is written in two stages, so that the coordinates of one
// chain can be spread over the lanes of a group (slice_epoch.cu):
//   term(th, d, out)  the per-coordinate stage: the NT terms of coordinate
//                     d from its theta (for the Gaussian, the division and
//                     the square);
//   combine(T, D)     the combine: the functor's reductions over the terms
//                     T[j][d], d = 0..D-1 (fold, fold_next), and what
//                     follows.
// A functor whose terms couple coordinates exports theta itself and keeps
// its body in the combine (the shells, himmelblau, rosenbrock,
// random_gaussian).  like_eval runs both stages in one thread (every kernel
// but the grouped B1); slice_epoch.cu's group form runs the first on the
// lane that owns coordinate d and the second on every lane of the group.
// The rounded operations and their order are the same either way.
//
// Each functor is a template on its dimension bucket M (slice_common.cuh):
// SLICE_MAXD = 32 or SLICE_MAXD_WIDE = 128, the bound on D that sizes its
// prior and its loops, or SLICE_MAXD_STREAM, the stream bucket above 128,
// whose prior comes by pointer from a device buffer (prior_t) and whose
// loops run to the run-time D.  combine reads the terms through a view that
// the caller hands it, and its reductions are fold calls, overloaded on
// the view, which fix their order:
//   the 32 bucket: T[NT][SLICE_MAXD] in registers, every term on every lane
//     of the group; a reduction runs in index order.
//   above D = 32: a chain holds a whole warp, lane g owning the coordinates
//     d = g, g + 32, g + 64, ...; the view is LaneRegs (the 128 bucket: the
//     lane's own terms in registers) or LaneRows (the stream bucket: the
//     lane's entries of the chain's rows of shared memory).  A reduction
//     runs in the lane order: every lane folds the values of its own
//     coordinates in index order in registers, then a butterfly of
//     __shfl_xor_sync at offsets 16, 8, 4, 2, 1 (warp_fold, B2's wide
//     order).  So no lane adds D terms one after the other, and nothing is
//     staged in shared memory for the combine.
// A functor that reads T[j][d] at any d (himmelblau; random_gaussian, whose
// quadratic form couples every pair of coordinates, so it keeps its index
// order in every bucket; a generated functor that reads a fixed
// coordinate's terms) says STAGED = true, and above D = 32 like_eval then
// stages the chain's terms in shared memory, where the view's T[j] reads
// them.  The torch forms (models/examples.py::coordinate_fold) reduce in
// the same orders.
//
// The functors here are float32.  A functor's scalar type is the type of
// its logzero (real_of): the fused route's generated functor is double in a
// run at precision='highest', and the generic pieces below (the prior, the
// probe, like_eval) follow it.
#pragma once

#include <type_traits>
#include <utility>

#include "slice_common.cuh"

// The scalar type of a functor: float, or double for a functor generated at
// precision='highest' (ops/fused_like.py).
template <class Like>
using real_of = decltype(Like::logzero);

// theta[d] = a[d] + s[d] * cube[d] for d < MAXD, the bucket's bound on the
// dimension; entries past D are unused.
template <int MAXD, class T = float>
struct AffinePriorT {
    T a[MAXD];
    T s[MAXD];
};
using AffinePrior = AffinePriorT<SLICE_MAXD>;

// The stream bucket's prior: a[D] and s[D] in device memory (read through
// the cache), since D values of each would not fit the kernel's parameters.
template <class T = float>
struct DevicePriorT {
    const T* __restrict__ a;
    const T* __restrict__ s;
};

// The prior of a functor of the bucket MAXD: by value up to SLICE_MAXD_WIDE,
// by pointer in the stream bucket.
template <int MAXD, class T = float>
using prior_t = typename std::conditional<MAXD == SLICE_MAXD_STREAM, DevicePriorT<T>,
                                          AffinePriorT<MAXD, T>>::type;

// The prior from host arrays a[D] and s[D]; entries past D are zero.
template <int MAXD = SLICE_MAXD, class T = float>
inline AffinePriorT<MAXD, T> affine_prior(const T* prior_a, const T* prior_s, int D) {
    AffinePriorT<MAXD, T> prior;
    for (int d = 0; d < MAXD; ++d) {
        prior.a[d] = d < D ? prior_a[d] : T(0);
        prior.s[d] = d < D ? prior_s[d] : T(0);
    }
    return prior;
}

// The prior of the bucket MAXD from the host arrays a[D], s[D] (up to
// SLICE_MAXD_WIDE) or from the device array dev = [a (D), s (D)] (the
// stream bucket).
template <int MAXD, class T = float>
inline prior_t<MAXD, T> make_prior(const T* prior_a, const T* prior_s, const T* dev, int D) {
    if constexpr (MAXD == SLICE_MAXD_STREAM)
        return DevicePriorT<T>{dev, dev + D};
    else
        return affine_prior<MAXD, T>(prior_a, prior_s, D);
}

// theta of one coordinate of the probe x0 + t n̂ under the prior a + s cube;
// clears `inside` if the cube coordinate leaves [0, 1].
template <class T>
__device__ __forceinline__ T probe_theta(T x0, exactly<T> n, exactly<T> t, exactly<T> a,
                                         exactly<T> s, bool& inside) {
    const T p = rn_add(x0, rn_mul(t, n));
    inside = inside && (p >= T(0)) && (p <= T(1));
    return rn_add(rn_mul(p, s), a);
}

template <class T>
__device__ __forceinline__ T like_result(T logL, bool inside, exactly<T> logzero) {
    if (logL != logL) logL = logzero;
    return inside ? logL : logzero;
}

// Both stages in one thread: the logL of the probe x0 + t n̂ (x0, n indexed
// by coordinate).
template <class Like>
__device__ __forceinline__ real_of<Like> like_eval(const Like& like, const real_of<Like>* x0,
                                                   const real_of<Like>* n, real_of<Like> t,
                                                   int D) {
    using Real = real_of<Like>;
    bool inside = true;
    Real T[Like::NT][Like::MAXD];
#pragma unroll
    for (int d = 0; d < Like::MAXD; ++d) {
        if (d < D) {
            Real o[Like::NT];
            like.term(probe_theta(x0[d], n[d], t, like.prior.a[d], like.prior.s[d], inside), d,
                      o);
#pragma unroll
            for (int j = 0; j < Like::NT; ++j) T[j][d] = o[j];
        }
    }
    return like_result(like.combine(T, D), inside, like.logzero);
}

// Several values folded side by side, each with the fold's operation, so
// that reductions over the same coordinates share one pass in their order.
template <int N, class Real>
struct Many {
    Real v[N];
};
template <class T, class Op>
__device__ __forceinline__ T fold_op(Op op, T a, T b) {
    return op(a, b);
}
template <int N, class Real, class Op>
__device__ __forceinline__ Many<N, Real> fold_op(Op op, const Many<N, Real>& a,
                                                 const Many<N, Real>& b) {
    Many<N, Real> r;
#pragma unroll
    for (int i = 0; i < N; ++i) r.v[i] = op(a.v[i], b.v[i]);
    return r;
}

// ---- the 32 bucket's view: T[NT][SLICE_MAXD], a reduction in index order

// f(d) for the coordinates d = 0 .. D-1 in index order, unrolled over the
// bucket with a guard.
template <int MAXD, class F>
__device__ __forceinline__ void for_each_coordinate(int D, F&& f) {
    static_assert(MAXD == SLICE_MAXD, "above SLICE_MAXD a reduction runs in the lane order");
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
        if (d < D) f(d);
}

template <class Real, int NT, int M>
__device__ __forceinline__ void terms_of(const Real (&T)[NT][M], int d, Real* o) {
#pragma unroll
    for (int j = 0; j < NT; ++j) o[j] = T[j][d];
}

// op over item(o, d), o the NT terms of coordinate d, for d = 0 .. D-1: from
// the first item, or from init (the leftmost operand) where one is given.
// An item may be a Many (each value folded with op).
template <class Real, int NT, int M, class Item, class Op>
__device__ __forceinline__ auto fold(const Real (&T)[NT][M], int D, Item&& item, Op op) {
    decltype(item(std::declval<const Real*>(), 0)) acc{};
    for_each_coordinate<M>(D, [&](int d) {
        Real o[NT];
        terms_of(T, d, o);
        const auto x = item(o, d);
        acc = d == 0 ? x : fold_op(op, acc, x);
    });
    return acc;
}
template <class Real, int NT, int M, class Item, class Op>
__device__ __forceinline__ Real fold(const Real (&T)[NT][M], int D, exactly<Real> init,
                                     Item&& item, Op op) {
    Real acc = init;
    for_each_coordinate<M>(D, [&](int d) {
        Real o[NT];
        terms_of(T, d, o);
        acc = op(acc, item(o, d));
    });
    return acc;
}

// op over item(t_d, t_{d+1}) for d = 0 .. D-2, t_d term 0 of coordinate d,
// from the first item.  (Its loop is written out: with the item a second
// lambda inside for_each_coordinate's, ptxas gave B3's one-lane rosenbrock
// kernel 173 registers, against 170 for this.)
template <class Real, int NT, int M, class Item, class Op>
__device__ __forceinline__ Real fold_next(const Real (&T)[NT][M], int D, Item&& item, Op op) {
    Real prev = Real(0), acc = Real(0);
#pragma unroll
    for (int d = 0; d < M; ++d) {
        if (d < D) {
            const Real t = T[0][d];
            if (d > 0) {
                const Real x = item(prev, t);
                acc = d == 1 ? x : op(acc, x);
            }
            prev = t;
        }
    }
    return acc;
}

// {term J of coordinate 0, fold(T, D, item, op)}, in one pass.
template <int J, class Real, int NT, int M, class Item, class Op>
__device__ __forceinline__ Many<2, Real> first_and_fold(const Real (&T)[NT][M], int D,
                                                        Item&& item, Op op) {
    Real first = Real(0), acc = Real(0);
    for_each_coordinate<M>(D, [&](int d) {
        Real o[NT];
        terms_of(T, d, o);
        if (d == 0) first = o[J];
        const Real x = item(o, d);
        acc = d == 0 ? x : op(acc, x);
    });
    return {{first, acc}};
}

// ---- the views above SLICE_MAXD: a chain on the WARP_LANES lanes of a
// warp, a reduction in the lane order

// A lane's own terms in the 128 bucket: slot k is coordinate d = g + 32 k,
// its NT terms own[j][k] in the lane's registers; T[j] reads the staged
// row (stride values a term; a STAGED functor only).
template <class Real, int NT_, int K>
struct LaneRegs {
    using real = Real;
    static constexpr int NT = NT_, SLOTS = K;
    const Real (&own)[NT_][K];
    int g, D;
    const Real* rows;
    int stride;
    // the terms of slot k (zeros past the lane's slots)
    __device__ __forceinline__ void get(int k, Real* o) const {
#pragma unroll
        for (int j = 0; j < NT; ++j) o[j] = k < K ? own[j][k] : Real(0);
    }
    __device__ __forceinline__ const Real* operator[](int j) const { return rows + j * stride; }
};

// ... in the stream bucket: the chain's rows of shared memory, row j at
// rows + j D, of which the lane reads its own entries d = g + 32 k (only
// lane g writes them, so they need no barrier); T[j] reads any entry once
// like_eval has fenced the rows (a STAGED functor).
template <class Real, int NT_>
struct LaneRows {
    using real = Real;
    static constexpr int NT = NT_, SLOTS = 0;  // (D + 31) / 32, at run time
    const Real* rows;
    int g, D;
    __device__ __forceinline__ void get(int k, Real* o) const {
        const int d = g + WARP_LANES * k;
#pragma unroll
        for (int j = 0; j < NT; ++j) o[j] = d < D ? rows[j * D + d] : Real(0);
    }
    __device__ __forceinline__ const Real* operator[](int j) const { return rows + j * D; }
};

// f(k) for every slot k that holds a coordinate on some lane (32 k < D):
// the same trip count on every lane, so f may shuffle.
template <class Lanes, class F>
__device__ __forceinline__ void for_each_slot(const Lanes& L, F&& f) {
    if constexpr (Lanes::SLOTS > 0) {
#pragma unroll
        for (int k = 0; k < Lanes::SLOTS; ++k)
            if (WARP_LANES * k < L.D) f(k);
    } else {
        for (int k = 0; WARP_LANES * k < L.D; ++k) f(k);
    }
}

// The butterfly: op(v, lane g ^ m's v) at m = 16, 8, 4, 2, 1.  For a
// commutative op every lane ends with the same value.
template <class T>
__device__ __forceinline__ T shfl_xor(T v, int m) {
    return __shfl_xor_sync(0xffffffffu, v, m);
}
template <int N, class Real>
__device__ __forceinline__ Many<N, Real> shfl_xor(const Many<N, Real>& v, int m) {
    Many<N, Real> r;
#pragma unroll
    for (int i = 0; i < N; ++i) r.v[i] = __shfl_xor_sync(0xffffffffu, v.v[i], m);
    return r;
}
template <class T, class Op>
__device__ __forceinline__ T warp_fold(T v, Op op) {
#pragma unroll
    for (int m = WARP_LANES / 2; m >= 1; m >>= 1) v = fold_op(op, v, shfl_xor(v, m));
    return v;
}

// fold in the lane order (D > SLICE_MAXD, so every lane owns slot 0): lane
// g folds item(o, d) over its coordinates in index order from its first
// (lane 0 from op(init, its first) where init is given), then warp_fold.
template <bool INIT, class Lanes, class Item, class Op>
__device__ __forceinline__ auto lane_fold(const Lanes& L, typename Lanes::real init, Item&& item,
                                          Op op) {
    using Real = typename Lanes::real;
    Real o[Lanes::NT];
    L.get(0, o);
    auto acc = item(o, L.g);
    if constexpr (INIT)
        if (L.g == 0) acc = op(init, acc);
    if constexpr (Lanes::SLOTS > 0) {
        for_each_slot(L, [&](int k) {
            const int d = L.g + WARP_LANES * k;
            if (k > 0 && d < L.D) {
                L.get(k, o);
                acc = fold_op(op, acc, item(o, d));
            }
        });
    } else {  // the lane's entries of the rows: four slots' loads ahead of their folds
        int d = L.g + WARP_LANES;
        for (; d + 3 * WARP_LANES < L.D; d += 4 * WARP_LANES) {
            Real q[4][Lanes::NT];
#pragma unroll
            for (int u = 0; u < 4; ++u) L.get((d - L.g) / WARP_LANES + u, q[u]);
#pragma unroll
            for (int u = 0; u < 4; ++u) acc = fold_op(op, acc, item(q[u], d + u * WARP_LANES));
        }
        for (; d < L.D; d += WARP_LANES) {
            L.get((d - L.g) / WARP_LANES, o);
            acc = fold_op(op, acc, item(o, d));
        }
    }
    return warp_fold(acc, op);
}
template <class Lanes, class Item, class Op>
__device__ __forceinline__ auto fold(const Lanes& L, int, Item&& item, Op op)
    -> decltype(lane_fold<false>(L, typename Lanes::real(0), item, op)) {
    return lane_fold<false>(L, typename Lanes::real(0), item, op);
}
template <class Lanes, class Item, class Op>
__device__ __forceinline__ typename Lanes::real fold(const Lanes& L, int,
                                                     typename Lanes::real init, Item&& item,
                                                     Op op) {
    return lane_fold<true>(L, init, item, op);
}

// fold_next in the lane order: the item of coordinate d needs t_{d+1},
// which lane g + 1 holds in the same slot, or for lane 31 lane 0 in the
// next: one shuffle a slot, lane 0 sending its next slot's and every other
// lane its own.
template <class Lanes, class Item, class Op>
__device__ __forceinline__ typename Lanes::real fold_next(const Lanes& L, int, Item&& item,
                                                          Op op) {
    using Real = typename Lanes::real;
    Real acc = Real(0);
    for_each_slot(L, [&](int k) {
        Real th[Lanes::NT], ahead[Lanes::NT];
        L.get(k, th);
        L.get(k + 1, ahead);
        const Real next =
            __shfl_sync(0xffffffffu, L.g == 0 ? ahead[0] : th[0], (L.g + 1) % WARP_LANES);
        if (L.g + WARP_LANES * k < L.D - 1) {
            const Real x = item(th[0], next);
            acc = k == 0 ? x : op(acc, x);
        }
    });
    return warp_fold(acc, op);
}

// first_and_fold in the lane order: coordinate 0's term from lane 0.
template <int J, class Lanes, class Item, class Op>
__device__ __forceinline__ Many<2, typename Lanes::real> first_and_fold(const Lanes& L, int D,
                                                                        Item&& item, Op op) {
    typename Lanes::real o[Lanes::NT];
    L.get(0, o);
    return {{__shfl_sync(0xffffffffu, o[J], 0), fold(L, D, item, op)}};
}

// The folds' operations: rounded add and multiply, fmaxf; and their
// commonest item, term J of the coordinate (terms J... as a Many).
struct FoldAdd {
    template <class T>
    __device__ __forceinline__ T operator()(T a, T b) const { return rn_add(a, b); }
};
struct FoldMul {
    template <class T>
    __device__ __forceinline__ T operator()(T a, T b) const { return rn_mul(a, b); }
};
struct FoldMax {
    __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
template <int... J>
struct TermOf {
    template <class T>
    __device__ __forceinline__ auto operator()(const T* o, int) const {
        if constexpr (sizeof...(J) == 1)
            return (o[J], ...);
        else
            return Many<sizeof...(J), T>{{o[J]...}};
    }
};
// the shells' item: theta_d^2, from d = 1 (coordinate 0's is 0)
struct SquareAfterFirst {
    template <class T>
    __device__ __forceinline__ T operator()(const T* o, int d) const {
        return d == 0 ? T(0) : rn_mul(o[0], o[0]);
    }
};

// Whether a functor reads T[j][d] at any d above SLICE_MAXD (the terms are
// then staged in shared memory for it).
template <class Like, class = void>
struct staged_terms : std::false_type {};
template <class Like>
struct staged_terms<Like, std::void_t<decltype(Like::STAGED)>>
    : std::integral_constant<bool, Like::STAGED> {};

// logaddexp(l1, l2) - log 2, spelled out as torch's form does it.
__device__ __forceinline__ float mix_of_two(float l1, float l2, float log_two) {
    const float m = fmaxf(l1, l2);
    const float e = expf(-fabsf(__fsub_rn(l1, l2)));
    return __fsub_rn(__fadd_rn(m, log1pf(e)), log_two);
}

// cosf once per call site: kept out of line so that the unrolled loops over
// a bucket's coordinates do not copy its range reduction 32 times.
__device__ __noinline__ float like_cosf(float x) { return cosf(x); }

// The normalised Gaussian (models/examples.py::gaussian): the chi-square
// summed over coordinates 0..D-1 in index order (above D = 32 in the lane
// order, as every functor's reductions below).
template <int M>
struct GaussianLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float mu, sigma, norm, logzero;
    static constexpr int NT = 1;

    __device__ __forceinline__ void term(float th, int, float* out) const {
        const float z = __fdiv_rn(__fsub_rn(th, mu), sigma);
        out[0] = __fmul_rn(z, z);
    }
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        const float chi2 = fold(T, D, 0.0f, TermOf<0>{}, FoldAdd{});
        return __fsub_rn(norm, __fmul_rn(0.5f, chi2));
    }
};

// Two Gaussian shells centred at x_1 = -centre and +centre
// (models/examples.py::gaussian_shells): rest = sum of theta_d^2 over
// d = 1..D-1 in index order (from 0), the two radii, each shell's logL, and their
// mixture.
template <int M>
struct GaussianShellsLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float centre, radius, two_s2, neg_a, log_two, logzero;
    static constexpr int NT = 1;

    __device__ __forceinline__ void term(float th, int, float* out) const { out[0] = th; }
    // rest from 0 (the torch form's zeros): coordinate 0's item is 0
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        const Many<2, float> r = first_and_fold<0>(T, D, SquareAfterFirst{}, FoldAdd{});
        const float th0 = r.v[0], rest = r.v[1];
        const float c1 = __fadd_rn(th0, centre);
        const float c2 = __fsub_rn(th0, centre);
        const float r1 = sqrtf(__fadd_rn(__fmul_rn(c1, c1), rest));
        const float r2 = sqrtf(__fadd_rn(__fmul_rn(c2, c2), rest));
        const float d1 = __fsub_rn(r1, radius);
        const float d2 = __fsub_rn(r2, radius);
        const float l1 = __fsub_rn(neg_a, __fdiv_rn(__fmul_rn(d1, d1), two_s2));
        const float l2 = __fsub_rn(neg_a, __fdiv_rn(__fmul_rn(d2, d2), two_s2));
        return mix_of_two(l1, l2, log_two);
    }
};

// models/examples.py::half_gaussian: the Gaussian with the first
// coordinate's mean at 0 (a half-Gaussian on [0, 1]).
template <int M>
struct HalfGaussianLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float mu, sigma, norm, logzero;
    static constexpr int NT = 1;

    __device__ __forceinline__ void term(float th, int d, float* out) const {
        const float z = __fdiv_rn(__fsub_rn(th, d == 0 ? 0.0f : mu), sigma);
        out[0] = __fmul_rn(z, z);
    }
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        const float chi2 = fold(T, D, 0.0f, TermOf<0>{}, FoldAdd{});
        return __fsub_rn(norm, __fmul_rn(0.5f, chi2));
    }
};

// models/examples.py::pyramidal: norm - max_d(|theta_d - mu| / sigma)^2 / factor.
template <int M>
struct PyramidalLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float mu, sigma, norm, factor, logzero;
    static constexpr int NT = 1;

    __device__ __forceinline__ void term(float th, int, float* out) const {
        out[0] = __fdiv_rn(fabsf(__fsub_rn(th, mu)), sigma);
    }
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        const float m = fold(T, D, TermOf<0>{}, FoldMax{});
        return __fsub_rn(norm, __fdiv_rn(__fmul_rn(m, m), factor));
    }
};

// models/examples.py::rastrigin: -sum_d (log_norm + theta_d^2 - A cos(2 pi theta_d)),
// with 2 pi the float32 of the torch form's Python constant.
template <int M>
struct RastriginLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float log_norm, A, two_pi, logzero;
    static constexpr int NT = 1;

    __device__ __forceinline__ void term(float th, int, float* out) const {
        const float c = like_cosf(__fmul_rn(th, two_pi));
        out[0] = __fsub_rn(__fadd_rn(__fmul_rn(th, th), log_norm), __fmul_rn(c, A));
    }
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        return -fold(T, D, TermOf<0>{}, FoldAdd{});
    }
};

// models/examples.py::twin_gaussian: an equal mixture of two Gaussians at
// (-off, -off, 0, ...) and (+off, +off, 0, ...).
template <int M>
struct TwinGaussianLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float off, sigma, norm, log_two, logzero;
    static constexpr int NT = 2;

    __device__ __forceinline__ void term(float th, int d, float* out) const {
        const float z1 = __fdiv_rn(__fsub_rn(th, d < 2 ? -off : 0.0f), sigma);
        const float z2 = __fdiv_rn(__fsub_rn(th, d < 2 ? off : 0.0f), sigma);
        out[0] = __fmul_rn(z1, z1);
        out[1] = __fmul_rn(z2, z2);
    }
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        const Many<2, float> c = fold(T, D, TermOf<0, 1>{}, FoldAdd{});
        const float l1 = __fsub_rn(norm, __fmul_rn(0.5f, c.v[0]));
        const float l2 = __fsub_rn(norm, __fmul_rn(0.5f, c.v[1]));
        return mix_of_two(l1, l2, log_two);
    }
};

// models/examples.py::himmelblau: norm - (x^2 + y - 11)^2 - (x + y^2 - 7)^2
// on the first two coordinates.
template <int M>
struct HimmelblauLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float norm, logzero;
    static constexpr int NT = 1;

    static constexpr bool STAGED = true;

    __device__ __forceinline__ void term(float th, int, float* out) const { out[0] = th; }
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        const float th0 = D > 0 ? T[0][0] : 0.0f;
        const float th1 = D > 1 ? T[0][1] : 0.0f;
        const float a = __fsub_rn(__fadd_rn(__fmul_rn(th0, th0), th1), 11.0f);
        const float b = __fsub_rn(__fadd_rn(th0, __fmul_rn(th1, th1)), 7.0f);
        return __fsub_rn(__fsub_rn(norm, __fmul_rn(a, a)), __fmul_rn(b, b));
    }
};

// models/examples.py::rosenbrock: norm - sum_{d<D-1} ((a - theta_d)^2 +
// b (theta_{d+1} - theta_d^2)^2).
template <int M>
struct RosenbrockLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float a, b, norm, logzero;
    static constexpr int NT = 1;

    __device__ __forceinline__ void term(float th, int, float* out) const { out[0] = th; }
    // (a - theta_d)^2 + b (theta_{d+1} - theta_d^2)^2
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        const float total = fold_next(
            T, D,
            [&](float th, float next) {
                const float u = __fsub_rn(a, th);
                const float v = __fsub_rn(next, __fmul_rn(th, th));
                return __fadd_rn(__fmul_rn(u, u), __fmul_rn(__fmul_rn(v, v), b));
            },
            FoldAdd{});
        return __fsub_rn(norm, total);
    }
};

// models/examples.py::eggbox: -(2 + prod_d cos(theta_d / 2))^5, the fifth
// power as q * (q^2)^2 (JAX's integer_pow order).
template <int M>
struct EggboxLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float logzero;
    static constexpr int NT = 1;

    __device__ __forceinline__ void term(float th, int, float* out) const {
        out[0] = like_cosf(__fdiv_rn(th, 2.0f));
    }
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        const float p = fold(T, D, TermOf<0>{}, FoldMul{});
        const float q = __fadd_rn(p, 2.0f);
        const float q2 = __fmul_rn(q, q);
        return -__fmul_rn(q, __fmul_rn(q2, q2));
    }
};

// models/examples.py::gaussian_shell: one shell at the origin,
// -A - (|theta| - radius)^2 / (2 sigma^2).
template <int M>
struct GaussianShellLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float radius, two_s2, neg_a, logzero;
    static constexpr int NT = 1;

    __device__ __forceinline__ void term(float th, int, float* out) const {
        out[0] = __fmul_rn(th, th);
    }
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        const float s = fold(T, D, TermOf<0>{}, FoldAdd{});
        const float dr = __fsub_rn(sqrtf(s), radius);
        return __fsub_rn(neg_a, __fdiv_rn(__fmul_rn(dr, dr), two_s2));
    }
};

// models/examples.py::random_gaussian: norm - q / 2 with the quadratic form
// q = sum_i d_i (sum_j M_ij d_j), d = theta - mu, both sums in index order
// from 0.  M, row-major D x D (4 MB at D = 1,024), lives in a device buffer
// and is read through L1 and L2 (every lane of the group reads the same
// entry).  In the 32 bucket the d_j are indexed at run time, so they go to
// local memory; above, they are read where they are staged, in shared
// memory.
template <int M>
struct RandomGaussianLike {
    static constexpr int MAXD = M;
    prior_t<M> prior;
    float mu, norm, logzero;
    const float* __restrict__ m;  // the matrix (device)
    static constexpr int NT = 1;
    static constexpr bool STAGED = true;

    __device__ __forceinline__ void term(float th, int, float* out) const {
        out[0] = __fsub_rn(th, mu);
    }
    template <class V>
    __device__ __forceinline__ float quadratic(const V& dv, int D) const {
        float q = 0.0f;
        for (int i = 0; i < D; ++i) {
            float row = 0.0f;
            for (int j = 0; j < D; ++j) row = __fadd_rn(row, __fmul_rn(m[i * D + j], dv[j]));
            q = __fadd_rn(q, __fmul_rn(dv[i], row));
        }
        return __fsub_rn(norm, __fmul_rn(0.5f, q));
    }
    template <class TT>
    __device__ __forceinline__ float combine(const TT& T, int D) const {
        if constexpr (MAXD == SLICE_MAXD) {
            float dv[MAXD];
#pragma unroll
            for (int d = 0; d < MAXD; ++d)
                if (d < D) dv[d] = T[0][d];
            return quadratic(dv, D);
        } else {
            return quadratic(T[0], D);
        }
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

// Build the functor `id` of the MAXD bucket (SLICE_MAXD, SLICE_MAXD_WIDE or
// SLICE_MAXD_STREAM) from host arrays — its constants c[], the prior's a[D]
// and s[D] — and the device array dev = [a (D), s (D), random_gaussian's
// D x D matrix], and call launch(functor).  The stream bucket takes its
// prior from dev; random_gaussian takes its matrix from there in every
// bucket (a host array c[] may end with it too; the functor does not read
// it there).  Returns 0, or cudaErrorInvalidValue for an unknown id.
template <int MAXD = SLICE_MAXD, class Launch>
int with_likelihood(int id, const float* c, const float* prior_a, const float* prior_s,
                    const float* dev, int D, float logzero, Launch&& launch) {
    const prior_t<MAXD> prior = make_prior<MAXD>(prior_a, prior_s, dev, D);
    switch (id) {
        case LIKE_GAUSSIAN:
            launch(GaussianLike<MAXD>{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_GAUSSIAN_SHELLS:
            launch(GaussianShellsLike<MAXD>{prior, c[0], c[1], c[2], c[3], c[4], logzero});
            return 0;
        case LIKE_HALF_GAUSSIAN:
            launch(HalfGaussianLike<MAXD>{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_PYRAMIDAL:
            launch(PyramidalLike<MAXD>{prior, c[0], c[1], c[2], c[3], logzero});
            return 0;
        case LIKE_RASTRIGIN:
            launch(RastriginLike<MAXD>{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_TWIN_GAUSSIAN:
            launch(TwinGaussianLike<MAXD>{prior, c[0], c[1], c[2], c[3], logzero});
            return 0;
        case LIKE_HIMMELBLAU:
            launch(HimmelblauLike<MAXD>{prior, c[0], logzero});
            return 0;
        case LIKE_ROSENBROCK:
            launch(RosenbrockLike<MAXD>{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_EGGBOX:
            launch(EggboxLike<MAXD>{prior, logzero});
            return 0;
        case LIKE_GAUSSIAN_SHELL:
            launch(GaussianShellLike<MAXD>{prior, c[0], c[1], c[2], logzero});
            return 0;
        case LIKE_RANDOM_GAUSSIAN:
            launch(RandomGaussianLike<MAXD>{prior, c[0], c[1], logzero, dev + 2 * D});
            return 0;
        default:
            return (int)cudaErrorInvalidValue;
    }
}
