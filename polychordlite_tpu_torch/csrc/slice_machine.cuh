// The per-lane slice-sampling state machine of one repeat, shared by the
// epoch kernels: slice_epoch.cuh's template (B1 in slice_epoch.cu, where
// every lane of a chain's group runs it in step, and its counted form E1,
// one thread per chain; B5 in slice_epoch_v2.cu), slice_epoch_v3.cu (B4),
// slice_epoch_v2.cu's counted form E3, slice_epoch_v3_instr.cu (E2, which
// keeps a lane's SliceState across its bodies), prototypes.cu (E4, E5) and
// slice_step.cu (B1's route for a likelihood evaluated in torch, which keeps
// the state in device memory between its launches).  Each kernel owns only
// its outer loop over repeats and what its TPU original does at a repeat's
// end (where the budget is counted, whether the kernel writes the cube).
// B3's packet machine (packet_machine.cuh) builds on the pieces at the end:
// the epoch's arguments, its records, the advance and the loads.
//
// No warp operation lives here: with the intrinsics mapped to plain float
// operations, the header also builds as host C++ (tests/test_torch_v5.py).
//
// Every piece is a template on the scalar type T of the chain's state (x0,
// n̂, t, w, the bound, logL): float for every kernel, double for B1's fused
// and traced routes at precision='highest' (slice_epoch_fused.cu,
// slice_step.cu).  The float code is the one the kernels have always run.
// The uniform stays slice_uniform's 24-bit draw, exact in either type.
//
// One repeat on the chord x0 + t n̂ (pallas_slice_v4.py:215-348; Neal 2003,
// chordal_sampling.f90:163-273):
//   INIT_R -> INIT_L -> STEP_R / STEP_L -> SHRINK,
//   max_step stepping-out steps per side and max_shrink shrinks,
//   inside = logL >= bound && logL > logzero,
//   cnt counts only probes with logL > logzero,
//   a forced accept after max_shrink stores logL = logzero and still moves
//   x0 to the probe (the caller moves it),
//   `it` starts at 0 and counts the repeat's micro-steps, so the uniform of
//   every probe is u = (fmix(mix(h_rep, it)) >> 8) * 2^-24 with
//   h_rep = mix(mix(mix(k0, k1), lane), repeat) —
// and at most `budget` micro-steps; a repeat that reaches it unaccepted
// returns accepted = false with t = 0 and logL = logzero.
// With SPLIT_INIT (E5, experiments/pallas_slice_repeat.py:48-56) the
// uniform that places the bracket is a draw of its own, taken before the
// loop: micro-step 0 (INIT_R) draws counter 0 and micro-step it > 0 draws
// counter it + 1, so counter 1 — the INIT_R iteration's own draw, which
// E5 leaves unused — is never drawn.
#pragma once

#include "likelihoods.cuh"

template <class T = float>
struct SliceRepeatT {
    bool accepted;
    T t;              // the accepted chord position (0 when not accepted)
    T logL;           // its logL (logzero for a forced accept or none)
    int cnt;          // likelihood calls counted (logL > logzero)
    long long steps;  // micro-steps taken
};
using SliceRepeat = SliceRepeatT<float>;

// The state of one lane inside one repeat.  slice_repeat runs it to the
// end; a kernel that must stop a lane between micro-steps (the cooperative
// v3 of slice_epoch_v3_instr.cu) keeps it across its bodies.
template <class T = float>
struct SliceStateT {
    int phase, rstep, lstep, nshrink, cnt;
    bool need_r, need_l;
    T tL, tR;
    uint32_t it;  // micro-steps of the repeat so far: the uniform's counter

    __device__ __forceinline__ void start() {
        phase = PH_INIT_R;
        rstep = lstep = 1;
        nshrink = cnt = 0;
        need_r = need_l = false;
        tL = tR = T(0);
        it = 0;
    }
};
using SliceState = SliceStateT<float>;

// A micro-step in two halves around the likelihood call: slice_propose
// draws the uniform, advances `it` and returns the chord position t of the
// probe; slice_decide takes that probe's logL and applies the transition.
// slice_micro runs both with the functor between them; slice_step.cu runs
// them in two launches, with the likelihood evaluated in torch in between.
template <bool SPLIT_INIT = false, class T>
__device__ __forceinline__ T slice_propose(SliceStateT<T>& s, exactly<T> wr, uint32_t h_rep) {
    const T u = (T)slice_uniform(h_rep, SPLIT_INIT && s.it > 0 ? s.it + 1 : s.it);
    ++s.it;
    switch (s.phase) {
        case PH_INIT_R:
            s.tL = rn_mul(-u, wr);
            s.tR = rn_mul(rn_sub(T(1), u), wr);
            return s.tR;
        case PH_INIT_L: return s.tL;
        case PH_STEP_R: return rn_mul(wr, (T)s.rstep);
        case PH_STEP_L: return rn_mul(-wr, (T)s.lstep);
        default: return rn_add(s.tL, rn_mul(u, rn_sub(s.tR, s.tL)));
    }
}

// The transition after the probe at t scored logL.  Returns true when the
// repeat accepts, with logL_store the accepted logL (logzero for a forced
// accept).
template <class T>
__device__ __forceinline__ bool slice_decide(SliceStateT<T>& s, exactly<T> t, exactly<T> logL,
                                             exactly<T> bnd, exactly<T> logzero, int max_step,
                                             int max_shrink, T& logL_store) {
    const bool inside = (logL >= bnd) && (logL > logzero);
    if (logL > logzero) ++s.cnt;
    switch (s.phase) {
        case PH_INIT_R:
            s.need_r = inside;
            s.phase = PH_INIT_L;
            break;
        case PH_INIT_L:
            s.need_l = inside;
            s.phase = s.need_r ? PH_STEP_R : (s.need_l ? PH_STEP_L : PH_SHRINK);
            break;
        case PH_STEP_R:
            if (!inside || s.rstep >= max_step) {
                s.tR = t;
                s.phase = s.need_l ? PH_STEP_L : PH_SHRINK;
            } else {
                ++s.rstep;
            }
            break;
        case PH_STEP_L:
            if (!inside || s.lstep >= max_step) {
                s.tL = t;
                s.phase = PH_SHRINK;
            } else {
                ++s.lstep;
            }
            break;
        default:
            if (inside) {
                logL_store = logL;
                return true;
            }
            if (s.nshrink + 1 >= max_shrink) {
                logL_store = logzero;  // forced: logzero, x0 still moves
                return true;
            }
            if (t > T(0)) s.tR = t; else s.tL = t;
            ++s.nshrink;
            break;
    }
    return false;
}

// One micro-step of the machine.  Returns true when the repeat accepts,
// with t the accepted chord position and logL_store its logL (logzero for
// a forced accept).
template <class Like, bool SPLIT_INIT = false, class T>
__device__ __forceinline__ bool slice_micro(const Like& like, SliceStateT<T>& s, const T* x0,
                                            const T* n, exactly<T> wr, exactly<T> bnd,
                                            uint32_t h_rep, int D, int max_step,
                                            int max_shrink, T& t, T& logL_store) {
    t = slice_propose<SPLIT_INIT>(s, wr, h_rep);
    return slice_decide(s, t, like_eval(like, x0, n, t, D), bnd, like.logzero, max_step,
                        max_shrink, logL_store);
}

template <class Like, bool SPLIT_INIT = false, class T = real_of<Like>>
__device__ __forceinline__ SliceRepeatT<T> slice_repeat(const Like& like, const T* x0,
                                                        const T* n, exactly<T> wr,
                                                        exactly<T> bnd, uint32_t h_rep, int D,
                                                        int max_step, int max_shrink,
                                                        long long budget) {
    SliceStateT<T> s;
    s.start();
    T t = T(0), logL_store = like.logzero;
    long long steps = 0;
    while (steps < budget) {
        ++steps;
        if (slice_micro<Like, SPLIT_INIT>(like, s, x0, n, wr, bnd, h_rep, D, max_step,
                                          max_shrink, t, logL_store))
            return SliceRepeatT<T>{true, t, logL_store, s.cnt, steps};
    }
    return SliceRepeatT<T>{false, T(0), like.logzero, s.cnt, steps};
}

// x0 <- x0 + t n̂, the accepted probe, with the functors' intrinsics.  A
// lane of a group of G holds coordinates d = g + k G at index k, k < MAXD / G;
// in the stream bucket (MAXD = SLICE_MAXD_STREAM) x0 and n̂ are the chain's
// rows of shared memory, indexed by d, and the lane walks its d to D.
template <int G = 1, int MAXD = SLICE_MAXD, class T>
__device__ __forceinline__ void slice_advance(T* x0, const T* n, exactly<T> t, int D,
                                              int g = 0) {
    if constexpr (MAXD == SLICE_MAXD_STREAM) {
        for (int d = g; d < D; d += G) x0[d] = rn_add(x0[d], rn_mul(t, n[d]));
    } else {
#pragma unroll
        for (int k = 0; k < MAXD / G; ++k)
            if (g + k * G < D) x0[k] = rn_add(x0[k], rn_mul(t, n[k]));
    }
}

// Load lane b's seed (D, B) or direction of repeat r (R, D, B), chain axis
// minor: coordinates d = g + k G to index k (to index d in the stream
// bucket).
template <int G = 1, int MAXD = SLICE_MAXD, class T>
__device__ __forceinline__ void slice_load(T* v, const T* __restrict__ src,
                                           size_t offset, int D, int B, int b, int g = 0) {
    if constexpr (MAXD == SLICE_MAXD_STREAM) {
        for (int d = g; d < D; d += G) v[d] = src[offset + (size_t)d * B + b];
    } else {
#pragma unroll
        for (int k = 0; k < MAXD / G; ++k) {
            const int d = g + k * G;
            if (d < D) v[k] = src[offset + (size_t)d * B + b];
        }
    }
}

// Load chain b's direction of repeat r into n.  In the 32 bucket the
// directions are (R, D, B), chain axis minor, as slice_load reads a seed:
// the chains of a warp read neighbouring entries.  Above D = 32, where one
// chain holds a warp, they are (B, R, D): a chain's repeat is one
// contiguous row of D values, which its warp reads in coalesced loads (in
// (R, D, B) each lane's load of a coordinate touched a sector of its own,
// and past D ~ 256 those misses made the repeat's load the dearest part of
// the machine).  ops/pallas_slice_v4.py::launch_slice_kernel lays them out
// by the same rule.
template <int G, int MAXD, class T>
__device__ __forceinline__ void slice_load_nhat(T* n, const T* __restrict__ nhat, int r, int D,
                                                int B, int R, int b, int g) {
    if constexpr (MAXD == SLICE_MAXD)
        slice_load<G, MAXD>(n, nhat, (size_t)r * D * B, D, B, b, g);
    else  // the row of (b, r): a "seed" of one chain at its offset
        slice_load<G, MAXD>(n, nhat, ((size_t)b * R + r) * D, D, 1, 0, g);
}

// The arguments of a free-running epoch kernel (slice_epoch.cuh: B1, B5 at
// G > 1; slice_epoch_v5.cu: B3).  Layout: x0 (D, B), nhat (R, D, B) (above
// D = 32 (B, R, D): slice_load_nhat) and w (R, B) with the chain
// axis minor; outputs t, logL (R, B) of the scalar
// type T (float32; float64 for the fused route at precision='highest'),
// nlike (R, B) int32 and, where the kernel writes it (B5), cube (R, D, B).
template <class T = float>
struct EpochArgsT {
    const T* x0t;
    const T* bound;
    const T* valid;
    const T* nhat;
    const T* w;
    T* t_out;
    T* logL_out;
    int* nlike_out;
    int B, D, R;
    uint32_t k0, k1;
    int max_step, max_shrink;
    long long cap;
    int* lane_steps;  // the counted form's outputs, else null
    int* warp_max;
    T* cube_out;  // B5's cube, else null
    // the launch's first lane in the whole batch: a shard's lanes hash as the
    // same lanes of the one-device launch (0 there)
    uint32_t lane0 = 0;
    // the ring engine's per-lane overflow flags (B,), zeroed by the caller
    // (RingPolicy, slice_epoch.cuh), else null
    int* overflow = nullptr;
};
using EpochArgs = EpochArgsT<float>;

template <class T = float>
inline EpochArgsT<T> epoch_args(const void* x0t, const void* bound, const void* valid,
                                const void* nhat, const void* w, void* t_out, void* logL_out,
                                void* nlike_out, int B, int D, int R, unsigned int k0,
                                unsigned int k1, int max_step, int max_shrink, long long cap,
                                void* lane_steps = nullptr, void* warp_max = nullptr,
                                void* cube_out = nullptr) {
    return EpochArgsT<T>{(const T*)x0t, (const T*)bound, (const T*)valid,
                         (const T*)nhat, (const T*)w, (T*)t_out, (T*)logL_out,
                         (int*)nlike_out, B, D, R, k0, k1, max_step, max_shrink, cap,
                         (int*)lane_steps, (int*)warp_max, (T*)cube_out};
}

// The same arguments for a shard whose lane b is lane lane0 + b of the batch.
template <class T>
inline EpochArgsT<T> at_lane0(EpochArgsT<T> a, unsigned int lane0) {
    a.lane0 = lane0;
    return a;
}

// The same arguments with the ring engine's overflow flags (B,) int32.
template <class T>
inline EpochArgsT<T> with_overflow(EpochArgsT<T> a, void* overflow) {
    a.overflow = (int*)overflow;
    return a;
}

// Record repeat r of chain b.
template <class T>
__device__ __forceinline__ void write_repeat(const EpochArgsT<T>& a, int r, int b,
                                             exactly<T> t, exactly<T> logL, int cnt) {
    const size_t o = (size_t)r * a.B + b;
    a.nlike_out[o] = cnt;
    a.t_out[o] = t;
    a.logL_out[o] = logL;
}
