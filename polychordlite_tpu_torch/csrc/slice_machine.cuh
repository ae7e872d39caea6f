// The per-lane slice-sampling state machine of one repeat, shared by the
// epoch kernels: slice_epoch.cu (B1, where every lane of a chain's group
// runs it in step, and its counted form E1, one thread per chain),
// slice_epoch_v3.cu (B4), slice_epoch_v2.cu (B5 and its counted
// form E3), slice_epoch_v3_instr.cu (E2, which keeps a lane's SliceState
// across its bodies), prototypes.cu (E4, E5) and slice_step.cu (B1's route
// for a likelihood evaluated in torch, which keeps the state in device
// memory between its launches).  Each kernel owns only its
// outer loop over repeats and what its TPU original does at a repeat's end
// (where the budget is counted, whether the kernel writes the cube).
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

struct SliceRepeat {
    bool accepted;
    float t;          // the accepted chord position (0 when not accepted)
    float logL;       // its logL (logzero for a forced accept or none)
    int cnt;          // likelihood calls counted (logL > logzero)
    long long steps;  // micro-steps taken
};

// The state of one lane inside one repeat.  slice_repeat runs it to the
// end; a kernel that must stop a lane between micro-steps (the cooperative
// v3 of slice_epoch_v3_instr.cu) keeps it across its bodies.
struct SliceState {
    int phase, rstep, lstep, nshrink, cnt;
    bool need_r, need_l;
    float tL, tR;
    uint32_t it;  // micro-steps of the repeat so far: the uniform's counter

    __device__ __forceinline__ void start() {
        phase = PH_INIT_R;
        rstep = lstep = 1;
        nshrink = cnt = 0;
        need_r = need_l = false;
        tL = tR = 0.0f;
        it = 0;
    }
};

// A micro-step in two halves around the likelihood call: slice_propose
// draws the uniform, advances `it` and returns the chord position t of the
// probe; slice_decide takes that probe's logL and applies the transition.
// slice_micro runs both with the functor between them; slice_step.cu runs
// them in two launches, with the likelihood evaluated in torch in between.
template <bool SPLIT_INIT = false>
__device__ __forceinline__ float slice_propose(SliceState& s, float wr, uint32_t h_rep) {
    const float u = slice_uniform(h_rep, SPLIT_INIT && s.it > 0 ? s.it + 1 : s.it);
    ++s.it;
    switch (s.phase) {
        case PH_INIT_R:
            s.tL = __fmul_rn(-u, wr);
            s.tR = __fmul_rn(__fsub_rn(1.0f, u), wr);
            return s.tR;
        case PH_INIT_L: return s.tL;
        case PH_STEP_R: return __fmul_rn(wr, (float)s.rstep);
        case PH_STEP_L: return __fmul_rn(-wr, (float)s.lstep);
        default: return __fadd_rn(s.tL, __fmul_rn(u, __fsub_rn(s.tR, s.tL)));
    }
}

// The transition after the probe at t scored logL.  Returns true when the
// repeat accepts, with logL_store the accepted logL (logzero for a forced
// accept).
__device__ __forceinline__ bool slice_decide(SliceState& s, float t, float logL, float bnd,
                                             float logzero, int max_step, int max_shrink,
                                             float& logL_store) {
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
            if (t > 0.0f) s.tR = t; else s.tL = t;
            ++s.nshrink;
            break;
    }
    return false;
}

// One micro-step of the machine.  Returns true when the repeat accepts,
// with t the accepted chord position and logL_store its logL (logzero for
// a forced accept).
template <class Like, bool SPLIT_INIT = false>
__device__ __forceinline__ bool slice_micro(const Like& like, SliceState& s, const float* x0,
                                            const float* n, float wr, float bnd,
                                            uint32_t h_rep, int D, int max_step,
                                            int max_shrink, float& t, float& logL_store) {
    t = slice_propose<SPLIT_INIT>(s, wr, h_rep);
    return slice_decide(s, t, like_eval(like, x0, n, t, D), bnd, like.logzero, max_step,
                        max_shrink, logL_store);
}

template <class Like, bool SPLIT_INIT = false>
__device__ __forceinline__ SliceRepeat slice_repeat(const Like& like, const float* x0,
                                                    const float* n, float wr, float bnd,
                                                    uint32_t h_rep, int D, int max_step,
                                                    int max_shrink, long long budget) {
    SliceState s;
    s.start();
    float t = 0.0f, logL_store = like.logzero;
    long long steps = 0;
    while (steps < budget) {
        ++steps;
        if (slice_micro<Like, SPLIT_INIT>(like, s, x0, n, wr, bnd, h_rep, D, max_step,
                                          max_shrink, t, logL_store))
            return SliceRepeat{true, t, logL_store, s.cnt, steps};
    }
    return SliceRepeat{false, 0.0f, like.logzero, s.cnt, steps};
}

// x0 <- x0 + t n̂, the accepted probe, with the functors' intrinsics.  A
// lane of a group of G holds coordinates d = g + k G at index k.
template <int G = 1>
__device__ __forceinline__ void slice_advance(float* x0, const float* n, float t, int D,
                                              int g = 0) {
#pragma unroll
    for (int k = 0; k < SLICE_MAXD / G; ++k)
        if (g + k * G < D) x0[k] = __fadd_rn(x0[k], __fmul_rn(t, n[k]));
}

// Load lane b's seed (D, B) or direction of repeat r (R, D, B), chain axis
// minor: coordinates d = g + k G to index k.
template <int G = 1>
__device__ __forceinline__ void slice_load(float* v, const float* __restrict__ src,
                                           size_t offset, int D, int B, int b, int g = 0) {
#pragma unroll
    for (int k = 0; k < SLICE_MAXD / G; ++k) {
        const int d = g + k * G;
        if (d < D) v[k] = src[offset + (size_t)d * B + b];
    }
}
