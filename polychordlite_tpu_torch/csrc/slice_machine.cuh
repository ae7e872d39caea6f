// The per-lane slice-sampling state machine of one repeat, shared by the
// one-thread-per-chain epoch kernels: slice_epoch.cu (B1 and its counted
// form E1), slice_epoch_v3.cu (B4), slice_epoch_v2.cu (B5 and its counted
// form E3) and slice_epoch_v3_instr.cu (E2, which keeps a lane's
// SliceState across its bodies).  Each kernel owns only its outer loop over
// repeats and what its TPU original does at a repeat's end (where the
// budget is counted, whether the kernel writes the cube).
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

// One micro-step of the machine.  Returns true when the repeat accepts,
// with t the accepted chord position and logL_store its logL (logzero for
// a forced accept).
template <class Like>
__device__ __forceinline__ bool slice_micro(const Like& like, SliceState& s, const float* x0,
                                            const float* n, float wr, float bnd,
                                            uint32_t h_rep, int D, int max_step,
                                            int max_shrink, float& t, float& logL_store) {
    const float logzero = like.logzero;
    const float u = slice_uniform(h_rep, s.it);
    ++s.it;
    switch (s.phase) {
        case PH_INIT_R:
            s.tL = __fmul_rn(-u, wr);
            s.tR = __fmul_rn(__fsub_rn(1.0f, u), wr);
            t = s.tR;
            break;
        case PH_INIT_L: t = s.tL; break;
        case PH_STEP_R: t = __fmul_rn(wr, (float)s.rstep); break;
        case PH_STEP_L: t = __fmul_rn(-wr, (float)s.lstep); break;
        default: t = __fadd_rn(s.tL, __fmul_rn(u, __fsub_rn(s.tR, s.tL))); break;
    }
    const float logL = like(x0, n, t, D);
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

template <class Like>
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
        if (slice_micro(like, s, x0, n, wr, bnd, h_rep, D, max_step, max_shrink, t,
                        logL_store))
            return SliceRepeat{true, t, logL_store, s.cnt, steps};
    }
    return SliceRepeat{false, 0.0f, like.logzero, s.cnt, steps};
}

// x0 <- x0 + t n̂, the accepted probe, with the functors' intrinsics.
__device__ __forceinline__ void slice_advance(float* x0, const float* n, float t, int D) {
#pragma unroll
    for (int d = 0; d < SLICE_MAXD; ++d)
        if (d < D) x0[d] = __fadd_rn(x0[d], __fmul_rn(t, n[d]));
}

// Load lane b's seed (D, B) or direction of repeat r (R, D, B), chain axis minor.
__device__ __forceinline__ void slice_load(float* v, const float* __restrict__ src,
                                           size_t offset, int D, int B, int b) {
#pragma unroll
    for (int d = 0; d < SLICE_MAXD; ++d)
        if (d < D) v[d] = src[offset + (size_t)d * B + b];
}
