// The per-lane slice-sampling state machine of one repeat, shared by the
// one-thread-per-chain epoch kernels: slice_epoch.cu (B1 and its counted
// form E1), slice_epoch_v3.cu (B4) and slice_epoch_v2.cu (B5).  Each
// kernel owns only its outer loop over repeats and what its TPU original
// does at a repeat's end (where the budget is counted, whether the kernel
// writes the cube).
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

template <class Like>
__device__ __forceinline__ SliceRepeat slice_repeat(const Like& like, const float* x0,
                                                    const float* n, float wr, float bnd,
                                                    uint32_t h_rep, int D, int max_step,
                                                    int max_shrink, long long budget) {
    const float logzero = like.logzero;
    int phase = PH_INIT_R, rstep = 1, lstep = 1, nshrink = 0, cnt = 0;
    bool need_r = false, need_l = false, accepted = false;
    float tL = 0.0f, tR = 0.0f, t = 0.0f, logL_store = logzero;
    long long steps = 0;
    for (uint32_t it = 0; steps < budget; ++it) {
        ++steps;
        const float u = slice_uniform(h_rep, it);
        switch (phase) {
            case PH_INIT_R:
                tL = __fmul_rn(-u, wr);
                tR = __fmul_rn(__fsub_rn(1.0f, u), wr);
                t = tR;
                break;
            case PH_INIT_L: t = tL; break;
            case PH_STEP_R: t = __fmul_rn(wr, (float)rstep); break;
            case PH_STEP_L: t = __fmul_rn(-wr, (float)lstep); break;
            default: t = __fadd_rn(tL, __fmul_rn(u, __fsub_rn(tR, tL))); break;
        }
        const float logL = like(x0, n, t, D);
        const bool inside = (logL >= bnd) && (logL > logzero);
        if (logL > logzero) ++cnt;
        switch (phase) {
            case PH_INIT_R:
                need_r = inside;
                phase = PH_INIT_L;
                break;
            case PH_INIT_L:
                need_l = inside;
                phase = need_r ? PH_STEP_R : (need_l ? PH_STEP_L : PH_SHRINK);
                break;
            case PH_STEP_R:
                if (!inside || rstep >= max_step) {
                    tR = t;
                    phase = need_l ? PH_STEP_L : PH_SHRINK;
                } else {
                    ++rstep;
                }
                break;
            case PH_STEP_L:
                if (!inside || lstep >= max_step) {
                    tL = t;
                    phase = PH_SHRINK;
                } else {
                    ++lstep;
                }
                break;
            default:
                if (inside) {
                    accepted = true;
                    logL_store = logL;
                } else if (nshrink + 1 >= max_shrink) {
                    accepted = true;  // forced: logzero, x0 still moves
                } else {
                    if (t > 0.0f) tR = t; else tL = t;
                    ++nshrink;
                }
                break;
        }
        if (accepted) break;
    }
    if (!accepted) return SliceRepeat{false, 0.0f, logzero, cnt, steps};
    return SliceRepeat{true, t, logL_store, cnt, steps};
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
