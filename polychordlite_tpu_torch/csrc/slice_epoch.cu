// Free-running slice-sampling epoch: one thread per chain.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_slice_v4.py::
// build_epoch_fn_pallas_v4 (kernel body :136-418).  It carries over v4's
// semantics, not its layout: each chain runs its R repeats of Neal
// stepping-out and shrinkage on the chord x0 + t n̂ with the state machine
// of pallas_slice_v4.py:215-348 —
//   INIT_R -> INIT_L -> STEP_R / STEP_L -> SHRINK,
//   max_step stepping-out steps per side and max_shrink shrinks,
//   inside = logL >= bound && logL > logzero,
//   nlike counts only probes with logL > logzero,
//   a forced accept after max_shrink stores logL = logzero and still moves
//   x0 to the probe,
//   `it` restarts at 0 with every repeat and counts the repeat's probes —
// with the uniform of each probe u = (fmix(mix(mix(h_lane, rep), it)) >> 8)
// * 2^-24, h_lane = mix(mix(k0, k1), lane).  v4's sliding window, DMA ring
// and SMEM base exist only because per-lane indexing is costly on the TPU;
// a lane's stalls there never change its own counter stream, so a thread
// that runs freely makes the same decisions.  A lane stops after the same
// bound on micro-steps that v4 has (pallas_slice_v4.py:134).
//
// The likelihood is evaluated inside the kernel by a functor (template
// parameter) from likelihoods.cuh, behind a per-coordinate affine prior;
// every float operation is an explicitly rounded intrinsic, in the same
// order as the plain torch engine (ops/slice_kernel.py) and the torch
// likelihoods (models/examples.py), so the kernel and its plain version
// agree bit for bit.
//
// Layout: x0 (D, B), nhat (R, D, B) and w (R, B) with the chain axis
// minor, so neighbouring threads read neighbouring words; outputs t, logL
// (R, B) float32 and nlike (R, B) int32.
//
// What bounds it on the card: the work is the likelihood at every
// micro-step (~4 flops per dimension) plus the hash, about 1 kFLOP per
// probe, and a few hundred bytes of direction per repeat — neither the
// arithmetic rate nor the memory bandwidth is near its limit.  The limit
// is parallelism and divergence: one thread per chain gives B threads
// (8192 at the bench geometry, 64 per SM), and lanes of a warp take
// different paths through the state machine and different numbers of
// probes per repeat, so a warp runs as long as its slowest lane.  The
// design keeps all per-lane state in registers (x0 and n̂ as arrays of
// SLICE_MAXD with static indices) and uses small blocks (32 threads) to
// spread the chains over as many SMs as possible.

#include "likelihoods.cuh"

template <class Like>
__global__ void slice_epoch_kernel(Like like, const float* __restrict__ x0t,
                                   const float* __restrict__ bound,
                                   const float* __restrict__ valid,
                                   const float* __restrict__ nhat,
                                   const float* __restrict__ w,
                                   float* __restrict__ t_out,
                                   float* __restrict__ logL_out,
                                   int* __restrict__ nlike_out, int B, int D,
                                   int R, uint32_t k0, uint32_t k1, int max_step,
                                   int max_shrink, long long cap) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float logzero = like.logzero;
    int r = 0;
    if (valid[b] > 0.5f) {
        float x0[SLICE_MAXD];
        float n[SLICE_MAXD];
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d)
            if (d < D) x0[d] = x0t[(size_t)d * B + b];
        const float bnd = bound[b];
        const uint32_t h_lane = mix32(mix32(k0, k1), (uint32_t)b);
        long long steps = 0;
        for (; r < R; ++r) {
#pragma unroll
            for (int d = 0; d < SLICE_MAXD; ++d)
                if (d < D) n[d] = nhat[((size_t)r * D + d) * B + b];
            const float wr = w[(size_t)r * B + b];
            const uint32_t h_rep = mix32(h_lane, (uint32_t)r);
            int phase = PH_INIT_R, rstep = 1, lstep = 1, nshrink = 0, cnt = 0;
            bool need_r = false, need_l = false, accepted = false;
            float tL = 0.0f, tR = 0.0f, t = 0.0f, logL_store = logzero;
            for (uint32_t it = 0; steps < cap; ++it) {
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
            const size_t o = (size_t)r * B + b;
            nlike_out[o] = cnt;
            if (!accepted) {  // the micro-step bound: leave this repeat unaccepted
                t_out[o] = 0.0f;
                logL_out[o] = logzero;
                ++r;
                break;
            }
            t_out[o] = t;
            logL_out[o] = logL_store;
#pragma unroll
            for (int d = 0; d < SLICE_MAXD; ++d)
                if (d < D) x0[d] = __fadd_rn(x0[d], __fmul_rn(t, n[d]));
        }
    }
    for (; r < R; ++r) {  // invalid lanes and repeats never reached
        const size_t o = (size_t)r * B + b;
        t_out[o] = 0.0f;
        logL_out[o] = logzero;
        nlike_out[o] = 0;
    }
}

// All device arrays float32 (nlike int32), contiguous; see the layout
// above.  `functor` is a LIKE_* id of likelihoods.cuh, `consts` its
// constants, and prior_a, prior_s the prior's D-vectors — these three are
// host arrays.  Returns cudaGetLastError() after the launch.
extern "C" int slice_epoch_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, int max_step, int max_shrink,
    long long cap, float logzero, void* stream) {
    if (D < 1 || D > SLICE_MAXD || R < 1 || B < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 32;
    const int blocks = (B + threads - 1) / threads;
    const int bad = with_likelihood(
        functor, consts, prior_a, prior_s, D, logzero, [&](auto like) {
            slice_epoch_kernel<decltype(like)>
                <<<blocks, threads, 0, (cudaStream_t)stream>>>(
                    like, (const float*)x0t, (const float*)bound,
                    (const float*)valid, (const float*)nhat, (const float*)w,
                    (float*)t_out, (float*)logL_out, (int*)nlike_out, B, D, R, k0,
                    k1, max_step, max_shrink, cap);
        });
    if (bad) return bad;
    return (int)cudaGetLastError();
}
