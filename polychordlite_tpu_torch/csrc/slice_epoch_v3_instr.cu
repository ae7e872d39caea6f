// v3's grid steps rebuilt on the card, with the body iterations of every
// step counted: a cooperative kernel, one thread per chain, a grid-wide
// barrier per step.
//
// Replaces the instrumented TPU kernel experiments/v3_instr.py::
// build_epoch_fn_pallas_v3 (pallas_call at :351, kernel body :93-294).  v3
// runs grid=(R,) steps in order over one tile of lanes.  In step r every
// lane runs bodies of 4 micro-steps inside the window rep <= min(r+3, R-1)
// (a lane further ahead stalls), and the step's while loop runs until every
// lane has finished repeat r: at least one body, at most cap_body.  The
// instrumented copy writes that body count per step (:274, :288); with
// `cheap` a body only advances rep (:269-270), which leaves the skeleton:
// R steps, one body each, and no machine.
//
// B4 (slice_epoch_v3.cu) drops the steps: a lane's uniforms are keyed on its
// own (repeat, micro-step), so stalls change nothing it decides.  To count
// the bodies of each step, this kernel keeps them.  In step r each lane
//   1. runs bodies of the shared machine (slice_machine.cuh, its SliceState
//      kept across bodies) under the window until rep > r, counting its
//      bodies n_b >= 1;
//   2. reduces n_b over its warp (__reduce_max_sync) and atomicMax-es the
//      result into iters[r];
//   3. waits at the grid barrier (cooperative_groups::this_grid().sync());
//   4. runs iters[r] - n_b further bodies under the window, as every lane of
//      v3's tile does, and goes on to step r+1.
// So iters[r] is v3's count, and t, logL and nlike are those of B4 and B1
// bit for bit: the same machine makes the same decisions whatever the
// number of bodies.  A lane writes a repeat's record when it accepts it.
//
// Failure modes.  cap_body cannot bind (ROADMAP C9): a lane that would need
// more bodies than the cap sets *overflow, and the wrapper raises.  The
// barrier needs every block resident at once: the launch checks that
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs covers the grid and
// returns cudaErrorCooperativeLaunchTooLarge if not; nothing falls back.
//
// Layout as slice_epoch.cu: x0 (D, B), nhat (R, D, B), w (R, B), chain axis
// minor; outputs t, logL (R, B) float32, nlike (R, B) int32, iters (R,)
// int32 (zeroed by the caller) and overflow (1,) int32 (zeroed).
//
// What bounds it on the card: B1's work and, per step, one barrier over
// every block; the barrier's price is what the study measures (B1 runs the
// same decisions without it).

#include <cooperative_groups.h>

#include "slice_machine.cuh"

namespace cg = cooperative_groups;

#define V3_RC 4    // direction-window slots (v3_instr.py:67)
#define V3_BODY 4  // micro-steps per while-loop body (v3_instr.py:68)

template <class Like, bool CHEAP>
__global__ void slice_epoch_v3_instr_kernel(
    Like like, const float* __restrict__ x0t, const float* __restrict__ bound,
    const float* __restrict__ valid, const float* __restrict__ nhat,
    const float* __restrict__ w, float* __restrict__ t_out, float* __restrict__ logL_out,
    int* __restrict__ nlike_out, int B, int D, int R, uint32_t k0, uint32_t k1,
    int max_step, int max_shrink, int cap_body, int* __restrict__ iters,
    int* __restrict__ overflow) {
    cg::grid_group grid = cg::this_grid();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const float logzero = like.logzero;
    const bool live = b < B && valid[b] > 0.5f;
    // the records of a lane that runs no machine (an invalid lane, or any
    // lane of the skeleton): v3's initial ring values
    if (b < B && (CHEAP || !live)) {
        for (int r = 0; r < R; ++r) {
            const size_t o = (size_t)r * B + b;
            t_out[o] = 0.0f;
            logL_out[o] = logzero;
            nlike_out[o] = 0;
        }
    }
    int rep = live ? 0 : R;
    float x0[SLICE_MAXD];
    float n[SLICE_MAXD];
    float bnd = 0.0f, wr = 0.0f;
    uint32_t h_rep = 0;
    bool pending = true;  // the direction of `rep` is still to be fetched
    SliceState s;
    s.start();
    if (!CHEAP && live) {
        slice_load(x0, x0t, 0, D, B, b);
        bnd = bound[b];
    }
    const uint32_t h_lane = mix32(mix32(k0, k1), (uint32_t)b);

    // one while-loop body of step r (v3_instr.py:155-275)
    auto body = [&](int window_hi) {
        if constexpr (CHEAP) {
            ++rep;  // every lane, valid or not (v3_instr.py:270)
        } else {
#pragma unroll 1
            for (int k = 0; k < V3_BODY && rep <= window_hi; ++k) {
                if (pending) {  // a freshly started repeat inside the window
                    slice_load(n, nhat, (size_t)rep * D * B, D, B, b);
                    wr = w[(size_t)rep * B + b];
                    h_rep = mix32(h_lane, (uint32_t)rep);
                    s.start();
                    pending = false;
                }
                float t = 0.0f, logL_store = logzero;
                if (slice_micro(like, s, x0, n, wr, bnd, h_rep, D, max_step, max_shrink, t,
                                logL_store)) {
                    const size_t o = (size_t)rep * B + b;
                    t_out[o] = t;
                    logL_out[o] = logL_store;
                    nlike_out[o] = s.cnt;
                    slice_advance(x0, n, t, D);
                    ++rep;
                    pending = true;
                }
            }
        }
    };

    for (int r = 0; r < R; ++r) {
        const int window_hi = min(r + V3_RC - 1, R - 1);
        int nb = 0;
        do {
            body(window_hi);
            ++nb;
        } while (rep <= r && nb < cap_body);
        if (rep <= r) *overflow = 1;  // cap_body bound: v3 would lose this repeat (C9)
        // every thread of the warp gets here: no early return above
        const int m = __reduce_max_sync(0xffffffffu, nb);
        if ((threadIdx.x & 31) == 0) atomicMax(&iters[r], m);
        grid.sync();
        const int total = __ldcg(&iters[r]);
        for (; nb < total; ++nb) body(window_hi);
    }
}

template <bool CHEAP>
static int launch(int functor, const float* consts, const float* prior_a,
                  const float* prior_s, const void* x0t, const void* bound,
                  const void* valid, const void* nhat, const void* w, void* t_out,
                  void* logL_out, void* nlike_out, int B, int D, int R, unsigned int k0,
                  unsigned int k1, int max_step, int max_shrink, long long cap_body,
                  float logzero, void* stream, void* iters, void* overflow) {
    if (D < 1 || D > SLICE_MAXD || R < 1 || B < 1 || cap_body < 1 || cap_body > (1 << 30))
        return (int)cudaErrorInvalidValue;
    const int threads = 32;  // one warp per block, as slice_epoch.cu
    const int blocks = (B + threads - 1) / threads;
    int status = 0;
    const int bad = with_likelihood(
        functor, consts, prior_a, prior_s, D, logzero, (cudaStream_t)stream,
        [&](auto like) {
            auto kernel = slice_epoch_v3_instr_kernel<decltype(like), CHEAP>;
            int device = 0, sms = 0, per_sm = 0, coop = 0;
            cudaError_t e = cudaGetDevice(&device);
            if (e == cudaSuccess)
                e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
            if (e == cudaSuccess)
                e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
            if (e == cudaSuccess)
                e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
            if (e != cudaSuccess) {
                status = (int)e;
                return;
            }
            if (!coop) {
                status = (int)cudaErrorNotSupported;
                return;
            }
            if ((long long)per_sm * sms < blocks) {  // not co-resident: the barrier would hang
                status = (int)cudaErrorCooperativeLaunchTooLarge;
                return;
            }
            const float* a_x0t = (const float*)x0t;
            const float* a_bound = (const float*)bound;
            const float* a_valid = (const float*)valid;
            const float* a_nhat = (const float*)nhat;
            const float* a_w = (const float*)w;
            float* a_t = (float*)t_out;
            float* a_logL = (float*)logL_out;
            int* a_nlike = (int*)nlike_out;
            int* a_iters = (int*)iters;
            int* a_overflow = (int*)overflow;
            uint32_t a_k0 = k0, a_k1 = k1;
            int a_cap = (int)cap_body;
            void* args[] = {&like,    &a_x0t,  &a_bound, &a_valid,    &a_nhat,     &a_w,
                            &a_t,     &a_logL, &a_nlike, &B,          &D,          &R,
                            &a_k0,    &a_k1,   &max_step, &max_shrink, &a_cap,     &a_iters,
                            &a_overflow};
            status = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                                      dim3(threads), args, 0,
                                                      (cudaStream_t)stream);
        });
    if (bad) return bad;
    if (status) return status;
    return (int)cudaGetLastError();
}

// The interface of slice_epoch_launch (slice_epoch.cu), with `cap` the
// bodies one grid step may run (cap_body) and two further device arrays:
// iters (R,) int32 and overflow (1,) int32, both zeroed.  Returns a CUDA
// error code: cudaErrorCooperativeLaunchTooLarge when the blocks cannot all
// be resident at once.
extern "C" int slice_epoch_v3_instr_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, int max_step, int max_shrink,
    long long cap, float logzero, void* stream, void* iters, void* overflow) {
    return launch<false>(functor, consts, prior_a, prior_s, x0t, bound, valid, nhat, w,
                         t_out, logL_out, nlike_out, B, D, R, k0, k1, max_step,
                         max_shrink, cap, logzero, stream, iters, overflow);
}

// The skeleton (v3_instr.py's cheap=True): the same steps and barriers, a
// body that only advances rep, records of a lane that ran nothing.
extern "C" int slice_epoch_v3_cheap_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, int max_step, int max_shrink,
    long long cap, float logzero, void* stream, void* iters, void* overflow) {
    return launch<true>(functor, consts, prior_a, prior_s, x0t, bound, valid, nhat, w,
                        t_out, logL_out, nlike_out, B, D, R, k0, k1, max_step,
                        max_shrink, cap, logzero, stream, iters, overflow);
}
