// Free-running slice epoch with v3's per-step budget: one thread per chain.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_slice_v3.py::
// build_epoch_fn_pallas_v3 (kernel body :93-287).  v3 runs grid=(R,) steps
// over a tile of lanes: step r streams repeat r+3's directions into a ring
// of RC = 4 slots, lanes run through their own repeats freely up to three
// ahead of r (the ones further ahead stall), and the step ends when every
// lane has finished repeat r, or after cap_body loops of 4 micro-steps;
// then slot r is flushed.  The ring, the stalls and the flush exist because
// the TPU grid runs in order over one tile; a lane's uniforms are keyed on
// its own (repeat, micro-step), so they never change what it decides.  Here
// each chain runs its repeats freely with the state machine of
// slice_machine.cuh, and each repeat gets the budget of one v3 grid step,
// cap_body * 4 micro-steps (passed as `cap`).  That budget cannot bind:
// cap_body * 4 >= 2 + 2 max_step + max_shrink + 16, more than a repeat can
// take, so t, logL and nlike are those of slice_epoch.cu bit for bit.  If it
// did bind, v3 would let the lagging lane run on and write its repeat into a
// ring slot already flushed and recycled (pallas_slice_v3.py:278-287,
// ROADMAP C9); this kernel records the repeat unaccepted and stops the lane,
// as slice_epoch.cu does at its budget.
//
// Layout and outputs as slice_epoch.cu: x0 (D, B), nhat (R, D, B), w (R, B),
// chain axis minor; t, logL (R, B) float32, nlike (R, B) int32.  Positions
// are rebuilt outside as seed + cumsum(t n̂) (ops/pallas_slice_v4.py), as
// v3 does (pallas_slice_v3.py:395-399).
//
// What bounds it on the card: as for slice_epoch.cu, parallelism and warp
// divergence — the same work with the same design.

#include "slice_machine.cuh"

template <class Like>
__global__ void slice_epoch_v3_kernel(Like like, const float* __restrict__ x0t,
                                      const float* __restrict__ bound,
                                      const float* __restrict__ valid,
                                      const float* __restrict__ nhat,
                                      const float* __restrict__ w,
                                      float* __restrict__ t_out,
                                      float* __restrict__ logL_out,
                                      int* __restrict__ nlike_out, int B, int D,
                                      int R, uint32_t k0, uint32_t k1, int max_step,
                                      int max_shrink, long long step_budget) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float logzero = like.logzero;
    int r = 0;
    if (valid[b] > 0.5f) {
        float x0[SLICE_MAXD];
        float n[SLICE_MAXD];
        slice_load(x0, x0t, 0, D, B, b);
        const float bnd = bound[b];
        const uint32_t h_lane = mix32(mix32(k0, k1), (uint32_t)b);
        for (; r < R; ++r) {
            slice_load(n, nhat, (size_t)r * D * B, D, B, b);
            const float wr = w[(size_t)r * B + b];
            const SliceRepeat rep =
                slice_repeat(like, x0, n, wr, bnd, mix32(h_lane, (uint32_t)r), D,
                             max_step, max_shrink, step_budget);
            const size_t o = (size_t)r * B + b;
            nlike_out[o] = rep.cnt;
            t_out[o] = rep.t;
            logL_out[o] = rep.logL;
            if (!rep.accepted) {  // one grid step's budget spent: the lane stops
                ++r;
                break;
            }
            slice_advance(x0, n, rep.t, D);
        }
    }
    for (; r < R; ++r) {  // invalid lanes and repeats never reached
        const size_t o = (size_t)r * B + b;
        t_out[o] = 0.0f;
        logL_out[o] = logzero;
        nlike_out[o] = 0;
    }
}

// The interface of slice_epoch_launch (slice_epoch.cu), with `cap` the
// micro-steps one repeat may take.  Returns cudaGetLastError() after the
// launch.
extern "C" int slice_epoch_v3_launch(
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
        functor, consts, prior_a, prior_s, D, logzero, (cudaStream_t)stream,
        [&](auto like) {
            slice_epoch_v3_kernel<decltype(like)>
                <<<blocks, threads, 0, (cudaStream_t)stream>>>(
                    like, (const float*)x0t, (const float*)bound,
                    (const float*)valid, (const float*)nhat, (const float*)w,
                    (float*)t_out, (float*)logL_out, (int*)nlike_out, B, D, R, k0,
                    k1, max_step, max_shrink, cap);
        });
    if (bad) return bad;
    return (int)cudaGetLastError();
}
