// The v2 slice epoch: one thread per chain, with the cube written by the
// kernel.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_slice.py::
// build_epoch_fn_pallas (kernel body :217-339).  v2 runs grid=(R,) steps
// over one tile of lanes; in step r every lane runs repeat r in lockstep —
// a while loop of 4-micro-step bodies until all lanes have accepted or the
// loop counter reaches max_inner = 2 max_step + max_shrink + 4 — and the
// accepted probe x0 + t n̂, which the kernel itself computed, is written as
// the baby's cube and seeds repeat r+1.  The per-repeat barrier is a TPU
// artefact: a lane's uniforms are keyed on its own (repeat, micro-step)
// (pallas_slice.py:233-252: the while counter restarts at 0 every grid
// step), and a lane that has accepted idles, so the barrier changes no
// lane's result and is not carried over.  Each chain runs its repeats
// freely with the state machine of slice_machine.cuh under v2's per-repeat
// budget, max_inner rounded up to whole 4-step bodies (passed as `cap`).
// That budget cannot bind (a repeat takes at most 2 + 2 max_step +
// max_shrink micro-steps), so t, logL and nlike are those of
// slice_epoch.cu bit for bit.  If it did, the lane would keep its x0 for the
// baby and the next repeat, with logL = logzero, as v2 does.
//
// What differs from slice_epoch.cu is the cube: v2 moves x0 <- x0 + t n̂
// sequentially and writes it after every repeat (pallas_slice.py:301, 336),
// where v3 and v4 rebuild it outside as seed + cumsum(t n̂).  The two agree
// to float rounding only, so a run on this kernel is another chain than a
// run on slice_epoch.cu, held to it statistically.
//
// Layout: x0 (D, B), nhat (R, D, B), w (R, B), chain axis minor; outputs
// t, logL (R, B) float32, nlike (R, B) int32 and cube (R, D, B) float32.
// A lane never accepted (an invalid lane) keeps x0 as its cube.
//
// The counted form (slice_epoch_v2_counted_launch) replaces the
// instrumented TPU kernel experiments/prof_lockstep_waste.py::
// build_instrumented (pallas_call at :165): the same kernel, instantiated
// with COUNTED, also writes the micro-steps of every (lane, repeat) and,
// per repeat, the micro-steps v2's lockstep loop runs over the whole batch
// — whole 4-step bodies until the slowest valid lane accepts: each warp's
// largest step count (__reduce_max_sync), rounded up to a body, goes into
// iters[r] by atomicMax.  Its t, logL, nlike and cube are B5's bit for bit.
// That loop counter is already in micro-steps (prof_lockstep_waste.py:123);
// the JAX study multiplies it by 4 once more (:221, ROADMAP C11), which
// this count does not inherit.
//
// What bounds it on the card: as slice_epoch.cu, parallelism and warp
// divergence; the cube adds R·D·4 bytes of coalesced writes per chain.

#include "slice_machine.cuh"

#define V2_BODY 4  // micro-steps per while-loop body (pallas_slice.py:213)

template <class Like, bool COUNTED>
__global__ void slice_epoch_v2_kernel(Like like, const float* __restrict__ x0t,
                                      const float* __restrict__ bound,
                                      const float* __restrict__ valid,
                                      const float* __restrict__ nhat,
                                      const float* __restrict__ w,
                                      float* __restrict__ t_out,
                                      float* __restrict__ logL_out,
                                      int* __restrict__ nlike_out,
                                      float* __restrict__ cube_out, int B, int D,
                                      int R, uint32_t k0, uint32_t k1, int max_step,
                                      int max_shrink, long long repeat_budget,
                                      int* __restrict__ steps_out,
                                      int* __restrict__ iters) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const bool lane = b < B;
    if constexpr (!COUNTED) {
        if (!lane) return;
    }
    const float logzero = like.logzero;
    float x0[SLICE_MAXD];
    float n[SLICE_MAXD];
    if (lane) slice_load(x0, x0t, 0, D, B, b);
    const bool live = lane && valid[b] > 0.5f;
    const float bnd = lane ? bound[b] : 0.0f;
    const uint32_t h_lane = mix32(mix32(k0, k1), (uint32_t)b);
    for (int r = 0; r < R; ++r) {
        const size_t o = (size_t)r * B + b;
        int steps = 0;  // micro-steps of this lane in repeat r
        if (live) {
            slice_load(n, nhat, (size_t)r * D * B, D, B, b);
            const float wr = w[o];
            const SliceRepeat rep =
                slice_repeat(like, x0, n, wr, bnd, mix32(h_lane, (uint32_t)r), D,
                             max_step, max_shrink, repeat_budget);
            nlike_out[o] = rep.cnt;
            t_out[o] = rep.t;
            logL_out[o] = rep.logL;
            steps = (int)rep.steps;
            if (rep.accepted) slice_advance(x0, n, rep.t, D);
        } else if (lane) {
            nlike_out[o] = 0;
            t_out[o] = 0.0f;
            logL_out[o] = logzero;
        }
        if (lane) {
#pragma unroll
            for (int d = 0; d < SLICE_MAXD; ++d)
                if (d < D) cube_out[((size_t)r * D + d) * B + b] = x0[d];
        }
        if constexpr (COUNTED) {  // every thread of the warp gets here
            if (lane) steps_out[o] = steps;
            // v2's loop runs whole bodies until its slowest lane accepts
            const int m = __reduce_max_sync(0xffffffffu, steps);
            if ((threadIdx.x & 31) == 0 && m > 0)
                atomicMax(&iters[r], (m + V2_BODY - 1) / V2_BODY * V2_BODY);
        }
    }
}

template <bool COUNTED>
static int launch(int functor, const float* consts, const float* prior_a,
                  const float* prior_s, const void* x0t, const void* bound,
                  const void* valid, const void* nhat, const void* w, void* t_out,
                  void* logL_out, void* nlike_out, int B, int D, int R, unsigned int k0,
                  unsigned int k1, int max_step, int max_shrink, long long cap,
                  float logzero, void* stream, void* cube_out, void* steps_out,
                  void* iters) {
    if (D < 1 || D > SLICE_MAXD || R < 1 || B < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 32;  // one warp per block: warp w holds lanes 32w..32w+31
    const int blocks = (B + threads - 1) / threads;
    const int bad = with_likelihood(
        functor, consts, prior_a, prior_s, D, logzero, (cudaStream_t)stream,
        [&](auto like) {
            slice_epoch_v2_kernel<decltype(like), COUNTED>
                <<<blocks, threads, 0, (cudaStream_t)stream>>>(
                    like, (const float*)x0t, (const float*)bound,
                    (const float*)valid, (const float*)nhat, (const float*)w,
                    (float*)t_out, (float*)logL_out, (int*)nlike_out,
                    (float*)cube_out, B, D, R, k0, k1, max_step, max_shrink, cap,
                    (int*)steps_out, (int*)iters);
        });
    if (bad) return bad;
    return (int)cudaGetLastError();
}

// The interface of slice_epoch_launch (slice_epoch.cu), with `cap` the
// micro-steps one repeat may take and cube_out an (R, D, B) float32 device
// array.  Returns cudaGetLastError() after the launch.
extern "C" int slice_epoch_v2_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, int max_step, int max_shrink,
    long long cap, float logzero, void* stream, void* cube_out) {
    return launch<false>(functor, consts, prior_a, prior_s, x0t, bound, valid, nhat, w,
                         t_out, logL_out, nlike_out, B, D, R, k0, k1, max_step,
                         max_shrink, cap, logzero, stream, cube_out, nullptr, nullptr);
}

// The counted form: as slice_epoch_v2_launch, and steps_out (R, B) int32,
// the micro-steps of each (lane, repeat), and iters (R,) int32, zeroed by
// the caller: the micro-steps v2's loop runs in repeat r, 4 * ceil(max over
// the lanes / 4) (0 when no lane is valid).
extern "C" int slice_epoch_v2_counted_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, int max_step, int max_shrink,
    long long cap, float logzero, void* stream, void* cube_out, void* steps_out,
    void* iters) {
    return launch<true>(functor, consts, prior_a, prior_s, x0t, bound, valid, nhat, w,
                        t_out, logL_out, nlike_out, B, D, R, k0, k1, max_step,
                        max_shrink, cap, logzero, stream, cube_out, steps_out, iters);
}
