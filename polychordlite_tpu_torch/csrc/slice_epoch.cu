// Free-running slice-sampling epoch: one thread per chain.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_slice_v4.py::
// build_epoch_fn_pallas_v4 (kernel body :136-418).  It carries over v4's
// semantics, not its layout: each chain runs its R repeats of Neal
// stepping-out and shrinkage on the chord x0 + t n̂ with the state machine
// of pallas_slice_v4.py:215-348, which lives in slice_machine.cuh
// (slice_repeat) and is shared with the v3 and v2 kernels.  v4's sliding
// window, DMA ring and SMEM base exist only because per-lane indexing is
// costly on the TPU; a lane's stalls there never change its own counter
// stream, so a thread that runs freely makes the same decisions.  A lane
// stops after the same bound on micro-steps over the epoch that v4 has
// (pallas_slice_v4.py:134).
//
// The counted form (slice_epoch_counted_launch) replaces the instrumented
// TPU kernel experiments/v4_instr.py::build_epoch_fn_pallas_v4 (:384, in
// the repository's top-level experiments/): the same kernel, instantiated with
// COUNTED, also writes the micro-steps each lane executed and, per warp,
// the largest of its 32 lanes' (__reduce_max_sync).  A warp runs as long
// as its slowest lane, so sum(lane steps) / (32 * sum(warp max)) is the
// share of issued lane-steps that did work: the lane efficiency.  Its t,
// logL and nlike are B1's bit for bit.
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

#include "slice_machine.cuh"

template <class Like, bool COUNTED>
__global__ void slice_epoch_kernel(Like like, const float* __restrict__ x0t,
                                   const float* __restrict__ bound,
                                   const float* __restrict__ valid,
                                   const float* __restrict__ nhat,
                                   const float* __restrict__ w,
                                   float* __restrict__ t_out,
                                   float* __restrict__ logL_out,
                                   int* __restrict__ nlike_out, int B, int D,
                                   int R, uint32_t k0, uint32_t k1, int max_step,
                                   int max_shrink, long long cap,
                                   int* __restrict__ lane_steps,
                                   int* __restrict__ warp_max) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    long long steps = 0;  // micro-steps of this lane in the epoch
    if (b < B) {
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
                                 max_step, max_shrink, cap - steps);
                steps += rep.steps;
                const size_t o = (size_t)r * B + b;
                nlike_out[o] = rep.cnt;
                t_out[o] = rep.t;
                logL_out[o] = rep.logL;
                if (!rep.accepted) {  // the epoch's budget: the lane stops here
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
    if constexpr (COUNTED) {  // every thread of the warp gets here (no early return)
        const int s = (int)steps;
        if (b < B) lane_steps[b] = s;
        const int m = __reduce_max_sync(0xffffffffu, s);
        if ((threadIdx.x & 31) == 0) warp_max[b >> 5] = m;
    }
}

template <bool COUNTED>
static int launch(int functor, const float* consts, const float* prior_a,
                  const float* prior_s, const void* x0t, const void* bound,
                  const void* valid, const void* nhat, const void* w, void* t_out,
                  void* logL_out, void* nlike_out, int B, int D, int R, unsigned int k0,
                  unsigned int k1, int max_step, int max_shrink, long long cap,
                  float logzero, void* stream, void* lane_steps, void* warp_max) {
    if (D < 1 || D > SLICE_MAXD || R < 1 || B < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 32;  // one warp per block: warp w holds lanes 32w..32w+31
    const int blocks = (B + threads - 1) / threads;
    const int bad = with_likelihood(
        functor, consts, prior_a, prior_s, D, logzero, (cudaStream_t)stream,
        [&](auto like) {
            slice_epoch_kernel<decltype(like), COUNTED>
                <<<blocks, threads, 0, (cudaStream_t)stream>>>(
                    like, (const float*)x0t, (const float*)bound,
                    (const float*)valid, (const float*)nhat, (const float*)w,
                    (float*)t_out, (float*)logL_out, (int*)nlike_out, B, D, R, k0,
                    k1, max_step, max_shrink, cap, (int*)lane_steps, (int*)warp_max);
        });
    if (bad) return bad;
    return (int)cudaGetLastError();
}

// All device arrays float32 (nlike int32), contiguous; see the layout
// above.  `functor` is a LIKE_* id of likelihoods.cuh, `consts` its
// constants, and prior_a, prior_s the prior's D-vectors — these three are
// host arrays.  `cap` bounds a lane's micro-steps over the epoch.  Returns
// cudaGetLastError() after the launch.
extern "C" int slice_epoch_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, int max_step, int max_shrink,
    long long cap, float logzero, void* stream) {
    return launch<false>(functor, consts, prior_a, prior_s, x0t, bound, valid, nhat, w,
                         t_out, logL_out, nlike_out, B, D, R, k0, k1, max_step,
                         max_shrink, cap, logzero, stream, nullptr, nullptr);
}

// The counted form: as slice_epoch_launch, and lane_steps (B,) int32 and
// warp_max (ceil(B / 32),) int32 device arrays.
extern "C" int slice_epoch_counted_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, int max_step, int max_shrink,
    long long cap, float logzero, void* stream, void* lane_steps, void* warp_max) {
    return launch<true>(functor, consts, prior_a, prior_s, x0t, bound, valid, nhat, w,
                        t_out, logL_out, nlike_out, B, D, R, k0, k1, max_step,
                        max_shrink, cap, logzero, stream, lane_steps, warp_max);
}
