// The v2 slice epoch (B5): one chain on a group of G lanes, with the cube
// written by the kernel.
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
// What bounds it on the card is B1's micro-step (slice_epoch.cuh): one
// chain's dependent chain of hash, state machine and D divisions, with too
// few warps to hide it when one thread holds a chain (about 2 warps per SM
// at the bench's 8,192 chains, 16 on the whole card at gaussian.ini's 512);
// the cube adds R D 4 bytes of writes per chain.  So B5 is B1's design:
// slice_epoch.cuh's kernel under V2Policy — the budget counted per repeat,
// the chain going on to its next repeat when it binds, cube row r written
// by each lane for the coordinates it owns after the repeat's advance —
// with G lanes per chain picked as for B1 (ops/pallas_slice_v4.py::
// choose_group).  G = 1 is that template's one-thread loop (chain_epoch).
// Measured on an H100 (PERF.md, section 6): 1.2x B1 at the bench; what it adds
// to B1 is the cube, written as scattered 4-byte words (the chains of a
// warp sit in different repeats), not split further.  At 512 chains G > D
// was faster than the rule's G = D, as for B1.  The next design: write the
// cube rows coalesced, and let the rule take G > D where warps are scarce.
//
// The counted form (slice_epoch_v2_counted_launch) replaces the
// instrumented TPU kernel experiments/prof_lockstep_waste.py::
// build_instrumented (pallas_call at :165): one thread per chain, every
// lane of a warp through every repeat in order, also writing the
// micro-steps of every (lane, repeat) and, per repeat, the micro-steps v2's
// lockstep loop runs over the whole batch — whole 4-step bodies until the
// slowest valid lane accepts: each warp's largest step count
// (__reduce_max_sync), rounded up to a body, goes into iters[r] by
// atomicMax.  Its t, logL, nlike and cube are B5's bit for bit.  That loop
// counter is already in micro-steps (prof_lockstep_waste.py:123); the JAX
// study multiplies it by 4 once more (:221, ROADMAP C11), which this count
// does not inherit.  It stays one thread per chain: it is a study of the
// one-thread lockstep's waste.

#include "slice_epoch.cuh"

#define V2_BODY 4  // micro-steps per while-loop body (pallas_slice.py:213)

// E3: a.lane_steps is (R, B) here, the micro-steps of each (lane, repeat).
template <class Like>
__global__ void slice_epoch_v2_counted_kernel(Like like, EpochArgs a, int* __restrict__ iters) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const bool lane = b < a.B;
    const int B = a.B, D = a.D, R = a.R;
    float x0[SLICE_MAXD];
    float n[SLICE_MAXD];
    if (lane) slice_load(x0, a.x0t, 0, D, B, b);
    const bool live = lane && a.valid[b] > 0.5f;
    const float bnd = lane ? a.bound[b] : 0.0f;
    const uint32_t h_lane = mix32(mix32(a.k0, a.k1), a.lane0 + (uint32_t)b);
    for (int r = 0; r < R; ++r) {
        const size_t o = (size_t)r * B + b;
        int steps = 0;  // micro-steps of this lane in repeat r
        if (live) {
            slice_load(n, a.nhat, (size_t)r * D * B, D, B, b);
            const SliceRepeat rep =
                slice_repeat(like, x0, n, a.w[o], bnd, mix32(h_lane, (uint32_t)r), D,
                             a.max_step, a.max_shrink, a.cap);
            write_repeat(a, r, b, rep.t, rep.logL, rep.cnt);
            steps = (int)rep.steps;
            if (rep.accepted) slice_advance(x0, n, rep.t, D);
        } else if (lane) {
            write_repeat(a, r, b, 0.0f, like.logzero, 0);
        }
        if (lane) {
            repeat_end<V2Policy, 1>(a, r, b, x0, 0);
            a.lane_steps[o] = steps;
        }
        // every thread of the warp gets here: v2's loop runs whole bodies
        // until its slowest lane accepts
        const int m = __reduce_max_sync(0xffffffffu, steps);
        if ((threadIdx.x & 31) == 0 && m > 0)
            atomicMax(&iters[r], (m + V2_BODY - 1) / V2_BODY * V2_BODY);
    }
}

template <bool COUNTED>
static int launch(int group, int functor, const float* consts, const float* prior_a,
                  const float* prior_s, const float* dev, const EpochArgs& a, float logzero,
                  void* stream, int* iters) {
    if (!epoch_args_ok(a, group, COUNTED ? SLICE_MAXD : SLICE_MAXD_STREAM) ||
        (COUNTED && group != 1))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int bad = with_bucket_likelihood(
        functor, consts, prior_a, prior_s, dev, a, logzero, [&](auto like) {
            using L = decltype(like);
            if constexpr (!COUNTED) {
                launch_epoch_group<V2Policy>(group, like, a, st);
            } else if constexpr (L::MAXD == SLICE_MAXD) {
                // one warp per block: warp w holds lanes 32w..32w+31
                const int blocks = (a.B + 31) / 32;
                slice_epoch_v2_counted_kernel<L><<<blocks, 32, 0, st>>>(like, a, iters);
            }
        });
    if (bad) return bad;
    return (int)cudaGetLastError();
}

// The interface of slice_epoch_launch (slice_epoch.cu), with `cap` the
// micro-steps one repeat may take, cube_out an (R, D, B) float32 device
// array and `group` G, the lanes per chain (1, 2, 4, 8, 16 or 32; 32 for
// D > 32, the SLICE_MAXD_WIDE and stream buckets), and `dev` the device
// array of slice_epoch_launch.  Returns cudaGetLastError() after the launch.
extern "C" int slice_epoch_v2_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const float* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, void* cube_out, int group) {
    return launch<false>(group, functor, consts, prior_a, prior_s, dev,
                         at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out,
                                             nlike_out, B, D, R, k0, k1, max_step, max_shrink,
                                             cap, nullptr, nullptr, cube_out), lane0),
                         logzero, stream, nullptr);
}

// The counted form: as slice_epoch_v2_launch at G = 1, and steps_out (R, B)
// int32, the micro-steps of each (lane, repeat), and iters (R,) int32,
// zeroed by the caller: the micro-steps v2's loop runs in repeat r,
// 4 * ceil(max over the lanes / 4) (0 when no lane is valid).
extern "C" int slice_epoch_v2_counted_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const float* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, void* cube_out, void* steps_out,
    void* iters) {
    return launch<true>(1, functor, consts, prior_a, prior_s, dev,
                        at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out,
                                            nlike_out, B, D, R, k0, k1, max_step, max_shrink, cap,
                                            steps_out, nullptr, cube_out), lane0),
                        logzero, stream, (int*)iters);
}
