// v3's grid steps rebuilt on the card, with the body iterations of every
// step counted (E2): a cooperative kernel, one chain on a group of G lanes, a
// grid-wide barrier per step.
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
// B4 (slice_epoch_v3.cu) drops the steps: a chain's uniforms are keyed on
// its own (repeat, micro-step), so stalls change nothing it decides.  To
// count the bodies of each step, this kernel keeps them.  In step r each
// chain
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
// number of bodies.  A chain writes a repeat's record when it accepts it.
//
// The layout is B1's (slice_epoch.cuh), so that the study prices v3's
// structure — the barrier, the window, the bodies of the chains that wait —
// against B4 at the same G: lane g of a group of G owns coordinates
// d = g + k G and evaluates through GroupLane's two-stage like_eval, whose
// ballot and shuffles take the full warp.  So the warp's 32 / G chains run
// every loop together, and each test that one thread made for itself is
// made for the warp: a body is 4 micro-steps for every chain, and a chain
// outside its window, or with no body to run, runs each micro-step on a
// copy of its state and keeps nothing; step 1 loops while __any_sync says a
// chain of the warp still needs a body, each chain counting its own n_b;
// step 4 runs to the warp's largest iters[r] - n_b.  G = 1 keeps the
// one-thread loops (instr_one), as B1 and B4 keep theirs; the skeleton runs
// there only: it has no machine to spread.  The launch picks G as B4 does
// (ops/pallas_slice_v4.py::choose_group); at G >= 8 the kernel is held to
// 128 registers, so that 16 one-warp blocks fit an SM (the bench's 8,192
// chains at G = 8 are 2,048 blocks on 132 SMs).
//
// Failure modes.  cap_body cannot bind (ROADMAP C9): a chain that would
// need more bodies than the cap sets *overflow, and the wrapper raises.  The
// barrier needs every block resident at once: the launch checks that
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs covers the B G / 32
// blocks and returns cudaErrorCooperativeLaunchTooLarge if not; nothing
// falls back.
//
// Layout as slice_epoch.cu: x0 (D, B), nhat (R, D, B), w (R, B), chain axis
// minor; outputs t, logL (R, B) float32, nlike (R, B) int32, iters (R,)
// int32 (zeroed by the caller) and overflow (1,) int32 (zeroed).
//
// What bounds it on the card: B4's work and, per step, one barrier over
// every block and the bodies the waiting chains run; their price is what
// the study measures (B4 runs the same decisions without them).  On an
// H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md, section 6), at the
// bench's 8,192 chains: 1.58 ms at G = 8 against B4's 0.81, 7.6 µs a step;
// 2.34 ms at G = 1 against B4's 1.68, 6.6 µs a step.  A step costs more at
// G = 8: there B4's warp waits for its 4 chains, E2's, every step, for the
// slowest chain of the grid.

#include <cooperative_groups.h>

#include "slice_epoch.cuh"

namespace cg = cooperative_groups;

#define V3_RC 4    // direction-window slots (v3_instr.py:67)
#define V3_BODY 4  // micro-steps per while-loop body (v3_instr.py:68)

struct InstrArgs {
    EpochArgs e;  // inputs and records as the free-running epoch's
    int cap_body;
    int* iters;
    int* overflow;
};

// G = 1: one thread per chain, each test its own.
template <class Like, bool CHEAP>
__device__ __forceinline__ void instr_one(const Like& like, const InstrArgs& ia,
                                          cg::grid_group& grid) {
    const EpochArgs& a = ia.e;
    const int B = a.B, D = a.D, R = a.R;
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const float logzero = like.logzero;
    const bool live = b < B && a.valid[b] > 0.5f;
    // the records of a lane that runs no machine (an invalid lane, or any
    // lane of the skeleton): v3's initial ring values
    if (b < B && (CHEAP || !live))
        for (int r = 0; r < R; ++r) write_repeat(a, r, b, 0.0f, logzero, 0);
    int rep = live ? 0 : R;
    float x0[SLICE_MAXD];
    float n[SLICE_MAXD];
    float bnd = 0.0f, wr = 0.0f;
    uint32_t h_rep = 0;
    bool pending = true;  // the direction of `rep` is still to be fetched
    SliceState s;
    s.start();
    if (!CHEAP && live) {
        slice_load(x0, a.x0t, 0, D, B, b);
        bnd = a.bound[b];
    }
    const uint32_t h_lane = mix32(mix32(a.k0, a.k1), a.lane0 + (uint32_t)b);

    // one while-loop body of step r (v3_instr.py:155-275)
    auto body = [&](int window_hi) {
        if constexpr (CHEAP) {
            ++rep;  // every lane, valid or not (v3_instr.py:270)
        } else {
#pragma unroll 1
            for (int k = 0; k < V3_BODY && rep <= window_hi; ++k) {
                if (pending) {  // a freshly started repeat inside the window
                    slice_load(n, a.nhat, (size_t)rep * D * B, D, B, b);
                    wr = a.w[(size_t)rep * B + b];
                    h_rep = mix32(h_lane, (uint32_t)rep);
                    s.start();
                    pending = false;
                }
                float t = 0.0f, logL_store = logzero;
                if (slice_micro(like, s, x0, n, wr, bnd, h_rep, D, a.max_step, a.max_shrink, t,
                                logL_store)) {
                    write_repeat(a, rep, b, t, logL_store, s.cnt);
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
        } while (rep <= r && nb < ia.cap_body);
        if (rep <= r) *ia.overflow = 1;  // cap_body bound: v3 would lose this repeat (C9)
        // every thread of the warp gets here: no early return above
        const int m = __reduce_max_sync(0xffffffffu, nb);
        if ((threadIdx.x & 31) == 0) atomicMax(&ia.iters[r], m);
        grid.sync();
        const int total = __ldcg(&ia.iters[r]);
        for (; nb < total; ++nb) body(window_hi);
    }
}

// G > 1: chain b on lane g of its group; every loop warp-uniform.
template <int G, class Like>
__device__ __forceinline__ void instr_group(const Like& like, const InstrArgs& ia,
                                            cg::grid_group& grid) {
    constexpr int K = SLICE_MAXD / G;
    const EpochArgs& a = ia.e;
    const int B = a.B, D = a.D, R = a.R;
    const int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
    const int b = lane_id / G, g = lane_id % G;
    const float logzero = like.logzero;
    GroupLane<G, Like> L{like, {}, {}, g, group_mask<G>(threadIdx.x), logzero};
    group_prior(L);
    const bool live = b < B && a.valid[b] > 0.5f;
    if (b < B && !live && g == 0)  // v3's initial ring values
        for (int r = 0; r < R; ++r) write_repeat(a, r, b, 0.0f, logzero, 0);
    int rep = live ? 0 : R;
    float x0[K] = {}, n[K] = {};
    float bnd = 0.0f, wr = 0.0f;
    uint32_t h_rep = 0;
    bool pending = true;  // the direction of `rep` is still to be fetched
    SliceState s;
    s.start();
    if (live) {
        slice_load<G>(x0, a.x0t, 0, D, B, b, g);
        bnd = a.bound[b];
    }
    const uint32_t h_lane = mix32(mix32(a.k0, a.k1), a.lane0 + (uint32_t)b);

    // one body for every chain of the warp; a chain that takes no part
    // (`run` false) or stands outside its window keeps nothing
    auto body = [&](int window_hi, bool run) {
#pragma unroll 1
        for (int k = 0; k < V3_BODY; ++k) {
            const bool active = run && rep <= window_hi;
            if (active && pending) {  // a freshly started repeat inside the window
                slice_load<G>(n, a.nhat, (size_t)rep * D * B, D, B, b, g);
                wr = a.w[(size_t)rep * B + b];
                h_rep = mix32(h_lane, (uint32_t)rep);
                s.start();
                pending = false;
            }
            SliceState next = s;
            float t = 0.0f, logL_store = logzero;
            const bool accepted = slice_micro(L, next, x0, n, wr, bnd, h_rep, D, a.max_step,
                                              a.max_shrink, t, logL_store);
            if (active) {
                s = next;
                if (accepted) {
                    if (g == 0) write_repeat(a, rep, b, t, logL_store, s.cnt);
                    slice_advance<G>(x0, n, t, D, g);
                    ++rep;
                    pending = true;
                }
            }
        }
    };

    for (int r = 0; r < R; ++r) {
        const int window_hi = min(r + V3_RC - 1, R - 1);
        int nb = 0;
        bool need = true;  // every chain runs at least one body
        while (__any_sync(0xffffffffu, need)) {
            body(window_hi, need);
            if (need) ++nb;
            need = rep <= r && nb < ia.cap_body;
        }
        if (rep <= r) *ia.overflow = 1;  // cap_body bound: v3 would lose this repeat (C9)
        const int m = __reduce_max_sync(0xffffffffu, nb);
        if ((threadIdx.x & 31) == 0) atomicMax(&ia.iters[r], m);
        grid.sync();
        const int total = __ldcg(&ia.iters[r]);
        while (__any_sync(0xffffffffu, nb < total)) {
            const bool run = nb < total;
            body(window_hi, run);
            if (run) ++nb;
        }
    }
}

template <class Like, int G, bool CHEAP>
__global__ void __launch_bounds__(32, G >= 8 ? 16 : 1)
    slice_epoch_v3_instr_kernel(Like like, InstrArgs ia) {
    static_assert(G == 1 || !CHEAP, "the skeleton runs one lane per chain");
    cg::grid_group grid = cg::this_grid();
    if constexpr (G == 1)
        instr_one<Like, CHEAP>(like, ia, grid);
    else
        instr_group<G>(like, ia, grid);
}

// Call fn with the kernel of `group` lanes per chain (the skeleton: G = 1).
template <class Like, bool CHEAP, class Fn>
void with_instr_kernel(int group, Fn&& fn) {
    if constexpr (CHEAP) {
        fn(slice_epoch_v3_instr_kernel<Like, 1, true>);
    } else {
        switch (group) {
            case 1: fn(slice_epoch_v3_instr_kernel<Like, 1, false>); break;
            case 2: fn(slice_epoch_v3_instr_kernel<Like, 2, false>); break;
            case 4: fn(slice_epoch_v3_instr_kernel<Like, 4, false>); break;
            case 8: fn(slice_epoch_v3_instr_kernel<Like, 8, false>); break;
            case 16: fn(slice_epoch_v3_instr_kernel<Like, 16, false>); break;
            default: fn(slice_epoch_v3_instr_kernel<Like, 32, false>); break;
        }
    }
}

// The blocks of one warp of `kernel` that one SM of the current device keeps
// resident, and the SM count.
template <class Kernel>
static cudaError_t resident_blocks(Kernel kernel, int& per_sm, int& sms) {
    int device = 0, coop = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, 0);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    return e;
}

template <bool CHEAP>
static int launch(int group, int functor, const float* consts, const float* prior_a,
                  const float* prior_s, const EpochArgs& e, long long cap_body, float logzero,
                  void* stream, void* iters, void* overflow) {
    if (!epoch_args_ok(e, group) || cap_body < 1 || cap_body > (1 << 30) || (CHEAP && group != 1))
        return (int)cudaErrorInvalidValue;
    InstrArgs ia{e, (int)cap_body, (int*)iters, (int*)overflow};
    const int blocks = (int)(((long long)e.B * group + 31) / 32);  // one warp per block
    int status = 0;
    const int bad = with_likelihood(
        functor, consts, prior_a, prior_s, e.D, logzero, (cudaStream_t)stream,
        [&](auto like) {
            with_instr_kernel<decltype(like), CHEAP>(group, [&](auto kernel) {
                int per_sm = 0, sms = 0;
                const cudaError_t q = resident_blocks(kernel, per_sm, sms);
                if (q != cudaSuccess) {
                    status = (int)q;
                } else if ((long long)per_sm * sms < blocks) {  // the barrier would hang
                    status = (int)cudaErrorCooperativeLaunchTooLarge;
                } else {
                    void* args[] = {&like, &ia};
                    status = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                                              dim3(32), args, 0,
                                                              (cudaStream_t)stream);
                }
            });
        });
    if (bad) return bad;
    if (status) return status;
    return (int)cudaGetLastError();
}

// The interface of slice_epoch_launch (slice_epoch.cu), with `cap` the
// bodies one grid step may run (cap_body), two further device arrays:
// iters (R,) int32 and overflow (1,) int32, both zeroed, and `group` G, the
// lanes per chain (1, 2, 4, 8, 16 or 32).  Returns a CUDA error code:
// cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be resident
// at once.
extern "C" int slice_epoch_v3_instr_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, void* iters, void* overflow,
        int group) {
    return launch<false>(group, functor, consts, prior_a, prior_s,
                         at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out,
                                             nlike_out, B, D, R, k0, k1, max_step, max_shrink,
                                             0), lane0),
                         cap, logzero, stream, iters, overflow);
}

// The skeleton (v3_instr.py's cheap=True): the same steps and barriers, a
// body that only advances rep, records of a lane that ran nothing; `group`
// must be 1.
extern "C" int slice_epoch_v3_cheap_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, void* iters, void* overflow,
        int group) {
    return launch<true>(group, functor, consts, prior_a, prior_s,
                        at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out,
                                            nlike_out, B, D, R, k0, k1, max_step, max_shrink,
                                            0), lane0),
                        cap, logzero, stream, iters, overflow);
}

// The one-warp blocks of the `group` kernel of `functor` (built from its
// arguments as slice_epoch_v3_instr_launch builds it) that one SM of the
// current device keeps resident: the occupancy the launch reads.  Returns
// that count, or minus a CUDA error.
extern "C" int slice_epoch_v3_instr_resident_blocks(int functor, const float* consts,
                                                    const float* prior_a, const float* prior_s,
                                                    int D, float logzero, void* stream,
                                                    int group) {
    if (D < 1 || D > SLICE_MAXD || group < 1 || group > 32 || (group & (group - 1)))
        return -(int)cudaErrorInvalidValue;
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaSuccess;
    const int bad = with_likelihood(
        functor, consts, prior_a, prior_s, D, logzero, (cudaStream_t)stream, [&](auto like) {
            with_instr_kernel<decltype(like), false>(
                group, [&](auto kernel) { e = resident_blocks(kernel, per_sm, sms); });
        });
    if (bad) return -bad;
    return e == cudaSuccess ? per_sm : -(int)e;
}
