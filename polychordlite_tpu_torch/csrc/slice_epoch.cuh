// Free-running slice-sampling epoch: one chain on a group of G lanes.  The
// kernel template and its launch, included by the entries that instantiate
// it: slice_epoch.cu (the functors of likelihoods.cuh, every G),
// slice_epoch_fused.cu (a likelihood lowered from torch by
// ops/fused_like.py, the one G the launch picks), slice_epoch_v2.cu (B5:
// the same loop under v2's budget, writing the cube — V2Policy below) and
// slice_epoch_v3.cu (B4: the same loop under v3's budget — V3Policy);
// slice_epoch_v5.cu (B3) evaluates each packet slot with GroupLane's
// like_eval, and slice_epoch_v3_instr.cu (E2) runs v3's grid steps on it.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_slice_v4.py::
// build_epoch_fn_pallas_v4 (kernel body :136-418).  It carries over v4's
// semantics, not its layout: each chain runs its R repeats of Neal
// stepping-out and shrinkage on the chord x0 + t n̂ with the state machine
// of pallas_slice_v4.py:215-348, which lives in slice_machine.cuh
// (slice_repeat) and is shared with the v3 and v2 kernels.  v4's sliding
// window, DMA ring and SMEM base exist only because per-lane indexing is
// costly on the TPU; a lane's stalls there never change its own counter
// stream, so a chain that runs freely makes the same decisions.  A chain
// stops after the same bound on micro-steps over the epoch that v4 has
// (pallas_slice_v4.py:134).
//
// What bounds it on the card (PERF.md): not bytes and not the
// arithmetic rate, but one micro-step's dependent chain with too few warps
// to hide it.  A micro-step is the murmur3 hash (E7's body20_hash: +0.11
// µs over body20's 0.11 µs per iteration), the state machine, and per
// coordinate the probe, the wall test, the prior and an IEEE division — a
// Newton sequence with a slow-path CALL in SASS, 32 of them in the
// one-thread kernel's unrolled loop (body20_div: +0.50 µs for 20) — then
// the index-order sum.  One thread per chain takes 2.7 µs per micro-step,
// and 4x the chains take only 1.3x the time: at B = 8192 there are ~2
// warps per SM, at gaussian.ini's B = 512 16 warps on the whole card.
//
// The design: G lanes of one warp (G in 1, 2, 4, ..., 32) hold one chain.
// Lane g owns the coordinates d = g + k G and keeps their x0, n̂ and prior
// coefficients in registers.  Every lane of the group runs the same scalar
// state machine and draws the same murmur3 uniform, so nothing is broadcast
// for the decisions.  A probe's per-coordinate stage (likelihoods.cuh:
// term) runs on the lane that owns the coordinate, so the group shares the
// D divisions; the wall flag is reduced over the group's lanes by a ballot
// and the terms reach every lane by __shfl_sync, where each lane adds them
// in index order (combine) exactly as the one-thread form does.  The 32 / G
// chains of a warp run one loop of micro-steps together (group_epoch), each
// chain in its own repeat and phase: so the warp's ballots and shuffles
// take the full mask.  (Per-group masks, with each chain's loops
// free-running, made the chains of a warp take turns: 33 WARPSYNCs per
// micro-step, and at G = 2 a micro-step cost twice G = 1's.)  Nothing
// synchronises beyond the warp.  More lanes per chain put more warps on the
// card (latency hidden) and spend G times the issue slots on each chain's
// machine and sums (throughput), so the launch picks G from B, D and the
// SM count (ops/pallas_slice_v4.py::choose_group).  G = 1 is the same
// template with the group parts compiled out: one thread per chain, its
// repeats one slice_repeat after another (chain_epoch).  It keeps that loop
// because the warp-wide loop at G = 1 (group_epoch<1> with the one-thread
// like_eval) made the same decisions and step counts but took 1.28x the
// time at the bench geometry (2.14-2.15 ms against 1.67-1.68) and 1.25x at
// gaussian.ini's (0.79-0.82 against 0.64-0.66), the counted form likewise:
// chip_smoke.py's measure_first and lane_efficiency phases, both trees
// twice in one run on an H100 80GB HBM3 at 700 W (PERF.md, section 6).
//
// Three dimension buckets (slice_common.cuh).  The functor's MAXD sizes every
// per-lane array, K = MAXD / G slots a lane.  In the SLICE_MAXD = 32 bucket
// every G is instantiated and the code is the design above.  Above D = 32
// the SLICE_MAXD_WIDE = 128 bucket holds a chain on G = 32 lanes only
// (K <= SLICE_LANE_CAP = 4: G = 1 would keep 128 coordinates a thread; G =
// 16 measured slower than G = 32 at every wide shape timed, PERF.md section
// 6), and its combine does not take the terms into registers — NT x 128
// floats a lane would spill — but from shared memory: each lane stores the
// terms it owns into its chain's row (NT x 128 + 1 floats; one warp, so one
// chain, a block), a __syncwarp, and every lane of the group runs the same
// index-order combine from the row (broadcast reads).  The order of every
// float operation is the 32 bucket's, so each G is bitwise the plain
// version and G = 32.  What bounds a wide micro-step is that combine: a
// chain of D dependent adds (the index order the torch calc fixes), with
// one warp a chain and 512 chains on 132 SMs.
//
// Above D = 128 the stream bucket (MAXD = SLICE_MAXD_STREAM, no compile-time
// bound) holds a chain on G = 32 lanes as the wide bucket does, but nothing
// of the chain sits in registers: its x0, its n̂ and its staged terms are
// rows of the block's dynamic shared memory, (2 + NT) D values of the run's
// type (one chain, one warp, a block), lane g owning the coordinates d = g
// (mod 32), which it alone reads and writes in x0 and n̂ (so no barrier
// guards them; the terms are fenced by __syncwarp as in the wide bucket).
// Every per-coordinate loop (the load, the advance, the cube row, the term
// stage) runs to the run-time D, and the prior's a and s come by pointer
// (DevicePriorT, likelihoods.cuh).  The combine and the order of every
// operation are the wide bucket's, so the plain version is the same.  D is
// bounded by the 227 KB a block may have: (2 + NT) D sizeof(T) <=
// SLICE_SMEM_MAX, D <= 14,528 in float32 at NT = 2
// (ops/pallas_slice_v4.py::stream_max_d); a request above 48 KB sets the
// kernel's dynamic shared-memory attribute first.  What bounds a micro-step is again the combine's D dependent adds,
// now read from shared memory one per add.
//
// The counted form (slice_epoch_counted_launch) replaces the instrumented
// TPU kernel experiments/v4_instr.py::build_epoch_fn_pallas_v4 (:384, in
// the repository's top-level experiments/): the G = 1 kernel, instantiated
// with COUNTED, also writes the micro-steps each lane executed and, per
// warp, the largest of its 32 lanes' (__reduce_max_sync).  A warp runs as
// long as its slowest lane, so sum(lane steps) / (32 * sum(warp max)) is
// the share of issued lane-steps that did work: the lane efficiency of the
// one-thread design.  Its t, logL and nlike are B1's bit for bit.
//
// Every float operation is an explicitly rounded intrinsic, in the same
// order as the plain torch engine (ops/slice_kernel.py) and the torch
// likelihoods (models/examples.py), so the kernel at every G and its plain
// version agree bit for bit.
//
// The template follows its functor's scalar type (real_of, likelihoods.cuh):
// float for every kernel, double for the fused route at
// precision='highest', whose state, directions, bound, records and staged
// terms are then double (slice_epoch_fused.cu).  Double doubles the
// registers of the chain state and the wide bucket's staged row.
//
// Layout: x0 (D, B), nhat (R, D, B) and w (R, B) with the chain axis
// minor; outputs t, logL (R, B) float32 and nlike (R, B) int32.  With
// G > 1 a warp's load of one coordinate touches G rows of 32 / G chains
// each; chains of a warp sit in different repeats (they run freely), so a
// repeat's directions cannot be staged for the block — they are read once
// per repeat, a few hundred bytes against the repeat's ~10 probes.

#pragma once

#include "slice_machine.cuh"

// Where an epoch counts its micro-step budget and what it does at a repeat's
// end: the policy of the kernels built on this template.
//   PER_REPEAT  the budget counts each repeat's micro-steps (v2, v3), not the
//               epoch's (v4);
//   STOP        a repeat the budget ends unaccepted stops the chain (v4,
//               v3); otherwise the chain keeps x0 and goes on to its next
//               repeat (v2);
//   CUBE        every repeat writes cube row r = x0 after the advance (v2).
// Either way such a repeat records t = 0, logL = logzero and its count.
struct V4Policy {  // B1 (slice_epoch.cu, slice_epoch_fused.cu)
    static constexpr bool PER_REPEAT = false, STOP = true, CUBE = false;
};
struct V2Policy {  // B5 (slice_epoch_v2.cu)
    static constexpr bool PER_REPEAT = true, STOP = false, CUBE = true;
};
struct V3Policy {  // B4 (slice_epoch_v3.cu)
    static constexpr bool PER_REPEAT = true, STOP = true, CUBE = false;
};

// B5's cube row r of chain b: each lane writes the coordinates it owns.
template <class Policy, int G, int MAXD = SLICE_MAXD, class T>
__device__ __forceinline__ void repeat_end(const EpochArgsT<T>& a, int r, int b, const T* x0,
                                           int g) {
    if constexpr (Policy::CUBE && MAXD == SLICE_MAXD_STREAM) {
        for (int d = g; d < a.D; d += G) a.cube_out[((size_t)r * a.D + d) * a.B + b] = x0[d];
    } else if constexpr (Policy::CUBE) {
#pragma unroll
        for (int k = 0; k < MAXD / G; ++k) {
            const int d = g + k * G;
            if (d < a.D) a.cube_out[((size_t)r * a.D + d) * a.B + b] = x0[k];
        }
    }
}

// Lane g of the group of G lanes that holds one chain: the functor, the
// prior coefficients of the coordinates d = g + k G it owns, and its
// group's lanes in the warp.  like_eval on it is the two-stage form; every
// lane of the warp calls it together (group_epoch), so its warp operations
// take the full mask.
template <int G, class Like, bool STREAM = Like::MAXD == SLICE_MAXD_STREAM>
struct GroupLane {
    using Real = real_of<Like>;
    static constexpr int K = Like::MAXD / G;
    const Like& like;
    Real a[K], s[K];
    int g;
    unsigned mask;
    Real logzero;
};

// ... in the stream bucket: the prior stays the functor's (by pointer), and
// the chain's rows of shared memory, x0 (D), n̂ (D) and the terms (NT x D),
// take the place of registers.
template <int G, class Like>
struct GroupLane<G, Like, true> {
    using Real = real_of<Like>;
    const Like& like;
    int g;
    unsigned mask;
    Real logzero;
    Real* x0;
    Real* n;
    Real* terms;
};

// The terms of the 128 bucket's chain, staged in shared memory: T[j][d].
template <int MAXD, class Real = float>
struct StagedTerms {
    const Real* p;
    __device__ __forceinline__ const Real* operator[](int j) const { return p + j * MAXD; }
};

// ... of the stream bucket's chain, rows of `stride` = D values.
template <class Real>
struct StreamTerms {
    const Real* p;
    int stride;
    __device__ __forceinline__ const Real* operator[](int j) const { return p + j * stride; }
};

template <int G, class Like>
__device__ __forceinline__ real_of<Like> like_eval(const GroupLane<G, Like>& L,
                                                   const real_of<Like>* x0,
                                                   const real_of<Like>* n, real_of<Like> t,
                                                   int D) {
    using Real = real_of<Like>;
    constexpr int NT = Like::NT, MAXD = Like::MAXD;
    if constexpr (MAXD == SLICE_MAXD_STREAM) {
        // the stream bucket: each lane stores the terms of the coordinates it
        // owns straight into the chain's row, as it makes them, and every
        // lane combines from there, as in the 128 bucket
        bool inside = true;
        __syncwarp();  // the previous micro-step's combine has read the row
        for (int d = L.g; d < D; d += G) {
            Real o[NT] = {};
            L.like.term(
                probe_theta(x0[d], n[d], t, L.like.prior.a[d], L.like.prior.s[d], inside), d, o);
#pragma unroll
            for (int j = 0; j < NT; ++j) L.terms[j * D + d] = o[j];
        }
        inside = (__ballot_sync(0xffffffffu, inside) & L.mask) == L.mask;
        __syncwarp();
        return like_result(L.like.combine(StreamTerms<Real>{L.terms, D}, D), inside,
                           L.logzero);
    } else {
    constexpr int K = GroupLane<G, Like>::K;
    bool inside = true;
    Real own[NT][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {  // the per-coordinate stage, on the owner
        const int d = L.g + k * G;
        Real o[NT] = {};
        if (d < D) L.like.term(probe_theta(x0[k], n[k], t, L.a[k], L.s[k], inside), d, o);
#pragma unroll
        for (int j = 0; j < NT; ++j) own[j][k] = o[j];
    }
    inside = (__ballot_sync(0xffffffffu, inside) & L.mask) == L.mask;
    if constexpr (MAXD == SLICE_MAXD) {
        // every term to every lane of the group, in batches of 8 slots under a
        // warp-uniform test so that a batch's shuffles go out back to back
        Real T[NT][SLICE_MAXD];
#pragma unroll
        for (int c = 0; c < SLICE_MAXD; c += 8) {
            if (c < D) {
#pragma unroll
                for (int d = c; d < c + 8; ++d)
#pragma unroll
                    for (int j = 0; j < NT; ++j)
                        T[j][d] = __shfl_sync(0xffffffffu, own[j][d / G], d % G, G);
            }
        }
        return like_result(L.like.combine(T, D), inside, L.logzero);
    } else {
        // the 128 bucket: NT x MAXD terms per chain would spill from every
        // lane's registers, so each lane stages the terms it owns in its
        // chain's row of shared memory (one warp per block; the odd row
        // stride puts the chains of a warp on distinct banks) and every lane
        // of the group combines from there, in the same index order
        __shared__ Real staged[32 / G][NT * MAXD + 1];
        Real* row = staged[(threadIdx.x & 31) / G];
        __syncwarp();  // the previous micro-step's combine has read the row
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int d = L.g + k * G;
            if (d < D) {
#pragma unroll
                for (int j = 0; j < NT; ++j) row[j * MAXD + d] = own[j][k];
            }
        }
        __syncwarp();
        return like_result(L.like.combine(StagedTerms<MAXD, Real>{row}, D), inside,
                           L.logzero);
    }
    }
}

// The lanes of the group of G that holds lane `lane` of a warp.
template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
    return (0xffffffffu >> (32 - G)) << ((lane & 31) & ~(G - 1));
}

// Lane g's prior coefficients: those of the coordinates d = g + k G.
template <int G, class Like>
__device__ __forceinline__ void group_prior(GroupLane<G, Like>& L) {
#pragma unroll
    for (int k = 0; k < Like::MAXD / G; ++k) {
#pragma unroll
        for (int j = 0; j < G; ++j) {  // static indices into the parameter
            if (L.g == j) {
                L.a[k] = L.like.prior.a[j + k * G];
                L.s[k] = L.like.prior.s[j + k * G];
            }
        }
    }
}

// G = 1: the R repeats of chain b, one slice_repeat after the other.
// Returns the micro-steps the chain took.
template <class Policy, class Like>
__device__ __forceinline__ long long chain_epoch(const Like& like,
                                                 const EpochArgsT<real_of<Like>>& a, int b) {
    static_assert(Like::MAXD == SLICE_MAXD, "one thread per chain in the SLICE_MAXD bucket only");
    using Real = real_of<Like>;
    const int B = a.B, D = a.D, R = a.R;
    long long steps = 0;
    int r = 0;
    const bool valid = a.valid[b] > 0.5f;
    Real x0[SLICE_MAXD], n[SLICE_MAXD];
    if (valid || Policy::CUBE) slice_load(x0, a.x0t, 0, D, B, b);
    if (valid) {
        const Real bnd = a.bound[b];
        const uint32_t h_lane = mix32(mix32(a.k0, a.k1), a.lane0 + (uint32_t)b);
        for (; r < R; ++r) {
            slice_load(n, a.nhat, (size_t)r * D * B, D, B, b);
            const Real wr = a.w[(size_t)r * B + b];
            const SliceRepeatT<Real> rep =
                slice_repeat(like, x0, n, wr, bnd, mix32(h_lane, (uint32_t)r), D, a.max_step,
                             a.max_shrink, Policy::PER_REPEAT ? a.cap : a.cap - steps);
            steps += rep.steps;
            write_repeat(a, r, b, rep.t, rep.logL, rep.cnt);
            if (rep.accepted) slice_advance(x0, n, rep.t, D);
            repeat_end<Policy, 1>(a, r, b, x0, 0);
            if (Policy::STOP && !rep.accepted) {  // the budget: the chain stops here
                ++r;
                break;
            }
        }
    }
    for (; r < R; ++r) {  // invalid, never reached
        write_repeat(a, r, b, Real(0), like.logzero, 0);
        repeat_end<Policy, 1>(a, r, b, x0, 0);
    }
    return steps;
}

// G > 1: chain b on lane g of its group, in one loop of micro-steps that
// every lane of the warp runs together — each iteration, each chain of the
// warp takes its next micro-step, whatever repeat it is in, so the warp
// operations of like_eval see the whole warp converged.  A chain that is
// done (or out of range) still runs the iteration and keeps nothing.  The
// decisions, the budget and the records are slice_repeat's and
// chain_epoch's under the same policy: a repeat that the budget ends
// unaccepted records t = 0, logL = logzero and its count, and the chain
// stops (STOP) or keeps x0 for its next repeat.  Lane 0 writes the
// records; each lane writes the cube coordinates it owns.
// x0 and n̂ are the lane's K slots in registers (the 32 and 128 buckets) or
// the chain's rows of shared memory (the stream bucket): group_epoch below.
template <class Policy, int G, class Like>
__device__ __forceinline__ void group_epoch_on(const GroupLane<G, Like>& L,
                                               const EpochArgsT<real_of<Like>>& a, int b,
                                               bool in_range, real_of<Like>* x0,
                                               real_of<Like>* n) {
    using Real = real_of<Like>;
    constexpr int MAXD = Like::MAXD;
    const int B = a.B, D = a.D, R = a.R, g = L.g;
    bool done = !(in_range && a.valid[b] > 0.5f);
    int r = 0;
    long long steps = 0;
    Real wr = Real(0), bnd = Real(0);
    uint32_t h_lane = 0;
    SliceStateT<Real> s;
    s.start();
    if (!done || (Policy::CUBE && in_range)) slice_load<G, MAXD>(x0, a.x0t, 0, D, B, b, g);
    if (!done) {
        slice_load<G, MAXD>(n, a.nhat, 0, D, B, b, g);
        wr = a.w[b];
        bnd = a.bound[b];
        h_lane = mix32(mix32(a.k0, a.k1), a.lane0 + (uint32_t)b);
    }
    uint32_t h_rep = mix32(h_lane, 0u);
    for (;;) {
        bool over = false;  // the budget ended this repeat, and the chain goes on
        if (!done && steps >= a.cap) {  // the budget ends the repeat unaccepted
            if (g == 0) write_repeat(a, r, b, Real(0), L.logzero, s.cnt);
            if (Policy::STOP) {
                repeat_end<Policy, G, MAXD>(a, r++, b, x0, g);
                done = true;
            } else {
                over = true;
            }
        }
        if (!__any_sync(0xffffffffu, !done)) break;
        Real t = Real(0), logL = L.logzero;
        const bool accepted = slice_micro(L, s, x0, n, wr, bnd, h_rep, D, a.max_step,
                                          a.max_shrink, t, logL);
        if (!done) {
            bool end = over;  // (an ended repeat's micro-step is dropped)
            if (!over) {
                ++steps;
                if (accepted) {
                    if (g == 0) write_repeat(a, r, b, t, logL, s.cnt);
                    slice_advance<G, MAXD>(x0, n, t, D, g);
                    end = true;
                }
            }
            if (end) {  // the cube row, then the next repeat
                repeat_end<Policy, G, MAXD>(a, r, b, x0, g);
                if (++r < R) {
                    slice_load<G, MAXD>(n, a.nhat, (size_t)r * D * B, D, B, b, g);
                    wr = a.w[(size_t)r * B + b];
                    h_rep = mix32(h_lane, (uint32_t)r);
                    s.start();
                    if (Policy::PER_REPEAT) steps = 0;
                } else {
                    done = true;
                }
            }
        }
    }
    if (in_range) {
        for (; r < R; ++r) {  // invalid, never reached
            if (g == 0) write_repeat(a, r, b, Real(0), L.logzero, 0);
            repeat_end<Policy, G, MAXD>(a, r, b, x0, g);
        }
    }
}

template <class Policy, int G, class Like>
__device__ __forceinline__ void group_epoch(const GroupLane<G, Like>& L,
                                            const EpochArgsT<real_of<Like>>& a, int b,
                                            bool in_range) {
    if constexpr (Like::MAXD == SLICE_MAXD_STREAM) {
        group_epoch_on<Policy>(L, a, b, in_range, L.x0, L.n);
    } else {
        real_of<Like> x0[Like::MAXD / G] = {}, n[Like::MAXD / G] = {};
        group_epoch_on<Policy>(L, a, b, in_range, x0, n);
    }
}

template <class Policy, class Like, int G, bool COUNTED>
__global__ void slice_epoch_kernel(Like like, EpochArgsT<real_of<Like>> a) {
    static_assert(G == 1 || !COUNTED, "the counted form runs one lane per chain");
    static_assert(Like::MAXD == SLICE_MAXD || G * SLICE_LANE_CAP >= SLICE_MAXD_WIDE,
                  "at most SLICE_LANE_CAP coordinates per lane above SLICE_MAXD");
    const int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
    const int b = lane_id / G;  // the chain
    long long steps = 0;        // micro-steps of this chain in the epoch
    if constexpr (G == 1) {
        if (b < a.B) steps = chain_epoch<Policy>(like, a, b);
    } else if constexpr (Like::MAXD == SLICE_MAXD_STREAM) {  // one chain a block
        extern __shared__ __align__(16) unsigned char slice_smem[];
        using Real = real_of<Like>;
        Real* rows = reinterpret_cast<Real*>(slice_smem);  // x0, n̂, the terms
        const GroupLane<G, Like> L{like, lane_id % G, group_mask<G>(threadIdx.x),
                                   like.logzero, rows, rows + a.D, rows + 2 * a.D};
        group_epoch<Policy>(L, a, b, b < a.B);
    } else {  // every lane of the warp runs group_epoch (no early return)
        GroupLane<G, Like> L{like, {}, {}, lane_id % G, group_mask<G>(threadIdx.x), like.logzero};
        group_prior(L);
        group_epoch<Policy>(L, a, b, b < a.B);
    }
    if constexpr (COUNTED) {  // every thread of the warp gets here (no early return)
        const int s = (int)steps;
        if (b < a.B) a.lane_steps[b] = s;
        const int m = __reduce_max_sync(0xffffffffu, s);
        if ((threadIdx.x & 31) == 0) a.warp_max[b >> 5] = m;
    }
}

// Launch slice_epoch_kernel<Policy, Like, G, COUNTED> on `stream`: one warp
// per block, 32 / G chains each.  In the stream bucket the block's (2 + NT)
// D values of dynamic shared memory, with the kernel's attribute raised past
// 48 KB first; a request above SLICE_SMEM_MAX fails there and at the launch,
// which cudaGetLastError() then reports.
template <class Policy, class Like, int G, bool COUNTED = false>
void launch_epoch(const Like& like, const EpochArgsT<real_of<Like>>& a, cudaStream_t stream) {
    const int threads = 32;
    const int blocks = (int)(((long long)a.B * G + threads - 1) / threads);
    if constexpr (Like::MAXD == SLICE_MAXD_STREAM) {
        const long long bytes = (2LL + Like::NT) * a.D * (long long)sizeof(real_of<Like>);
        const int smem = (int)(bytes <= SLICE_SMEM_MAX ? bytes : SLICE_SMEM_MAX + 1);
        if (smem > 48 * 1024)
            cudaFuncSetAttribute((const void*)slice_epoch_kernel<Policy, Like, G, COUNTED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        slice_epoch_kernel<Policy, Like, G, COUNTED><<<blocks, threads, smem, stream>>>(like, a);
    } else {
        slice_epoch_kernel<Policy, Like, G, COUNTED><<<blocks, threads, 0, stream>>>(like, a);
    }
}

// Launch at `group` lanes per chain: one of 1, 2, 4, ..., 32 in the
// SLICE_MAXD bucket, 32 in the SLICE_MAXD_WIDE bucket (the only
// instantiation there, SLICE_LANE_CAP coordinates per lane at most) and in
// the stream bucket.
template <class Policy, class Like>
void launch_epoch_group(int group, const Like& like, const EpochArgsT<real_of<Like>>& a,
                        cudaStream_t st) {
    if constexpr (Like::MAXD == SLICE_MAXD) {
        switch (group) {
            case 1: launch_epoch<Policy, Like, 1>(like, a, st); break;
            case 2: launch_epoch<Policy, Like, 2>(like, a, st); break;
            case 4: launch_epoch<Policy, Like, 4>(like, a, st); break;
            case 8: launch_epoch<Policy, Like, 8>(like, a, st); break;
            case 16: launch_epoch<Policy, Like, 16>(like, a, st); break;
            default: launch_epoch<Policy, Like, 32>(like, a, st); break;
        }
    } else {
        static_assert((Like::MAXD == SLICE_MAXD_WIDE && SLICE_MAXD_WIDE / SLICE_LANE_CAP == 32) ||
                          Like::MAXD == SLICE_MAXD_STREAM,
                      "the wide and stream buckets' only instantiation is G = 32");
        launch_epoch<Policy, Like, 32>(like, a, st);
    }
}

// Whether a launch of `group` lanes per chain can take these arguments: D
// up to `maxd` (SLICE_MAXD_STREAM, no compile-time bound, for the entries
// with every bucket), and above SLICE_MAXD only at the wide and stream
// buckets' G.
template <class T>
inline bool epoch_args_ok(const EpochArgsT<T>& a, int group, int maxd = SLICE_MAXD) {
    return a.D >= 1 && (maxd == SLICE_MAXD_STREAM || a.D <= maxd) && a.R >= 1 && a.B >= 1 &&
           group >= 1 && group <= 32 && !(group & (group - 1)) &&
           (a.D <= SLICE_MAXD || group * SLICE_LANE_CAP >= SLICE_MAXD_WIDE);
}

// with_likelihood (likelihoods.cuh) in the bucket of a.D: launch(functor)
// with the functor of the SLICE_MAXD bucket for D <= SLICE_MAXD, of the
// SLICE_MAXD_WIDE bucket up to SLICE_MAXD_WIDE, else of the stream bucket.
template <class Launch>
int with_bucket_likelihood(int id, const float* c, const float* prior_a, const float* prior_s,
                           const float* dev, const EpochArgs& a, float logzero,
                           Launch&& launch) {
    if (a.D <= SLICE_MAXD)
        return with_likelihood<SLICE_MAXD>(id, c, prior_a, prior_s, dev, a.D, logzero, launch);
    if (a.D <= SLICE_MAXD_WIDE)
        return with_likelihood<SLICE_MAXD_WIDE>(id, c, prior_a, prior_s, dev, a.D, logzero,
                                                launch);
    return with_likelihood<SLICE_MAXD_STREAM>(id, c, prior_a, prior_s, dev, a.D, logzero,
                                              launch);
}
