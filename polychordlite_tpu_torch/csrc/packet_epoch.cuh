// B3's kernel template: the speculative-packet epoch (packet_machine.cuh)
// on the lanes of a warp, in the three dimension buckets of slice_epoch.cuh.
// Included by slice_epoch_v5.cu (the functors of likelihoods.cuh) and by
// slice_epoch_fused.cu built with FUSED_V5 (a likelihood lowered from torch
// by ops/fused_like.py, one G a library).  The design in the SLICE_MAXD
// bucket, and what bounds it, are in slice_epoch_v5.cu.
//
// Above SLICE_MAXD (the wide bucket to SLICE_MAXD_WIDE, the stream bucket
// above) a chain holds a whole warp, G = 32, one chain a block, and the
// warp evaluates the packet's four slots one after the other, each with the
// bucket's G = 32 like_eval (slice_epoch.cuh: each lane folds the terms of
// its own coordinates and a shuffle butterfly joins the lanes, the lane
// order of likelihoods.cuh; in the stream bucket x0, n̂ and the terms are
// the chain's rows of the block's dynamic shared memory; in both buckets
// its directions are read as slice_load_nhat's coalesced rows).
// Every lane runs the packet machine on the four logLs, so nothing is
// broadcast for the decisions.  Of the two layouts open here — this one,
// and one chain on a block of four warps, warp j evaluating slot j, the four
// logLs meeting in shared memory behind a barrier — this one is kept: the
// four-slot layout of the SLICE_MAXD bucket puts P = 4 sub-groups of Gs
// lanes in a warp, and at D = 128 a sub-group of 8 lanes would own 16
// coordinates a lane, four times SLICE_LANE_CAP; four warps a chain would
// keep the lane cap, but every packet would then wait on a block barrier
// and 512 chains would need 2,048 warps, where B1 runs one warp a chain.
// Evaluated in turn, a packet costs its warp four of B1's wide micro-steps'
// likelihood evaluations, of which it consumes about two: a simple kernel
// that is right, bitwise B1 and the plain version, not a fast one.
#pragma once

#include "packet_machine.cuh"
#include "slice_epoch.cuh"

// A packet slot's logL on its sub-group of Gs lanes: slice_epoch.cuh's
// two-stage like_eval (its ballot masked to the sub-group, its shuffles of
// width Gs, the terms combined in index order on every lane), or at Gs = 1
// both stages in the one lane.  Bitwise the same either way.
template <int Gs, class Like>
__device__ __forceinline__ float slot_eval(const GroupLane<Gs, Like>& L, const float* x0,
                                           const float* n, float t, int D) {
    if constexpr (Gs == 1)
        return like_eval(L.like, x0, n, t, D);
    else
        return like_eval(L, x0, n, t, D);
}

// G = 4 Gs > 1: chain b on sub-group `slot` (its packet slot) of Gs lanes,
// lane g of it.  Every lane of the chain plans the same packet (the same
// uniforms: each lane hashes the ones the plan asks for), its sub-group
// evaluates the probe of its slot, the four logLs reach every lane of the
// chain from each sub-group's first lane, and every lane resolves the
// packet.  The 32 / G chains of the warp run one loop of macro-steps
// together, each in its own repeat and phase, so every warp operation takes
// the full mask; a chain that is done (or out of range) still runs the
// iteration and keeps nothing.  The decisions, the budget and the records
// are packet_chain_epoch's; lane 0 of the chain writes.
template <int Gs, class Like>
__device__ __forceinline__ void packet_group_epoch(const GroupLane<Gs, Like>& L,
                                                   const EpochArgs& a, int b, int slot,
                                                   bool in_range) {
    constexpr int G = SLICE_P * Gs, K = SLICE_MAXD / Gs;
    const int B = a.B, D = a.D, R = a.R, g = L.g;
    const bool lead = slot == 0 && g == 0;
    const float logzero = L.logzero;
    bool done = !(in_range && a.valid[b] > 0.5f);
    int r = 0;
    long long steps = 0;  // probes consumed in this epoch
    float x0[K] = {}, n[K] = {}, wr = 0.0f, bnd = 0.0f;
    uint32_t h_lane = 0;
    PacketState s;
    s.start();
    if (!done) {
        slice_load<Gs>(x0, a.x0t, 0, D, B, b, g);
        slice_load<Gs>(n, a.nhat, 0, D, B, b, g);
        wr = a.w[b];
        bnd = a.bound[b];
        h_lane = mix32(mix32(a.k0, a.k1), a.lane0 + (uint32_t)b);
    }
    uint32_t h_rep = mix32(h_lane, 0u);
    for (;;) {
        if (!done && steps >= a.cap) {  // the budget ends the chain
            if (lead) write_repeat(a, r, b, 0.0f, logzero, s.cnt);
            ++r;
            done = true;
        }
        if (!__any_sync(0xffffffffu, !done)) break;
        const Packet p =
            packet_plan(s, wr, [&](int j) { return slice_uniform(h_rep, s.it + (uint32_t)j); });
        float t = p.t[0];
#pragma unroll
        for (int j = 1; j < SLICE_P; ++j)  // static indices: the packet stays in registers
            if (slot == j) t = p.t[j];
        const float l_slot = slot_eval(L, x0, n, t, D);
        float lj[SLICE_P];
#pragma unroll
        for (int j = 0; j < SLICE_P; ++j) lj[j] = __shfl_sync(0xffffffffu, l_slot, j * Gs, G);
        if (!done) {
            const PacketResult res = packet_resolve(s, p, lj, bnd, logzero, a.max_step,
                                                    a.max_shrink, a.cap - steps);
            if (res.trunc) {
                steps = a.cap;
            } else {
                steps += res.cons;
                if (res.acc) {
                    if (lead) write_repeat(a, r, b, res.t, res.logL, s.cnt);
                    slice_advance<Gs>(x0, n, res.t, D, g);
                    if (++r < R) {
                        slice_load<Gs>(n, a.nhat, (size_t)r * D * B, D, B, b, g);
                        wr = a.w[(size_t)r * B + b];
                        h_rep = mix32(h_lane, (uint32_t)r);
                        s.start();
                    } else {
                        done = true;
                    }
                }
            }
        }
    }
    if (in_range && lead)
        for (; r < R; ++r) write_repeat(a, r, b, 0.0f, logzero, 0);  // invalid, never reached
}

// D > SLICE_MAXD (the wide and stream buckets): chain b on a whole warp of
// G = 32 lanes, lane g owning the coordinates d = g (mod 32) — x0 and n̂ in
// registers (the wide bucket, K = MAXD / 32 slots) or in the chain's rows of
// shared memory (the stream bucket) — the R repeats one after the other as
// packet_chain_epoch runs them, the four slots of each packet evaluated in
// turn by the whole warp.  b is the warp's (one chain a block), so every
// lane takes the same branch and the warp operations of like_eval see the
// whole warp.  The decisions, the budget and the records are
// packet_chain_epoch's; lane 0 writes.
template <class Like>
__device__ __forceinline__ void packet_warp_epoch(const GroupLane<WARP_LANES, Like>& L,
                                                  const EpochArgs& a, int b, float* x0,
                                                  float* n) {
    constexpr int MAXD = Like::MAXD;
    const int B = a.B, D = a.D, R = a.R, g = L.g;
    const float logzero = L.logzero;
    long long steps = 0;  // probes consumed in this epoch
    int r = 0;
    if (a.valid[b] > 0.5f) {
        slice_load<WARP_LANES, MAXD>(x0, a.x0t, 0, D, B, b, g);
        const float bnd = a.bound[b];
        const uint32_t h_lane = mix32(mix32(a.k0, a.k1), a.lane0 + (uint32_t)b);
        for (; r < R; ++r) {
            slice_load_nhat<WARP_LANES, MAXD>(n, a.nhat, r, D, B, R, b, g);
            const float wr = a.w[(size_t)r * B + b];
            const uint32_t h_rep = mix32(h_lane, (uint32_t)r);
            PacketState s;
            s.start();
            PacketResult res{0, false, false, 0.0f, logzero};
            while (steps < a.cap) {
                const Packet p = packet_plan(
                    s, wr, [&](int j) { return slice_uniform(h_rep, s.it + (uint32_t)j); });
                float lj[SLICE_P];
#pragma unroll
                for (int j = 0; j < SLICE_P; ++j) lj[j] = like_eval(L, x0, n, p.t[j], D);
                res = packet_resolve(s, p, lj, bnd, logzero, a.max_step, a.max_shrink,
                                     a.cap - steps);
                if (res.trunc) {
                    steps = a.cap;
                    break;
                }
                steps += res.cons;
                if (res.acc) break;
            }
            if (!res.acc) {  // the budget: leave this repeat unaccepted, stop
                if (g == 0) write_repeat(a, r, b, 0.0f, logzero, s.cnt);
                ++r;
                break;
            }
            if (g == 0) write_repeat(a, r, b, res.t, res.logL, s.cnt);
            slice_advance<WARP_LANES, MAXD>(x0, n, res.t, D, g);
        }
    }
    if (g == 0)
        for (; r < R; ++r) write_repeat(a, r, b, 0.0f, logzero, 0);  // invalid, never reached
}

template <class Like, int G>
__global__ void slice_epoch_v5_kernel(Like like, EpochArgs a) {
    static_assert(Like::MAXD == SLICE_MAXD || G == WARP_LANES,
                  "above SLICE_MAXD a chain holds a whole warp");
    const int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
    const int b = lane_id / G;  // the chain
    if constexpr (G == 1) {
        if (b < a.B) packet_chain_epoch(like, a, b);
    } else if constexpr (Like::MAXD == SLICE_MAXD_STREAM) {  // one chain a block
        extern __shared__ __align__(16) unsigned char packet_smem[];
        float* rows = reinterpret_cast<float*>(packet_smem);  // x0, n̂, the terms
        const GroupLane<G, Like> L{like, lane_id % G, group_mask<G>(threadIdx.x), like.logzero,
                                   rows, rows + a.D, rows + 2 * a.D};
        if (b < a.B) packet_warp_epoch(L, a, b, L.x0, L.n);
    } else if constexpr (Like::MAXD != SLICE_MAXD) {  // the wide bucket: one chain a block
        GroupLane<G, Like> L{like, {}, {}, lane_id % G, group_mask<G>(threadIdx.x), like.logzero};
        group_prior(L);
        float x0[Like::MAXD / G] = {}, n[Like::MAXD / G] = {};
        if (b < a.B) packet_warp_epoch(L, a, b, x0, n);
    } else {  // every lane of the warp runs packet_group_epoch (no early return)
        constexpr int Gs = G / SLICE_P;
        const int c = lane_id % G;  // this lane's place in its chain
        GroupLane<Gs, Like> L{like, {}, {}, c % Gs, group_mask<Gs>(threadIdx.x), like.logzero};
        if constexpr (Gs > 1) group_prior(L);
        packet_group_epoch<Gs>(L, a, b, c / Gs, b < a.B);
    }
}

// The dynamic shared memory of the `G` kernel for `like` at dimension D:
// the stream bucket's rows, (2 + NT) D floats (SLICE_SMEM_MAX + 1 past the
// bound, which the launch then refuses), none in the other buckets.
template <class Like>
inline int packet_smem_bytes(int D) {
    if constexpr (Like::MAXD == SLICE_MAXD_STREAM) {
        const long long bytes = (2LL + Like::NT) * D * (long long)sizeof(float);
        return (int)(bytes <= SLICE_SMEM_MAX ? bytes : SLICE_SMEM_MAX + 1);
    } else {
        return 0;
    }
}

// Launch slice_epoch_v5_kernel<Like, G> on `stream`: one warp per block,
// 32 / G chains each; in the stream bucket the block's rows of dynamic
// shared memory, the kernel's attribute raised past 48 KB first.
template <class Like, int G>
void launch_packet_kernel(const Like& like, const EpochArgs& a, cudaStream_t stream) {
    const int blocks = (int)(((long long)a.B * G + 31) / 32);
    const int smem = packet_smem_bytes<Like>(a.D);
    if (smem > 48 * 1024)
        cudaFuncSetAttribute((const void*)slice_epoch_v5_kernel<Like, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    slice_epoch_v5_kernel<Like, G><<<blocks, 32, smem, stream>>>(like, a);
}

// Call f(slice_epoch_v5_kernel<Like, G>) for `group` G: 1, 4, 8, 16 or 32
// in the SLICE_MAXD bucket, 32 above (the only instantiation there).
template <class Like, class F>
void with_packet_kernel(int group, F&& f) {
    if constexpr (Like::MAXD == SLICE_MAXD) {
        switch (group) {
            case 1: f(slice_epoch_v5_kernel<Like, 1>); break;
            case 4: f(slice_epoch_v5_kernel<Like, 4>); break;
            case 8: f(slice_epoch_v5_kernel<Like, 8>); break;
            case 16: f(slice_epoch_v5_kernel<Like, 16>); break;
            default: f(slice_epoch_v5_kernel<Like, 32>); break;
        }
    } else {
        f(slice_epoch_v5_kernel<Like, WARP_LANES>);
    }
}

// Launch at `group` lanes per chain (with_packet_kernel's G).
template <class Like>
void launch_packet(int group, const Like& like, const EpochArgs& a, cudaStream_t stream) {
    if constexpr (Like::MAXD == SLICE_MAXD) {
        switch (group) {
            case 1: launch_packet_kernel<Like, 1>(like, a, stream); break;
            case 4: launch_packet_kernel<Like, 4>(like, a, stream); break;
            case 8: launch_packet_kernel<Like, 8>(like, a, stream); break;
            case 16: launch_packet_kernel<Like, 16>(like, a, stream); break;
            default: launch_packet_kernel<Like, 32>(like, a, stream); break;
        }
    } else {
        launch_packet_kernel<Like, WARP_LANES>(like, a, stream);
    }
}

// Whether a launch of `group` lanes per chain can take these arguments: D
// to the stream bucket (its bound is the launch's shared memory), G one of
// 1, 4, 8, 16, 32, and 32 above SLICE_MAXD.
inline bool packet_args_ok(const EpochArgs& a, int group) {
    return epoch_args_ok(a, group, SLICE_MAXD_STREAM) && group != 2;
}
