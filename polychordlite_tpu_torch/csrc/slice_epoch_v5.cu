// Speculative slice-sampling epoch (B3): packets of P = 4 probes per
// macro-step, one chain on a group of G = 4 Gs lanes of a warp.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_slice_v5.py::
// build_epoch_fn_pallas_v5 (kernel body :117-518).  It keeps v5's packet
// machine (packet_machine.cuh: the plan, the in-order resolution, the count
// and B1's budget in consumed probes) and drops its TPU layout (lane-chunk
// grid, SMEM sliding window, 8-slot direction ring by manual DMA), as
// slice_epoch.cuh does for v4.  The decisions, t, logL and nlike are bitwise
// those of B1 (slice_epoch.cu) and of the plain engines, at every G.
//
// What bounds it on the card is what bounds B1 (slice_epoch.cuh): a
// macro-step's dependent chain — the plan's hash, four likelihood
// evaluations each with D IEEE divisions, the resolution — with too few
// warps to hide it.  One thread per chain evaluated the four probes in
// turn, so each macro-step was four dependent like_evals, of which it then
// consumed about two.  The design spreads a packet over its chain's lanes:
// sub-group j (lanes j Gs .. j Gs + Gs - 1 of the chain) evaluates slot j,
// and lane s of a sub-group owns the coordinates d = s + k Gs, with their
// x0, n̂ and prior coefficients in registers (replicated over the four
// sub-groups).  A macro-step then costs one sub-group evaluation (B1's
// two-stage like_eval at G = Gs) plus four shuffles and the resolution on
// every lane, and the chains fill 4 Gs times the warps.  The launch picks
// Gs from B, D and the SM count (ops/pallas_slice_v5.py::
// choose_packet_group), stopping before a G whose warps would need a second
// wave of the warps an SM keeps resident for that kernel
// (slice_epoch_v5_resident_warps).  G = 1 keeps the one-thread form
// (packet_chain_epoch), the baseline each group is held against.
//
// Measured on an H100 (PERF.md, section 6): where warps are scarce (512 chains)
// the shorter dependent chain wins, 0.7-1.1x B1; where the card is full (the
// bench's 8,192) the issue slots bound it, and the two probes of a packet
// that are never consumed cost them: 1.7x B1 at its best G.  Drawing each
// slot's uniform on its own sub-group and sharing the four by shuffle was a
// few per cent faster at the bench and no faster at 512 chains, and was not
// kept.  The next design: fewer probes per packet where the warps fill the
// card.
//
// Layout: EpochArgs (slice_machine.cuh): x0 (D, B), nhat (R, D, B), w
// (R, B), chain axis minor; outputs t, logL (R, B) float32 and nlike (R, B)
// int32.  Every float operation is an explicitly rounded intrinsic under
// --fmad=false.

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

template <class Like, int G>
__global__ void slice_epoch_v5_kernel(Like like, EpochArgs a) {
    const int lane_id = blockIdx.x * blockDim.x + threadIdx.x;
    const int b = lane_id / G;  // the chain
    if constexpr (G == 1) {
        if (b < a.B) packet_chain_epoch(like, a, b);
    } else {  // every lane of the warp runs packet_group_epoch (no early return)
        constexpr int Gs = G / SLICE_P;
        const int c = lane_id % G;  // this lane's place in its chain
        GroupLane<Gs, Like> L{like, {}, {}, c % Gs, group_mask<Gs>(threadIdx.x), like.logzero};
        if constexpr (Gs > 1) group_prior(L);
        packet_group_epoch<Gs>(L, a, b, c / Gs, b < a.B);
    }
}

// Call f(slice_epoch_v5_kernel<Like, G>) for `group` G (1, 4, 8, 16 or 32).
template <class Like, class F>
void with_packet_kernel(int group, F&& f) {
    switch (group) {
        case 1: f(slice_epoch_v5_kernel<Like, 1>); break;
        case 4: f(slice_epoch_v5_kernel<Like, 4>); break;
        case 8: f(slice_epoch_v5_kernel<Like, 8>); break;
        case 16: f(slice_epoch_v5_kernel<Like, 16>); break;
        default: f(slice_epoch_v5_kernel<Like, 32>); break;
    }
}

// The interface of slice_epoch_launch (slice_epoch.cu): `group` is G, the
// lanes per chain (1, 4, 8, 16 or 32), one warp per block, 32 / G chains
// each.  Returns cudaGetLastError() after the launch.
extern "C" int slice_epoch_v5_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, int group) {
    const EpochArgs a = at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out,
                                            nlike_out, B, D, R, k0, k1, max_step, max_shrink,
                                            cap), lane0);
    if (!epoch_args_ok(a, group) || group == 2) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int blocks = (int)(((long long)B * group + 31) / 32);
    const int bad = with_likelihood(
        functor, consts, prior_a, prior_s, D, logzero, st, [&](auto like) {
            with_packet_kernel<decltype(like)>(
                group, [&](auto kernel) { kernel<<<blocks, 32, 0, st>>>(like, a); });
        });
    if (bad) return bad;
    return (int)cudaGetLastError();
}

// The warps of the `group` kernel of `functor` (built from its arguments as
// slice_epoch_v5_launch builds it) that one SM of the current device keeps
// resident at one warp a block: its registers decide.  Returns that count,
// or minus a CUDA error.  ops/pallas_slice_v5.py::choose_packet_group reads
// it.
extern "C" int slice_epoch_v5_resident_warps(int functor, const float* consts,
                                             const float* prior_a, const float* prior_s, int D,
                                             float logzero, void* stream, int group) {
    if (D < 1 || D > SLICE_MAXD || group < 1 || group > 32 || (group & (group - 1)) ||
        group == 2)
        return -(int)cudaErrorInvalidValue;
    int warps = 0;
    cudaError_t e = cudaSuccess;
    const int bad = with_likelihood(
        functor, consts, prior_a, prior_s, D, logzero, (cudaStream_t)stream, [&](auto like) {
            with_packet_kernel<decltype(like)>(group, [&](auto kernel) {
                e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&warps, kernel, 32, 0);
            });
        });
    if (bad) return -bad;
    return e == cudaSuccess ? warps : -(int)e;
}
