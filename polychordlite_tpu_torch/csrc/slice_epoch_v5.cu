// Speculative slice-sampling epoch (B3): packets of P = 4 probes per
// macro-step, one chain on a group of G = 4 Gs lanes of a warp (D <= 32),
// or on a whole warp above (the wide and stream buckets).
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
// Above D = SLICE_MAXD the sub-groups would own more than SLICE_LANE_CAP
// coordinates a lane, so a chain holds a whole warp (G = 32) and the warp
// evaluates the four slots in turn with the bucket's like_eval: the wide
// bucket to D = 128 (x0 and n̂ in registers, the terms staged in shared
// memory) and the stream bucket above (x0, n̂ and the terms in the block's
// dynamic shared memory, D bounded as for B1, ops/pallas_slice_v4.py::
// stream_max_d).  The kernel template and that design are in
// packet_epoch.cuh; the launches take the functor of the bucket of D, the
// wide and stream buckets' from a library of their own
// (slice_epoch_v5_wide, built with SLICE_EPOCH_V5_WIDE).
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

#include "packet_epoch.cuh"

// The file builds two libraries, so that each compiles in the time the
// other libraries take: slice_epoch_v5, the SLICE_MAXD bucket's
// instantiations (every G), and, with SLICE_EPOCH_V5_WIDE
// (utils/nvcc.py::DEFINES), slice_epoch_v5_wide, the wide and stream
// buckets' (G = 32).  Each entry refuses the other library's D.
#ifdef SLICE_EPOCH_V5_WIDE
static bool in_library(int D) { return D > SLICE_MAXD; }
#else
static bool in_library(int D) { return D <= SLICE_MAXD; }
#endif

// with_bucket_likelihood (slice_epoch.cuh) over this library's buckets.
template <class Launch>
static int with_library_likelihood(int id, const float* c, const float* prior_a,
                                   const float* prior_s, const float* dev, const EpochArgs& a,
                                   float logzero, Launch&& launch) {
#ifdef SLICE_EPOCH_V5_WIDE
    if (a.D <= SLICE_MAXD_WIDE)
        return with_likelihood<SLICE_MAXD_WIDE>(id, c, prior_a, prior_s, dev, a.D, logzero,
                                                launch);
    return with_likelihood<SLICE_MAXD_STREAM>(id, c, prior_a, prior_s, dev, a.D, logzero,
                                              launch);
#else
    return with_likelihood<SLICE_MAXD>(id, c, prior_a, prior_s, dev, a.D, logzero, launch);
#endif
}

// The interface of slice_epoch_launch (slice_epoch.cu): `group` is G, the
// lanes per chain (1, 4, 8, 16 or 32; 32 for D > 32, the SLICE_MAXD_WIDE and
// stream buckets), one warp per block, 32 / G chains each, and `dev` the
// device array of slice_epoch_launch (the stream bucket's prior,
// random_gaussian's matrix).  Returns cudaGetLastError() after the launch.
extern "C" int slice_epoch_v5_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const float* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, int group) {
    const EpochArgs a = at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out,
                                            nlike_out, B, D, R, k0, k1, max_step, max_shrink,
                                            cap), lane0);
    if (!packet_args_ok(a, group) || !in_library(a.D)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int bad = with_library_likelihood(
        functor, consts, prior_a, prior_s, dev, a, logzero,
        [&](auto like) { launch_packet(group, like, a, st); });
    if (bad) return bad;
    return (int)cudaGetLastError();
}

// The warps of the `group` kernel of `functor` at dimension D (built from
// its arguments as slice_epoch_v5_launch builds it, with no device array:
// the query reads none) that one SM of the current device keeps resident at
// one warp a block: its registers decide, and in the stream bucket its
// shared memory.  Returns that count, or minus a CUDA error.
// ops/pallas_slice_v5.py::choose_packet_group reads it.
extern "C" int slice_epoch_v5_resident_warps(int functor, const float* consts,
                                             const float* prior_a, const float* prior_s, int D,
                                             float logzero, void* stream, int group) {
    EpochArgs a{};
    a.B = a.R = 1;
    a.D = D;
    if (!packet_args_ok(a, group) || !in_library(D)) return -(int)cudaErrorInvalidValue;
    int warps = 0;
    cudaError_t e = cudaSuccess;
    const int bad = with_library_likelihood(
        functor, consts, prior_a, prior_s, nullptr, a, logzero, [&](auto like) {
            using L = decltype(like);
            with_packet_kernel<L>(group, [&](auto kernel) {
                e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&warps, kernel, 32,
                                                                  packet_smem_bytes<L>(D));
            });
        });
    if (bad) return -bad;
    return e == cudaSuccess ? warps : -(int)e;
}
