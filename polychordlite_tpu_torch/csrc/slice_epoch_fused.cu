// B1 with a likelihood lowered from torch: the fused route.
//
// Replaces, for a model without a hand-written functor, the TPU kernel
// polychordlite_tpu/ops/pallas_slice_v4.py::build_epoch_fn_pallas_v4 (:508),
// which evaluates any traced jnp likelihood inside its body
// (pallas_slice_v4.py:266, resolved by pallas_slice.py::_validated_tile_logL).
// ops/fused_like.py traces the model's torch prior and likelihood, lowers
// the trace to B1's two-stage functor interface (likelihoods.cuh) and writes
// it, with the group size G and the dimension D, into the generated header
// fused_like.cuh, found through -I at build time (utils/nvcc.py), in the
// dimension bucket of D (FUSED_MAXD: 32, 128 at G = 32, or SLICE_MAXD_STREAM
// at G = 32 above 128, to the shared-memory bound).  This entry
// instantiates slice_epoch.cuh's kernel for that functor at that one G only,
// so that one build takes seconds; each model graph and G is a library of its
// own, named by a hash of the header.  A header that defines FUSED_RING
// (the ring engine's, ops/fused_like.py) makes a library of its own whose
// entry is slice_epoch_fused_ring_launch, the same kernel under RingPolicy.
// The forced engines' libraries are three more, one define each in the
// header: FUSED_V3 (B4, slice_epoch_fused_v3_launch: the template under
// V3Policy), FUSED_V2 (B5, slice_epoch_fused_v2_launch: V2Policy, which
// writes the cube in every bucket) and FUSED_V5 (B3,
// slice_epoch_fused_v5_launch: packet_epoch.cuh's packet kernel at the
// library's G, 1, 4, 8, 16 or 32 lanes a chain up to D = 32 — its slots'
// like_eval at Gs = G / 4 — and 32 above, with
// slice_epoch_fused_v5_resident_warps for the launch's choice of G), float32
// only, as their functor kernels are.  Each is a library of its own, so
// B1's fused and ring libraries keep their sources, names and kernels.
// The model's constants (captured
// tensors and numbers, a lowered prior's parameters) are not in the source:
// they come in one float32 device buffer, `consts`, so a family of models
// with one graph shares one library.  A prior with an affine form stays B1's
// AffinePrior (prior_a, prior_s, host arrays); in the stream bucket it is the
// device array `dev` = [a (D), s (D)] (DevicePriorT).  The float64 kernel is
// instantiated in every bucket as the float32 one is.  A functor with data
// loops (a sum over a model's data rows, ops/fused_like.py) splits their rows
// over the chain's lanes (FUSED_ROW_LANES in its header, fused_ops.cuh's
// FusedRowFold), and a float32 functor with a float64 body reads its float64
// constants from the buffer's tail (FUSED_NC64_AT, fused_f64).
//
// What bounds it is B1's micro-step (slice_epoch.cuh), with the lowered
// body in place of the hand-written one: its per-coordinate chain runs on
// the lane that owns the coordinate (term), its sums and scalar tail on
// every lane of the group (combine; above D = 32 each sum folded in
// the lane order), the constants read through the read-only
// cache.  Every float operation is a rounded intrinsic under
// --fmad=false, so the kernel agrees bit for bit with fused_like.py's plain
// version, Lowered.plain_logL.
//
// At precision='highest' the generated functor is double (its logzero, its
// constants, its statements; fused_like.py writes the dtype into the
// header, so it is part of the library's hash), and so is every array of
// this entry and the chain state of the template: the entry's pointers and
// logzero take the functor's scalar type, fused_real.

#include "slice_epoch.cuh"
#include "fused_ops.cuh"
#include "fused_like.cuh"
#ifdef FUSED_V5
#include "packet_epoch.cuh"
#endif

using fused_real = real_of<FusedLike>;

// The arguments of slice_epoch.cu's entries, with the compiled G first and a
// device pointer for the constants, every float array and logzero of type
// fused_real.  Returns cudaErrorInvalidValue for another G or D, else
// cudaGetLastError() after the launch.
#if !defined(FUSED_RING) && !defined(FUSED_V5) && !defined(FUSED_V3) && !defined(FUSED_V2)
extern "C" int slice_epoch_fused_launch(
    int group, const fused_real* consts, const fused_real* prior_a, const fused_real* prior_s,
    const fused_real* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, fused_real logzero, void* stream) {
    const EpochArgsT<fused_real> a =
        at_lane0(epoch_args<fused_real>(x0t, bound, valid, nhat, w, t_out, logL_out, nlike_out, B,
                                        D, R, k0, k1, max_step, max_shrink, cap), lane0);
    if (group != FUSED_G || D != FUSED_D || !epoch_args_ok(a, group, FusedLike::MAXD))
        return (int)cudaErrorInvalidValue;
    const FusedLike like{make_prior<FusedLike::MAXD>(prior_a, prior_s, dev, D), consts, logzero};
    launch_epoch<V4Policy, FusedLike, FUSED_G>(like, a, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

#elif defined(FUSED_RING)  // the ring engine's library of this model and G

// The ring engine's epoch (RingPolicy, slice_epoch.cuh): the arguments of
// slice_epoch_fused_launch, with `cap` the ring's budget, then `overflow`
// (B,) int32, zeroed by the caller, where a chain that the budget stopped
// before its last repeat was accepted writes 1.
extern "C" int slice_epoch_fused_ring_launch(
    int group, const fused_real* consts, const fused_real* prior_a, const fused_real* prior_s,
    const fused_real* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, fused_real logzero, void* stream, void* overflow) {
    const EpochArgsT<fused_real> a = with_overflow(
        at_lane0(epoch_args<fused_real>(x0t, bound, valid, nhat, w, t_out, logL_out, nlike_out,
                                        B, D, R, k0, k1, max_step, max_shrink, cap), lane0),
        overflow);
    if (group != FUSED_G || D != FUSED_D || !epoch_args_ok(a, group, FusedLike::MAXD) ||
        overflow == nullptr)
        return (int)cudaErrorInvalidValue;
    const FusedLike like{make_prior<FusedLike::MAXD>(prior_a, prior_s, dev, D), consts, logzero};
    launch_epoch<RingPolicy, FusedLike, FUSED_G>(like, a, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

#else  // FUSED_V5, FUSED_V3 or FUSED_V2: a forced engine's library of this model and G

static_assert(std::is_same<fused_real, float>::value,
              "the forced engines' kernels are float32, as their functor kernels are");

// The arguments of slice_epoch_fused_launch, float32; B4's `cap` is the
// micro-steps one repeat may take (v3's budget), B5's the same (v2's),
// B3's B1's budget in consumed probes.  B5 takes `cube_out` (R, D, B)
// float32 after the stream.
static EpochArgs forced_args(const void* x0t, const void* bound, const void* valid,
                             const void* nhat, const void* w, void* t_out, void* logL_out,
                             void* nlike_out, int B, int D, int R, unsigned int k0,
                             unsigned int k1, unsigned int lane0, int max_step, int max_shrink,
                             long long cap, void* cube_out = nullptr) {
    return at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out, nlike_out, B, D, R,
                               k0, k1, max_step, max_shrink, cap, nullptr, nullptr, cube_out),
                    lane0);
}

#if defined(FUSED_V5)
extern "C" int slice_epoch_fused_v5_launch(
    int group, const float* consts, const float* prior_a, const float* prior_s,
    const float* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream) {
    const EpochArgs a = forced_args(x0t, bound, valid, nhat, w, t_out, logL_out, nlike_out, B,
                                    D, R, k0, k1, lane0, max_step, max_shrink, cap);
    if (group != FUSED_G || D != FUSED_D || !packet_args_ok(a, group) ||
        !epoch_args_ok(a, group, FusedLike::MAXD))
        return (int)cudaErrorInvalidValue;
    const FusedLike like{make_prior<FusedLike::MAXD>(prior_a, prior_s, dev, D), consts, logzero};
    launch_packet_kernel<FusedLike, FUSED_G>(like, a, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// The warps of this library's kernel that one SM of the current device
// keeps resident at one warp a block (slice_epoch_v5_resident_warps'
// query), or minus a CUDA error.
extern "C" int slice_epoch_fused_v5_resident_warps() {
    int warps = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &warps, slice_epoch_v5_kernel<FusedLike, FUSED_G>, 32,
        packet_smem_bytes<FusedLike>(FUSED_D));
    return e == cudaSuccess ? warps : -(int)e;
}

#elif defined(FUSED_V3)
extern "C" int slice_epoch_fused_v3_launch(
    int group, const float* consts, const float* prior_a, const float* prior_s,
    const float* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream) {
    const EpochArgs a = forced_args(x0t, bound, valid, nhat, w, t_out, logL_out, nlike_out, B,
                                    D, R, k0, k1, lane0, max_step, max_shrink, cap);
    if (group != FUSED_G || D != FUSED_D || !epoch_args_ok(a, group, FusedLike::MAXD))
        return (int)cudaErrorInvalidValue;
    const FusedLike like{make_prior<FusedLike::MAXD>(prior_a, prior_s, dev, D), consts, logzero};
    launch_epoch<V3Policy, FusedLike, FUSED_G>(like, a, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

#else  // FUSED_V2
extern "C" int slice_epoch_fused_v2_launch(
    int group, const float* consts, const float* prior_a, const float* prior_s,
    const float* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, void* cube_out) {
    const EpochArgs a = forced_args(x0t, bound, valid, nhat, w, t_out, logL_out, nlike_out, B,
                                    D, R, k0, k1, lane0, max_step, max_shrink, cap, cube_out);
    if (group != FUSED_G || D != FUSED_D || !epoch_args_ok(a, group, FusedLike::MAXD) ||
        cube_out == nullptr)
        return (int)cudaErrorInvalidValue;
    const FusedLike like{make_prior<FusedLike::MAXD>(prior_a, prior_s, dev, D), consts, logzero};
    launch_epoch<V2Policy, FusedLike, FUSED_G>(like, a, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
#endif

#endif  // the engine's library
