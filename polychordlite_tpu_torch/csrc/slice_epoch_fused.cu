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
// own, named by a hash of the header.  The model's constants (captured
// tensors and numbers, a lowered prior's parameters) are not in the source:
// they come in one float32 device buffer, `consts`, so a family of models
// with one graph shares one library.  A prior with an affine form stays B1's
// AffinePrior (prior_a, prior_s, host arrays); in the stream bucket it is the
// device array `dev` = [a (D), s (D)] (DevicePriorT).  The float64 kernel is
// instantiated in every bucket as the float32 one is.
//
// What bounds it is B1's micro-step (slice_epoch.cuh), with the lowered
// body in place of the hand-written one: its per-coordinate chain runs on
// the lane that owns the coordinate (term), its sums and scalar tail on
// every lane of the group (combine), the constants read through the
// read-only cache.  Every float operation is a rounded intrinsic under
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

using fused_real = real_of<FusedLike>;

// The arguments of slice_epoch.cu's entries, with the compiled G first and a
// device pointer for the constants, every float array and logzero of type
// fused_real.  Returns cudaErrorInvalidValue for another G or D, else
// cudaGetLastError() after the launch.
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
