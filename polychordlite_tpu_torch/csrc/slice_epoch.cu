// B1's entries for the device functors of likelihoods.cuh: the slice epoch
// at any G (slice_epoch_launch; D <= 32 in the SLICE_MAXD bucket, up to 128
// in the SLICE_MAXD_WIDE bucket at G = 32, above in the stream bucket at G =
// 32, to the shared-memory bound) and its counted G = 1 form
// (slice_epoch_counted_launch, D <= 32).  The kernel, its design and what
// bounds it are in slice_epoch.cuh.

#include "slice_epoch.cuh"

template <bool COUNTED>
static int launch(int group, int functor, const float* consts, const float* prior_a,
                  const float* prior_s, const float* dev, const EpochArgs& a, float logzero,
                  void* stream) {
    if (!epoch_args_ok(a, group, COUNTED ? SLICE_MAXD : SLICE_MAXD_STREAM) ||
        (COUNTED && group != 1))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int bad = with_bucket_likelihood(
        functor, consts, prior_a, prior_s, dev, a, logzero, [&](auto like) {
            using L = decltype(like);
            if constexpr (!COUNTED)
                launch_epoch_group<V4Policy>(group, like, a, st);
            else if constexpr (L::MAXD == SLICE_MAXD)
                launch_epoch<V4Policy, L, 1, true>(like, a, st);
        });
    if (bad) return bad;
    return (int)cudaGetLastError();
}

// All device arrays float32 (nlike int32), contiguous; see the layout
// above.  `functor` is a LIKE_* id of likelihoods.cuh, `consts` its
// constants, and prior_a, prior_s the prior's D-vectors — these three are
// host arrays — and `dev` the device array [a (D), s (D)], followed by
// random_gaussian's D x D matrix for that functor (with_likelihood).
// `cap` bounds a chain's micro-steps over the epoch; `group` is G, the
// lanes per chain (1, 2, 4, 8, 16 or 32; 32 for D > 32).
// `lane0` is the first lane of the launch in the whole chain batch (a
// shard's first logical lane, 0 for an unsharded launch): chain b draws the
// uniforms of lane lane0 + b, so a shard runs its lanes as the one-device
// launch runs them.  Every entry of the slice kernels takes it after k1.
// Returns cudaGetLastError() after the launch.
extern "C" int slice_epoch_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const float* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, int group) {
    return launch<false>(group, functor, consts, prior_a, prior_s, dev,
                         at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out,
                                             nlike_out, B, D, R, k0, k1, max_step, max_shrink,
                                             cap), lane0),
                         logzero, stream);
}

// The counted form (G = 1): as slice_epoch_launch, and lane_steps (B,)
// int32 and warp_max (ceil(B / 32),) int32 device arrays.
extern "C" int slice_epoch_counted_launch(
    int functor, const float* consts, const float* prior_a, const float* prior_s,
    const float* dev, const void* x0t, const void* bound, const void* valid, const void* nhat,
    const void* w, void* t_out, void* logL_out, void* nlike_out, int B, int D,
    int R, unsigned int k0, unsigned int k1, unsigned int lane0, int max_step,
    int max_shrink, long long cap, float logzero, void* stream, void* lane_steps, void* warp_max) {
    return launch<true>(1, functor, consts, prior_a, prior_s, dev,
                        at_lane0(epoch_args(x0t, bound, valid, nhat, w, t_out, logL_out,
                                            nlike_out, B, D, R, k0, k1, max_step, max_shrink, cap,
                                            lane_steps, warp_max), lane0),
                        logzero, stream);
}
