// The two prototype slice kernels of the repository's experiments/: one
// thread per chain on the state machine of slice_machine.cuh, with the
// normalised Gaussian of likelihoods.cuh (mu 0.5, sigma, norm) on the
// identity prior — the prototypes have no prior: the parameter is the cube,
// a coordinate outside [0, 1] gives logzero, else norm - 0.5 sum_d
// ((cube_d - 0.5) / sigma)^2 summed in index order.  Both TPU kernels cap a
// repeat at max_inner = 2 max_step + max_shrink + 4 = 504 iterations with
// max_step 200 and max_shrink 100; the accepted probe x0 + t n̂ is the
// output (a forced accept stores logzero and still moves the chain), and a
// lane that reaches the cap unaccepted keeps x0 with logL = logzero.
//
// proto_epoch_kernel replaces experiments/pallas_epoch_v2.py::pallas_epoch
// (pallas_call at :141): the whole epoch in one launch.  The TPU kernel
// runs grid=(R,) steps over one (S, 128) tile holding every chain; step r
// runs repeat r as a while loop over the whole tile until every lane is
// DONE or the loop counter reaches max_inner, and the accepted probe
// carries to step r+1 in VMEM scratch.  Here each chain runs its R repeats
// freely.  Its uniforms are murmur3 draws keyed on its own iteration of
// its repeat — u = fmix(mix(mix(seed + r, lane), it)) at INIT_R and SHRINK,
// in place of the TPU's hardware stream seeded with seed + r (a seed
// change) — so the tile-wide loop changes no decision: every lane still
// running steps once per iteration and a DONE lane idles.  Outputs: cube
// (R, D, B), logL (R, B) and nlike (B,) summed over the repeats.
//
// proto_repeat_kernel replaces experiments/pallas_slice_repeat.py::
// run_repeat (pallas_call at :124): one repeat per launch over blocks of
// 8 x 128 = 1024 chains, each block in lockstep on the TPU.  The bracket's
// uniform u0 is drawn before the loop and iteration i draws u again
// (:48-56): with the hash keyed on (seed + 7919 block, lane in block) that
// is counter 0 for u0 and i + 1 for iteration i (SPLIT_INIT).
//
// Layout: the TPU kernels' own, chain axis minor — x0 (D, B), nhat
// (R, D, B) or (D, B), w and bound (R, B) / (B,) — read as they come.
// Every float operation is a rounded intrinsic and the file is built with
// --fmad=false, so each kernel equals its plain torch version bit for bit.
//
// What bounds them on the card: not bytes (E4 moves ~138 MB at D=20,
// B=8192, R=100) but the latency of each lane's dependent micro-steps at a
// few warps per SM, as for slice_epoch.cu.

#include "slice_machine.cuh"

#define PROTO_MAX_STEP 200
#define PROTO_MAX_SHRINK 100
#define PROTO_MAX_INNER (2 * PROTO_MAX_STEP + PROTO_MAX_SHRINK + 4)
#define PROTO_BLOCK 1024  // chains of one (8, 128) block of E5
#define PROTO_THREADS 32  // one warp per block, as the slice kernels

__global__ void proto_epoch_kernel(GaussianLike<SLICE_MAXD> like, const int* __restrict__ seed,
                                   const float* __restrict__ x0_in,
                                   const float* __restrict__ bound,
                                   const float* __restrict__ nhats,
                                   const float* __restrict__ ws, float* __restrict__ cube,
                                   float* __restrict__ logL_out, int* __restrict__ nlike_out,
                                   int B, int D, int R) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    float x0[SLICE_MAXD];
    float n[SLICE_MAXD];
    slice_load(x0, x0_in, 0, D, B, b);
    const float bnd = bound[b];
    const uint32_t s0 = (uint32_t)seed[0];
    int nlike = 0;
    for (int r = 0; r < R; ++r) {
        slice_load(n, nhats, (size_t)r * D * B, D, B, b);
        const SliceRepeat rep =
            slice_repeat(like, x0, n, ws[(size_t)r * B + b], bnd,
                         mix32(s0 + (uint32_t)r, (uint32_t)b), D, PROTO_MAX_STEP,
                         PROTO_MAX_SHRINK, PROTO_MAX_INNER);
        nlike += rep.cnt;
        if (rep.accepted) slice_advance(x0, n, rep.t, D);
#pragma unroll
        for (int d = 0; d < SLICE_MAXD; ++d)
            if (d < D) cube[((size_t)r * D + d) * B + b] = x0[d];
        logL_out[(size_t)r * B + b] = rep.logL;
    }
    nlike_out[b] = nlike;
}

__global__ void proto_repeat_kernel(GaussianLike<SLICE_MAXD> like, const int* __restrict__ seed,
                                    const float* __restrict__ x0_in,
                                    const float* __restrict__ nhat,
                                    const float* __restrict__ w,
                                    const float* __restrict__ bound, float* __restrict__ cube,
                                    float* __restrict__ logL_out, int* __restrict__ nlike_out,
                                    int B, int D) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= B) return;
    float x0[SLICE_MAXD];
    float n[SLICE_MAXD];
    slice_load(x0, x0_in, 0, D, B, g);
    slice_load(n, nhat, 0, D, B, g);
    const uint32_t block = (uint32_t)g / PROTO_BLOCK, lane = (uint32_t)g % PROTO_BLOCK;
    const uint32_t h = mix32((uint32_t)seed[0] + 7919u * block, lane);
    const SliceRepeat rep = slice_repeat<GaussianLike<SLICE_MAXD>, true>(
        like, x0, n, w[g], bound[g], h, D, PROTO_MAX_STEP, PROTO_MAX_SHRINK, PROTO_MAX_INNER);
    if (rep.accepted) slice_advance(x0, n, rep.t, D);
#pragma unroll
    for (int d = 0; d < SLICE_MAXD; ++d)
        if (d < D) cube[(size_t)d * B + g] = x0[d];
    logL_out[g] = rep.logL;
    nlike_out[g] = rep.cnt;
}

static GaussianLike<SLICE_MAXD> proto_like(int D, float sigma, float norm, float logzero) {
    AffinePrior prior;
    for (int d = 0; d < SLICE_MAXD; ++d) {
        prior.a[d] = 0.0f;
        prior.s[d] = d < D ? 1.0f : 0.0f;
    }
    return GaussianLike<SLICE_MAXD>{prior, 0.5f, sigma, norm, logzero};
}

// E4: seed int32[1], x0 (D, B), bound (B,), nhats (R, D, B), ws (R, B)
// float32 device arrays -> cube (R, D, B), logL (R, B) float32, nlike (B,)
// int32.  Returns a CUDA error code.
extern "C" int proto_epoch_launch(const void* seed, const void* x0, const void* bound,
                                  const void* nhats, const void* ws, void* cube, void* logL,
                                  void* nlike, int B, int D, int R, float sigma, float norm,
                                  float logzero, void* stream) {
    if (B < 1 || R < 1 || D < 1 || D > SLICE_MAXD) return (int)cudaErrorInvalidValue;
    proto_epoch_kernel<<<(B + PROTO_THREADS - 1) / PROTO_THREADS, PROTO_THREADS, 0,
                         (cudaStream_t)stream>>>(
        proto_like(D, sigma, norm, logzero), (const int*)seed, (const float*)x0,
        (const float*)bound, (const float*)nhats, (const float*)ws, (float*)cube,
        (float*)logL, (int*)nlike, B, D, R);
    return (int)cudaGetLastError();
}

// E5: seed int32[1], x0 and nhat (D, B), w and bound (B,) float32 device
// arrays, B a multiple of 1024 -> cube (D, B), logL (B,) float32, nlike
// (B,) int32.  Returns a CUDA error code.
extern "C" int proto_repeat_launch(const void* seed, const void* x0, const void* nhat,
                                   const void* w, const void* bound, void* cube, void* logL,
                                   void* nlike, int B, int D, float sigma, float norm,
                                   float logzero, void* stream) {
    if (B < 1 || B % PROTO_BLOCK || D < 1 || D > SLICE_MAXD) return (int)cudaErrorInvalidValue;
    proto_repeat_kernel<<<(B + PROTO_THREADS - 1) / PROTO_THREADS, PROTO_THREADS, 0,
                          (cudaStream_t)stream>>>(
        proto_like(D, sigma, norm, logzero), (const int*)seed, (const float*)x0,
        (const float*)nhat, (const float*)w, (const float*)bound, (float*)cube, (float*)logL,
        (int*)nlike, B, D);
    return (int)cudaGetLastError();
}
