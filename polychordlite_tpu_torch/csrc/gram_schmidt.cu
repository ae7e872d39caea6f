// Haar-basis Gram-Schmidt (CGS2) for the slice directions.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_dirs.py::
// gram_schmidt_lanes.  Same layout at the interface: the input is a batch
// of (dim, dim) Gaussian matrices stored (n_bases, dim, dim, B) with the
// chain axis minor, and the output holds their orthonormalised columns in
// the same layout.  For each column j: two sweeps of v -= (q_k . v) q_k over
// k < j, then q_j = v / max(|v|, 1e-30).  Every dot product sums over the
// row index in order 0..dim-1.
//
// What bounds it on the card: it is tiny work (about 3 dim^3 flops per
// basis, ~1 GFLOP at the bench shape) spread over many independent chains,
// so the limit is memory latency of re-reading the finished columns q_k.
// Design: one thread per (basis, chain); the working column v lives in
// registers (dim <= GS_MAXD, loops unrolled so the indices are static);
// the finished columns are written to the output and re-read from there —
// neighbouring threads are neighbouring chains, so every load and store is
// coalesced and the re-reads hit L1/L2.  Built with --fmad=false, and every
// operation is an explicitly rounded intrinsic.

#include <cuda_runtime.h>

#define GS_MAXD 32

__global__ void gram_schmidt_kernel(const float* __restrict__ g,
                                    float* __restrict__ q,
                                    int dim, int B) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t sj = (size_t)B;        // stride of the column index
    const size_t si = (size_t)dim * B;  // stride of the row index
    const size_t base = (size_t)blockIdx.y * dim * dim * B + b;
    const float* gb = g + base;
    float* qb = q + base;

    float v[GS_MAXD];
    for (int j = 0; j < dim; ++j) {
#pragma unroll
        for (int i = 0; i < GS_MAXD; ++i)
            if (i < dim) v[i] = gb[i * si + j * sj];
        for (int sweep = 0; sweep < 2; ++sweep) {
            for (int k = 0; k < j; ++k) {
                const float* qk = qb + k * sj;
                float c = 0.0f;
#pragma unroll
                for (int i = 0; i < GS_MAXD; ++i)
                    if (i < dim) c = __fadd_rn(c, __fmul_rn(qk[i * si], v[i]));
#pragma unroll
                for (int i = 0; i < GS_MAXD; ++i)
                    if (i < dim) v[i] = __fsub_rn(v[i], __fmul_rn(c, qk[i * si]));
            }
        }
        float nrm = 0.0f;
#pragma unroll
        for (int i = 0; i < GS_MAXD; ++i)
            if (i < dim) nrm = __fadd_rn(nrm, __fmul_rn(v[i], v[i]));
        const float den = fmaxf(__fsqrt_rn(nrm), 1e-30f);
#pragma unroll
        for (int i = 0; i < GS_MAXD; ++i)
            if (i < dim) qb[i * si + j * sj] = __fdiv_rn(v[i], den);
    }
}

extern "C" int gram_schmidt_max_dim() { return GS_MAXD; }

// g, q: (n_bases, dim, dim, B) float32, contiguous, on the device.
extern "C" int gram_schmidt_f32(const void* g, void* q, int n_bases, int dim,
                                int B, void* stream) {
    if (dim < 1 || dim > GS_MAXD || n_bases < 1 || n_bases > 65535 || B < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 64;
    dim3 grid((B + threads - 1) / threads, n_bases);
    gram_schmidt_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)g, (float*)q, dim, B);
    return (int)cudaGetLastError();
}
