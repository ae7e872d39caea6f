// Haar-basis Gram-Schmidt (CGS2) for the slice directions.
//
// Replaces the TPU kernel polychordlite_tpu/ops/pallas_dirs.py::
// gram_schmidt_lanes.  Same layout at the interface: the input is a batch
// of (dim, dim) Gaussian matrices stored (n_bases, dim, dim, B) with the
// chain axis minor, and the output holds their orthonormalised columns in
// the same layout.  For each column j: two sweeps of v -= (q_k . v) q_k over
// k < j, then q_j = v / max(|v|, 1e-30).  Every dot product sums over the
// row index in order 0..dim-1, one rounded operation at a time, as
// ops/pallas_dirs.py::gram_schmidt_plain does (built with --fmad=false).
//
// What bounds it on the card: about 3 dim^3 flops per basis (~1 GFLOP at
// the bench shape) against 2 dim^2 floats of input and output, and each
// basis is a chain of ~dim^2 dependent dot products of dim adds each (the
// sweeps are sequential in k).  The first port kept one thread per
// (basis, chain), wrote each finished column q_k to the output and re-read
// it from there for every later column, in both sweeps: ~15,000 loads per
// basis at dim 20, ~2.5 GB of L1/L2 traffic at the bench shape (5, 20, 20,
// 8192) against 131 MB of input and output, 1.03 ms (PERF.md).
//
// The design: one thread per (basis, chain), 32 chains per block.  The
// working column lives in registers and the finished columns in shared
// memory, laid out [k][i][lane] so that the 32 lanes of a warp read 32
// banks: dim^2 * 128 bytes per block (51 KB at dim 20, dynamic shared
// memory, with the carveout set to the most shared memory so that four
// blocks fit on an SM).  Every input is read and every output written once
// in global memory.  dim is a template parameter: the loops over rows are
// exact, so a dot product's loads issue together ahead of its chain of
// adds (a run-time bound puts a branch before every load; that kernel took
// ~700 cycles per dot at one warp per SM, PERF.md).  No barrier: each
// thread reads only the shared memory it wrote.  (One basis per warp, lane
// i holding row i and the products exchanged by __shfl_sync, was measured
// and removed: slower at both main-path shapes.)

#include <cuda_runtime.h>

#include <utility>

#define GS_MAXD 32

template <int DIM>
__global__ void gram_schmidt_kernel(const float* __restrict__ g, float* __restrict__ q,
                                    int B) {
    extern __shared__ float qs[];  // [k][i][lane]: finished column k, row i
    const int lane = threadIdx.x;  // blockDim.x == 32
    const int b = blockIdx.x * 32 + lane;
    if (b >= B) return;
    const size_t sj = (size_t)B;        // stride of the column index
    const size_t si = (size_t)DIM * B;  // stride of the row index
    const size_t base = (size_t)blockIdx.y * DIM * DIM * B + b;
    const float* gb = g + base;
    float* qb = q + base;

    float v[DIM];
    for (int j = 0; j < DIM; ++j) {
#pragma unroll
        for (int i = 0; i < DIM; ++i) v[i] = gb[i * si + j * sj];
        for (int sweep = 0; sweep < 2; ++sweep) {
            for (int k = 0; k < j; ++k) {
                const float* qk = qs + k * DIM * 32 + lane;
                float qv[DIM];
#pragma unroll
                for (int i = 0; i < DIM; ++i) qv[i] = qk[i * 32];
                float c = 0.0f;
#pragma unroll
                for (int i = 0; i < DIM; ++i) c = __fadd_rn(c, __fmul_rn(qv[i], v[i]));
#pragma unroll
                for (int i = 0; i < DIM; ++i) v[i] = __fsub_rn(v[i], __fmul_rn(c, qv[i]));
            }
        }
        float nrm = 0.0f;
#pragma unroll
        for (int i = 0; i < DIM; ++i) nrm = __fadd_rn(nrm, __fmul_rn(v[i], v[i]));
        const float den = fmaxf(__fsqrt_rn(nrm), 1e-30f);
        float* qj = qs + j * DIM * 32 + lane;
#pragma unroll
        for (int i = 0; i < DIM; ++i) {
            const float x = __fdiv_rn(v[i], den);
            qj[i * 32] = x;
            qb[i * si + j * sj] = x;
        }
    }
}

using GramSchmidtKernel = void (*)(const float*, float*, int);

template <int... Ds>
static GramSchmidtKernel kernel_for(int dim, std::integer_sequence<int, Ds...>) {
    static const GramSchmidtKernel kernels[] = {gram_schmidt_kernel<Ds + 1>...};
    return kernels[dim - 1];
}

extern "C" int gram_schmidt_max_dim() { return GS_MAXD; }

// g, q: (n_bases, dim, dim, B) float32, contiguous, on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int gram_schmidt_f32(const void* g, void* q, int n_bases, int dim, int B,
                                void* stream) {
    if (dim < 1 || dim > GS_MAXD || n_bases < 1 || n_bases > 65535 || B < 1)
        return (int)cudaErrorInvalidValue;
    const GramSchmidtKernel kernel =
        kernel_for(dim, std::make_integer_sequence<int, GS_MAXD>{});
    const int smem = (int)sizeof(float) * dim * dim * 32;
    cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute((const void*)kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((B + 31) / 32, n_bases);
    kernel<<<grid, 32, smem, (cudaStream_t)stream>>>((const float*)g, (float*)q, B);
    return (int)cudaGetLastError();
}
