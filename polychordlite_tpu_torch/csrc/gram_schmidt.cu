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
//
// Above dim 32 that design does not fit: a block's dim^2 * 128 bytes pass
// the 227 KB an SM has at dim 42, and v[dim] per thread spills.  So dims 33
// to 128 have a second kernel, gram_schmidt_wide_kernel: one basis per warp
// (one warp per block), lane l holding rows i = l + 32 m (m < 4) of the
// working column in registers, the finished columns in shared memory
// ([k][i], dim^2 floats: 64 KB at 128, so three bases per SM there,
// fourteen at 64), and every dot product reduced across the lanes.  Its
// order differs from the thread-per-basis kernel's, and
// ops/pallas_dirs.py::gram_schmidt_plain follows it above dim 32: each lane
// sums its four rows in order (the rows past dim hold zeros, which change
// no sum), then a butterfly of __shfl_xor_sync over offsets 16, 8, 4, 2, 1
// adds the partial sums (every lane ends with the same value, float
// addition being commutative).  dim is a run-time argument: one kernel
// for the 96 dims, the loops over rows fixed at four per lane.  The chain
// is the same one the thread-per-basis kernel has — ~dim^2 dependent dot
// products per basis — with five shuffle steps in each, hidden only by the
// other bases on the SM.

#include <cuda_runtime.h>

#include <utility>

#define GS_MAXD 32
#define GS_MAXD_WIDE 128
#define GS_ROWS (GS_MAXD_WIDE / 32)  // rows per lane in the wide kernel

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

// The dot product of two columns held as rows i = lane + 32 m: each lane's
// rows in order, then the butterfly over the warp.
__device__ __forceinline__ float warp_dot(const float (&a)[GS_ROWS], const float (&b)[GS_ROWS]) {
    float c = 0.0f;
#pragma unroll
    for (int m = 0; m < GS_ROWS; ++m) c = __fadd_rn(c, __fmul_rn(a[m], b[m]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c = __fadd_rn(c, __shfl_xor_sync(0xffffffffu, c, off));
    return c;
}

// GS_MAXD < dim <= GS_MAXD_WIDE: basis (blockIdx.y, chain blockIdx.x) on the
// block's one warp.
__global__ void gram_schmidt_wide_kernel(const float* __restrict__ g, float* __restrict__ q,
                                         int dim, int B) {
    extern __shared__ float qw[];  // [k][i]: finished column k, row i
    const int lane = threadIdx.x;  // blockDim.x == 32
    const int b = blockIdx.x;
    const size_t sj = (size_t)B;        // stride of the column index
    const size_t si = (size_t)dim * B;  // stride of the row index
    const size_t base = (size_t)blockIdx.y * dim * dim * B + b;
    const float* gb = g + base;
    float* qb = q + base;

    for (int j = 0; j < dim; ++j) {
        float v[GS_ROWS];
#pragma unroll
        for (int m = 0; m < GS_ROWS; ++m) {
            const int i = lane + 32 * m;
            v[m] = i < dim ? gb[i * si + j * sj] : 0.0f;
        }
        for (int sweep = 0; sweep < 2; ++sweep) {
            for (int k = 0; k < j; ++k) {
                float qv[GS_ROWS];
#pragma unroll
                for (int m = 0; m < GS_ROWS; ++m) {
                    const int i = lane + 32 * m;
                    qv[m] = i < dim ? qw[k * dim + i] : 0.0f;
                }
                const float c = warp_dot(qv, v);
#pragma unroll
                for (int m = 0; m < GS_ROWS; ++m) v[m] = __fsub_rn(v[m], __fmul_rn(c, qv[m]));
            }
        }
        const float den = fmaxf(__fsqrt_rn(warp_dot(v, v)), 1e-30f);
#pragma unroll
        for (int m = 0; m < GS_ROWS; ++m) {
            const int i = lane + 32 * m;
            if (i < dim) {
                const float x = __fdiv_rn(v[m], den);
                qw[j * dim + i] = x;
                qb[i * si + j * sj] = x;
            }
        }
        __syncwarp();  // column j is in shared memory before any lane reads it
    }
}

static int gram_schmidt_wide(const float* g, float* q, int n_bases, int dim, int B,
                             cudaStream_t stream) {
    const int smem = (int)sizeof(float) * dim * dim;
    const cudaError_t e = cudaFuncSetAttribute((const void*)gram_schmidt_wide_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)sizeof(float) * GS_MAXD_WIDE * GS_MAXD_WIDE);
    if (e != cudaSuccess) return (int)e;
    gram_schmidt_wide_kernel<<<dim3(B, n_bases), 32, smem, stream>>>(g, q, dim, B);
    return (int)cudaGetLastError();
}

using GramSchmidtKernel = void (*)(const float*, float*, int);

template <int... Ds>
static GramSchmidtKernel kernel_for(int dim, std::integer_sequence<int, Ds...>) {
    static const GramSchmidtKernel kernels[] = {gram_schmidt_kernel<Ds + 1>...};
    return kernels[dim - 1];
}

// The largest dim of the two kernels.
extern "C" int gram_schmidt_max_dim() { return GS_MAXD_WIDE; }

// g, q: (n_bases, dim, dim, B) float32, contiguous, on the device: the
// thread-per-basis kernel for dim <= GS_MAXD, the wide kernel above.
// Returns cudaGetLastError() after the launch.
extern "C" int gram_schmidt_f32(const void* g, void* q, int n_bases, int dim, int B,
                                void* stream) {
    if (dim < 1 || dim > GS_MAXD_WIDE || n_bases < 1 || n_bases > 65535 || B < 1)
        return (int)cudaErrorInvalidValue;
    if (dim > GS_MAXD)
        return gram_schmidt_wide((const float*)g, (float*)q, n_bases, dim, B,
                                 (cudaStream_t)stream);
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
