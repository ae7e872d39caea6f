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

// Above dim 128 the warp-per-basis design goes on with run-time rows
// (gram_schmidt_long_kernel): lane l holds rows i = l + 32 m, ceil(dim / 32)
// of them, in the same order — each lane sums its rows in index order, then
// the butterfly — so the plain version is the same function with its row
// cap lifted.  Neither the working column nor the finished ones fit
// registers at any dim, so the working column lives in the block's dynamic
// shared memory (dim values) and so do the finished columns k < k_smem,
// as many as the rest of the 227 KB holds ([k][i]): all of them up to dim
// 240 in float32 and 169 in float64 (gs_columns_in_smem).  The columns past
// k_smem go to a scratch buffer in device memory that the wrapper
// allocates, [basis][k - k_smem][i], so that a warp's 32 rows of a column
// are 32 contiguous values.  Each lane reads only the rows it wrote, in
// shared and in device memory alike, so no barrier is needed.  What bounds
// it: the same chain of ~dim^2 dependent dot products per basis, now of
// ceil(dim / 32) shared-memory loads a lane each; past k_smem, the values
// each basis reads back from device memory, about (dim - k_smem)^2 dim of
// them (327 MB a basis at dim 512 in float32), which L2 holds for only a
// few bases at a time.  The working column bounds
// dim: dim sizeof(T) <= 227 KB, dim <= 29,056 (GS_MAXD_LONG) in either type.

// Double: a run at precision='highest' draws its directions in
// float64, so both kernels are templates on the scalar type T, the float
// instantiations the code above.  In double, a block of the
// thread-per-basis kernel needs 8 * dim^2 * 32 bytes of shared memory,
// past the 227 KB a block may have above dim 30; there the block holds 16
// chains (gs_lanes: half a warp, 128 KB at dim 32).  Its v[DIM] and qv[DIM]
// take twice the registers.  The wide kernel's one basis takes dim^2 * 8
// bytes, 128 KB at dim 128: one basis an SM there.  The sums keep their
// order, so each double kernel is bitwise gram_schmidt_plain in float64.

#include <cuda_runtime.h>

#include <utility>

#include "rounded.cuh"

#define GS_MAXD 32
#define GS_MAXD_WIDE 128
#define GS_ROWS (GS_MAXD_WIDE / 32)  // rows per lane in the wide kernel
// the shared memory a block may have (bytes)
#define GS_SMEM_MAX 232448
// the largest dim of the long kernel: its working column fills a block's
// shared memory in float64
#define GS_MAXD_LONG (GS_SMEM_MAX / 8)

// The chains of a block of the thread-per-basis kernel: 32, or 16 where a
// block of 32 would need more shared memory than a block may have (double
// above dim 30).
template <class T>
constexpr int gs_lanes(int dim) {
    return (int)sizeof(T) * dim * dim * 32 <= GS_SMEM_MAX ? 32 : 16;
}

// The norm's rounded square root, clamped from below (the plain version's
// clamp_min(sqrt(norm), 1e-30) in the type's own literal).
__device__ __forceinline__ float gs_den(float nrm) { return fmaxf(__fsqrt_rn(nrm), 1e-30f); }
__device__ __forceinline__ double gs_den(double nrm) { return fmax(__dsqrt_rn(nrm), 1e-30); }

template <class T, int DIM, int LANES>
__global__ void gram_schmidt_kernel(const T* __restrict__ g, T* __restrict__ q, int B) {
    extern __shared__ __align__(16) unsigned char gs_smem[];
    T* qs = reinterpret_cast<T*>(gs_smem);  // [k][i][lane]: finished column k, row i
    const int lane = threadIdx.x;  // blockDim.x == LANES
    const int b = blockIdx.x * LANES + lane;
    if (b >= B) return;
    const size_t sj = (size_t)B;        // stride of the column index
    const size_t si = (size_t)DIM * B;  // stride of the row index
    const size_t base = (size_t)blockIdx.y * DIM * DIM * B + b;
    const T* gb = g + base;
    T* qb = q + base;

    T v[DIM];
    for (int j = 0; j < DIM; ++j) {
#pragma unroll
        for (int i = 0; i < DIM; ++i) v[i] = gb[i * si + j * sj];
        for (int sweep = 0; sweep < 2; ++sweep) {
            for (int k = 0; k < j; ++k) {
                const T* qk = qs + k * DIM * LANES + lane;
                T qv[DIM];
#pragma unroll
                for (int i = 0; i < DIM; ++i) qv[i] = qk[i * LANES];
                T c = T(0);
#pragma unroll
                for (int i = 0; i < DIM; ++i) c = rn_add(c, rn_mul(qv[i], v[i]));
#pragma unroll
                for (int i = 0; i < DIM; ++i) v[i] = rn_sub(v[i], rn_mul(c, qv[i]));
            }
        }
        T nrm = T(0);
#pragma unroll
        for (int i = 0; i < DIM; ++i) nrm = rn_add(nrm, rn_mul(v[i], v[i]));
        const T den = gs_den(nrm);
        T* qj = qs + j * DIM * LANES + lane;
#pragma unroll
        for (int i = 0; i < DIM; ++i) {
            const T x = rn_div(v[i], den);
            qj[i * LANES] = x;
            qb[i * si + j * sj] = x;
        }
    }
}

// The dot product of two columns held as rows i = lane + 32 m: each lane's
// rows in order, then the butterfly over the warp.
template <class T>
__device__ __forceinline__ T warp_dot(const T (&a)[GS_ROWS], const T (&b)[GS_ROWS]) {
    T c = T(0);
#pragma unroll
    for (int m = 0; m < GS_ROWS; ++m) c = rn_add(c, rn_mul(a[m], b[m]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c = rn_add(c, __shfl_xor_sync(0xffffffffu, c, off));
    return c;
}

// GS_MAXD < dim <= GS_MAXD_WIDE: basis (blockIdx.y, chain blockIdx.x) on the
// block's one warp.
template <class T>
__global__ void gram_schmidt_wide_kernel(const T* __restrict__ g, T* __restrict__ q, int dim,
                                         int B) {
    extern __shared__ __align__(16) unsigned char gs_smem[];
    T* qw = reinterpret_cast<T*>(gs_smem);  // [k][i]: finished column k, row i
    const int lane = threadIdx.x;  // blockDim.x == 32
    const int b = blockIdx.x;
    const size_t sj = (size_t)B;        // stride of the column index
    const size_t si = (size_t)dim * B;  // stride of the row index
    const size_t base = (size_t)blockIdx.y * dim * dim * B + b;
    const T* gb = g + base;
    T* qb = q + base;

    for (int j = 0; j < dim; ++j) {
        T v[GS_ROWS];
#pragma unroll
        for (int m = 0; m < GS_ROWS; ++m) {
            const int i = lane + 32 * m;
            v[m] = i < dim ? gb[i * si + j * sj] : T(0);
        }
        for (int sweep = 0; sweep < 2; ++sweep) {
            for (int k = 0; k < j; ++k) {
                T qv[GS_ROWS];
#pragma unroll
                for (int m = 0; m < GS_ROWS; ++m) {
                    const int i = lane + 32 * m;
                    qv[m] = i < dim ? qw[k * dim + i] : T(0);
                }
                const T c = warp_dot(qv, v);
#pragma unroll
                for (int m = 0; m < GS_ROWS; ++m) v[m] = rn_sub(v[m], rn_mul(c, qv[m]));
            }
        }
        const T den = gs_den(warp_dot(v, v));
#pragma unroll
        for (int m = 0; m < GS_ROWS; ++m) {
            const int i = lane + 32 * m;
            if (i < dim) {
                const T x = rn_div(v[m], den);
                qw[j * dim + i] = x;
                qb[i * si + j * sj] = x;
            }
        }
        __syncwarp();  // column j is in shared memory before any lane reads it
    }
}

// dim > GS_MAXD_WIDE: basis (blockIdx.y, chain blockIdx.x) on the block's
// one warp, the working column and the finished columns k < k_smem in shared
// memory, the others in `scratch` (see the top of the file).
template <class T>
__global__ void gram_schmidt_long_kernel(const T* __restrict__ g, T* __restrict__ q,
                                         T* __restrict__ scratch, int dim, int B, int k_smem) {
    extern __shared__ __align__(16) unsigned char gs_smem[];
    T* v = reinterpret_cast<T*>(gs_smem);  // the working column: row i at v[i]
    T* qw = v + dim;                       // [k][i]: finished column k < k_smem, row i
    const int lane = threadIdx.x;          // blockDim.x == 32
    const int b = blockIdx.x;
    const size_t sj = (size_t)B;        // stride of the column index
    const size_t si = (size_t)dim * B;  // stride of the row index
    const size_t base = (size_t)blockIdx.y * dim * dim * B + b;
    const T* gb = g + base;
    T* qb = q + base;
    // [k - k_smem][i]: this basis's finished columns past k_smem
    T* qg = scratch + ((size_t)blockIdx.y * B + b) * (size_t)(dim - k_smem) * dim;

    for (int j = 0; j < dim; ++j) {
        for (int i = lane; i < dim; i += 32) v[i] = gb[i * si + j * sj];
        for (int sweep = 0; sweep < 2; ++sweep) {
            for (int k = 0; k < j; ++k) {
                const T* qk = k < k_smem ? qw + (size_t)k * dim : qg + (size_t)(k - k_smem) * dim;
                T c = T(0);
                for (int i = lane; i < dim; i += 32) c = rn_add(c, rn_mul(qk[i], v[i]));
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    c = rn_add(c, __shfl_xor_sync(0xffffffffu, c, off));
                for (int i = lane; i < dim; i += 32) v[i] = rn_sub(v[i], rn_mul(c, qk[i]));
            }
        }
        T nrm = T(0);
        for (int i = lane; i < dim; i += 32) nrm = rn_add(nrm, rn_mul(v[i], v[i]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            nrm = rn_add(nrm, __shfl_xor_sync(0xffffffffu, nrm, off));
        const T den = gs_den(nrm);
        T* qj = j < k_smem ? qw + (size_t)j * dim : qg + (size_t)(j - k_smem) * dim;
        for (int i = lane; i < dim; i += 32) {
            const T x = rn_div(v[i], den);
            qj[i] = x;
            qb[i * si + j * sj] = x;
        }
    }
}

// The finished columns the long kernel keeps in shared memory at `dim`:
// as many as fit beside the working column, at most dim.
static long long gs_columns_in_smem(int dim, int bytes) {
    const long long k = ((long long)GS_SMEM_MAX / bytes - dim) / dim;
    return k < dim ? k : dim;
}

template <class T>
static int gram_schmidt_long(const T* g, T* q, T* scratch, int n_bases, int dim, int B,
                             cudaStream_t stream) {
    const int k_smem = (int)gs_columns_in_smem(dim, (int)sizeof(T));
    if (k_smem < dim && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int smem = (int)sizeof(T) * dim * (1 + k_smem);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute((const void*)gram_schmidt_long_kernel<T>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   smem);
        if (e != cudaSuccess) return (int)e;
    }
    gram_schmidt_long_kernel<T><<<dim3(B, n_bases), 32, smem, stream>>>(g, q, scratch, dim, B,
                                                                         k_smem);
    return (int)cudaGetLastError();
}

template <class T>
static int gram_schmidt_wide(const T* g, T* q, int n_bases, int dim, int B,
                             cudaStream_t stream) {
    const int smem = (int)sizeof(T) * dim * dim;
    const cudaError_t e = cudaFuncSetAttribute((const void*)gram_schmidt_wide_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)sizeof(T) * GS_MAXD_WIDE * GS_MAXD_WIDE);
    if (e != cudaSuccess) return (int)e;
    gram_schmidt_wide_kernel<T><<<dim3(B, n_bases), 32, smem, stream>>>(g, q, dim, B);
    return (int)cudaGetLastError();
}

template <class T>
using GramSchmidtKernel = void (*)(const T*, T*, int);

template <class T, int... Ds>
static GramSchmidtKernel<T> kernel_for(int dim, std::integer_sequence<int, Ds...>) {
    static const GramSchmidtKernel<T> kernels[] = {
        gram_schmidt_kernel<T, Ds + 1, gs_lanes<T>(Ds + 1)>...};
    return kernels[dim - 1];
}

// The launch of the kernel of `dim` in the scalar type T; see the entries
// below.
template <class T>
static int gram_schmidt(const void* g, void* q, void* scratch, int n_bases, int dim, int B,
                        void* stream) {
    if (dim < 1 || dim > GS_MAXD_LONG || n_bases < 1 || n_bases > 65535 || B < 1)
        return (int)cudaErrorInvalidValue;
    if (dim > GS_MAXD_WIDE)
        return gram_schmidt_long((const T*)g, (T*)q, (T*)scratch, n_bases, dim, B,
                                 (cudaStream_t)stream);
    if (dim > GS_MAXD)
        return gram_schmidt_wide((const T*)g, (T*)q, n_bases, dim, B, (cudaStream_t)stream);
    const GramSchmidtKernel<T> kernel =
        kernel_for<T>(dim, std::make_integer_sequence<int, GS_MAXD>{});
    const int lanes = gs_lanes<T>(dim);
    const int smem = (int)sizeof(T) * dim * dim * lanes;
    cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute((const void*)kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((B + lanes - 1) / lanes, n_bases);
    kernel<<<grid, lanes, smem, (cudaStream_t)stream>>>((const T*)g, (T*)q, B);
    return (int)cudaGetLastError();
}

// The largest dim of the three kernels.
extern "C" int gram_schmidt_max_dim() { return GS_MAXD_LONG; }

// The values of the scratch buffer a launch at (n_bases, dim, B) in a type
// of `bytes` bytes needs: the long kernel's finished columns past those
// its shared memory holds (0 where it holds them all, and at dim <= 128).
extern "C" long long gram_schmidt_scratch_values(int n_bases, int dim, int B, int bytes) {
    if (dim <= GS_MAXD_WIDE) return 0;
    return (long long)n_bases * B * (dim - gs_columns_in_smem(dim, bytes)) * dim;
}

// g, q: (n_bases, dim, dim, B) float32, contiguous, on the device: the
// thread-per-basis kernel for dim <= GS_MAXD, the wide kernel up to
// GS_MAXD_WIDE, the long kernel above; scratch: a device array of
// gram_schmidt_scratch_values(n_bases, dim, B, 4) float32 (null when 0).
// Returns cudaGetLastError() after the launch.
extern "C" int gram_schmidt_f32(const void* g, void* q, void* scratch, int n_bases, int dim,
                                int B, void* stream) {
    return gram_schmidt<float>(g, q, scratch, n_bases, dim, B, stream);
}

// The same in float64.
extern "C" int gram_schmidt_f64(const void* g, void* q, void* scratch, int n_bases, int dim,
                                int B, void* stream) {
    return gram_schmidt<double>(g, q, scratch, n_bases, dim, B, stream);
}
