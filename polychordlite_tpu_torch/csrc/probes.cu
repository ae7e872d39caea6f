// Structure probes: what the TPU kernels' skeleton costs on the card.
//
// grid_steps_* replaces the TPU kernel experiments/prof_grid_overhead.py::
// build (pallas_call at :90): a grid=(R,) kernel over (R, D, S, 128)
// float32 whose step r writes
//     out[r] = stream[r, 0] * 1.0 (+ head[0, 0]) (+ x0[0]) (+ 1.0)
// with the structural pieces of v3 added one at a time (variants A-F,
// :1-12).  Pallas runs the grid in order ("arbitrary"): one step after the
// other, each with its (1, D, S, 128) block staged from HBM into VMEM by
// the pipeline, the constant-index inputs (head, x0) staged once.  Here
// variants A-E are one cooperative kernel that walks r = 0..R-1 with a grid
// barrier (this_grid().sync()) between steps; each block owns one row s of
// the tile (128 threads, one per lane) and stages its part of every block
// into shared memory with cp.async — the step moves the same bytes as on
// the TPU.  D and E also keep v3's scratch set (:84-88: a (4, D, S, 128)
// ring, two (D, S, 128) and twelve (S, 128) arrays) in global memory,
// zeroed at r = 0, the ring accumulated with out[r] every step.  F
// ("parallel") is one launch over R x S independent blocks; B is also run
// as one launch per step, the other way a sequential step can be done.
//
// while_loop_kernel replaces experiments/prof_pallas_while.py::run
// (pallas_call at :66): a loop of n iterations over a (S, 128) float32 tile,
// one thread per element, with one of four bodies (:17-57):
//   counter  acc += 1
//   anycond  acc += 1, the loop running while the tile-wide any(acc > -1e30)
//            holds — a reduction over every thread, so over every block: a
//            grid barrier per iteration (cooperative).  Its warp
//            (__any_sync) and block (__syncthreads_or) forms are extra
//            variants: the three granularities a loop condition can need.
//   prng     acc += u, u from the murmur3 counter hash keyed on (7, lane,
//            iteration) (slice_common.cuh) in place of the TPU's hardware
//            stream
//   body20   a dependent 20-D slice-like iteration in JAX's float order:
//            probe = b + 0.001 acc, d = (probe - 0.5) 10, logL = -0.5 sum_d
//            d^2 (d in index order), acc = logL > -40 ? acc + 1 : acc / 2,
//            with b the (20, S, 128) broadcast of the input, read from
//            memory so that the 20 coordinates are not folded into one.
// Every float operation is a rounded intrinsic (and the file is built with
// --fmad=false), so each kernel equals its plain torch version bit for bit.
//
// What bounds them: not bytes or arithmetic — these kernels measure
// latencies (a barrier, a loop iteration, a dependent chain of float
// operations) at the occupancy of the slice kernels (8192 threads).

#include <cooperative_groups.h>

#include "slice_common.cuh"

namespace cg = cooperative_groups;

#define LANES 128  // lanes of a tile row: the threads of a block

// ---------------------------------------------------------------------------
// grid steps (E6)

__device__ __forceinline__ void stage4(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage rows [0, nrows) of a (nrows, S, LANES) array's row s into smem
// (nrows, LANES): each thread copies its lane's column.
__device__ __forceinline__ void stage_rows(float* smem, const float* src, int nrows, int S,
                                           int s) {
    for (int k = 0; k < nrows; ++k)
        stage4(smem + k * LANES + threadIdx.x, src + ((size_t)k * S + s) * LANES + threadIdx.x);
}

struct GridArgs {
    const float* stream;  // (R, D, S, 128)
    const float* head;    // (3, D, S, 128) or null
    const float* x0;      // (D, S, 128) or null
    float* out;           // (R, S, 128)
    float* ring;          // scratch (4, D, S, 128) or null
    float* rest;          // scratch 2 x (D, S, 128) + 12 x (S, 128), or null
    int R, D, S, one;     // `one`: the trip count of the one-iteration loop
};

template <bool WHILE, bool HEAD, bool SCRATCH, bool X0>
__device__ __forceinline__ void grid_step(const GridArgs& a, float* smem, int r, int s) {
    const int D = a.D, S = a.S, lane = threadIdx.x;
    float* st = smem;                          // (D, 128): this step's block
    float* hd = st + D * LANES;                // (3 D, 128): head, staged at r = 0
    float* xs = hd + (HEAD ? 3 * D : 0) * LANES;  // (D, 128): x0, staged at r = 0
    stage_rows(st, a.stream + (size_t)r * D * S * LANES, D, S, s);
    if (HEAD && r == 0) stage_rows(hd, a.head, 3 * D, S, s);
    if (X0 && r == 0) stage_rows(xs, a.x0, D, S, s);
    stage_wait();
    float val = __fmul_rn(st[lane], 1.0f);
    if (HEAD) val = __fadd_rn(val, hd[lane]);
    if (X0) val = __fadd_rn(val, xs[lane]);
    if (WHILE) {
        for (int i = 0; i < a.one; ++i) val = __fadd_rn(val, 1.0f);
    }
    const size_t e = (size_t)s * LANES + lane;
    if (SCRATCH) {
        const size_t E = (size_t)S * LANES;
        if (r == 0) {
            for (int k = 0; k < 4 * D; ++k) a.ring[k * E + e] = 0.0f;
            for (int k = 0; k < 2 * D + 12; ++k) a.rest[k * E + e] = 0.0f;
        }
        for (int k = 0; k < 4 * D; ++k) a.ring[k * E + e] = __fadd_rn(a.ring[k * E + e], val);
    }
    a.out[(size_t)r * S * LANES + e] = val;
}

// Variants A-E: all R steps in order, a grid barrier between steps.
template <bool WHILE, bool HEAD, bool SCRATCH, bool X0>
__global__ void grid_steps_coop(GridArgs a) {
    extern __shared__ float smem[];
    cg::grid_group grid = cg::this_grid();
    for (int r = 0; r < a.R; ++r) {
        if (r > 0) grid.sync();
        grid_step<WHILE, HEAD, SCRATCH, X0>(a, smem, r, blockIdx.x);
    }
}

// F (all steps at once, blockIdx.y = step) and B one launch per step
// (gridDim.y = 1, the step r0).
__global__ void grid_steps_parallel(GridArgs a, int r0) {
    extern __shared__ float smem[];
    grid_step<true, false, false, false>(a, smem, r0 + blockIdx.y, blockIdx.x);
}

template <class Kernel>
static int coop_launch(Kernel kernel, int blocks, int threads, size_t smem, void** args,
                       cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int device = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if ((long long)per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(threads), args,
                                    smem, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// variant: 0-5 = A-F; 6 = B as one launch per step.  head, x0, ring and
// rest may be null where the variant does not use them.  Returns a CUDA
// error code.
extern "C" int grid_steps_launch(int variant, const void* stream_in, const void* head,
                                 const void* x0, void* out, void* ring, void* rest, int R,
                                 int D, int S, void* stream) {
    if (R < 1 || D < 1 || S < 1 || variant < 0 || variant > 6) return (int)cudaErrorInvalidValue;
    GridArgs a{(const float*)stream_in, (const float*)head, (const float*)x0, (float*)out,
               (float*)ring, (float*)rest, R, D, S, 1};
    const bool head_used = variant >= 2 && variant <= 4, x0_used = variant == 4;
    const size_t smem = sizeof(float) * LANES * (D + (head_used ? 3 * D : 0) + (x0_used ? D : 0));
    const cudaStream_t st = (cudaStream_t)stream;
    void* args[] = {&a};
    switch (variant) {
        case 0: return coop_launch(grid_steps_coop<false, false, false, false>, S, LANES, smem, args, st);
        case 1: return coop_launch(grid_steps_coop<true, false, false, false>, S, LANES, smem, args, st);
        case 2: return coop_launch(grid_steps_coop<true, true, false, false>, S, LANES, smem, args, st);
        case 3: return coop_launch(grid_steps_coop<true, true, true, false>, S, LANES, smem, args, st);
        case 4: return coop_launch(grid_steps_coop<true, true, true, true>, S, LANES, smem, args, st);
        default: break;
    }
    cudaError_t e = cudaFuncSetAttribute((const void*)grid_steps_parallel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (variant == 5) {
        grid_steps_parallel<<<dim3(S, R), LANES, smem, st>>>(a, 0);
        return (int)cudaGetLastError();
    }
    for (int r = 0; r < R; ++r) {  // B, one launch per step
        grid_steps_parallel<<<dim3(S, 1), LANES, smem, st>>>(a, r);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// loop bodies (E7)

enum { W_COUNTER = 0, W_ANY_GRID, W_ANY_WARP, W_ANY_CTA, W_PRNG, W_BODY20 };

#define BODY20_D 20

// any(pred) over every thread of the grid.  flags (3,) int32, zeroed by the
// caller: iteration i votes into slot i % 3 and, after the barrier, one
// thread clears slot (i + 2) % 3, which every block has read (before this
// barrier) and none writes before the next one.
__device__ __forceinline__ bool grid_any(cg::grid_group& grid, bool pred, int* flags, int i) {
    if (__syncthreads_or(pred) && threadIdx.x == 0) atomicOr(&flags[i % 3], 1);
    grid.sync();
    const bool any = __ldcg(&flags[i % 3]) != 0;
    if (blockIdx.x == 0 && threadIdx.x == 0) flags[(i + 2) % 3] = 0;
    return any;
}

template <int VARIANT>
__global__ void while_loop_kernel(const float* __restrict__ x, const float* __restrict__ b20,
                                  float* __restrict__ out, int* __restrict__ flags, int n,
                                  int E) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    float acc = e < E ? x[e] : 0.0f;
    if constexpr (VARIANT == W_ANY_GRID) {
        cg::grid_group grid = cg::this_grid();
        for (int i = 0;; ++i) {  // the condition as prof_pallas_while.py:28-30 evaluates it
            const bool any = grid_any(grid, e < E && acc > -1e30f, flags, i);
            if (!(i < n && any)) break;
            acc = __fadd_rn(acc, 1.0f);
        }
    } else if constexpr (VARIANT == W_ANY_WARP || VARIANT == W_ANY_CTA) {
        for (int i = 0;; ++i) {
            const bool pred = e < E && acc > -1e30f;
            const bool any = VARIANT == W_ANY_WARP ? __any_sync(0xffffffffu, pred)
                                                   : __syncthreads_or(pred) != 0;
            if (!(i < n && any)) break;
            acc = __fadd_rn(acc, 1.0f);
        }
    } else if constexpr (VARIANT == W_PRNG) {
        const uint32_t h = mix32(7u, (uint32_t)e);
        for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, slice_uniform(h, (uint32_t)i));
    } else if constexpr (VARIANT == W_BODY20) {
        float b[BODY20_D];
#pragma unroll
        for (int d = 0; d < BODY20_D; ++d) b[d] = e < E ? b20[(size_t)d * E + e] : 0.0f;
        for (int i = 0; i < n; ++i) {
            const float step = __fmul_rn(0.001f, acc);
            float sum = 0.0f;
#pragma unroll
            for (int d = 0; d < BODY20_D; ++d) {
                const float dd = __fmul_rn(__fsub_rn(__fadd_rn(b[d], step), 0.5f), 10.0f);
                sum = d == 0 ? __fmul_rn(dd, dd) : __fadd_rn(sum, __fmul_rn(dd, dd));
            }
            const float logL = __fmul_rn(-0.5f, sum);
            acc = logL > -40.0f ? __fadd_rn(acc, 1.0f) : __fmul_rn(acc, 0.5f);
        }
    } else {
        for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, 1.0f);
    }
    if (e < E) out[e] = acc;
}

// variant: a W_* id; x and out (E,) float32 with E = S * 128; b20 (20, E)
// float32 for body20 (else null); flags (3,) int32 zeroed, for the grid
// form.  Returns a CUDA error code.
extern "C" int while_loop_launch(int variant, const void* x, const void* b20, void* out,
                                 void* flags, int n, int E, void* stream) {
    if (E < 1 || n < 0) return (int)cudaErrorInvalidValue;
    const int blocks = (E + LANES - 1) / LANES;
    const cudaStream_t st = (cudaStream_t)stream;
    const float* a_x = (const float*)x;
    const float* a_b = (const float*)b20;
    float* a_out = (float*)out;
    int* a_flags = (int*)flags;
    switch (variant) {
        case W_COUNTER: while_loop_kernel<W_COUNTER><<<blocks, LANES, 0, st>>>(a_x, a_b, a_out, a_flags, n, E); break;
        case W_ANY_WARP: while_loop_kernel<W_ANY_WARP><<<blocks, LANES, 0, st>>>(a_x, a_b, a_out, a_flags, n, E); break;
        case W_ANY_CTA: while_loop_kernel<W_ANY_CTA><<<blocks, LANES, 0, st>>>(a_x, a_b, a_out, a_flags, n, E); break;
        case W_PRNG: while_loop_kernel<W_PRNG><<<blocks, LANES, 0, st>>>(a_x, a_b, a_out, a_flags, n, E); break;
        case W_BODY20: while_loop_kernel<W_BODY20><<<blocks, LANES, 0, st>>>(a_x, a_b, a_out, a_flags, n, E); break;
        case W_ANY_GRID: {
            void* args[] = {&a_x, &a_b, &a_out, &a_flags, &n, &E};
            return coop_launch(while_loop_kernel<W_ANY_GRID>, blocks, LANES, 0, args, st);
        }
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
