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
// to 128 have a second kernel, gram_schmidt_wide_kernel: one basis per warp,
// lane l holding rows i = l + 32 m (m < R = ceil(dim / 32), a template
// parameter: 2, 3 or 4) of the working column in registers, the finished
// columns in shared memory.  Its order is classical CGS2 column by column —
// the long path's panel step below, on the whole basis
// (ops/pallas_dirs.py::_long_plain_panel): for column j each sweep first
// takes all j coefficients c_k = q_k . v against the same v (each lane's
// rows in order from +0, then a butterfly over offsets 16, 8, 4, 2, 1), then
// v -= sum_k c_k q_k summed over k in order from +0.  The first wide kernel
// took each coefficient against the v the previous update had left
// (modified Gram-Schmidt), so a basis was a chain of ~dim^2 dependent dot
// products, each a shared-memory load and five shuffle steps, with about
// one warp a scheduler to hide it: 0.535 ms at the 64-D run's (2, 64, 64,
// 256), 14.6 at (5, 64, 64, 8192) (PERF.md).  Here a sweep's coefficients
// are independent: gram_schmidt_wide.cuh reduces them KC at a time
// (gsw_reduce: at each butterfly offset a lane keeps half of its values
// and adds its partner's partial of each, KC - 1 shuffles for KC sums,
// each with its own butterfly's bits) and keeps the chunk's finished
// values in registers for the update, so a sweep reads the finished
// columns once; the last chunk of a sweep narrows to the power of two that
// holds it.  A column's critical path is two sweeps of chunked reductions
// and one j-long chain of adds a row; 0.107 ms at (2, 64, 64, 256), 5.04 at
// (5, 64, 64, 8192) (experiments/gs_wide_times.py).  The long path forced
// down to dim 33 measured 0.290 and 18.5 there: its panel steps are this
// chain again, in three panels a basis.
//
// A warp's shared memory holds its basis (dim columns of 32 R values, the
// rows past dim +0 once a column is finished; 64 KB at dim 128 in float32)
// and two buffers of KC coefficients.  A block holds nw bases of
// consecutive chains (gsw_choose weighs the shared memory, the resident
// warps and the SMs reached), copied in by cp.async before its warps start
// and out after they finish, so that each copy of an entry (i, j) covers a
// run of nw chains of the (n_bases, dim, dim, B) layout instead of a
// sector a value (one base a block measured 1.2-1.6x slower at dim 64).

// Above dim 128 (gram_schmidt_long_kernel) a basis no longer fits one warp's
// registers, and the warp-per-basis order — ~2 dim^2 dependent dot
// products, each a chain of shared-memory loads and shuffles — left one or
// two warps an SM with nothing to overlap (that kernel took 43.53 ms at
// (2, 160, 160, 512) and 2,475 ms at dim 512, slower than one batched
// torch.linalg.qr from dim 256 up; PERF.md).  So the long kernel is
// blocked: the JAX package's XLA path (polychordlite_tpu/ops/directions.py::
// _gram_schmidt) in its reorthogonalised form, BCGS2 (Barlow and
// Smoktunowicz), in panels of GSL_P = 32 columns.  The panel of columns
// j0 .. j0 + 31 (V, dim x 32) against the finished columns Q = q_0 ..
// q_{j0 - 1} takes two passes (one at j0 = 0) of
//   C = Q^T V  (C[k][jj] summed over the rows i in index order 0 .. dim-1)
//   V = V - U, U = Q C  (U[i][jj] summed over k in index order 0 .. j0-1)
// and then each column of the panel in turn: two sweeps of CGS2 against the
// panel's earlier columns (their coefficients as the wide kernel sums a
// dot product: each lane its rows i = lane + 32 m in order,
// then the butterfly; the update summed over those columns in order), the
// norm in the same order, q = v / max(sqrt(norm), 1e-30).  The XLA path's
// order — both sweeps against Q, then the panel once — loses orthogonality
// on an ill-conditioned basis: a column that the panel step shrinks by s
// grows its error along Q by 1 / s; the second pass takes that error out
// (tests/test_torch_gram_schmidt_long.py holds both orders to it).
// The two products are the ~4 dim^3 operations a basis that chip_smoke.py
// counts (the panel steps add ~8 dim^2 P more, 2 P / dim of it: 40 % at
// dim 160, 12.5 % at 512, in chains of 32 columns), and their outputs are
// independent sums, so a thread holds a 4 x 4 tile of them in registers:
// sixteen independent chains of adds in one thread instead of one chain a
// warp.
// Each sum keeps its one fixed order, so the plain version
// (ops/pallas_dirs.py::_gram_schmidt_long_plain) repeats the kernel bit
// for bit: the file stays --fmad=false with rounded.cuh's rn_mul and
// rn_add, which caps the kernel at half of the FFMA rate that
// chip_smoke.py's bound assumes (a multiply and an add issue apart: 33.5
// TFLOP/s of them in float32, 17 in float64).  No tensor cores: a TF32
// product keeps ~10 bits of each factor, which undoes what the second
// pass exists for, and no plain version repeats an mma's order of
// summation.  P = 32: a panel is one warp wide, and a 64-column pass of
// the coefficient product reads Q once for 32 columns of V (16 operations
// a byte of Q); a wider panel would lengthen the panel steps' chains.
//
// Where the time goes (experiments/gs_long_parts.py, PERF.md): at (2, 160,
// 160, 512) the kernel takes 3.24 ms, the two products alone 1.05 and the
// panel steps alone 1.71; at dim 512 51.0, 30.9 and 18.8.  The panel steps
// are bound by shared-memory traffic and latency, not by their operations:
// each column reads the panel's earlier columns twice a sweep, one value
// per multiply-add.  They run on a copy of the panel in the block's shared
// memory (where the ring's stages were; up to dim 768 in float32, 384 in
// float64, past that in the scratch), which measured 3.24 ms against 3.81
// in the scratch at dim 160; a row-major copy with 16-byte loads of four
// columns measured slower, and so did the kernel capped at 128 registers
// at the 160-D run's (5, 160, 160, 256), where its 20 warps an SM (96
// registers, a 44-byte spill) finish the 1,280 bases in fewer waves.
//
// Where the finished columns live: a basis's dim^2 values pass a block's
// 227 KB above dim ~230 in float32, and the panel, C and Q together far
// below that, so every basis lives in a basis-major scratch in device
// memory and the products stream through the block's shared memory in a
// ring of two stages filled by cp.async (the alternative, a thread-block
// cluster holding Q in distributed shared memory, would hold dim <= ~660
// and needs a fixed block order to combine partial sums, while streaming
// serves every dim to GS_MAXD_LONG with one code path and a ring of 27.8
// KB a block in float32, 52 KB in float64, so several bases share an SM;
// past dim 192 the panel steps' copy, below, takes more).  Each stage is
// filled by all the block's threads and consumed after one block barrier
// (cp.async.wait_group), so no mbarrier is needed.  Q is read once a pass:
// each 64-column pass of C = Q^T V streams its columns of Q and the panel
// in 32-row tiles, each 64-row pass of the update streams Q's rows and C
// in 32-column tiles.
//
// Layout: the interface keeps the JAX package's (n_bases, dim, dim, B)
// with the chain axis minor, where one basis's values lie B apart.  So a
// transpose kernel (gsl_to_columns, 32 x 32 tiles through shared memory,
// coalesced on both sides) first writes every basis column-major into the
// scratch — basis n = nb B + b, column j, row i at (n dim + j) ld + i, ld
// = dim rounded up to 32, the pad rows zero — and gsl_from_columns writes
// the result back: two memory-bound passes of ~2 x the input's bytes.  The
// coefficients C of each basis (ld x 32) follow in the same scratch:
// gram_schmidt_scratch_values = n_bases B ld (dim + 32) values.  One
// launch of the long path is these three kernels.  Its shared memory grows
// with dim only through the panel's copy, which stops at GSL_PANEL_SMEM;
// GS_MAXD_LONG stays where the earlier design's working column in shared
// memory put it (the scratch, 3.4 GB a basis there in float32, bounds dim
// long before).

// Double: a run at precision='highest' draws its directions in
// float64, so both kernels are templates on the scalar type T, the float
// instantiations the code above.  In double, a block of the
// thread-per-basis kernel needs 8 * dim^2 * 32 bytes of shared memory,
// past the 227 KB a block may have above dim 30; there the block holds 16
// chains (gs_lanes: half a warp, 128 KB at dim 32).  Its v[DIM] and qv[DIM]
// take twice the registers.  The wide kernel's basis takes 8 * dim * 32 R
// bytes, 128 KB at dim 128: one basis an SM there.  The sums keep their
// order, so each double kernel is bitwise gram_schmidt_plain in float64.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <type_traits>
#include <utility>

#include "gram_schmidt_wide.cuh"
#include "rounded.cuh"

#define GS_MAXD 32
#define GS_MAXD_WIDE 128
// the shared memory a block may have (bytes)
#define GS_SMEM_MAX 232448
// the largest dim of the long path: where the earlier long kernel's working
// column filled a block's shared memory in float64 (see the top of the file)
#define GS_MAXD_LONG (GS_SMEM_MAX / 8)

// The chains of a block of the thread-per-basis kernel: 32, or 16 where a
// block of 32 would need more shared memory than a block may have (double
// above dim 30).
template <class T>
constexpr int gs_lanes(int dim) {
    return (int)sizeof(T) * dim * dim * 32 <= GS_SMEM_MAX ? 32 : 16;
}

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

// One cp.async of a value of T (4 or 8 bytes) into shared memory.
template <class T>
__device__ __forceinline__ void gsw_cp(T* dst, const T* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (sizeof(T) == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// GS_MAXD < dim <= GS_MAXD_WIDE, R = ceil(dim / 32): the bases of chains
// b0 .. b0 + nw - 1 of blockIdx.y (nw = blockDim.x / 32, b0 = blockIdx.x nw),
// warp w on chain b0 + w, its values at w * stride in shared memory (stride
// from gsw_stride).  The block's threads copy every basis in by cp.async —
// entry (i, j) of the nw chains from nw consecutive values, one entry a
// thread, rows i consecutive across a warp — and out the same way.
template <class T, int R>
__global__ void gram_schmidt_wide_kernel(const T* __restrict__ g, T* __restrict__ q, int dim,
                                         int B, int stride) {
    constexpr int P = GsWide<T, R>::P;
    extern __shared__ __align__(16) unsigned char gs_smem[];
    T* sm = reinterpret_cast<T*>(gs_smem);
    const int nw = blockDim.x / 32, b0 = blockIdx.x * nw, here = min(nw, B - b0);
    const size_t base = (size_t)blockIdx.y * dim * dim * B + b0;
    const int w = threadIdx.x % nw, r = threadIdx.x / nw;  // chain b0 + w, rows r + 32 m
    T* sw = sm + w * stride;
    if (w < here)
        for (int j = 0; j < dim; ++j)
#pragma unroll
            for (int m = 0; m < R; ++m) {
                const int i = r + 32 * m;
                if (i < dim) gsw_cp(sw + j * P + i, g + base + ((size_t)i * dim + j) * B + w);
            }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int warp = threadIdx.x / 32;
    if (warp < here) gsw_basis<T, R>(sm + warp * stride, dim, threadIdx.x % 32);
    __syncthreads();
    if (w < here)
        for (int j = 0; j < dim; ++j)
#pragma unroll
            for (int m = 0; m < R; ++m) {
                const int i = r + 32 * m;
                if (i < dim) q[base + ((size_t)i * dim + j) * B + w] = sw[j * P + i];
            }
}

// ---- the long kernel: dim > GS_MAXD_WIDE (see the top of the file) ----
#define GSL_THREADS 128  // four warps a basis
#define GSL_P 32         // columns of a panel
#define GSL_TI 32        // rows of a staged tile of C = Q^T V
#define GSL_KB 64        // finished columns a pass of C = Q^T V
#define GSL_RB 64        // rows a pass of the update V -= Q C
#define GSL_KC 32        // finished columns of a staged tile of the update

// The staged tiles of the long kernel's ring, in T: two stages.  A staged column is
// padded by 16 bytes, so that the eight columns a quarter-warp reads lie in
// eight different groups of four banks.
template <class T>
struct GsLong {
    static constexpr int VEC = 16 / (int)sizeof(T);  // values a 16-byte copy
    static constexpr int S1 = GSL_TI + VEC;          // a staged column of C = Q^T V
    static constexpr int S2 = GSL_RB + VEC;          // a staged column of Q in the update
    static constexpr int SC = GSL_P + VEC;           // a staged row of C in the update
    static constexpr int STAGE1 = (GSL_KB + GSL_P) * S1;
    static constexpr int STAGE2 = GSL_KC * (S2 + SC);
    static constexpr int STAGE = STAGE1 > STAGE2 ? STAGE1 : STAGE2;
};

// One 16-byte cp.async into shared memory, zero-filled where !valid.
__device__ __forceinline__ void gsl_cp16(void* dst, const void* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void gsl_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every copy but the newest group has landed
__device__ __forceinline__ void gsl_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One staged tile of C = Q^T V: the thread's C[kslot + 16 a][jslot + 8 b]
// (a < NA, b < 4) over the tile's `rows` rows in order.
template <class T, int NA>
__device__ __forceinline__ void gsl_coef_tile(const T* qs, const T* vs, int rows, int kslot,
                                              int jslot, T (&acc)[4][4]) {
    using L = GsLong<T>;
    int r = 0;
    for (; r + 4 <= rows; r += 4) {
        T q[NA][4], v[4][4];
#pragma unroll
        for (int a = 0; a < NA; ++a) ld4(qs + (kslot + 16 * a) * L::S1 + r, q[a]);
#pragma unroll
        for (int b = 0; b < 4; ++b) ld4(vs + (jslot + 8 * b) * L::S1 + r, v[b]);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int a = 0; a < NA; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) acc[a][b] = rn_add(acc[a][b], rn_mul(q[a][x], v[b][x]));
    }
    for (; r < rows; ++r)
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
                acc[a][b] = rn_add(acc[a][b], rn_mul(qs[(kslot + 16 * a) * L::S1 + r],
                                                     vs[(jslot + 8 * b) * L::S1 + r]));
}

// C = Q^T V for the panel at j0 (pe columns) against its j0 finished
// columns, written to cb[k][jj]: passes of GSL_KB columns of Q, each over
// the rows in GSL_TI-row tiles streamed through the ring.
template <class T>
__device__ void gsl_coefficients(const T* wb, T* cb, T* ring, int dim, int ld, int j0, int pe) {
    using L = GsLong<T>;
    constexpr int CPC = GSL_TI / L::VEC;  // copies a staged column
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // a quarter-warp reads eight consecutive columns of Q and one of V
    const int kslot = (warp & 1) * 8 + (lane & 7), jslot = (warp >> 1) * 4 + (lane >> 3);
    const int n_tiles = (dim + GSL_TI - 1) / GSL_TI;
    for (int kb = 0; kb < j0; kb += GSL_KB) {
        const int kn = min(GSL_KB, j0 - kb);  // 32 or 64
        auto stage = [&](int t) {
            T* qs = ring + (t & 1) * L::STAGE;
            T* vs = qs + GSL_KB * L::S1;
            const int i0 = t * GSL_TI;
            for (int c = tid; c < (kn + GSL_P) * CPC; c += GSL_THREADS) {
                const int col = c / CPC, off = (c % CPC) * L::VEC, i = i0 + off;
                const bool of_q = col < kn;
                const int jj = col - kn;
                const bool ok = i < dim && (of_q || jj < pe);
                const T* src = wb + (size_t)(of_q ? kb + col : j0 + jj) * ld + i;
                gsl_cp16((of_q ? qs + col * L::S1 : vs + jj * L::S1) + off, ok ? src : wb, ok);
            }
            gsl_commit();
        };
        T acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = T(0);
        stage(0);
        for (int t = 0; t < n_tiles; ++t) {
            if (t + 1 < n_tiles)
                stage(t + 1);
            else
                gsl_commit();
            gsl_wait_one();
            __syncthreads();
            const T* qs = ring + (t & 1) * L::STAGE;
            const int rows = min(GSL_TI, dim - t * GSL_TI);
            if (kn == GSL_KB)
                gsl_coef_tile<T, 4>(qs, qs + GSL_KB * L::S1, rows, kslot, jslot, acc);
            else
                gsl_coef_tile<T, 2>(qs, qs + GSL_KB * L::S1, rows, kslot, jslot, acc);
            __syncthreads();  // the stage is read before the next fill
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
            if (16 * a < kn)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    cb[(size_t)(kb + kslot + 16 * a) * GSL_P + jslot + 8 * b] = acc[a][b];
    }
    __threadfence_block();
    __syncthreads();  // C is whole before the update reads it
}

// V -= Q C for the panel at j0: passes of GSL_RB rows, each summing
// U[i][jj] over the finished columns k in order, streamed in GSL_KC-column
// tiles of Q and C; then V[i][jj] = V[i][jj] - U[i][jj] in the scratch.
template <class T>
__device__ void gsl_update(T* wb, const T* cb, T* ring, int dim, int ld, int j0, int pe) {
    using L = GsLong<T>;
    constexpr int CPQ = GSL_RB / L::VEC, CPR = GSL_P / L::VEC;  // copies a column, a row
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int roff = warp * 16 + (lane & 3) * 4, jq = (lane >> 2) * 4;  // 4 rows x 4 columns
    const int n_tiles = j0 / GSL_KC;
    for (int r0 = 0; r0 < dim; r0 += GSL_RB) {
        auto stage = [&](int t) {
            T* qs = ring + (t & 1) * L::STAGE;
            T* cs = qs + GSL_KC * L::S2;
            const int k0 = t * GSL_KC;
            for (int c = tid; c < GSL_KC * CPQ; c += GSL_THREADS) {
                const int kk = c / CPQ, off = (c % CPQ) * L::VEC, i = r0 + off;
                const bool ok = i < dim;
                gsl_cp16(qs + kk * L::S2 + off, ok ? wb + (size_t)(k0 + kk) * ld + i : wb, ok);
            }
            for (int c = tid; c < GSL_KC * CPR; c += GSL_THREADS) {
                const int kk = c / CPR, off = (c % CPR) * L::VEC;
                gsl_cp16(cs + kk * L::SC + off, cb + (size_t)(k0 + kk) * GSL_P + off, true);
            }
            gsl_commit();
        };
        T acc[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[x][b] = T(0);
        stage(0);
        for (int t = 0; t < n_tiles; ++t) {
            if (t + 1 < n_tiles)
                stage(t + 1);
            else
                gsl_commit();
            gsl_wait_one();
            __syncthreads();
            const T* qs = ring + (t & 1) * L::STAGE;
            const T* cs = qs + GSL_KC * L::S2;
            if (r0 + warp * 16 < dim) {  // the warp has rows in this pass
#pragma unroll 4
                for (int kk = 0; kk < GSL_KC; ++kk) {
                    T q[4], c[4];
                    ld4(qs + kk * L::S2 + roff, q);
                    ld4(cs + kk * L::SC + jq, c);
#pragma unroll
                    for (int x = 0; x < 4; ++x)
#pragma unroll
                        for (int b = 0; b < 4; ++b)
                            acc[x][b] = rn_add(acc[x][b], rn_mul(q[x], c[b]));
                }
            }
            __syncthreads();  // the stage is read before the next fill
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int i = r0 + roff + x;
            if (i < dim)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (jq + b < pe) {
                        T* p = wb + (size_t)(j0 + jq + b) * ld + i;
                        *p = rn_sub(*p, acc[x][b]);
                    }
        }
    }
    __threadfence_block();
    __syncthreads();  // the panel is updated before it is read again
}

// The butterfly over the warp (gsw_reduce of one value): every lane ends
// with the sum.
template <class T>
__device__ __forceinline__ T gsl_butterfly(T c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c = rn_add(c, __shfl_xor_sync(0xffffffffu, c, off));
    return c;
}

// The panel's own CGS2, column by column, on `panel` (its columns ld
// apart): against its earlier columns t < jj, each coefficient a warp's dot
// product (warp w takes t = w + 4 a, four at a time), the update summed
// over t in order by a thread a row; then the norm and the division by
// warp 0.  cs (16-byte aligned shared memory) holds the coefficients.
template <class T>
__device__ __forceinline__ void gsl_panel_columns(T* panel, T* cs, int dim, int ld, int pe) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    for (int jj = 0; jj < pe; ++jj) {
        T* v = panel + (size_t)jj * ld;
        for (int sweep = 0; jj > 0 && sweep < 2; ++sweep) {
            // t = t0 + 4 x (x < 4): those past jj are computed on column t0
            // and dropped
            for (int t0 = warp; t0 < jj; t0 += 16) {
                const T* p[4];
#pragma unroll
                for (int x = 0; x < 4; ++x)
                    p[x] = panel + (size_t)(t0 + 4 * x < jj ? t0 + 4 * x : t0) * ld;
                T a[4] = {T(0), T(0), T(0), T(0)};
                for (int i = lane; i < dim; i += 32) {
                    const T vi = v[i];
#pragma unroll
                    for (int x = 0; x < 4; ++x) a[x] = rn_add(a[x], rn_mul(p[x][i], vi));
                }
#pragma unroll
                for (int x = 0; x < 4; ++x)
                    if (t0 + 4 * x < jj) {  // uniform over the warp
                        const T c = gsl_butterfly(a[x]);
                        if (lane == 0) cs[t0 + 4 * x] = c;
                    }
            }
            __syncthreads();
            for (int i = tid; i < dim; i += GSL_THREADS) {
                T u = T(0);
                int t = 0;
                for (; t + 4 <= jj; t += 4) {
                    T c[4];
                    ld4(cs + t, c);
#pragma unroll
                    for (int x = 0; x < 4; ++x)
                        u = rn_add(u, rn_mul(panel[(size_t)(t + x) * ld + i], c[x]));
                }
                for (; t < jj; ++t) u = rn_add(u, rn_mul(panel[(size_t)t * ld + i], cs[t]));
                v[i] = rn_sub(v[i], u);
            }
            __syncthreads();
        }
        if (warp == 0) {  // the norm and the division, in one warp: no barrier between
            T nrm = T(0);
            for (int i = lane; i < dim; i += 32) nrm = rn_add(nrm, rn_mul(v[i], v[i]));
            const T den = gs_den(gsl_butterfly(nrm));
            for (int i = lane; i < dim; i += 32) v[i] = rn_div(v[i], den);
        }
        __syncthreads();
    }
}

// The panel step at j0: its pe columns staged into shared memory at `ps`
// where they fit (panel_in_smem; the loads and stores above then compile to
// shared-memory ones), else worked on in the scratch.
template <class T>
__device__ void gsl_panel(T* wb, T* ps, T* cs, int dim, int ld, int j0, int pe,
                          bool panel_in_smem) {
    using L = GsLong<T>;
    T* g = wb + (size_t)j0 * ld;
    if (!panel_in_smem) {
        gsl_panel_columns<T>(g, cs, dim, ld, pe);
        return;
    }
    const int n16 = pe * ld / L::VEC;  // 16-byte pieces of the panel
    for (int c = threadIdx.x; c < n16; c += GSL_THREADS)
        reinterpret_cast<uint4*>(ps)[c] = reinterpret_cast<const uint4*>(g)[c];
    __syncthreads();
    gsl_panel_columns<T>(ps, cs, dim, ld, pe);
    for (int c = threadIdx.x; c < n16; c += GSL_THREADS)
        reinterpret_cast<uint4*>(g)[c] = reinterpret_cast<const uint4*>(ps)[c];
    __threadfence_block();
    __syncthreads();
}

// The shared memory of the long kernel at `dim` (bytes): the ring, or the
// panel where it is staged there (the two are never used at once), then the
// coefficients.
template <class T>
static int gsl_smem(int dim, bool panel_in_smem) {
    using L = GsLong<T>;
    const long long ring = 2LL * L::STAGE, panel = (dim + 31LL) / 32 * 32 * GSL_P;
    const long long body = panel_in_smem && panel > ring ? panel : ring;
    return (int)((body + GSL_P + L::VEC) * (long long)sizeof(T));
}

// Whether the panel steps run in shared memory at `dim`: while the panel
// takes at most GSL_PANEL_SMEM bytes (dim 768 in float32, 384 in float64).
#define GSL_PANEL_SMEM (96 * 1024)
template <class T>
static bool gsl_panel_in_smem(int dim) {
    return (dim + 31LL) / 32 * 32 * GSL_P * (long long)sizeof(T) <= GSL_PANEL_SMEM;
}

// One basis a block (blockIdx.x = nb B + b): its columns at w + n dim ld,
// its coefficients at cg + n ld GSL_P, both in the scratch.  No pointer here
// is __restrict__: the kernel reads what it wrote, and a read-only load
// would not see it.
template <class T>
__global__ void __launch_bounds__(GSL_THREADS)
    gram_schmidt_long_kernel(T* w, T* cg, int dim, int ld, int panel_in_smem, int cs_at) {
    extern __shared__ __align__(16) unsigned char gs_smem[];
    T* ring = reinterpret_cast<T*>(gs_smem);
    T* cs = ring + cs_at;
    T* wb = w + (size_t)blockIdx.x * dim * ld;
    T* cb = cg + (size_t)blockIdx.x * ld * GSL_P;
    for (int j0 = 0; j0 < dim; j0 += GSL_P) {
        const int pe = min(GSL_P, dim - j0);
        for (int pass = 0; pass < (j0 > 0 ? 2 : 1); ++pass) {
            if (j0 > 0) {
                gsl_coefficients<T>(wb, cb, ring, dim, ld, j0, pe);
                gsl_update<T>(wb, cb, ring, dim, ld, j0, pe);
            }
            gsl_panel<T>(wb, ring, cs, dim, ld, j0, pe, panel_in_smem != 0);
        }
    }
}

// (n_bases, dim, dim, B) -> the scratch, column-major by basis (rows dim ..
// ld - 1 zero): for each (nb, j) a (rows i, chains b) matrix transposed in
// 32 x 32 tiles.  Grid (n_bases b_tiles, ld / 32, dim), block (32, 8).
template <class T>
__global__ void gsl_to_columns(const T* __restrict__ g, T* __restrict__ w, int dim, int ld, int B,
                               int b_tiles) {
    __shared__ T tile[32][33];
    const int nb = blockIdx.x / b_tiles, b0 = (blockIdx.x % b_tiles) * 32;
    const int i0 = blockIdx.y * 32, j = blockIdx.z, tx = threadIdx.x;
    for (int r = threadIdx.y; r < 32; r += 8) {
        const int i = i0 + r, b = b0 + tx;
        tile[r][tx] = i < dim && b < B ? g[(((size_t)nb * dim + i) * dim + j) * B + b] : T(0);
    }
    __syncthreads();
    for (int r = threadIdx.y; r < 32; r += 8) {
        const int b = b0 + r;
        if (b < B) w[(((size_t)nb * B + b) * dim + j) * ld + i0 + tx] = tile[tx][r];
    }
}

// The scratch -> (n_bases, dim, dim, B).  Grid (n_bases b_tiles,
// ceil(dim / 32), dim), block (32, 8).
template <class T>
__global__ void gsl_from_columns(const T* __restrict__ w, T* __restrict__ q, int dim, int ld,
                                 int B, int b_tiles) {
    __shared__ T tile[32][33];
    const int nb = blockIdx.x / b_tiles, b0 = (blockIdx.x % b_tiles) * 32;
    const int i0 = blockIdx.y * 32, j = blockIdx.z, tx = threadIdx.x;
    for (int r = threadIdx.y; r < 32; r += 8) {
        const int b = b0 + r, i = i0 + tx;
        tile[r][tx] = b < B && i < dim ? w[(((size_t)nb * B + b) * dim + j) * ld + i] : T(0);
    }
    __syncthreads();
    for (int r = threadIdx.y; r < 32; r += 8) {
        const int i = i0 + r, b = b0 + tx;
        if (i < dim && b < B) q[(((size_t)nb * dim + i) * dim + j) * B + b] = tile[tx][r];
    }
}

// The long path's column stride in the scratch: dim rounded up to 32.
static long long gsl_ld(int dim) { return (dim + 31LL) / 32 * 32; }

// The three kernels of one launch of the long path, on `stream`.
template <class T>
static int gram_schmidt_long(const T* g, T* q, T* scratch, int n_bases, int dim, int B,
                             cudaStream_t stream) {
    using L = GsLong<T>;
    const long long n = (long long)n_bases * B;
    if (scratch == nullptr || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int ld = (int)gsl_ld(dim), b_tiles = (B + 31) / 32;
    T* w = scratch;
    T* cg = scratch + (size_t)n * dim * ld;
    gsl_to_columns<T><<<dim3(n_bases * b_tiles, ld / 32, dim), dim3(32, 8), 0, stream>>>(
        g, w, dim, ld, B, b_tiles);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const bool in_smem = gsl_panel_in_smem<T>(dim);
    const int smem = gsl_smem<T>(dim, in_smem);
    const int cs_at = smem / (int)sizeof(T) - GSL_P - L::VEC;
    // set at every launch: the largest size it allows depends on dim
    e = cudaFuncSetAttribute((const void*)gram_schmidt_long_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    gram_schmidt_long_kernel<T><<<(unsigned)n, GSL_THREADS, smem, stream>>>(w, cg, dim, ld,
                                                                           in_smem, cs_at);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gsl_from_columns<T><<<dim3(n_bases * b_tiles, (dim + 31) / 32, dim), dim3(32, 8), 0, stream>>>(
        w, q, dim, ld, B, b_tiles);
    return (int)cudaGetLastError();
}

// The wide kernel's values a warp: its dim columns of P rows and 2 KC
// coefficients, rounded up to 32 values, then (nw > 1) an offset that puts
// the areas of a block's nw warps in different banks for the copies in and
// out (a warp-wide copy: nw chains x 32 / nw rows of one column).
template <class T, int R>
static int gsw_stride(int dim, int nw) {
    const int body = (dim * GsWide<T, R>::P + 2 * GsWide<T, R>::KC + 31) / 32 * 32;
    return body + (nw > 1 ? 128 / (int)sizeof(T) / nw : 0);
}

// The bases a block (nw, a power of two) of the wide kernel at (n_bases,
// dim, B), and its blocks resident on an SM.  More bases a block make each
// copy in or out one contiguous run of nw chains instead of a sector a
// value; but a block's shared memory grows with nw, and fewer blocks may
// leave SMs idle.  So each nw that fits is scored by the warps it keeps busy
// on an SM: its resident warps, at most the chains' even share of an SM,
// times the share of SMs its blocks reach; the largest nw within 15 % of
// the best score is taken.
template <class T, int R>
static cudaError_t gsw_choose(int n_bases, int dim, int B, int* nw_out, int* blocks_out) {
    cudaError_t e = cudaFuncSetAttribute((const void*)gram_schmidt_wide_kernel<T, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GS_SMEM_MAX);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute((const void*)gram_schmidt_wide_kernel<T, R>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    int dev = 0, n_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const double share = std::ceil((double)n_bases * B / n_sm);
    double score[4] = {0, 0, 0, 0}, best = 0;
    int blocks[4] = {0, 0, 0, 0};
    for (int x = 0; x < 4; ++x) {  // nw = 1, 2, 4, 8
        const int nw = 1 << x, smem = nw * gsw_stride<T, R>(dim, nw) * (int)sizeof(T);
        if (smem > GS_SMEM_MAX) break;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks[x], gram_schmidt_wide_kernel<T, R>, 32 * nw, smem);
        if (e != cudaSuccess) return e;
        const double reach = std::min(1.0, (double)n_bases * ((B + nw - 1) / nw) / n_sm);
        score[x] = std::min((double)(nw * blocks[x]), share) * reach;
        best = std::max(best, score[x]);
    }
    int x = 3;
    while (x > 0 && !(blocks[x] > 0 && score[x] >= 0.85 * best)) --x;
    *nw_out = 1 << x;
    *blocks_out = blocks[x];
    return cudaSuccess;
}

template <class T, int R>
static int gsw_launch(const T* g, T* q, int n_bases, int dim, int B, cudaStream_t stream) {
    int nw = 0, blocks = 0;
    const cudaError_t e = gsw_choose<T, R>(n_bases, dim, B, &nw, &blocks);
    if (e != cudaSuccess) return (int)e;
    const int stride = gsw_stride<T, R>(dim, nw);
    gram_schmidt_wide_kernel<T, R><<<dim3((B + nw - 1) / nw, n_bases), 32 * nw,
                                     nw * stride * (int)sizeof(T), stream>>>(g, q, dim, B, stride);
    return (int)cudaGetLastError();
}

// f(std::integral_constant<int, R>) at the rows a lane of `dim`, R = 2, 3, 4.
template <class F>
static int gsw_by_rows(int dim, F f) {
    switch ((dim + 31) / 32) {
        case 2: return f(std::integral_constant<int, 2>{});
        case 3: return f(std::integral_constant<int, 3>{});
        default: return f(std::integral_constant<int, 4>{});
    }
}

template <class T>
static int gram_schmidt_wide(const T* g, T* q, int n_bases, int dim, int B,
                             cudaStream_t stream) {
    return gsw_by_rows(dim, [&](auto r) {
        return gsw_launch<T, decltype(r)::value>(g, q, n_bases, dim, B, stream);
    });
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

// The warps of the long kernel resident on one SM at `dim` in a type of
// `bytes` bytes (its blocks by cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at the shared memory of that dim, four warps each), or minus a CUDA error.
template <class T>
static int gsl_resident_warps(int dim) {
    const int smem = gsl_smem<T>(dim, gsl_panel_in_smem<T>(dim));
    int blocks = 0;
    cudaError_t e = cudaFuncSetAttribute((const void*)gram_schmidt_long_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gram_schmidt_long_kernel<T>,
                                                          GSL_THREADS, smem);
    return e == cudaSuccess ? blocks * GSL_THREADS / 32 : -(int)e;
}

extern "C" int gram_schmidt_long_resident_warps(int dim, int bytes) {
    return bytes == 8 ? gsl_resident_warps<double>(dim) : gsl_resident_warps<float>(dim);
}

// The bases a block of the wide kernel takes at a launch of (n_bases, dim,
// B) in a type of `bytes` bytes (gsw_choose), times 100, plus its resident
// blocks an SM; or minus a CUDA error; 0 outside 32 < dim <= 128.
template <class T>
static int gsw_report(int n_bases, int dim, int B) {
    if (dim <= GS_MAXD || dim > GS_MAXD_WIDE) return 0;
    return gsw_by_rows(dim, [&](auto r) {
        int nw = 0, blocks = 0;
        const cudaError_t e = gsw_choose<T, decltype(r)::value>(n_bases, dim, B, &nw, &blocks);
        return e == cudaSuccess ? 100 * nw + blocks : -(int)e;
    });
}

extern "C" int gram_schmidt_wide_blocks(int n_bases, int dim, int B, int bytes) {
    return bytes == 8 ? gsw_report<double>(n_bases, dim, B) : gsw_report<float>(n_bases, dim, B);
}

// The values of the scratch buffer a launch at (n_bases, dim, B) needs: the
// long path's bases, column-major with the column stride ld = dim rounded
// up to 32, and their coefficients, ld x 32 each (0 at dim <= 128; the
// same count in either type, `bytes` kept for the interface).
extern "C" long long gram_schmidt_scratch_values(int n_bases, int dim, int B, int bytes) {
    (void)bytes;
    if (dim <= GS_MAXD_WIDE) return 0;
    return (long long)n_bases * B * gsl_ld(dim) * (dim + GSL_P);
}

// g, q: (n_bases, dim, dim, B) float32, contiguous, on the device: the
// thread-per-basis kernel for dim <= GS_MAXD, the wide kernel up to
// GS_MAXD_WIDE, the long path above (three kernels on the stream); scratch:
// a device array of gram_schmidt_scratch_values(n_bases, dim, B, 4) float32
// (null when 0).
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
