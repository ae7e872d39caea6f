// Device functions of the fused route's generated likelihood functors
// (ops/fused_like.py writes one per model graph into fused_like.cuh;
// slice_epoch_fused.cu includes this file after slice_epoch.cuh).
//
// Each function is a fixed sequence of rounded float operations that
// fused_like.py's plain version repeats in torch, step for step, so that the
// kernel and its plain version agree bit for bit:
//   fused_max, fused_min   maximum and minimum that return a NaN operand
//                          (torch.maximum's rule), and on a tie the second;
//   fused_erfinv           Giles's single-precision approximation ("Approximating
//                          the erfinv function", GPU Computing Gems, 2011: a
//                          polynomial in w = -log((1 - x)(1 + x)), one for
//                          w < 5 and one in sqrt(w) beyond), +-inf at +-1;
//   fused_ndtri            the standard normal quantile: Giles's polynomial at
//                          x = 2p - 1 (w from 2p (2 - 2p)) times sqrt 2 in the
//                          centre, and in each tail (p or 1 - p below 0.02425)
//                          Acklam's rational function of sqrt(-2 log p), which
//                          holds down to the smallest float32 p (Giles's tail
//                          polynomial is fitted only as far as float32's
//                          largest x below 1 reaches).
// tests/test_torch_fused.py holds both, evaluated in float32, within 5e-7
// relative of float64 over float32's range.
// sinf, cosf and powf are kept out of line, as likelihoods.cuh keeps cosf:
// the unrolled loops over coordinates would copy their range reduction.
//
// The file includes nothing: it is also compiled as host C++ by the CPU
// tests (tests/test_torch_fused.py), with the intrinsics mapped to plain
// float operations.
//
// A data loop of a generated functor (ops/fused_like.py: a sum or a max
// over data rows) folds its rows as 32 virtual lanes, row r on virtual lane
// r mod 32, each from the fold's identity in row order, then a butterfly of
// the 32 (the lane order of likelihoods.cuh::fold).  The L lanes that hold
// a chain's evaluation (FUSED_ROW_LANES: the chain's G, or 1 where every
// lane runs every row) split the virtual lanes: lane g runs g, g + L, ...
// (fused_row_lane), and FusedRowFold joins them, the butterfly's steps
// m >= L within the lane and m < L by shuffles, then hands every lane lane
// 0's value.  So the order, and the plain version (fused_like.row_fold), do
// not depend on L.  Every lane runs the same trip count, a row past the end
// computing row 0 unfolded: with each lane leaving the row loop after its
// own last row, fitting's functor (ini/fitting.ini) at G = 32 gives wrong
// sums on an H100, with 8-byte or 32-bit float64 loads and with a
// __syncwarp() before the fold's shuffles, while the same loop with each
// slot index and row checked against its range finds none outside and is
// bitwise (PERF.md section 6; the cause is not found).  The int
// overloads of fused_max and fused_min clamp searchsorted's indices.
//
// A functor generated at precision='highest' is double: fused_max and
// fused_min have double overloads, and sin, cos and pow double forms kept
// out of line (fused_sin, fused_cos, fused_pow).  erfinv and ndtri have no
// double sequence: the lowering refuses them at float64 (the traced route
// evaluates them in torch).
#pragma once

__device__ __forceinline__ float fused_max(float a, float b) {
    return a != a ? a : (b != b ? b : (a > b ? a : b));
}

__device__ __forceinline__ float fused_min(float a, float b) {
    return a != a ? a : (b != b ? b : (a < b ? a : b));
}

__device__ __forceinline__ double fused_max(double a, double b) {
    return a != a ? a : (b != b ? b : (a > b ? a : b));
}

__device__ __forceinline__ double fused_min(double a, double b) {
    return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// A float64 slot of a float32 lowering's buffer: its two words from word
// `at` (low word first; `at` is even and the buffer 8-byte aligned, so one
// 8-byte load).
__device__ __forceinline__ double fused_f64(const float* c, int at) {
#ifdef __CUDACC__
    return __ldg(reinterpret_cast<const double*>(c + at));
#else
    union {
        float f[2];
        double d;
    } u = {{c[at], c[at + 1]}};
    return u.d;
#endif
}

__device__ __forceinline__ int fused_max(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ int fused_min(int a, int b) { return a < b ? a : b; }

// This lane's place among the L lanes that split a data loop's rows.
template <int L>
__device__ __forceinline__ int fused_row_lane() {
#ifdef __CUDACC__
    if constexpr (L > 1) return (int)(threadIdx.x & (L - 1));
#endif
    return 0;
}

// The fold of a data loop's virtual lanes on lane g of the L that split the
// rows: V = 32 / L virtual lanes g + j L, visited one after another in the
// order i = 0 .. V - 1, j = lane_of(i) (i's bits reversed), each pushed as
// its partial.  The butterfly's steps m >= L pair, within the lane, j with
// j + V / 2, then j with j + V / 4, ...: a tree whose leaves in bit-reversed
// order are neighbours, so push folds it as a binary counter (level k holds
// the finished subtree of 2^k leaves) in named registers — no array, no
// local memory.  result() then runs the steps m < L as shuffles and hands
// every lane lane 0's value.
template <int L, class T>
struct FusedRowFold {
    static constexpr int V = 32 / L;
    static constexpr int BITS = V >= 32 ? 5 : V >= 16 ? 4 : V >= 8 ? 3 : V >= 4 ? 2 : V >= 2 ? 1 : 0;
    T s0, s1, s2, s3, s4, s5;
    __device__ __forceinline__ int lane_of(int i) const {
        int j = 0;
#pragma unroll
        for (int b = 0; b < BITS; ++b) j |= ((i >> b) & 1) << (BITS - 1 - b);
        return j;
    }
    template <class Op>
    __device__ __forceinline__ void push(int i, T c, Op op) {
        if (!(i & 1)) { s0 = c; return; }
        c = op(s0, c);
        if (!(i & 2)) { s1 = c; return; }
        c = op(s1, c);
        if (!(i & 4)) { s2 = c; return; }
        c = op(s2, c);
        if (!(i & 8)) { s3 = c; return; }
        c = op(s3, c);
        if (!(i & 16)) { s4 = c; return; }
        s5 = op(s4, c);
    }
    template <class Op>
    __device__ __forceinline__ T result(Op op) const {
        T v = BITS == 0 ? s0 : BITS == 1 ? s1 : BITS == 2 ? s2 : BITS == 3 ? s3 : BITS == 4 ? s4 : s5;
#ifdef __CUDACC__
        if constexpr (L > 1) {
#pragma unroll
            for (int m = L / 2; m >= 1; m >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, m));
            v = __shfl_sync(0xffffffffu, v, 0, L);
        }
#endif
        return v;
    }
};

__device__ __noinline__ float fused_sinf(float x) { return sinf(x); }
__device__ __noinline__ float fused_cosf(float x) { return cosf(x); }
__device__ __noinline__ float fused_powf(float x, float y) { return powf(x, y); }

__device__ __noinline__ double fused_sin(double x) { return sin(x); }
__device__ __noinline__ double fused_cos(double x) { return cos(x); }
__device__ __noinline__ double fused_pow(double x, double y) { return pow(x, y); }

// Giles's polynomial times x, from w = -log(y), y = (1 - x)(1 + x).
__device__ __forceinline__ float fused_giles(float x, float y) {
    float w = -logf(y), p;
    if (w < 5.0f) {
        w = __fsub_rn(w, 2.5f);
        p = 0x1.e2cb1p-26f;
        p = __fadd_rn(0x1.70966cp-22f, __fmul_rn(p, w));
        p = __fadd_rn(-0x1.d8e6aep-19f, __fmul_rn(p, w));
        p = __fadd_rn(-0x1.26b582p-18f, __fmul_rn(p, w));
        p = __fadd_rn(0x1.ca65b6p-13f, __fmul_rn(p, w));
        p = __fadd_rn(-0x1.48a81p-10f, __fmul_rn(p, w));
        p = __fadd_rn(-0x1.11c9dep-8f, __fmul_rn(p, w));
        p = __fadd_rn(0x1.f91ec6p-3f, __fmul_rn(p, w));
        p = __fadd_rn(0x1.805c5ep+0f, __fmul_rn(p, w));
    } else {
        w = __fsub_rn(sqrtf(w), 3.0f);
        p = -0x1.a3e136p-13f;
        p = __fadd_rn(0x1.a76ad6p-14f, __fmul_rn(p, w));
        p = __fadd_rn(0x1.61b8e4p-10f, __fmul_rn(p, w));
        p = __fadd_rn(-0x1.e17bcep-9f, __fmul_rn(p, w));
        p = __fadd_rn(0x1.7824f6p-8f, __fmul_rn(p, w));
        p = __fadd_rn(-0x1.f38baep-8f, __fmul_rn(p, w));
        p = __fadd_rn(0x1.354afcp-7f, __fmul_rn(p, w));
        p = __fadd_rn(0x1.006db6p+0f, __fmul_rn(p, w));
        p = __fadd_rn(0x1.6a9efcp+1f, __fmul_rn(p, w));
    }
    return __fmul_rn(p, x);
}

// Acklam's tail: c(t) / d(t) with t = sqrt(-2 log p), the quantile of a
// small p.
__device__ __forceinline__ float fused_tail(float p) {
    const float t = sqrtf(__fmul_rn(-2.0f, logf(p)));
    float n = -0x1.fe30dap-8f;
    n = __fadd_rn(__fmul_rn(n, t), -0x1.4a224cp-2f);
    n = __fadd_rn(__fmul_rn(n, t), -0x1.334c0cp+1f);
    n = __fadd_rn(__fmul_rn(n, t), -0x1.465da2p+1f);
    n = __fadd_rn(__fmul_rn(n, t), 0x1.17fa8p+2f);
    n = __fadd_rn(__fmul_rn(n, t), 0x1.7815c2p+1f);
    float d = 0x1.fe2d86p-8f;
    d = __fadd_rn(__fmul_rn(d, t), 0x1.4a34d2p-2f);
    d = __fadd_rn(__fmul_rn(d, t), 0x1.38fa28p+1f);
    d = __fadd_rn(__fmul_rn(d, t), 0x1.e09076p+1f);
    d = __fadd_rn(__fmul_rn(d, t), 1.0f);
    return __fdiv_rn(n, d);
}

__device__ __noinline__ float fused_erfinv(float x) {
    if (fabsf(x) == 1.0f) return __fmul_rn(x, INFINITY);
    return fused_giles(x, __fmul_rn(__fsub_rn(1.0f, x), __fadd_rn(1.0f, x)));
}

__device__ __noinline__ float fused_ndtri(float p) {
    const float p_low = 0x1.8d4fep-6f;  // 0.02425
    if (p == 0.0f) return -INFINITY;
    if (p == 1.0f) return INFINITY;
    const float q = __fsub_rn(1.0f, p);
    if (p < p_low) return fused_tail(p);
    if (q < p_low) return -fused_tail(q);
    const float tp = __fmul_rn(2.0f, p);
    return __fmul_rn(fused_giles(__fsub_rn(tp, 1.0f), __fmul_rn(tp, __fsub_rn(2.0f, tp))),
                     0x1.6a09e6p+0f);  // sqrt 2
}
