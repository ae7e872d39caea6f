// B2 at 32 < dim <= 128: one warp's work on one basis, the finished columns
// and the input in the warp's shared memory (see gram_schmidt.cu).  A header
// of its own so that the tests can build it as host C++ on a warp of 32 host
// threads (tests/test_torch_gram_schmidt_wide.py).
#pragma once

#include "rounded.cuh"

// The norm's rounded square root, clamped from below (the plain version's
// clamp_min(sqrt(norm), 1e-30) in the type's own literal).
__device__ __forceinline__ float gs_den(float nrm) { return fmaxf(__fsqrt_rn(nrm), 1e-30f); }
__device__ __forceinline__ double gs_den(double nrm) { return fmax(__dsqrt_rn(nrm), 1e-30); }

// Four consecutive values of shared memory (16-byte aligned).
__device__ __forceinline__ void ld4(const float* p, float (&r)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&r)[4]) {
    const double2 x = *reinterpret_cast<const double2*>(p);
    const double2 y = *reinterpret_cast<const double2*>(p + 2);
    r[0] = x.x, r[1] = x.y, r[2] = y.x, r[3] = y.y;
}

// R = ceil(dim / 32) rows a lane: lane l holds rows l + 32 m (m < R) of the
// working column.  A column takes P = 32 R values in shared memory, row i at
// i, the rows from dim on +0 once the column is finished.  The coefficients
// of a sweep are reduced KC at a time, a chunk's KC x R finished values kept
// in registers between their two uses (up to 128 registers of them).
template <class T, int R>
struct GsWide {
    static constexpr int P = 32 * R;
    static constexpr int KC = sizeof(T) == 4 ? 32 : 16;
};

// N sums over the warp at once (N a power of two up to 32): lane l's N
// partials x[0 .. N-1], and lane l gets the sum of x[l / (32 / N)].  At
// offset 16, 8, ... each lane keeps half of its values (the upper half where
// its lane bit is set) and adds its partner's partial of each: the pair
// sums the butterfly of one value makes (a + b, the same bits as b + a), so
// each result has the bits of that value's own butterfly over offsets 16,
// 8, 4, 2, 1 (_lane_dot's order), in N - 1 shuffles for all N instead of
// 5 N.  Once one value is left the steps are the butterfly's own.
template <int OFF, int N, class T, int M>
__device__ __forceinline__ void gsw_halve(T (&x)[M], int lane) {
    if constexpr (OFF > 0) {
        if constexpr (N >= 2) {
            const bool hi = (lane & OFF) != 0;
#pragma unroll
            for (int t = 0; t < N / 2; ++t) {
                const T send = hi ? x[t] : x[t + N / 2];
                const T keep = hi ? x[t + N / 2] : x[t];
                x[t] = rn_add(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
            }
            gsw_halve<OFF / 2, N / 2>(x, lane);
        } else {
            x[0] = rn_add(x[0], __shfl_xor_sync(0xffffffffu, x[0], OFF));
            gsw_halve<OFF / 2, 1>(x, lane);
        }
    }
}

template <class T, int N>
__device__ __forceinline__ T gsw_reduce(T (&x)[N], int lane) {
    gsw_halve<16, N>(x, lane);
    return x[0];
}

// One chunk of a sweep: the coefficients of the finished columns k0 ..
// k0 + nk - 1 (nk <= W; all W where FULL) against v, reduced W at a time
// over the warp, written to cb and read back by every lane, then added to
// u[m] += q_k[m] c_k in order of k.  The columns past nk are neither read
// nor added.
template <class T, int R, int W, bool FULL>
__device__ __forceinline__ void gsw_chunk(const T* s, T* cb, int k0, int nk, const T (&v)[R],
                                          T (&u)[R], int lane) {
    constexpr int P = GsWide<T, R>::P;
    T qc[W][R], p[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
        const T* qk = s + (k0 + c) * P + lane;
        T a = T(0);
#pragma unroll
        for (int m = 0; m < R; ++m) {
            qc[c][m] = FULL || c < nk ? qk[32 * m] : T(0);
            a = rn_add(a, rn_mul(qc[c][m], v[m]));
        }
        p[c] = a;
    }
    const T coef = gsw_reduce<T, W>(p, lane);
    if (lane % (32 / W) == 0) cb[lane / (32 / W)] = coef;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < W; c += 4) {
        T cc[4];
        ld4(cb + c, cc);
#pragma unroll
        for (int x = 0; x < 4; ++x)
            if (FULL || c + x < nk)
#pragma unroll
                for (int m = 0; m < R; ++m) u[m] = rn_add(u[m], rn_mul(qc[c + x][m], cc[x]));
    }
}

// The last chunk of a sweep, nk < KC columns: at the narrowest width W (KC,
// KC / 2, ... down to 4) that holds them.
template <class T, int R, int W>
__device__ __forceinline__ void gsw_tail(const T* s, T* cb, int k0, int nk, const T (&v)[R],
                                         T (&u)[R], int lane) {
    if constexpr (W > 4) {
        if (nk <= W / 2) {
            gsw_tail<T, R, W / 2>(s, cb, k0, nk, v, u, lane);
            return;
        }
    }
    gsw_chunk<T, R, W, false>(s, cb, k0, nk, v, u, lane);
}

// CGS2 of one basis on one warp: column j of the input at s + j P (rows
// below dim), replaced there by q_j; 2 KC values after the dim columns hold
// the coefficients (two buffers, so one __syncwarp a chunk).  For column j:
// two sweeps (none at j = 0), each computing all j coefficients
// c_k = q_k . v against the same v (each lane's rows in order from +0, then
// the butterfly), then v -= sum_k c_k q_k, the sum over k in index order
// from +0; then v / max(sqrt(|v|^2), 1e-30).  ops/pallas_dirs.py::
// _long_plain_panel, on the whole basis, is this order.
template <class T, int R>
__device__ void gsw_basis(T* s, int dim, int lane) {
    constexpr int P = GsWide<T, R>::P, KC = GsWide<T, R>::KC;
    T* cs = s + dim * P;
    int buf = 0;
    for (int j = 0; j < dim; ++j) {
        T* col = s + j * P;
        T v[R];
#pragma unroll
        for (int m = 0; m < R; ++m) v[m] = lane + 32 * m < dim ? col[lane + 32 * m] : T(0);
        for (int sweep = 0; j > 0 && sweep < 2; ++sweep) {
            T u[R];
#pragma unroll
            for (int m = 0; m < R; ++m) u[m] = T(0);
            int k0 = 0;
            for (; k0 + KC <= j; k0 += KC, buf ^= 1)
                gsw_chunk<T, R, KC, true>(s, cs + buf * KC, k0, KC, v, u, lane);
            if (k0 < j) {
                gsw_tail<T, R, KC>(s, cs + buf * KC, k0, j - k0, v, u, lane);
                buf ^= 1;
            }
#pragma unroll
            for (int m = 0; m < R; ++m) v[m] = rn_sub(v[m], u[m]);
        }
        T nrm[1] = {T(0)};
#pragma unroll
        for (int m = 0; m < R; ++m) nrm[0] = rn_add(nrm[0], rn_mul(v[m], v[m]));
        const T den = gs_den(gsw_reduce<T, 1>(nrm, lane));
#pragma unroll
        for (int m = 0; m < R; ++m) col[lane + 32 * m] = rn_div(v[m], den);
        __syncwarp();  // column j is whole before any lane reads it
    }
}
