// Pieces shared by the slice-epoch kernels (likelihoods.cuh and every
// slice_epoch*.cu) and probes.cu: the bounds on the dimension, the phases of
// the per-lane state machine (ops/pallas_slice.py), the murmur3 counter
// hash the uniforms come from, and the rounded arithmetic of the scalar
// type (rounded.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rounded.cuh"

// A parameter of type T that takes no part in deducing T: the scalar type
// of the slice kernels' templates (float, or double for B1's fused and
// traced routes at precision='highest') is deduced from their state alone.
template <class T>
struct same_type {
    using type = T;
};
template <class T>
using exactly = typename same_type<T>::type;

// The three dimension buckets of the slice-epoch template (slice_epoch.cuh):
// D <= SLICE_MAXD, every kernel and G; SLICE_MAXD < D <= SLICE_MAXD_WIDE,
// B1, B4 and B5 at G = SLICE_MAXD_WIDE / SLICE_LANE_CAP = 32 lanes per
// chain, so that no lane owns more than SLICE_LANE_CAP coordinates; and
// above, the stream bucket (a functor's MAXD = SLICE_MAXD_STREAM: no
// compile-time bound), B1, B4 and B5 at G = 32 with the chain's x0, n̂ and
// staged terms in the block's dynamic shared memory, (2 + NT) D values of
// the run's type, so D is bounded at run time by the SLICE_SMEM_MAX bytes a
// block may have (ops/pallas_slice_v4.py::stream_max_d).
#define SLICE_MAXD 32
#define SLICE_MAXD_WIDE 128
#define SLICE_LANE_CAP 4
#define SLICE_MAXD_STREAM 0
#define SLICE_SMEM_MAX 232448

enum { PH_INIT_R = 0, PH_INIT_L, PH_STEP_R, PH_STEP_L, PH_SHRINK, PH_DONE };

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t k) {
    k *= 0xCC9E2D51u;
    k = rotl32(k, 15);
    k *= 0x1B873593u;
    h ^= k;
    h = rotl32(h, 13);
    return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
}

// The uniform of draw `it` of a repeat: the top 24 bits of
// fmix(mix(h_rep, it)) times 2^-24, exact in float32 (and so in double: a
// double kernel draws the same u as a float one).
__device__ __forceinline__ float slice_uniform(uint32_t h_rep, uint32_t it) {
    return (float)(fmix32(mix32(h_rep, it)) >> 8) * 5.9604644775390625e-08f;
}
