// Pieces shared by the slice-epoch kernels (likelihoods.cuh and every
// slice_epoch*.cu) and probes.cu: the bound on the dimension, the phases of
// the per-lane state machine (ops/pallas_slice.py), and the murmur3 counter
// hash the uniforms come from.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SLICE_MAXD 32

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
// fmix(mix(h_rep, it)) times 2^-24, exact in float32.
__device__ __forceinline__ float slice_uniform(uint32_t h_rep, uint32_t it) {
    return (float)(fmix32(mix32(h_rep, it)) >> 8) * 5.9604644775390625e-08f;
}
