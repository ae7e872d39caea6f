// Explicitly rounded arithmetic in the scalar type of a kernel: float, the
// type of every kernel of the port, or double, the type of B1's fused and
// traced routes and of B2 in a run at precision='highest'
// (ops/precision.py).  Each overload is one IEEE operation rounded to
// nearest, so a kernel written with them keeps the order of its plain torch
// version in either type (the libraries are built with --fmad=false).  The
// float overloads are the intrinsics the kernels called before the double
// instantiations existed, so the float code is unchanged.
#pragma once

__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }
