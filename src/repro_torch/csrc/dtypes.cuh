// The value, x and y types of the SpMV kernels: float32 or bfloat16 read as
// f32, and f32 sums rounded to the destination's type once, on store.
// Included by every csrc/*.cu (build.py hashes it into each library's name).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// One element through the read-only path, widened to f32.
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// Four consecutive elements in one load: 16 bytes of f32 or 8 of bf16, which
// p must be aligned to.
__device__ __forceinline__ float4 load_f32x4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_f32x4(const __nv_bfloat16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// An f32 sum stored in the destination's type, rounded to nearest even once.
__device__ __forceinline__ void store_rounded(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_rounded(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive sums in one store (aligned as for load_f32x4).
__device__ __forceinline__ void store_rounded4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store_rounded4(__nv_bfloat16* p, float a, float b, float c,
                                               float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}
