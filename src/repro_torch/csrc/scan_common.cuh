// Helpers shared by K7 (csrc/selective_scan.cu) and its backward
// (csrc/selective_scan_bwd.cu): float32 views of the staged bf16 or
// float32 values, and the dtype casts. Header-only.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace scan {

// exp(x) = 2^(x log2(e)): bf16 inputs fold log2(e) into A once a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the two bf16 of a 32-bit word, as float32 (a bf16 is a float32's top half)
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// P consecutive staged values (16-byte aligned when P * sizeof(T) >= 16)
// as float32, in vector loads
template <int P>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else if constexpr (P == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    v[0] = p[0];
  }
}
template <int P>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&v)[P]) {
  if constexpr (P % 8 == 0) {
#pragma unroll
    for (int q = 0; q < P / 8; ++q) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[q];
      unpack2(w.x, v[8 * q], v[8 * q + 1]);
      unpack2(w.y, v[8 * q + 2], v[8 * q + 3]);
      unpack2(w.z, v[8 * q + 4], v[8 * q + 5]);
      unpack2(w.w, v[8 * q + 6], v[8 * q + 7]);
    }
  } else if constexpr (P == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    unpack2(w.x, v[0], v[1]);
    unpack2(w.y, v[2], v[3]);
  } else if constexpr (P == 2) {
    unpack2(*reinterpret_cast<const uint32_t*>(p), v[0], v[1]);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// P float32 values to consecutive addresses (16-byte aligned when P >= 4)
template <int P>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (P == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

}  // namespace scan
