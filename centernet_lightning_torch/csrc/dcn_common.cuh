// Value conversions and 16-byte vector loads and stores shared by the DCN
// kernels (dcn_sample.cu, dcn_fused.cu). T is float or __nv_bfloat16; the
// arithmetic around these runs in f32.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to nearest even in T, as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

// VEC values of T as floats, from a 16-byte load when VEC * sizeof(T) == 16
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(words[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // little endian: the lower address is the low half
        out[2 * i] = __uint_as_float(words[i] << 16);
        out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float<T>(p[i]);
  }
}

// VEC floats rounded to T, as one 16-byte store when VEC * sizeof(T) == 16
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    unsigned words[4];
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < 4; ++i) words[i] = __float_as_uint(v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        words[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
                   ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_float<T>(v[i]);
  }
}

}  // namespace
