// Deformable-convolution tap sampling over an NHWC map, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel centernet_lightning_tpu/ops/pallas_dcn.py:
// dcn_sample_all_taps (the _pallas_sample_all / _pallas_tap / _tap_kernel
// programs).
//
// What it computes, for every pixel p = (n, y, x) and tap t of the 3x3 grid:
//   taps[p, t, :] = sum over the four corners (y + a0 + r, x + b0 + s),
//                   r, s in {0, 1}, in the order (0,0), (0,1), (1,0), (1,1),
//                   of  round((wy_r * wm) * wx_s) * x[corner, :]
// with wy_0 = 1 - fy, wy_1 = fy, wx_0 = 1 - fx, wx_1 = fx, and a corner
// outside the image reading 0. a0, b0, fy, fx, wm are the per-pixel planes
// (N, H, W, 9) that ops/dcn.py:dcn_planes computes (offsets clamped to
// [-d, d], floors clipped into [tap - d, tap + d - 1]).
// The plain twin (ops/dcn.py:tap_sample_reference, the JAX xla_tap_sample)
// sums (2d+1)^2 masked shifts; every shift but these four corners has
// weight 0 and, for finite inputs, adds exactly 0. The weight is formed in
// f32 and rounded to the map's dtype, and the product and the running sum
// are each rounded to the dtype, with no FMA contraction (__fmul_rn and
// __fadd_rn in f32, mul.rn / add.rn on packed bf16 pairs), so the result is
// bitwise the twin's in f32 and bf16.
//
// Bound on an H100 SXM: memory. The nine tap maps are written once
// (9x the input's bytes) and the input and the five planes are read once:
// at the slice's largest layer, (32, 128, 128, 128) bf16, that is 1.21 GB
// written and 0.23 GB read, about 0.43 ms at 3.35 TB/s. The arithmetic,
// about 8 operations an output value, is far below the card's rates.
//
// Design: the TPU kernel pads an NCHW copy (W on lanes) and sums shifted
// slices because the TPU has no cheap gather. Here the model's
// channels_last activation is read as it lies, with no pad or transpose
// copy: a pixel's channels are contiguous, so each pixel gets C / VEC
// neighbouring threads that read 16-byte vectors (8 bf16 or 4 f32) of the
// four corners. One thread walks all nine taps of its channel vector, so a
// pixel's planes are read once (broadcast to its threads from L1), and it
// writes the tap maps as (N, H, W, 9, C): a pixel's 9*C outputs are one
// contiguous span, and the matrix product that follows reads them as
// (N*H*W, 9*C) with no permute. Corners repeat between neighbouring pixels
// and taps and are served by L1/L2. In bf16 the arithmetic runs on packed
// pairs (two values an instruction): rounding every product and sum to
// bf16 in f32 registers instead costs about four instructions a value and
// left the kernel bound by instruction issue (1.40 ms against the 0.43 ms
// bound on an H100 SXM, 700 W). A map whose pointer or channel row is not
// 16-byte aligned takes the same kernel with one value per load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "dcn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 9;

// Packed bf16 pairs, each lane rounded once to nearest even. The twin
// computes in f32 and then rounds to bf16; for a product or a sum of two
// bf16 values that double rounding equals the single one (f32 keeps
// 24 >= 2 * 8 + 2 bits), so the results are the same bits. The explicit
// .rn keeps the compiler from contracting the pair into an FMA.
__device__ __forceinline__ unsigned bf16x2_mul(unsigned a, unsigned b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned bf16x2_add(unsigned a, unsigned b) {
  unsigned r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dcn_sample_kernel(const T* __restrict__ x, const int32_t* __restrict__ a0,
                  const int32_t* __restrict__ b0, const float* __restrict__ fy,
                  const float* __restrict__ fx, const float* __restrict__ wm,
                  T* __restrict__ taps, int64_t total, int h, int w, int c) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int nvec = c / VEC;
  const int64_t pix = idx / nvec;
  const int c0 = (int)(idx - pix * nvec) * VEC;
  const int px = (int)(pix % w);
  const int py = (int)((pix / w) % h);
  const int64_t img0 = pix - ((int64_t)py * w + px);  // pixel (n, 0, 0)

#pragma unroll 1
  for (int t = 0; t < kTaps; ++t) {
    const int64_t q = pix * kTaps + t;
    const int ay = py + __ldg(a0 + q);
    const int bx = px + __ldg(b0 + q);
    const float fyv = __ldg(fy + q);
    const float fxv = __ldg(fx + q);
    const float wmv = __ldg(wm + q);
    const float wy[2] = {__fmul_rn(__fsub_rn(1.0f, fyv), wmv), __fmul_rn(fyv, wmv)};
    const float wx[2] = {__fsub_rn(1.0f, fxv), fxv};
    if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC == 8) {
      // 16-byte vectors as four packed pairs: two operations a pair
      unsigned acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int yy = ay + r, xx = bx + s;
          if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;  // adds +-0
          const unsigned short wb =
              __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(wy[r], wx[s])));
          const unsigned wgt = ((unsigned)wb << 16) | wb;
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(
              x + (img0 + (int64_t)yy * w + xx) * c + c0));
          acc[0] = bf16x2_add(acc[0], bf16x2_mul(wgt, u.x));
          acc[1] = bf16x2_add(acc[1], bf16x2_mul(wgt, u.y));
          acc[2] = bf16x2_add(acc[2], bf16x2_mul(wgt, u.z));
          acc[3] = bf16x2_add(acc[3], bf16x2_mul(wgt, u.w));
        }
      }
      *reinterpret_cast<uint4*>(taps + q * c + c0) = make_uint4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int yy = ay + r, xx = bx + s;
          const float wgt = round_to<T>(__fmul_rn(wy[r], wx[s]));
          float v[VEC];
          if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
            load_vec<T, VEC>(x + (img0 + (int64_t)yy * w + xx) * c + c0, v);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[i] = 0.0f;
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            acc[i] = round_to<T>(__fadd_rn(acc[i], round_to<T>(__fmul_rn(wgt, v[i]))));
          }
        }
      }
      store_vec<T, VEC>(taps + q * c + c0, acc);
    }
  }
}

template <typename T, int VEC>
void launch(const void* x, const int32_t* a0, const int32_t* b0, const float* fy,
            const float* fx, const float* wm, void* taps, int64_t num_pixels, int h,
            int w, int c, cudaStream_t stream) {
  const int64_t total = num_pixels * (c / VEC);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  dcn_sample_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), a0, b0, fy, fx, wm, static_cast<T*>(taps), total, h, w,
      c);
}

}  // namespace

// x: (N, H, W, C) contiguous, bf16 (is_bf16 = 1) or f32; a0, b0 int32 and
// fy, fx, wm f32, each (N, H, W, 9) contiguous; taps: (N, H, W, 9, C) in x's
// dtype. Launches on `stream`; returns cudaGetLastError().
extern "C" int dcn_sample_launch(const void* x, const void* a0, const void* b0,
                                 const void* fy, const void* fx, const void* wm,
                                 void* taps, int n, int h, int w, int c, int is_bf16,
                                 void* stream) {
  const int64_t num_pixels = (int64_t)n * h * w;
  if (num_pixels <= 0 || c <= 0 || num_pixels * kTaps * c / kThreads >= UINT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t elt = is_bf16 ? 2 : 4;
  const bool vec16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(taps) % 16 == 0 && (c * elt) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ia0 = static_cast<const int32_t*>(a0);
  const auto* ib0 = static_cast<const int32_t*>(b0);
  const auto* ffy = static_cast<const float*>(fy);
  const auto* ffx = static_cast<const float*>(fx);
  const auto* fwm = static_cast<const float*>(wm);
  if (is_bf16) {
    if (vec16) launch<__nv_bfloat16, 8>(x, ia0, ib0, ffy, ffx, fwm, taps, num_pixels, h, w, c, s);
    else launch<__nv_bfloat16, 1>(x, ia0, ib0, ffy, ffx, fwm, taps, num_pixels, h, w, c, s);
  } else {
    if (vec16) launch<float, 4>(x, ia0, ib0, ffy, ffx, fwm, taps, num_pixels, h, w, c, s);
    else launch<float, 1>(x, ia0, ib0, ffy, ffx, fwm, taps, num_pixels, h, w, c, s);
  }
  return (int)cudaGetLastError();
}
