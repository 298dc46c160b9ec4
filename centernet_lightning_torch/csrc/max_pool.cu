// 3x3 / stride-2 / pad-1 max pool over an NHWC map, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel centernet_lightning_tpu/ops/pallas_pool.py:
// max_pool_3x3_s2_pallas (its _pool_kernel).
//
// What it computes: out[n, oy, ox, c] = max of x[n, 2oy + i, 2ox + j, c] over
// i, j in {-1, 0, 1} inside the map (the pad reads -inf), for an output of
// ceil(H/2) x ceil(W/2). The window is scanned in row-major order and a
// value replaces the running max only when it is larger or NaN, which is
// F.max_pool2d's own rule: the result is one of the inputs, bitwise (a NaN
// propagates as a NaN), equal to F.max_pool2d(x, 3, 2, 1) and to the plain
// twin (ops/pool.py:max_pool_3x3_s2_reference), -inf included.
//
// Bound on an H100 SXM: memory. The input is read once and the output,
// a quarter of its size, written once: at the ResNet stem's
// (64, 256, 256, 64) bf16 that is 536.9 MB read and 134.2 MB written,
// 0.200 ms at 3.35 TB/s. A max is one compare a value.
//
// Design: the TPU kernel viewed W as (W/2, 2C) so that even and odd
// columns sat side by side on the lanes, tiled H with a one-row halo and
// needed even H and W for that view. Here the channels_last map is read as
// it lies. Each thread owns one output column and one 16-byte channel
// vector (8 bf16 or 4 f32), so a warp's loads along C are contiguous; each
// block owns a band of kBand output rows and walks its input rows top to
// bottom, keeping the max of the row below the current output row in
// registers for the next one. So every input row is loaded once per band
// (the band's top halo row twice), and the three columns of a row that a
// thread reads are shared with its neighbours through L1: each element
// comes from device memory once. Odd H and W, and a 1 x 1 map, need no
// special case: rows and columns past the map read -inf. A map whose
// pointer or channel row is not 16-byte aligned runs the same kernel with
// one value per load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dcn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 8;  // output rows per block

// F.max_pool2d's update: take v when it is larger, or NaN
__device__ __forceinline__ float take_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// m = the running max of `m` and row r's three columns 2ox-1, 2ox, 2ox+1
// (left to right), for the channel vector at cv; a row or column outside
// the map adds nothing
template <typename T, int VEC>
__device__ __forceinline__ void row_max(const T* __restrict__ img, int r, int ox,
                                        int h, int w, int c, int cv, float (&m)[VEC]) {
  if (r < 0 || r >= h) return;
  const T* row = img + (int64_t)r * w * c + cv;
#pragma unroll
  for (int j = -1; j <= 1; ++j) {
    const int col = 2 * ox + j;
    if (col < 0 || col >= w) continue;
    float v[VEC];
    load_vec<T, VEC>(row + (int64_t)col * c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) m[i] = take_max(m[i], v[i]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    max_pool_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w, int c,
                    int ho, int wo) {
  const int nvec = c / VEC;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= wo * nvec) return;
  const int ox = j / nvec;
  const int cv = (j - ox * nvec) * VEC;
  const int oy0 = blockIdx.y * kBand;
  const int oy1 = min(oy0 + kBand, ho);
  const T* img = x + (int64_t)blockIdx.z * h * w * c;
  T* dst = out + (int64_t)blockIdx.z * ho * wo * c + (int64_t)ox * c + cv;

  float above[VEC];  // max of input row 2oy - 1, the row above the pair
#pragma unroll
  for (int i = 0; i < VEC; ++i) above[i] = -INFINITY;
  row_max<T, VEC>(img, 2 * oy0 - 1, ox, h, w, c, cv, above);
  for (int oy = oy0; oy < oy1; ++oy) {
    float m[VEC], below[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      m[i] = above[i];
      below[i] = -INFINITY;
    }
    row_max<T, VEC>(img, 2 * oy, ox, h, w, c, cv, m);
    row_max<T, VEC>(img, 2 * oy + 1, ox, h, w, c, cv, below);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      m[i] = take_max(m[i], below[i]);
      above[i] = below[i];
    }
    store_vec<T, VEC>(dst + (int64_t)oy * wo * c, m);
  }
}

template <typename T, int VEC>
void launch(const void* x, void* out, int n, int h, int w, int c, int ho, int wo,
            cudaStream_t stream) {
  const int64_t per_row = (int64_t)wo * (c / VEC);
  const dim3 grid((unsigned)((per_row + kThreads - 1) / kThreads),
                  (unsigned)((ho + kBand - 1) / kBand), (unsigned)n);
  max_pool_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, w, c, ho, wo);
}

}  // namespace

// x: (N, H, W, C) contiguous, bf16 (is_bf16 = 1) or f32; out:
// (N, ceil(H/2), ceil(W/2), C) contiguous in x's dtype. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for an
// empty map or one past the grid's limits.
extern "C" int max_pool_launch(const void* x, void* out, int n, int h, int w, int c,
                               int is_bf16, void* stream) {
  const int ho = (h + 1) / 2;
  const int wo = (w + 1) / 2;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || n > 65535 ||
      (ho + kBand - 1) / kBand > 65535 || (int64_t)wo * c >= INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t elt = is_bf16 ? 2 : 4;
  const bool vec16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0 && (c * elt) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec16) launch<__nv_bfloat16, 8>(x, out, n, h, w, c, ho, wo, s);
    else launch<__nv_bfloat16, 1>(x, out, n, h, w, c, ho, wo, s);
  } else {
    if (vec16) launch<float, 4>(x, out, n, h, w, c, ho, wo, s);
    else launch<float, 1>(x, out, n, h, w, c, ho, wo, s);
  }
  return (int)cudaGetLastError();
}
