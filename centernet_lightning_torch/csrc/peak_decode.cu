// Fused pseudo-NMS + class max/argmax over an NHWC heatmap, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel centernet_lightning_tpu/ops/pallas_decode.py:
// peak_class_scores_pallas (the _peak_kernel / _peak_kernel_nhwc programs).
//
// What it computes, for every pixel p = (n, y, x) of an (N, H, W, C) map:
//   m[c]      = max of the 3x3 window around p in class plane c, where an
//               out-of-image neighbour counts as `neutral` (0 for
//               probabilities, -1e30 for logits)
//   masked[c] = heat[p, c] if heat[p, c] == m[c] else neutral
//   score[p]  = max_c masked[c]      (f32)
//   label[p]  = lowest c with masked[c] == score[p]   (strict >, as torch.max)
// Comparisons are in f32; a bf16 input widens exactly, so the result is
// bitwise the plain PyTorch version's (ops/peak_decode.py).
//
// Bound on an H100 SXM: memory. The map is read once and (N, H*W) f32 scores
// and int32 labels are written once: at (64, 128, 128, 80) bf16 that is
// 167.8 MB + 8.4 MB, about 52.6 us at 3.35 TB/s. The arithmetic (about ten
// f32 operations a class value) is far below the card's rates.
//
// Design: a pixel's classes are contiguous in NHWC, so each pixel gets `tpp`
// neighbouring threads that each take 16-byte vectors of classes (8 bf16 or 4
// f32) and read the same vector at the eight neighbours, as 16-byte loads
// through the L1/L2 caches. A block of 256 threads covers 256 / tpp
// neighbouring pixels of one row (25 at C = 80 bf16), so the block's loads of
// each neighbour row are one contiguous span, and rows y-1 and y+1 are read
// from L2 by the blocks around it: device memory sees each byte about once.
// Each thread keeps a running (max, first class) over its vectors; the
// pixel's threads then combine through shared memory, ties to the lowest
// class. A map whose pointer or class row is not 16-byte aligned takes the
// same kernel with one value per load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]);

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                           float (&out)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: the lower address is the low half
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float (&out)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                           float (&out)[1]) {
  out[0] = __bfloat162float(p[0]);
}

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float (&out)[1]) {
  out[0] = __ldg(p);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
peak_class_scores_kernel(const T* __restrict__ heat, float* __restrict__ scores,
                         int32_t* __restrict__ labels, int num_pixels, int h, int w,
                         int c, int tpp, float neutral) {
  __shared__ float s_best[kThreads];
  __shared__ int s_cls[kThreads];
  const int ppb = kThreads / tpp;                 // pixels per block
  const int local = threadIdx.x / tpp;
  const int t = threadIdx.x - local * tpp;        // this thread's rank in its pixel
  const int pix = blockIdx.x * ppb + local;
  const bool active = local < ppb && pix < num_pixels;

  float best = -INFINITY;
  int best_c = INT_MAX;
  if (active) {
    const int x = pix % w;
    const int y = (pix / w) % h;
    const int64_t row_stride = (int64_t)w * c;
    const T* center = heat + (int64_t)pix * c;
    const int nvec = c / VEC;
    for (int v = t; v < nvec; v += tpp) {         // classes rise within a thread
      const int c0 = v * VEC;
      float val[VEC], m[VEC];
      load_vec<T, VEC>(center + c0, val);
#pragma unroll
      for (int i = 0; i < VEC; ++i) m[i] = val[i];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          const int yy = y + dy, xx = x + dx;
          float nb[VEC];
          if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
            load_vec<T, VEC>(center + dy * row_stride + (int64_t)dx * c + c0, nb);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) nb[i] = neutral;
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) m[i] = fmaxf(m[i], nb[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float masked = (m[i] == val[i]) ? val[i] : neutral;
        if (masked > best) {                      // strict: keeps the first class
          best = masked;
          best_c = c0 + i;
        }
      }
    }
  }
  s_best[threadIdx.x] = best;
  s_cls[threadIdx.x] = best_c;
  __syncthreads();
  if (active && t == 0) {
    for (int j = 1; j < tpp; ++j) {
      const float b = s_best[threadIdx.x + j];
      const int bc = s_cls[threadIdx.x + j];
      if (b > best || (b == best && bc < best_c)) {
        best = b;
        best_c = bc;
      }
    }
    scores[pix] = best;
    labels[pix] = best_c;
  }
}

template <typename T, int VEC>
void launch(const void* heat, void* scores, void* labels, int num_pixels, int h, int w,
            int c, float neutral, cudaStream_t stream) {
  const int nvec = c / VEC;
  const int tpp = nvec < kThreads ? nvec : kThreads;
  const int ppb = kThreads / tpp;
  const unsigned blocks = (unsigned)((num_pixels + ppb - 1) / ppb);
  peak_class_scores_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(heat), static_cast<float*>(scores),
      static_cast<int32_t*>(labels), num_pixels, h, w, c, tpp, neutral);
}

}  // namespace

// heat: (N, H, W, C) contiguous, bf16 (is_bf16 = 1) or f32; scores f32 and
// labels int32, each N*H*W < 2^31. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int peak_class_scores_launch(const void* heat, void* scores, void* labels,
                                        int n, int h, int w, int c, int is_bf16,
                                        float neutral, void* stream) {
  const int64_t num_pixels = (int64_t)n * h * w;
  if (num_pixels <= 0 || num_pixels > INT_MAX || c <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t elt = is_bf16 ? 2 : 4;
  const bool vec16 = reinterpret_cast<uintptr_t>(heat) % 16 == 0 && (c * elt) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = (int)num_pixels;
  if (is_bf16) {
    if (vec16) launch<__nv_bfloat16, 8>(heat, scores, labels, p, h, w, c, neutral, s);
    else launch<__nv_bfloat16, 1>(heat, scores, labels, p, h, w, c, neutral, s);
  } else {
    if (vec16) launch<float, 4>(heat, scores, labels, p, h, w, c, neutral, s);
    else launch<float, 1>(heat, scores, labels, p, h, w, c, neutral, s);
  }
  return (int)cudaGetLastError();
}
