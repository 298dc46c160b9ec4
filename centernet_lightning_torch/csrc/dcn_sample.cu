// Deformable-convolution tap sampling over an NHWC map, for Hopper (sm_90a):
// the forward, dcn_sample_kernel, and its backward, dcn_sample_grad_tiled and
// dcn_sample_grad.
//
// The forward replaces the Pallas TPU kernel centernet_lightning_tpu/ops/pallas_dcn.py:
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

// ---- the backward --------------------------------------------------------
//
// The backward (dcn_sample_grad_launch: the kernels dcn_sample_grad_tiled
// and dcn_sample_grad) replaces no Pallas kernel. The JAX package's custom VJP
// recomputes the XLA twin under jax.vjp (centernet_lightning_tpu/ops/
// pallas_dcn.py:398-406), and the port did the same through ops/dcn.py:
// twin_vjp: 25 masked shifts a tap at d = 2, each a few elementwise kernels
// forward and backward on tensors as large as the block's input, some 9,000
// launches a block. That recompute set the pace of DCN training (93% of the
// kernel time of a ResNet-18 FPN-128 step at b128), so it has a kernel.
//
// What it computes, from grad = dL/dtaps (N, H, W, 9, C) and the forward's
// inputs, for every pixel p and tap t, over the corners (r, s) in {0, 1}^2
// inside the image (the twin's zero pad gives the others no gradient), with
// g = grad[p, t, :], x_rs = x[p + (a0 + r, b0 + s), :], wy = (1 - fy, fy),
// wx = (1 - fx, fx):
//   dx[p + (a0 + r, b0 + s), :] += ((wy_r * wm) * wx_s) * g
//   dfy[p, t] = wm * sum_c g * (wx_0 * (x10 - x00) + wx_1 * (x11 - x01))
//   dfx[p, t] = wm * sum_c g * (wy_0 * (x01 - x00) + wy_1 * (x11 - x10))
//   dwm[p, t] = sum_c g * sum_rs wy_r * wx_s * x_rs
// The floors get no gradient. The planes carry the clipped floors, so no
// forward is recomputed and the displacement bound d is not needed: one
// launcher serves every dcn_fast_d{d}. Sums run in f32; dx is a scatter,
// accumulated with f32 atomics into a zeroed f32 buffer (x's dtype is
// rounded to once, by the caller), so its sums run in an order that changes
// from run to run. A null output pointer skips that gradient.
//
// Bound on an H100 SXM: memory. grad is read once (9x the input's bytes),
// x and the five planes are read, dx and three f32 planes are written: at
// the slice's largest layer, (128, 128, 128, 128) bf16, 4.83 + 0.54 + 0.38
// GB read and 0.54 (bf16) + 0.23 GB written, about 1.94 ms at 3.35 TB/s,
// and 2.55 ms for the three layers of a step (32^2, 64^2, 128^2). The
// arithmetic, about 16 operations a tap gradient value, is far below the
// card's rates.
//
// Design: two kernels, both in the forward's thread layout. A pixel gets
// C / VEC neighbouring threads, each reading 16-byte vectors (8 bf16 or 4
// f32) of g and of the four corners and walking the nine taps of its
// channel vector, so a pixel's planes are read once; each thread forms its
// channels' share of the three plane sums, and the shares meet by shuffles
// within the pixel's threads. dx is a scatter:
//  - dcn_sample_grad_tiled, the main path (16-byte vectors, C a multiple of
//    kChunk): a block sums its tile's contributions in shared memory and
//    adds them to dx once a window position (below);
//  - dcn_sample_grad, every other map (rows not 16-byte aligned, other C):
//    each thread adds its contributions to dx with global atomics, 16-byte
//    vector ones where aligned (atomicAdd on a float4, which sm_90 has);
//    where C / VEC does not divide 32 the plane shares meet by f32 atomics
//    into zeroed planes.
// Measured on an H100 SXM at 700 W, at the largest layer above with d = 2:
// the tiled kernel 15.2-15.6 ms (0.12-0.13 of the bound), the direct
// scatter 25.8 ms, the twin recompute it replaced 1,343 ms. The card has no
// shared-memory f32 atomic add: atomicAdd there compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN), which takes about 9 of the 15
// ms (the kernel without it: 5.8 ms). Running a thread's compare-and-swaps
// side by side was slower (22.6 ms), and so was a layout with no shared
// memory bank conflicts (one pixel a warp, 4-byte loads: 18.6 ms).

// VEC floats added to p, as 16-byte vector atomics where VEC allows
template <int VEC>
__device__ __forceinline__ void red_add(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(p + i, v[i]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dcn_sample_grad(const T* __restrict__ x, const int32_t* __restrict__ a0,
                const int32_t* __restrict__ b0, const float* __restrict__ fy,
                const float* __restrict__ fx, const float* __restrict__ wm,
                const T* __restrict__ grad, float* __restrict__ dx,
                float* __restrict__ dfy, float* __restrict__ dfx,
                float* __restrict__ dwm, int64_t total, int h, int w, int c,
                int group) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  // with shuffles (group > 0) every lane of a warp takes part; a thread past
  // the end reads pixel 0 and writes nothing
  const bool valid = idx < total;
  if (!valid && group == 0) return;
  const int nvec = c / VEC;
  const int64_t pix = valid ? idx / nvec : 0;
  const int c0 = valid ? (int)(idx - pix * nvec) * VEC : 0;
  const int px = (int)(pix % w);
  const int py = (int)((pix / w) % h);
  const int64_t img0 = pix - ((int64_t)py * w + px);  // pixel (n, 0, 0)
  const bool planes = dfy != nullptr || dfx != nullptr || dwm != nullptr;

#pragma unroll 1
  for (int t = 0; t < kTaps; ++t) {
    const int64_t q = pix * kTaps + t;
    const int ay = py + __ldg(a0 + q);
    const int bx = px + __ldg(b0 + q);
    const float fyv = __ldg(fy + q);
    const float fxv = __ldg(fx + q);
    const float wmv = __ldg(wm + q);
    const float wy[2] = {__fsub_rn(1.0f, fyv), fyv};
    const float wx[2] = {__fsub_rn(1.0f, fxv), fxv};
    float g[VEC];
    if (valid) {
      load_vec<T, VEC>(grad + q * c + c0, g);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) g[i] = 0.0f;
    }
    float dot[2][2];  // this thread's channels of sum_c g * x_rs
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        dot[r][s] = 0.0f;
        const int yy = ay + r, xx = bx + s;
        if (!valid || yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
        const int64_t at = (img0 + (int64_t)yy * w + xx) * c + c0;
        if (planes) {
          float v[VEC];
          load_vec<T, VEC>(x + at, v);
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc = fmaf(g[i], v[i], acc);
          dot[r][s] = acc;
        }
        if (dx != nullptr) {
          const float wgt = __fmul_rn(__fmul_rn(wy[r], wmv), wx[s]);
          float add[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) add[i] = wgt * g[i];
          red_add<VEC>(dx + at, add);
        }
      }
    }
    if (!planes) continue;
    float gy = wx[0] * (dot[1][0] - dot[0][0]) + wx[1] * (dot[1][1] - dot[0][1]);
    float gx = wy[0] * (dot[0][1] - dot[0][0]) + wy[1] * (dot[1][1] - dot[1][0]);
    float gm = wy[0] * (wx[0] * dot[0][0] + wx[1] * dot[0][1]) +
               wy[1] * (wx[0] * dot[1][0] + wx[1] * dot[1][1]);
    if (group > 0) {
      // a pixel's threads are `group` aligned lanes of one warp
#pragma unroll 1
      for (int off = group >> 1; off > 0; off >>= 1) {
        gy += __shfl_xor_sync(0xffffffffu, gy, off);
        gx += __shfl_xor_sync(0xffffffffu, gx, off);
        gm += __shfl_xor_sync(0xffffffffu, gm, off);
      }
      if (valid && c0 == 0) {
        if (dfy != nullptr) dfy[q] = wmv * gy;
        if (dfx != nullptr) dfx[q] = wmv * gx;
        if (dwm != nullptr) dwm[q] = gm;
      }
    } else {
      if (dfy != nullptr) atomicAdd(dfy + q, wmv * gy);
      if (dfx != nullptr) atomicAdd(dfx + q, wmv * gx);
      if (dwm != nullptr) atomicAdd(dwm + q, gm);
    }
  }
}

// The tiled backward. A block owns a tile of kTileY x kTileX source pixels of one
// image and walks the channels kChunk at a time. Within a chunk it sums the
// tile's dx contributions into the tile plus a kHalo border in shared
// memory (a bounded offset moves a corner at most d + 1 pixels, so every
// corner at d <= 2 lands in it; a farther one goes straight to global
// memory), with shared f32 atomics, and then adds the window to dx with
// 16-byte global atomics: about 2.4 window values a pixel against the
// direct scatter's 36 (4 corners x 9 taps). The window stores thread i's
// value j of a pixel's group of G threads at j * G + i, and pads each
// position by G values, so the G lanes of a group, and the next groups of
// the warp at neighbouring targets, fall on different banks. Two blocks of
// 512 threads fit an SM. The plane sums add up over the chunks in shared
// memory; each plane gradient is stored once, at the end.
constexpr int kTileY = 8;
constexpr int kTileX = 16;
constexpr int kHalo = 3;
constexpr int kWinY = kTileY + 2 * kHalo;
constexpr int kWinX = kTileX + 2 * kHalo;
constexpr int kChunk = 64;
constexpr int kTiledThreads = 512;

template <int VEC>
constexpr int tiled_smem_floats() {
  return kWinY * kWinX * (kChunk + kChunk / VEC) + kTileY * kTileX * kTaps * 3;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kTiledThreads)
dcn_sample_grad_tiled(const T* __restrict__ x, const int32_t* __restrict__ a0,
                      const int32_t* __restrict__ b0, const float* __restrict__ fy,
                      const float* __restrict__ fx, const float* __restrict__ wm,
                      const T* __restrict__ grad, float* __restrict__ dx,
                      float* __restrict__ dfy, float* __restrict__ dfx,
                      float* __restrict__ dwm, int h, int w, int c) {
  constexpr int G = kChunk / VEC;          // threads a pixel: 8 (bf16), 16 (f32)
  constexpr int S = kChunk + G;            // window floats a position
  constexpr int kPix = kTileY * kTileX;
  extern __shared__ float smem[];
  float* win = smem;                       // kWinY * kWinX * S
  float* part = smem + kWinY * kWinX * S;  // kPix * kTaps * 3 plane sums
  const int ty0 = blockIdx.y * kTileY, tx0 = blockIdx.x * kTileX;
  const int64_t img0 = (int64_t)blockIdx.z * h * w;
  const int lane = threadIdx.x % G, slot = threadIdx.x / G;
  const bool planes = dfy != nullptr || dfx != nullptr || dwm != nullptr;

  for (int i = threadIdx.x; i < kPix * kTaps * 3; i += kTiledThreads) part[i] = 0.0f;
#pragma unroll 1
  for (int c_lo = 0; c_lo < c; c_lo += kChunk) {
    for (int i = threadIdx.x; i < kWinY * kWinX * S; i += kTiledThreads) win[i] = 0.0f;
    __syncthreads();
    const int c0 = c_lo + lane * VEC;
#pragma unroll 1
    for (int pl = slot; pl < kPix; pl += kTiledThreads / G) {
      const int py = ty0 + pl / kTileX, px = tx0 + pl % kTileX;
      // a pixel past the map's edge takes part in the shuffles only
      const bool valid = py < h && px < w;
      const int64_t pix = img0 + (valid ? (int64_t)py * w + px : 0);
#pragma unroll 1
      for (int t = 0; t < kTaps; ++t) {
        const int64_t q = pix * kTaps + t;
        const int ay = py + __ldg(a0 + q);
        const int bx = px + __ldg(b0 + q);
        const float fyv = __ldg(fy + q);
        const float fxv = __ldg(fx + q);
        const float wmv = __ldg(wm + q);
        const float wy[2] = {__fsub_rn(1.0f, fyv), fyv};
        const float wx[2] = {__fsub_rn(1.0f, fxv), fxv};
        float g[VEC];
        if (valid) {
          load_vec<T, VEC>(grad + q * c + c0, g);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) g[i] = 0.0f;
        }
        float dot[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            dot[r][s] = 0.0f;
            const int yy = ay + r, xx = bx + s;
            if (!valid || yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
            const int64_t at = (img0 + (int64_t)yy * w + xx) * c + c0;
            if (planes) {
              float v[VEC];
              load_vec<T, VEC>(x + at, v);
              float acc = 0.0f;
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc = fmaf(g[i], v[i], acc);
              dot[r][s] = acc;
            }
            if (dx != nullptr) {
              const float wgt = __fmul_rn(__fmul_rn(wy[r], wmv), wx[s]);
              float add[VEC];
#pragma unroll
              for (int i = 0; i < VEC; ++i) add[i] = wgt * g[i];
              const int wy_ = yy - ty0 + kHalo, wx_ = xx - tx0 + kHalo;
              if (wy_ >= 0 && wy_ < kWinY && wx_ >= 0 && wx_ < kWinX) {
                float* cell = win + (wy_ * kWinX + wx_) * S + lane;
#pragma unroll
                for (int i = 0; i < VEC; ++i) atomicAdd(cell + i * G, add[i]);
              } else {
                red_add<VEC>(dx + at, add);
              }
            }
          }
        }
        if (!planes) continue;
        float gy = wx[0] * (dot[1][0] - dot[0][0]) + wx[1] * (dot[1][1] - dot[0][1]);
        float gx = wy[0] * (dot[0][1] - dot[0][0]) + wy[1] * (dot[1][1] - dot[1][0]);
        float gm = wy[0] * (wx[0] * dot[0][0] + wx[1] * dot[0][1]) +
                   wy[1] * (wx[0] * dot[1][0] + wx[1] * dot[1][1]);
#pragma unroll
        for (int off = G >> 1; off > 0; off >>= 1) {
          gy += __shfl_xor_sync(0xffffffffu, gy, off);
          gx += __shfl_xor_sync(0xffffffffu, gx, off);
          gm += __shfl_xor_sync(0xffffffffu, gm, off);
        }
        if (lane == 0) {  // one group a pixel, and the chunks in turn
          float* sums = part + (pl * kTaps + t) * 3;
          sums[0] += wmv * gy;
          sums[1] += wmv * gx;
          sums[2] += gm;
        }
      }
    }
    __syncthreads();
    if (dx != nullptr) {
      for (int i = threadIdx.x; i < kWinY * kWinX * (kChunk / 4); i += kTiledThreads) {
        const int pos = i / (kChunk / 4), k4 = (i % (kChunk / 4)) * 4;
        const int yy = ty0 - kHalo + pos / kWinX, xx = tx0 - kHalo + pos % kWinX;
        if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = k4 + j;
          v[j] = win[pos * S + (cc % VEC) * G + cc / VEC];
        }
        if (v[0] == 0.0f && v[1] == 0.0f && v[2] == 0.0f && v[3] == 0.0f) continue;
        red_add<4>(dx + (img0 + (int64_t)yy * w + xx) * c + c_lo + k4, v);
      }
    }
    __syncthreads();  // the window is zeroed again for the next chunk
  }
  if (!planes) return;
  for (int i = threadIdx.x; i < kPix * kTaps; i += kTiledThreads) {
    const int pl = i / kTaps;
    const int py = ty0 + pl / kTileX, px = tx0 + pl % kTileX;
    if (py >= h || px >= w) continue;
    const int64_t q = (img0 + (int64_t)py * w + px) * kTaps + i % kTaps;
    if (dfy != nullptr) dfy[q] = part[i * 3];
    if (dfx != nullptr) dfx[q] = part[i * 3 + 1];
    if (dwm != nullptr) dwm[q] = part[i * 3 + 2];
  }
}

template <typename T, int VEC>
cudaError_t launch_grad_tiled(const void* x, const int32_t* a0, const int32_t* b0,
                              const float* fy, const float* fx, const float* wm,
                              const void* grad, float* dx, float* dfy, float* dfx,
                              float* dwm, int n, int h, int w, int c,
                              cudaStream_t stream) {
  const size_t smem = tiled_smem_floats<VEC>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dcn_sample_grad_tiled<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, n);
  dcn_sample_grad_tiled<T, VEC><<<grid, kTiledThreads, smem, stream>>>(
      static_cast<const T*>(x), a0, b0, fy, fx, wm, static_cast<const T*>(grad), dx,
      dfy, dfx, dwm, h, w, c);
  return cudaSuccess;
}

template <typename T, int VEC>
void launch_grad(const void* x, const int32_t* a0, const int32_t* b0, const float* fy,
                 const float* fx, const float* wm, const void* grad, float* dx,
                 float* dfy, float* dfx, float* dwm, int64_t num_pixels, int h, int w,
                 int c, cudaStream_t stream) {
  const int nvec = c / VEC;
  const int64_t total = num_pixels * nvec;
  const int group = 32 % nvec == 0 ? nvec : 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  dcn_sample_grad<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), a0, b0, fy, fx, wm, static_cast<const T*>(grad), dx,
      dfy, dfx, dwm, total, h, w, c, group);
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

// The backward. x (N, H, W, C) and grad (N, H, W, 9, C), contiguous, bf16
// (is_bf16 = 1) or f32; the planes as for dcn_sample_launch. Outputs, each
// f32 and contiguous, or null to skip it: dx (N, H, W, C) and dfy, dfx, dwm
// (N, H, W, 9). The accumulated outputs are zeroed here, on `stream`, before
// the launch. Returns the first CUDA error, or cudaGetLastError().
extern "C" int dcn_sample_grad_launch(const void* x, const void* a0, const void* b0,
                                      const void* fy, const void* fx, const void* wm,
                                      const void* grad, void* dx, void* dfy, void* dfx,
                                      void* dwm, int n, int h, int w, int c, int is_bf16,
                                      void* stream) {
  const int64_t num_pixels = (int64_t)n * h * w;
  if (num_pixels <= 0 || c <= 0 || num_pixels * kTaps * c / kThreads >= UINT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t elt = is_bf16 ? 2 : 4;
  const bool vec16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(grad) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dx) % 16 == 0 && (c * elt) % 16 == 0;
  const int nvec = vec16 ? c / (int)(16 / elt) : c;
  const bool tiled = vec16 && c % kChunk == 0 && n <= 65535;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane_bytes = (size_t)num_pixels * kTaps * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (dx != nullptr) err = cudaMemsetAsync(dx, 0, (size_t)num_pixels * c * sizeof(float), s);
  if (!tiled && 32 % nvec != 0) {  // the planes' shares meet by atomics
    void* const outs[3] = {dfy, dfx, dwm};
    for (void* p : outs) {
      if (err == cudaSuccess && p != nullptr) err = cudaMemsetAsync(p, 0, plane_bytes, s);
    }
  }
  if (err != cudaSuccess) return (int)err;
  const auto* ia0 = static_cast<const int32_t*>(a0);
  const auto* ib0 = static_cast<const int32_t*>(b0);
  const auto* ffy = static_cast<const float*>(fy);
  const auto* ffx = static_cast<const float*>(fx);
  const auto* fwm = static_cast<const float*>(wm);
  auto* gx = static_cast<float*>(dx);
  auto* gfy = static_cast<float*>(dfy);
  auto* gfx = static_cast<float*>(dfx);
  auto* gwm = static_cast<float*>(dwm);
  if (tiled) {
    err = is_bf16 ? launch_grad_tiled<__nv_bfloat16, 8>(x, ia0, ib0, ffy, ffx, fwm, grad, gx, gfy, gfx, gwm, n, h, w, c, s)
                  : launch_grad_tiled<float, 4>(x, ia0, ib0, ffy, ffx, fwm, grad, gx, gfy, gfx, gwm, n, h, w, c, s);
    if (err != cudaSuccess) return (int)err;
  } else if (is_bf16) {
    if (vec16) launch_grad<__nv_bfloat16, 8>(x, ia0, ib0, ffy, ffx, fwm, grad, gx, gfy, gfx, gwm, num_pixels, h, w, c, s);
    else launch_grad<__nv_bfloat16, 1>(x, ia0, ib0, ffy, ffx, fwm, grad, gx, gfy, gfx, gwm, num_pixels, h, w, c, s);
  } else {
    if (vec16) launch_grad<float, 4>(x, ia0, ib0, ffy, ffx, fwm, grad, gx, gfy, gfx, gwm, num_pixels, h, w, c, s);
    else launch_grad<float, 1>(x, ia0, ib0, ffy, ffx, fwm, grad, gx, gfy, gfx, gwm, num_pixels, h, w, c, s);
  }
  return (int)cudaGetLastError();
}
