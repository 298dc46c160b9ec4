// Fused deformable convolution: tap sampling and the per-tap matrix product
// in one kernel, over an NHWC map, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel centernet_lightning_tpu/ops/pallas_dcn.py:
// dcn_fused_conv (the _fused_kernel program).
//
// What it computes, for every pixel p = (n, y, x) and output channel o:
//   out[p, o] = cast( sum_t sum_c round(sample_t[p, c]) * W[t, c, o] )
// where sample_t is the bilinear sample of tap t in f32, from its four
// corners in the order (0,0), (0,1), (1,0), (1,1), each weighted by
// (wy_r * wm) * wx_s (see csrc/dcn_sample.cu, same planes), `round` is to
// W's dtype, and the sum over taps and channels is held in f32. The plain
// twin is ops/dcn.py:fused_reference; the samples are bitwise the twin's,
// the f32 sums run in another order.
//
// It takes the planes (a0, b0 int32; fy, fx, wm f32; (N, H, W, 9) each),
// not the TPU kernel's per-term weights w9 (N, 9, 2d+1, 2d+1, H, W): the
// planes hold 20 bytes a pixel and tap whatever d is, w9 holds 4 (2d+1)^2
// (36 at d = 1, 100 at d = 2), and the four corner weights are three
// multiplies away.
//
// Bound on an H100 SXM: operations. At the slice's largest layer,
// (32, 128, 128, 128) bf16 with O = 128, the product is 2 * 524,288 * 9 *
// 128 * 128 = 154.6 GFLOP (0.156 ms at 989 TFLOP/s on the tensor cores)
// and the sampling about 4.8 GFLOP of f32 (0.072 ms at 67 TFLOP/s on the
// CUDA cores, a separate pipe that can run beside the tensor cores), while
// 0.36 GB moves (input, planes, weights and output once; 0.11 ms at
// 3.35 TB/s). The least time is the largest of the three, 0.156 ms. In
// f32 the product and the sampling share the CUDA cores and add.
//
// Design: one block of 8 warps per tile of 128 output pixels x 128 output
// channels (grid.y walks O in chunks of 128). For each tap: (1) 128 threads
// work out their pixel's four corner indices and weights into shared
// memory; (2) all threads sample the 128 x C tile in f32, each thread
// 16-byte vectors of channels of one pixel (8 bf16 or 4 f32; one value
// where C or the pointer does not allow it), neighbouring threads on
// neighbouring vectors of one corner row, round it to W's dtype and store
// it in shared memory, while W[t][:, chunk] is staged beside it with
// 16-byte loads;
// (3) bf16: each warp multiplies two 16-row strips by four 16-column tiles
// with WMMA (16x16x16 bf16, f32 accumulators held in registers across all
// nine taps); f32: each thread keeps 16 x 4 sums and multiplies on the
// CUDA cores with FMA (no TF32). After the ninth tap the sums are cast once
// and written NHWC. The sampled tap never reaches device memory; a staged
// weight tile serves 128 pixels. Padding rows and channels (C and O rounded
// up to 16) are zeros. At C = O = 128 bf16 a block takes 73.7 KB of shared
// memory and 112-122 registers a thread, so two blocks fit on an SM.
// Loading all four corners of two vectors before any arithmetic (more
// loads in flight) took 166 registers, one block an SM, and 35% more time.
// wgmma, TMA and overlapping the next tap's loads with this tap's product
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "dcn_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 128;       // output channels per block
constexpr int kTaps = 9;
constexpr int kSkew = 8;       // row padding of the shared tiles (bank spread)
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

template <typename T>
__host__ __device__ constexpr int64_t tile_bytes(int c) {
  // sample tile kBM x (Cp + skew), weight tile Cp x (kBN + skew); the f32
  // output tile kBM x (kBN + 4) reuses the same space after the last tap
  const int64_t ab = ((int64_t)kBM * (round16(c) + kSkew) +
                      (int64_t)round16(c) * (kBN + kSkew)) * sizeof(T);
  const int64_t cs = (int64_t)kBM * (kBN + 4) * sizeof(float);
  return ab > cs ? ab : cs;
}

template <typename T>
__host__ __device__ constexpr int64_t smem_bytes(int c) {
  // tiles, then per pixel four corner pixel indices (int32) and weights (f32)
  return tile_bytes<T>(c) + (int64_t)kBM * 4 * (sizeof(int32_t) + sizeof(float));
}

// VX: values of T per load of x (16 bytes, or 1); VW: the same for W.
template <typename T, int VX, int VW>
__global__ void __launch_bounds__(kThreads)
dcn_fused_kernel(const T* __restrict__ x, const int32_t* __restrict__ a0,
                 const int32_t* __restrict__ b0, const float* __restrict__ fy,
                 const float* __restrict__ fx, const float* __restrict__ wm,
                 const T* __restrict__ kernel, T* __restrict__ out, int num_pixels,
                 int h, int w, int c, int o) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = round16(c);
  const int lda = cp + kSkew;
  const int ldb = kBN + kSkew;
  T* s_a = reinterpret_cast<T*>(smem);                    // kBM x lda
  T* s_b = s_a + kBM * lda;                                // cp x ldb
  int32_t* s_pix = reinterpret_cast<int32_t*>(smem + tile_bytes<T>(c));  // kBM x 4
  float* s_wgt = reinterpret_cast<float*>(s_pix + kBM * 4);             // kBM x 4

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int p0 = blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;
  const int ncols = min(kBN, o - o0);
  const int ctiles = (ncols + 15) / 16;

  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  // bf16: warp -> row strips strip0, strip0 + 1 and column tiles col0..col0+3
  // (acc_frag[r * 4 + j]), so each B fragment serves two products
  const int strip0 = (warp % 4) * 2;
  const int col0 = (warp / 4) * 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_frag[8];
  // f32: thread -> rows warp + 8 i, columns lane + 32 j
  float acc[16][4];
  if constexpr (kTensorCores) {
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc_frag[j], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

#pragma unroll 1
  for (int t = 0; t < kTaps; ++t) {
    // (1) corner pixels and weights of each pixel of the tile
    if (tid < kBM) {
      const int pix = p0 + tid;
      if (pix < num_pixels) {
        const int px = pix % w;
        const int py = (pix / w) % h;
        const int img0 = pix - (py * w + px);
        const int64_t q = (int64_t)pix * kTaps + t;
        const int ay = py + __ldg(a0 + q);
        const int bx = px + __ldg(b0 + q);
        const float fyv = __ldg(fy + q);
        const float fxv = __ldg(fx + q);
        const float wmv = __ldg(wm + q);
        const float wy[2] = {__fmul_rn(__fsub_rn(1.0f, fyv), wmv), __fmul_rn(fyv, wmv)};
        const float wx[2] = {__fsub_rn(1.0f, fxv), fxv};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int yy = ay + r, xx = bx + s;
            const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
            s_pix[tid * 4 + r * 2 + s] = inside ? img0 + yy * w + xx : -1;
            s_wgt[tid * 4 + r * 2 + s] = __fmul_rn(wy[r], wx[s]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_pix[tid * 4 + k] = -1;
          s_wgt[tid * 4 + k] = 0.0f;
        }
      }
    }
    // W[t][:, o0:o0+kBN] into s_b, zeros past C and O
    {
      const T* wt = kernel + (int64_t)t * c * o + o0;
      constexpr int kRowVecs = kBN / VW;
      for (int i = tid; i < cp * kRowVecs; i += kThreads) {
        const int ci = i / kRowVecs, n0 = (i - ci * kRowVecs) * VW;
        float v[VW];
        if (ci < c && n0 < ncols) {
          load_vec<T, VW>(wt + (int64_t)ci * o + n0, v);
        } else {
#pragma unroll
          for (int k = 0; k < VW; ++k) v[k] = 0.0f;
        }
        store_vec<T, VW>(s_b + ci * ldb + n0, v);
      }
    }
    __syncthreads();
    // (2) the f32 sample of the tile, rounded to T
    {
      const int row_vecs = cp / VX;
      for (int i = tid; i < kBM * row_vecs; i += kThreads) {
        const int m = i / row_vecs, c0 = (i - m * row_vecs) * VX;
        float samp[VX];
#pragma unroll
        for (int k = 0; k < VX; ++k) samp[k] = 0.0f;
        if (c0 < c) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int src = s_pix[m * 4 + k];
            if (src < 0) continue;                 // a zero corner adds +-0
            const float wgt = s_wgt[m * 4 + k];
            float v[VX];
            load_vec<T, VX>(x + (int64_t)src * c + c0, v);
#pragma unroll
            for (int e = 0; e < VX; ++e) samp[e] = __fadd_rn(samp[e], __fmul_rn(wgt, v[e]));
          }
        }
        store_vec<T, VX>(s_a + m * lda + c0, samp);
      }
    }
    __syncthreads();
    // (3) the product, accumulated in f32 across taps
    if constexpr (kTensorCores) {
      for (int k = 0; k < cp; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a_frag[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          wmma::load_matrix_sync(a_frag[r], s_a + (strip0 + r) * 16 * lda + k, lda);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col0 + j < ctiles) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b_frag;
            wmma::load_matrix_sync(b_frag, s_b + k * ldb + (col0 + j) * 16, ldb);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              wmma::mma_sync(acc_frag[r * 4 + j], a_frag[r], b_frag, acc_frag[r * 4 + j]);
            }
          }
        }
      }
    } else {
      for (int ci = 0; ci < c; ++ci) {
        float av[16], bv[4];
#pragma unroll
        for (int i = 0; i < 16; ++i) av[i] = to_float<T>(s_a[(warp + 8 * i) * lda + ci]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_float<T>(s_b[ci * ldb + lane + 32 * j]);
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // the next tap overwrites s_a, s_b and the corners
  }

  // cast once and write NHWC
  if constexpr (kTensorCores) {
    float* s_c = reinterpret_cast<float*>(smem);  // kBM x (kBN + 4)
    const int ldc = kBN + 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col0 + j < ctiles) {
          wmma::store_matrix_sync(s_c + (strip0 + r) * 16 * ldc + (col0 + j) * 16,
                                  acc_frag[r * 4 + j], ldc, wmma::mem_row_major);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int m = i / kBN, n = i - m * kBN;
      const int pix = p0 + m;
      if (pix < num_pixels && n < ncols) {
        out[(int64_t)pix * o + o0 + n] = from_float<T>(s_c[m * ldc + n]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int pix = p0 + warp + 8 * i;
      if (pix >= num_pixels) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = lane + 32 * j;
        if (n < ncols) out[(int64_t)pix * o + o0 + n] = from_float<T>(acc[i][j]);
      }
    }
  }
}

template <typename T, int VX, int VW>
int launch(const void* x, const void* a0, const void* b0, const void* fy, const void* fx,
           const void* wm, const void* kernel, void* out, int num_pixels, int h, int w,
           int c, int o, cudaStream_t stream) {
  const int64_t bytes = smem_bytes<T>(c);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_fused_kernel<T, VX, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((num_pixels + kBM - 1) / kBM), (unsigned)((o + kBN - 1) / kBN));
  dcn_fused_kernel<T, VX, VW><<<grid, kThreads, (size_t)bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(a0),
      static_cast<const int32_t*>(b0), static_cast<const float*>(fy),
      static_cast<const float*>(fx), static_cast<const float*>(wm),
      static_cast<const T*>(kernel), static_cast<T*>(out), num_pixels, h, w, c, o);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_aligned(const void* x, const void* a0, const void* b0, const void* fy,
                   const void* fx, const void* wm, const void* kernel, void* out,
                   int num_pixels, int h, int w, int c, int o, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vx = reinterpret_cast<uintptr_t>(x) % 16 == 0 && c % kVec == 0;
  const bool vw = reinterpret_cast<uintptr_t>(kernel) % 16 == 0 && o % kVec == 0;
  if (vx && vw) return launch<T, kVec, kVec>(x, a0, b0, fy, fx, wm, kernel, out, num_pixels, h, w, c, o, stream);
  if (vx) return launch<T, kVec, 1>(x, a0, b0, fy, fx, wm, kernel, out, num_pixels, h, w, c, o, stream);
  if (vw) return launch<T, 1, kVec>(x, a0, b0, fy, fx, wm, kernel, out, num_pixels, h, w, c, o, stream);
  return launch<T, 1, 1>(x, a0, b0, fy, fx, wm, kernel, out, num_pixels, h, w, c, o, stream);
}

}  // namespace

// x: (N, H, W, C) contiguous, bf16 (is_bf16 = 1) or f32, N*H*W < 2^31;
// a0, b0 int32 and fy, fx, wm f32, each (N, H, W, 9) contiguous; kernel:
// (9, C, O) in x's dtype; out: (N, H, W, O) in x's dtype. Launches on
// `stream`; returns the launch's CUDA error (cudaErrorInvalidValue when C
// is too wide or the map too large).
extern "C" int dcn_fused_launch(const void* x, const void* a0, const void* b0,
                                const void* fy, const void* fx, const void* wm,
                                const void* kernel, void* out, int n, int h, int w, int c,
                                int o, int is_bf16, void* stream) {
  const int64_t num_pixels = (int64_t)n * h * w;
  if (num_pixels <= 0 || num_pixels > INT_MAX || c <= 0 || o <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int p = (int)num_pixels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_aligned<__nv_bfloat16>(x, a0, b0, fy, fx, wm, kernel, out, p, h, w, c, o, s);
  }
  return launch_aligned<float>(x, a0, b0, fy, fx, wm, kernel, out, p, h, w, c, o, s);
}
