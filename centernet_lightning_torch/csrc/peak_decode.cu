// Fused pseudo-NMS + class max/argmax over an NHWC heatmap, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel centernet_lightning_tpu/ops/pallas_decode.py:
// peak_class_scores_pallas (the _peak_kernel / _peak_kernel_nhwc programs).
//
// What it computes, for every pixel p = (n, y, x) of an (N, H, W, C) map:
//   m[c]      = max of the 3x3 window around p in class plane c, where an
//               out-of-image neighbour counts as `neutral` (0 for
//               probabilities, -1e30 for logits); a NaN anywhere in the
//               window makes m[c] NaN, as F.max_pool2d and reduce_window do
//   masked[c] = heat[p, c] if heat[p, c] == m[c] else neutral
//   score[p]  = max_c masked[c]      (f32)
//   label[p]  = lowest c with masked[c] == score[p]
// So a class whose window holds a NaN scores the neutral. Comparisons are
// in f32; a max selects one of its inputs and a bf16 value widens exactly,
// so the result is bitwise the plain PyTorch twin's (ops/peak_decode.py).
//
// Bound on an H100 SXM: memory. The map is read once and (N, H*W) f32 scores
// and int32 labels are written once: at (64, 128, 128, 80) bf16 that is
// 167.8 MB + 8.4 MB, 52.6 us at 3.35 TB/s. The arithmetic, about ten f32
// operations a class value, is far below the card's rates.
//
// Design: a row-streaming kernel. A block owns a strip of `strip` output
// columns of one image and a band of `band` output rows, and walks the
// band's input rows (one halo row above and below) top to bottom. Each
// input row of the strip, with its two halo columns, is one contiguous
// span of NHWC memory: one thread fetches it with one cp.async.bulk (the
// TMA's 1-D copy, completing on an mbarrier) into a ring of `stages` row
// buffers in shared memory, stages - 3 rows ahead of the row being read,
// so each byte crosses L2 about (1 + 2/strip)(1 + 2/band) times. Each warp
// releases a row (one arrival on the stage's mbarrier) a row after reading
// it, since the next row's output reads its centre values there again. A span
// that does not start or end on 16 bytes (an odd C, a misaligned pointer)
// is copied from the 16-byte boundary below its start to the one above
// its end; those extra bytes lie in the 16-byte blocks of the span's own
// first and last bytes, so inside the allocation (CUDA allocations are
// 256-byte aligned), and are never read.
//
// `lanes` neighbouring threads of a warp share a pixel; each holds `items`
// class vectors (16 bytes: 8 bf16 or 4 f32, or one value where the map is
// not 16-byte aligned). Per staged row a thread reads its vectors at x-1,
// x and x+1 from shared memory and takes their horizontal max once; the
// vertical max of three rows then comes from the two previous horizontal
// maxes kept in registers (separable: 4 maxes a value, not 8). The older
// of the two is overwritten by the new row's, the two arrays swapping
// roles (the walk is unrolled by two). The maxes run on packed bf16x2 or
// f32 with PTX's NaN-propagating max.NaN; an edge row or column is
// replaced by a copy of the row or column inside it, which leaves the max
// unchanged, and the neutral joins the max only at image borders, in f32
// (bf16 cannot hold -1e30). Each thread then keeps a running (score,
// class) over its vectors in f32 with a strict > (the lowest class wins a
// tie); the pixel's lanes combine with xor shuffles, lower class first on
// equal scores, and the warp writes its pixels' scores and labels to
// consecutive addresses.
// Classes beyond what a pass's registers hold (over 32 lanes x 4 vectors:
// 1024 bf16 or 512 f32 classes; 512 with one-value loads) run as several
// passes over the band, each staging one class chunk of every pixel with
// one bulk copy a pixel, the running best kept in the outputs between
// passes.
//
// The launch plan (strip, band, stages, lanes, items, class chunk) comes
// from the wrapper (ops/peak_decode.py:launch_plan, cached a shape), which
// the CPU tests hold to cover every pixel and class once within the
// shared memory.
//
// The build caps a thread at 64 registers, so that 4 blocks of 256 threads
// share an SM (32 warps); at 3 vectors a lane it spills a few bytes.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, `times`):
// 0.103 ms at (64, 128, 128, 80) bf16 logits, 0.51 of the 52.6 us bound
// (the earlier design, 16-byte loads of all nine neighbours through L1:
// 0.267 ms). The SMs' work binds it, not the bytes: 8 images (64 blocks,
// one an SM, on 21 MB in L2) still take 0.053 ms, about 1.6 us a row step
// for one block alone. Timed before band, ring depth and strip cap became
// constants of the plan (PERF.md), fewer or larger blocks (bands of 64
// rows, a deeper ring) ran slower. The f32 argmax, about 7 operations a class
// value, is most of a row step's instructions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;       // blocks of 256 an SM: 64 registers a thread
constexpr int kSmemLimit = 232448;  // 227 KB of dynamic shared memory a block
constexpr int kAlign = 128;         // ring buffers start on 128 bytes

// The plan as ops/peak_decode.py:launch_plan lays it out
// (pitch: the bytes a pixel's staged class chunk takes when passes > 1)
struct Plan {
  int vec, lanes, items, chunk, passes, strip, band, stages, pitch, stage_bytes;
};

// Per instantiation: 32-bit words of a class vector held in registers
template <typename T, int VEC>
struct Traits {
  static constexpr bool kPacked = std::is_same<T, __nv_bfloat16>::value && VEC == 8;
  static constexpr int kWords = VEC == 1 ? 1 : 4;
};
constexpr int kMaxItems = 4;        // vectors a lane holds, 16-byte loads
constexpr int kScalarItems = 16;    // values a lane holds, one-value loads

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t max_nan_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// words of the max: packed bf16 pairs, or f32 bits
template <bool PACKED>
__device__ __forceinline__ uint32_t wmax(uint32_t a, uint32_t b) {
  if constexpr (PACKED) {
    return max_nan_bf16x2(a, b);
  } else {
    return __float_as_uint(max_nan(__uint_as_float(a), __uint_as_float(b)));
  }
}

// one class vector from shared memory as register words: a 16-byte load, or
// one value widened to f32 bits
template <typename T, int VEC>
__device__ __forceinline__ void load_words(const unsigned char* p,
                                           uint32_t (&out)[Traits<T, VEC>::kWords]) {
  if constexpr (VEC == 1) {
    if constexpr (std::is_same<T, float>::value) {
      out[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      out[0] = (uint32_t)(*reinterpret_cast<const unsigned short*>(p)) << 16;
    }
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  }
}

// value e of a vector's words, as f32
template <typename T, int VEC>
__device__ __forceinline__ float value_of(const uint32_t* words, int e) {
  if constexpr (Traits<T, VEC>::kPacked) {  // little endian: low half first
    const uint32_t u = words[e >> 1];
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
  } else {
    return __uint_as_float(words[e]);
  }
}

// (a, ac) becomes the better of (a, ac) and (b, bc): the larger score, the
// lower class on equal scores
__device__ __forceinline__ void better(float& a, int& ac, float b, int bc) {
  if (b > a || (b == a && bc < ac)) {
    a = b;
    ac = bc;
  }
}

// The running (best, best_c) over one vector's classes k, k + 1, ...: the
// value where it equals its window's max `win` (the neutral joins the window
// at the image's borders), else the neutral; strict >, so the first class
// keeps a tie
template <typename T, int VEC>
__device__ __forceinline__ void window_best(const uint32_t* win, const uint32_t* cen,
                                            float neutral, bool border, int k, float& best,
                                            int& best_c) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float mx = value_of<T, VEC>(win, e);
    const float v = value_of<T, VEC>(cen, e);
    if (border) mx = max_nan(mx, neutral);
    const float masked = (mx == v) ? v : neutral;
    if (masked > best) {
      best = masked;
      best_c = k + e;
    }
  }
}

// ITEMS: the vectors a lane holds, exactly (16-byte loads), or at most
// (one-value loads: plan.items of them)
template <typename T, int VEC, int ITEMS>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    peak_rows_kernel(const T* __restrict__ heat, float* __restrict__ scores,
                     int32_t* __restrict__ labels, const Plan plan, int h, int w, int c,
                     float neutral) {
  using Tr = Traits<T, VEC>;
  constexpr int kW = Tr::kWords;
  constexpr int kElt = sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((kAlign - smem_addr(smem_raw) % kAlign) % kAlign);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + plan.stages * plan.stage_bytes);
  uint64_t* empty = full + plan.stages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid / plan.lanes;            // the pixel's column in the strip
  const int li = tid - g * plan.lanes;       // this thread's rank in its pixel

  // block -> (image, strip, band), the band fastest so that neighbouring
  // bands, which share halo rows, run together
  const int nbands = (h + plan.band - 1) / plan.band;
  const int nstrips = (w + plan.strip - 1) / plan.strip;
  const int band = blockIdx.x % nbands;
  const int strip = (blockIdx.x / nbands) % nstrips;
  const int img = blockIdx.x / (nbands * nstrips);
  const int y0 = band * plan.band;
  const int y1 = min(y0 + plan.band, h);
  const int x0 = strip * plan.strip;
  const int xa = max(x0 - 1, 0);                 // first staged column
  const int ncols = min(x0 + plan.strip, w - 1) - xa + 1;
  const int nrows = y1 - y0 + 2;                 // input rows y0 - 1 .. y1
  const int total = plan.passes * nrows;

  const int x = x0 + g;
  const int xc = min(x, w - 1);                  // past the map: a copy, unused
  const int js[3] = {max(xc - 1, 0) - xa, xc - xa, min(xc + 1, w - 1) - xa};
  const bool border_x = x == 0 || x == w - 1;
  const char* base = reinterpret_cast<const char*>(heat);
  const int64_t img_pix = (int64_t)img * h * w;
  // the three columns' staged offsets, before a one-value load's 0-15 byte
  // shift (16-byte loads have none: their spans start on 16 bytes)
  int col0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) col0[k] = js[k] * (plan.passes == 1 ? c * kElt : plan.pitch);

  if (tid == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], blockDim.x >> 5);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the first pixel of input row t (an edge row stands in for the missing
  // row beyond it), and the global byte address of (staged column j, class k)
  auto row_pixel = [&](int t) {
    return img_pix + (int64_t)min(max(y0 - 1 + t, 0), h - 1) * w + xa;
  };
  auto gaddr = [&](int64_t pix0, int j, int k) {
    return reinterpret_cast<uintptr_t>(base + ((pix0 + j) * c + k) * kElt);
  };
  auto issue = [&](int q) {  // one thread: stage row q of the walk
    const int s = q % plan.stages;
    if (q >= plan.stages) mbar_wait(&empty[s], ((q / plan.stages) - 1) & 1);
    unsigned char* dst = ring + s * plan.stage_bytes;
    const int64_t pix0 = row_pixel(q % nrows);
    if (plan.passes == 1) {
      const uintptr_t a = gaddr(pix0, 0, 0) & ~(uintptr_t)15;
      const uintptr_t b = (gaddr(pix0, ncols, 0) + 15) & ~(uintptr_t)15;
      mbar_arrive_expect_tx(&full[s], (uint32_t)(b - a));
      bulk_copy(dst, reinterpret_cast<const void*>(a), (uint32_t)(b - a), &full[s]);
    } else {
      const int c0 = (q / nrows) * plan.chunk;
      const int cn = min(plan.chunk, c - c0);
      uint32_t bytes = 0;
      for (int j = 0; j < ncols; ++j) {
        const uintptr_t a = gaddr(pix0, j, c0) & ~(uintptr_t)15;
        bytes += (uint32_t)(((gaddr(pix0, j, c0 + cn) + 15) & ~(uintptr_t)15) - a);
      }
      mbar_arrive_expect_tx(&full[s], bytes);
      for (int j = 0; j < ncols; ++j) {
        const uintptr_t a = gaddr(pix0, j, c0) & ~(uintptr_t)15;
        const uintptr_t b = (gaddr(pix0, j, c0 + cn) + 15) & ~(uintptr_t)15;
        bulk_copy(dst + j * plan.pitch, reinterpret_cast<const void*>(a), (uint32_t)(b - a),
                  &full[s]);
      }
    }
  };

  if (tid == 0) {  // rows are staged stages - 3 ahead of the row being read
    for (int q = 0; q < min(plan.stages - 3, total); ++q) issue(q);
  }

  // Per vector, the horizontal maxes of the last two rows stay in registers:
  // the older one is overwritten with each new row's, so the two arrays swap
  // roles from row to row (the walk is unrolled by two). The centre row's
  // values are read again from its staged row: the ring releases a row one
  // row after it is read.
  uint32_t hm_a[ITEMS][kW], hm_b[ITEMS][kW];
  int t = 0, pass = 0, s = 0, s_prev = 0, centre_col = 0;
  uint32_t lap = 0;  // the parity of the ring's round
  auto step = [&](int q, uint32_t(&older)[ITEMS][kW], const uint32_t(&newer)[ITEMS][kW]) {
    if (tid == 0 && q + plan.stages - 3 < total) issue(q + plan.stages - 3);
    const int c0 = pass * plan.chunk;
    const int cn = min(plan.chunk, c - c0);
    const unsigned char* row = ring + s * plan.stage_bytes;
    const unsigned char* centre_row = ring + s_prev * plan.stage_bytes + centre_col;
    int col[3] = {col0[0], col0[1], col0[2]};
    if constexpr (VEC == 1) {
      const int64_t pix0 = row_pixel(t);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        col[k] += (int)(gaddr(pix0, plan.passes == 1 ? 0 : js[k], c0) & 15);
      }
    }
    const bool out_row = t >= 2;
    const int y = y0 + t - 2;                    // the output row, when t >= 2
    const bool border = border_x || y == 0 || y == h - 1;
    float best = -INFINITY;
    int best_c = c0 + li * VEC;  // all values -inf: the lane's first class

    mbar_wait(&full[s], lap);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int k0 = (li + i * plan.lanes) * VEC;  // class within the chunk
      if (i >= plan.items || k0 >= cn) continue;
      uint32_t l[kW], m[kW], r[kW], hm[kW];
      load_words<T, VEC>(row + col[0] + k0 * kElt, l);
      load_words<T, VEC>(row + col[1] + k0 * kElt, m);
      load_words<T, VEC>(row + col[2] + k0 * kElt, r);
#pragma unroll
      for (int u = 0; u < kW; ++u) hm[u] = wmax<Tr::kPacked>(wmax<Tr::kPacked>(l[u], m[u]), r[u]);
      if (out_row) {
        uint32_t win[kW], cen[kW];
        load_words<T, VEC>(centre_row + k0 * kElt, cen);
#pragma unroll
        for (int u = 0; u < kW; ++u) {
          win[u] = wmax<Tr::kPacked>(wmax<Tr::kPacked>(older[i][u], newer[i][u]), hm[u]);
        }
        window_best<T, VEC>(win, cen, neutral, border, c0 + k0, best, best_c);
      }
#pragma unroll
      for (int u = 0; u < kW; ++u) older[i][u] = hm[u];
    }
    __syncwarp();
    if (lane == 0 && q > 0) mbar_arrive(&empty[s_prev]);  // the row before: read
    centre_col = col[1];
    s_prev = s;
    if (++s == plan.stages) {
      s = 0;
      lap ^= 1;
    }
    if (++t == nrows) {
      t = 0;
      ++pass;
    }
    if (!out_row) return;

    for (int off = plan.lanes >> 1; off > 0; off >>= 1) {
      better(best, best_c, __shfl_xor_sync(0xffffffffu, best, off),
             __shfl_xor_sync(0xffffffffu, best_c, off));
    }
    // lane k of the warp writes the warp's k-th pixel: consecutive addresses
    const int per_warp = 32 / plan.lanes;
    const float b = __shfl_sync(0xffffffffu, best, lane * plan.lanes);
    const int bc = __shfl_sync(0xffffffffu, best_c, lane * plan.lanes);
    const int xo = x0 + (tid >> 5) * per_warp + lane;
    if (lane < per_warp && xo < min(x0 + plan.strip, w)) {
      const int64_t o = img_pix + (int64_t)y * w + xo;
      float sb = b;
      int sc = bc;
      if (c0 > 0) {  // earlier passes hold lower classes: they keep a tie
        const float prev = scores[o];
        if (!(sb > prev)) {
          sb = prev;
          sc = labels[o];
        }
      }
      scores[o] = sb;
      labels[o] = sc;
    }
  };
  for (int q = 0; q < total; q += 2) {
    step(q, hm_a, hm_b);
    if (q + 1 < total) step(q + 1, hm_b, hm_a);
  }
}

template <typename T, int VEC, int ITEMS>
int launch(const void* heat, void* scores, void* labels, const Plan& p, int n, int h,
           int w, int c, float neutral, cudaStream_t stream) {
  const int smem = p.stages * p.stage_bytes + 2 * p.stages * 8 + kAlign;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      peak_rows_kernel<T, VEC, ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)n * ((w + p.strip - 1) / p.strip) *
                         ((h + p.band - 1) / p.band);
  peak_rows_kernel<T, VEC, ITEMS><<<(unsigned)blocks, p.strip * p.lanes, smem, stream>>>(
      static_cast<const T*>(heat), static_cast<float*>(scores),
      static_cast<int32_t*>(labels), p, h, w, c, neutral);
  return (int)cudaGetLastError();
}

// the instantiation for a plan: 16-byte loads of exactly p.items vectors,
// or one-value loads
template <typename T, int VEC>
int dispatch(const void* heat, void* scores, void* labels, const Plan& p, int n, int h,
             int w, int c, float neutral, cudaStream_t s) {
  if (p.vec == 1) {
    return launch<T, 1, kScalarItems>(heat, scores, labels, p, n, h, w, c, neutral, s);
  }
  switch (p.items) {
    case 1: return launch<T, VEC, 1>(heat, scores, labels, p, n, h, w, c, neutral, s);
    case 2: return launch<T, VEC, 2>(heat, scores, labels, p, n, h, w, c, neutral, s);
    case 3: return launch<T, VEC, 3>(heat, scores, labels, p, n, h, w, c, neutral, s);
    default: return launch<T, VEC, 4>(heat, scores, labels, p, n, h, w, c, neutral, s);
  }
}

template <typename T, int VEC>
cudaError_t attributes(const Plan& p, cudaFuncAttributes* attr) {
  if (p.vec == 1) return cudaFuncGetAttributes(attr, peak_rows_kernel<T, 1, kScalarItems>);
  switch (p.items) {
    case 1: return cudaFuncGetAttributes(attr, peak_rows_kernel<T, VEC, 1>);
    case 2: return cudaFuncGetAttributes(attr, peak_rows_kernel<T, VEC, 2>);
    case 3: return cudaFuncGetAttributes(attr, peak_rows_kernel<T, VEC, 3>);
    default: return cudaFuncGetAttributes(attr, peak_rows_kernel<T, VEC, 4>);
  }
}

bool plan_ok(const Plan& p, int c, int elt, bool aligned) {
  const bool lanes_ok = p.lanes > 0 && p.lanes <= 32 && (p.lanes & (p.lanes - 1)) == 0;
  const int threads = p.strip * p.lanes;
  const bool vec_ok = p.vec == 1 || (aligned && p.vec * elt == 16 && c % p.vec == 0);
  const int64_t row = p.passes == 1 ? (int64_t)(p.strip + 2) * c * elt + 32
                                    : (int64_t)(p.strip + 2) * p.pitch;
  const bool pitch_ok = p.passes == 1 || (p.pitch % 16 == 0 && p.pitch >= p.chunk * elt + 32);
  const int most = p.vec == 1 ? kScalarItems : kMaxItems;
  return lanes_ok && vec_ok && pitch_ok && p.items > 0 && p.items <= most && p.strip > 0 &&
         threads % 32 == 0 && threads <= kMaxThreads && p.band > 0 && p.stages >= 4 &&
         p.stage_bytes % kAlign == 0 && p.stage_bytes >= row && p.chunk > 0 &&
         p.passes == (c + p.chunk - 1) / p.chunk &&
         (int64_t)p.lanes * p.items * p.vec >= p.chunk;
}

}  // namespace

// heat: (N, H, W, C) contiguous, bf16 (is_bf16 = 1) or f32; scores f32 and
// labels int32, each (N, H*W), N*H*W < 2^31; plan: the ten ints of
// ops/peak_decode.py:launch_plan, in struct Plan's order. Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for an empty map or
// a plan that does not fit the map or the kernel.
extern "C" int peak_class_scores_launch(const void* heat, void* scores, void* labels,
                                        int n, int h, int w, int c, int is_bf16,
                                        float neutral, const int* plan, void* stream) {
  const int64_t num_pixels = (int64_t)n * h * w;
  if (num_pixels <= 0 || num_pixels > INT_MAX || c <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4],
               plan[5], plan[6], plan[7], plan[8], plan[9]};
  const int elt = is_bf16 ? 2 : 4;
  const bool aligned = reinterpret_cast<uintptr_t>(heat) % 16 == 0 && (c * elt) % 16 == 0;
  if (!plan_ok(p, c, elt, aligned)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16, 8>(heat, scores, labels, p, n, h, w, c, neutral, s);
  return dispatch<float, 4>(heat, scores, labels, p, n, h, w, c, neutral, s);
}

// The build of the kernel that `plan` (the ten ints of launch_plan) takes:
// out[0] registers a thread, out[1] local (spilled) bytes a thread, out[2]
// static shared bytes, out[3] the most threads a block. Returns a CUDA error.
extern "C" int peak_class_scores_info(int is_bf16, const int* plan, int* out) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4],
               plan[5], plan[6], plan[7], plan[8], plan[9]};
  cudaFuncAttributes attr;
  const cudaError_t err = is_bf16 ? attributes<__nv_bfloat16, 8>(p, &attr)
                                  : attributes<float, 4>(p, &attr);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = attr.maxThreadsPerBlock;
  return 0;
}
