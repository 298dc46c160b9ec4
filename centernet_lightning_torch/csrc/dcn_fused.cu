// Fused deformable convolution: tap sampling and the per-tap matrix product
// in one kernel, over an NHWC map, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel centernet_lightning_tpu/ops/pallas_dcn.py:
// dcn_fused_conv (pallas_dcn.py:332, the _fused_kernel program).
//
// What it computes, for every pixel p = (n, y, x) and output channel o:
//   out[p, o] = cast( sum_t sum_c round(sample_t[p, c]) * W[t, c, o] )
// where sample_t is the bilinear sample of tap t in f32, from its four
// corners in the order (0,0), (0,1), (1,0), (1,1), each weighted by
// (wy_r * wm) * wx_s (see csrc/dcn_sample.cu, same planes), `round` is to
// W's dtype, and the sum over taps and channels is held in f32. The plain
// twin is ops/dcn.py:fused_reference; the samples are bitwise the twin's
// (__fmul_rn / __fadd_rn, no contraction), the f32 sums run in another
// order.
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
// bf16 design (dcn_fused_tc): one block of five warpgroups (640 threads,
// 96 registers each, one block an SM) per tile of 128 output pixels x 128
// output channels (grid.y walks O in tiles of 128). The work is a
// pipeline of steps, one per (64-channel chunk kc, tap t), chunk-major so
// that a chunk's corners stay in L1 across the nine taps, through a ring
// of 3 stages in shared memory, each an A tile (128 pixels x 64 channels)
// and a W tile (128 outputs x 64 channels), 16 KB each.
//  - Corners: at the tile's start the producers work out the four corners
//    and weights of every pixel and tap once (a 36 KB table; plane loads
//    coalesced, all in flight together), so a step reads its pixels'
//    corners from shared memory and issues every one of its corner loads
//    before any arithmetic.
//  - Producers (warpgroups 2-4, 384 threads, eight a pixel, one 16-byte
//    channel vector each, so a warp reads four whole 128-byte corner rows):
//    sample in f32, round to bf16 and write the vector straight into the
//    128-byte-swizzled K-major layout that the wgmma descriptor names
//    (16-byte group g of row m at g ^ (m % 8)). A thread takes rows m0,
//    m0 + 48 (and m0 + 96), m0 turning a step so that each does 8 rows in
//    3 steps. One thread first starts the W tile's cp.async.bulk (16 KB,
//    completing on the stage's "full" mbarrier with expect_tx); all fence
//    their generic-proxy writes for the async proxy and arrive on "full"
//    (one arrival a warp after __syncwarp measured slower).
//  - Consumers (warpgroups 0-1, 64 rows each): wait on "full", issue four
//    wgmma.mma_async m64n128k16 (bf16 in, f32 accumulators held in 64
//    registers a thread across all steps), commit, wait until only this
//    step's group is in flight, and release the previous step's stage
//    (one arrival a warp on its "empty" mbarrier). So the sampling of the
//    next steps runs on the CUDA cores and load units while this step's
//    product runs on the tensor cores.
//  - W arrives as cp.async.bulk copies of tiles laid out once a call by
//    pack_w_kernel below ((kc, t, O tile) blocks of 128 x 64, K-major,
//    zero-padded, already swizzled), so no thread loads W. A W tile serves
//    128 pixels: 288 KB of L2 reads a tile at C = O = 128, 1.2 GB at the
//    s4 layer. An earlier build that shared each tile between the two
//    blocks of a cluster by multicast ran slower on the card: W traffic
//    does not bind.
//    Keeping W resident would need 147 KB for one 64-wide O half, with
//    the sampling done twice; 256-pixel tiles would need 128 accumulators
//    a consumer thread.
//  - The corners come from L1 (__ldg gathers). A second source, a band of
//    input rows (y - d - 1 to y + d + 1 of the tile's rows) staged per
//    chunk in shared memory with cp.async, was built, measured slower at
//    every layer on an H100 (PERF.md has both times) and removed: a
//    sample's corners repeat across neighbouring pixels and taps, and L1
//    serves them (with every corner an L1 hit the kernel was barely
//    faster).
//  - Epilogue: the consumers cast their sums once to bf16 pairs, stage
//    the 128 x 128 tile in shared memory and write it NHWC with 16-byte
//    stores (one value a store where O is not a multiple of 8).
//  - Registers: 640 threads at 96 registers fill the SM; the consumers
//    need 64 accumulators, the producers about as many for 12 loads in
//    flight. setmaxnreg is not used: with a 512-thread block this
//    toolchain kept one 128-register limit (spills, serialized wgmma)
//    when asked to give a 128-row consumer warpgroup 224.
//  - Any C: channels stream in chunks of 64, ragged C zero-padded in both
//    tiles (A rows past C are written as zeros, W's by the re-layout);
//    O is padded to 128. Small maps: the s16 layer, (32, 32, 32, 128),
//    has 256 tiles, two waves at 97% on 132 SMs.
// What this does about the earlier WMMA design (2.42 ms at the s4 layer on
// an H100 80GB HBM3, 700 W): its phases (corners, W staging, gather,
// product) ran one after another between __syncthreads, now producers and
// consumers overlap through mbarriers; its legacy 16x16x16 WMMA reloaded
// fragments from shared memory, now wgmma reads both operands through
// descriptors; its W came through plain 16-byte loads each tap, now through
// cp.async.bulk; its two 8-warp blocks an SM hid little gather latency, now
// twelve producer warps an SM do nothing but sample, with the tensor cores
// busy beside them; its epilogue stored one value a thread, now 16 bytes.
// What binds it now: the producers' L1 gathers and f32 sampling; the
// product hides under them (see PERF.md).
//
// f32 design (dcn_fused_fma, unchanged from the first port): one block of 8
// warps per 128 x 128 tile; per tap, corners into shared memory, the f32
// sample tile and W[t] staged with 16-byte loads, then each thread keeps
// 16 x 4 sums on the CUDA cores with FMA (no TF32). C is bounded by shared
// memory (208 channels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "dcn_common.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kMaxSmem = 232448;

// ---- shared helpers -------------------------------------------------------

// A pixel's four corners for one tap, in the order (0,0), (0,1), (1,0),
// (1,1): flat pixel index (-1 outside the image) and weight
// (wy_r * wm) * wx_s.
struct __align__(16) Corners {
  int src[4];
  float wgt[4];
};

// The corners of flat pixel `pix` for tap t, from the planes; none (every
// src -1) for a pixel past `num_pixels`.
__device__ __forceinline__ Corners pixel_corners(const int32_t* __restrict__ a0,
                                                 const int32_t* __restrict__ b0,
                                                 const float* __restrict__ fy,
                                                 const float* __restrict__ fx,
                                                 const float* __restrict__ wm, int pix, int t,
                                                 int num_pixels, int h, int w) {
  Corners k;
  const bool valid = pix < num_pixels;
  const int px = pix % w, py = (pix / w) % h;
  const int img0 = pix - (py * w + px);
  const int64_t q = (int64_t)pix * kTaps + t;
  const int ay = py + (valid ? __ldg(a0 + q) : 0);
  const int bx = px + (valid ? __ldg(b0 + q) : 0);
  const float fyv = valid ? __ldg(fy + q) : 0.0f;
  const float fxv = valid ? __ldg(fx + q) : 0.0f;
  const float wmv = valid ? __ldg(wm + q) : 0.0f;
  const float wy[2] = {__fmul_rn(__fsub_rn(1.0f, fyv), wmv), __fmul_rn(fyv, wmv)};
  const float wx[2] = {__fsub_rn(1.0f, fxv), fxv};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int yy = ay + r, xx = bx + s;
      const bool inside = valid && yy >= 0 && yy < h && xx >= 0 && xx < w;
      k.src[r * 2 + s] = inside ? img0 + yy * w + xx : -1;
      k.wgt[r * 2 + s] = __fmul_rn(wy[r], wx[s]);
    }
  }
  return k;
}

// eight bf16 (one uint4) as floats; the lower address is the low half
__device__ __forceinline__ void unpack8(const uint4 u, float (&v)[8]) {
  const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// ---- PTX: proxy fence, named barriers, wgmma (bulk copies: bulk_copy.cuh) --

// generic-proxy writes to shared memory made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, rows of 128
// bytes in 8-row atoms 1024 bytes apart (SBO = 64 x 16 B; LBO unused, 1).
// The tile base is 1024-byte aligned; a k-step of 16 values adds 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128 f32 across the warpgroup) += A (64 x 16, desc_a) @ B (16 x 128, desc_b)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---- bf16: the wgmma kernel -----------------------------------------------

constexpr int kBM = 128;                 // output pixels per block
constexpr int kBN = 128;                 // output channels per block (the wgmma N)
constexpr int kBK = 64;                  // channels per chunk: one 128-byte swizzle row
constexpr int kConsumerThreads = 256;    // warpgroups 0-1: rows 0-63 and 64-127
constexpr int kProducerThreads = 384;    // warpgroups 2-4
constexpr int kTcThreads = kConsumerThreads + kProducerThreads;  // 96 registers a thread
constexpr int kSlots = kProducerThreads / 8;  // pixels a producer pass covers (8 threads a pixel)
constexpr int kRotate = kSlots - kBM % kSlots;  // 16: see the producers' rows
constexpr int kTileBytes = kBM * kBK * 2;  // 16 KB; the W tile kBN x kBK is as large
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kStages = 3;               // 4 measured no faster
constexpr int kOutLd = kBN + 8;          // bf16 a row of the staged output tile
constexpr int kAlign = 1024;             // the 128-byte swizzle's atom
static_assert(kBN * kBK * 2 == kTileBytes, "A and W tiles share a size");
static_assert(kBM * kOutLd * 2 <= 2 * kStageBytes, "the output tile fits the stages");

constexpr int kTableBytes = kTaps * kBM * (int)sizeof(Corners);  // every tap's, 36 KB
constexpr int kTcSmemBytes = kAlign + kStages * kStageBytes + kTableBytes +
                             2 * kStages * (int)sizeof(uint64_t);
static_assert(kTcSmemBytes <= kMaxSmem, "the stages and the table fit one block");

struct TcArgs {
  const __nv_bfloat16* x;
  const int32_t* a0;
  const int32_t* b0;
  const float* fy;
  const float* fx;
  const float* wm;
  const __nv_bfloat16* wpack;  // (kchunks, 9, otiles, kBN, kBK), swizzled
  __nv_bfloat16* out;
  int num_pixels, h, w, c, o;
  int kchunks, otiles;
};

// Eight bf16 channels [ch0, ch0 + 8) of flat pixel `src` from x, zeros past
// C (one 16-byte load when kVec).
template <bool kVec>
__device__ __forceinline__ uint4 corner8(const TcArgs& a, int src, int ch0) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(a.x + (int64_t)src * a.c + ch0));
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(a.x + (int64_t)src * a.c + ch0);
  unsigned words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = ch0 + 2 * i < a.c ? p[2 * i] : 0u;
    const unsigned hi = ch0 + 2 * i + 1 < a.c ? p[2 * i + 1] : 0u;
    words[i] = lo | (hi << 16);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// The thread's pixels' eight channels of the chunk (rows m0 + kSlots j of
// the tile), sampled in f32 from their corners and rounded to bf16, written
// to the swizzled A tile. Every corner load of the step is issued before
// any arithmetic, so the step waits on one load latency.
template <bool kVec>
__device__ __forceinline__ void sample_rows(const TcArgs& a, const Corners* tab, int ch0, int g,
                                            int m0, unsigned char* tile_a) {
  constexpr int kRows = (kBM + kSlots - 1) / kSlots;
  uint4 raw[kRows][4];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int m = m0 + kSlots * j;
    if (m >= kBM) continue;
    const int4 src = *reinterpret_cast<const int4*>(tab[m].src);
    const int s4[4] = {src.x, src.y, src.z, src.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (s4[k] >= 0) {
        raw[j][k] = corner8<kVec>(a, s4[k], ch0);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int m = m0 + kSlots * j;
    if (m >= kBM) continue;
    const int4 src = *reinterpret_cast<const int4*>(tab[m].src);
    const float4 wgt = *reinterpret_cast<const float4*>(tab[m].wgt);
    const int s4[4] = {src.x, src.y, src.z, src.w};
    const float w4[4] = {wgt.x, wgt.y, wgt.z, wgt.w};
    float samp[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) samp[e] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (s4[k] < 0) continue;  // a zero corner adds +-0
      float v[8];
      unpack8(raw[j][k], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) samp[e] = __fadd_rn(samp[e], __fmul_rn(w4[k], v[e]));
    }
    *reinterpret_cast<uint4*>(tile_a + m * (kBK * 2) + ((g ^ (m & 7)) << 4)) = pack8(samp);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kTcThreads, 1) dcn_fused_tc(const TcArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAlign - smem_addr(smem_raw) % kAlign) % kAlign);
  Corners* table = reinterpret_cast<Corners*>(smem + kStages * kStageBytes);  // [9][kBM]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + kTableBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kBM;
  const int steps = a.kchunks * kTaps;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducerThreads);
      mbar_init(&empty[s], kConsumerThreads / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ==== producers: corners, samples into the A tiles, the W copies ====
    const int pt = tid - kConsumerThreads;
    const int g = pt & 7;      // 16-byte group of the chunk: channels 8g .. 8g + 7
    const int slot = pt >> 3;
    // the corners of every tap for the tile's pixels, once: entry t kBM + m
#pragma unroll
    for (int e = pt; e < kTaps * kBM; e += kProducerThreads) {
      table[e] = pixel_corners(a.a0, a.b0, a.fy, a.fx, a.wm, p0 + e % kBM, e / kBM,
                               a.num_pixels, a.h, a.w);
    }
    named_sync(2, kProducerThreads);
    int stage = 0;
    uint32_t phase = 0;
    for (int step = 0; step < steps; ++step) {
      const int kc = step / kTaps, t = step - kc * kTaps;
      mbar_wait(&empty[stage], phase ^ 1);
      unsigned char* tile_a = smem + stage * kStageBytes;
      if (pt == 0) {
        const int64_t block = ((int64_t)step * a.otiles + blockIdx.y) * (kBN * kBK);
        bulk_copy(tile_a + kTileBytes, a.wpack + block, kTileBytes, &full[stage]);
      }
      const int ch0 = kc * kBK + g * 8;
      // rows m0 + kSlots j: the first row turns by kRotate a step, so each
      // thread takes three rows in two steps of three and two in the third
      const int m0 = (slot + kSlots - (kRotate * step) % kSlots) % kSlots;
      if (ch0 < a.c) {
        sample_rows<kVec>(a, table + t * kBM, ch0, g, m0, tile_a);
      } else {
#pragma unroll
        for (int m = m0; m < kBM; m += kSlots) {
          *reinterpret_cast<uint4*>(tile_a + m * (kBK * 2) + ((g ^ (m & 7)) << 4)) =
              make_uint4(0, 0, 0, 0);
        }
      }
      fence_async_shared();
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[stage], kTileBytes);
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ==== consumers: wgmma over the stages, then the epilogue ====
    const int wg = tid / 128;  // rows 64 wg .. 64 wg + 63 of the tile
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int step = 0; step < steps; ++step) {
      mbar_wait(&full[stage], phase);
      const uint32_t tile_w = smem_addr(smem + stage * kStageBytes) + kTileBytes;
      const uint32_t tile_a = smem_addr(smem + stage * kStageBytes) + wg * 64 * (kBK * 2);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        wgmma_m64n128k16(acc, sw128_desc(tile_a + 32 * k), sw128_desc(tile_w + 32 * k));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      __syncwarp();
      if (step > 0 && tid % 32 == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    // every stage is consumed (by both warpgroups, after the barrier) and
    // the producers are past their last write to them: reuse the stages for
    // the bf16 output tile (kBM x kOutLd)
    named_sync(1, kConsumerThreads);
    __nv_bfloat16* out_s = reinterpret_cast<__nv_bfloat16*>(smem);
    const int lane = tid % 32;
    const int row = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out_s + row * kOutLd + col) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out_s + (row + 8) * kOutLd + col) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_sync(1, kConsumerThreads);
    const int o0 = blockIdx.y * kBN;
    const int ncols = min(kBN, a.o - o0);
    const bool vec_out = a.o % 8 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
    for (int i = tid; i < kBM * (kBN / 8); i += kConsumerThreads) {
      const int m = i / (kBN / 8), n0 = (i % (kBN / 8)) * 8;
      const int pix = p0 + m;
      if (pix >= a.num_pixels || n0 >= ncols) continue;
      const __nv_bfloat16* src = out_s + m * kOutLd + n0;
      __nv_bfloat16* dst = a.out + (int64_t)pix * a.o + o0 + n0;
      if (vec_out) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && n0 + e < ncols; ++e) dst[e] = src[e];
      }
    }
  }
}

template <bool kVec>
int launch_tc(const TcArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dcn_fused_tc<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.num_pixels + kBM - 1) / kBM), (unsigned)a.otiles);
  dcn_fused_tc<kVec><<<grid, kTcThreads, kTcSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The (9, C, O) kernel as the wgmma kernel's W tiles (ops/dcn_fused.py:
// pack_wgmma_kernel is the plain twin): one thread per 16-byte group of a
// tile row, (chunk, tap, O tile, row n, group) in storage order, the group
// holding channels 8 ((p ^ n) % 8) .. + 7 of the chunk for stored group p,
// zeros past C and O.
__global__ void pack_w_kernel(const __nv_bfloat16* __restrict__ kernel,
                              __nv_bfloat16* __restrict__ packed, int c, int o, int otiles,
                              int64_t groups) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const int p = (int)(i % 8), n = (int)(i / 8 % kBN);
  const int64_t tile = i / (8 * kBN);  // (kc * 9 + t) * otiles + ot
  const int ot = (int)(tile % otiles), t = (int)(tile / otiles % kTaps);
  const int kc = (int)(tile / otiles / kTaps);
  const int oc = ot * kBN + n, c0 = kc * kBK + (p ^ (n % 8)) * 8;
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = oc < o && c0 + e < c ? kernel[((int64_t)t * c + c0 + e) * o + oc]
                                : __float2bfloat16_rn(0.0f);
  }
  *reinterpret_cast<uint4*>(packed + i * 8) = *reinterpret_cast<const uint4*>(v);
}

// ---- f32: the FMA kernel ----------------------------------------------------

constexpr int kFmaThreads = 256;  // 8 warps
constexpr int kFmaBM = 128;       // output pixels per block
constexpr int kFmaBN = 128;       // output channels per block
constexpr int kSkew = 8;          // row padding of the shared tiles (bank spread)

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

__host__ __device__ constexpr int64_t fma_smem_bytes(int c) {
  // sample tile kFmaBM x (Cp + skew) and weight tile Cp x (kFmaBN + skew)
  // in f32, then per pixel four corner indices (int32) and weights (f32)
  return ((int64_t)kFmaBM * (round16(c) + kSkew) + (int64_t)round16(c) * (kFmaBN + kSkew)) *
             sizeof(float) +
         (int64_t)kFmaBM * 4 * (sizeof(int32_t) + sizeof(float));
}

// VX: floats per load of x (4, or 1); VW: the same for W.
template <int VX, int VW>
__global__ void __launch_bounds__(kFmaThreads)
dcn_fused_fma(const float* __restrict__ x, const int32_t* __restrict__ a0,
              const int32_t* __restrict__ b0, const float* __restrict__ fy,
              const float* __restrict__ fx, const float* __restrict__ wm,
              const float* __restrict__ kernel, float* __restrict__ out, int num_pixels, int h,
              int w, int c, int o) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = round16(c);
  const int lda = cp + kSkew;
  const int ldb = kFmaBN + kSkew;
  float* s_a = reinterpret_cast<float*>(smem);  // kFmaBM x lda
  float* s_b = s_a + kFmaBM * lda;              // cp x ldb
  int32_t* s_pix = reinterpret_cast<int32_t*>(s_b + cp * ldb);  // kFmaBM x 4
  float* s_wgt = reinterpret_cast<float*>(s_pix + kFmaBM * 4);  // kFmaBM x 4

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int p0 = blockIdx.x * kFmaBM;
  const int o0 = blockIdx.y * kFmaBN;
  const int ncols = min(kFmaBN, o - o0);
  // thread -> rows warp + 8 i, columns lane + 32 j
  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

#pragma unroll 1
  for (int t = 0; t < kTaps; ++t) {
    // (1) corner pixels and weights of each pixel of the tile
    if (tid < kFmaBM) {
      const Corners k = pixel_corners(a0, b0, fy, fx, wm, p0 + tid, t, num_pixels, h, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_pix[tid * 4 + j] = k.src[j];
        s_wgt[tid * 4 + j] = k.wgt[j];
      }
    }
    // W[t][:, o0:o0+kFmaBN] into s_b, zeros past C and O
    {
      const float* wt = kernel + (int64_t)t * c * o + o0;
      constexpr int kRowVecs = kFmaBN / VW;
      for (int i = tid; i < cp * kRowVecs; i += kFmaThreads) {
        const int ci = i / kRowVecs, n0 = (i - ci * kRowVecs) * VW;
        float v[VW];
        if (ci < c && n0 < ncols) {
          load_vec<float, VW>(wt + (int64_t)ci * o + n0, v);
        } else {
#pragma unroll
          for (int k = 0; k < VW; ++k) v[k] = 0.0f;
        }
        store_vec<float, VW>(s_b + ci * ldb + n0, v);
      }
    }
    __syncthreads();
    // (2) the f32 sample of the tile
    {
      const int row_vecs = cp / VX;
      for (int i = tid; i < kFmaBM * row_vecs; i += kFmaThreads) {
        const int m = i / row_vecs, c0 = (i - m * row_vecs) * VX;
        float samp[VX];
#pragma unroll
        for (int k = 0; k < VX; ++k) samp[k] = 0.0f;
        if (c0 < c) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int src = s_pix[m * 4 + k];
            if (src < 0) continue;  // a zero corner adds +-0
            const float wgt = s_wgt[m * 4 + k];
            float v[VX];
            load_vec<float, VX>(x + (int64_t)src * c + c0, v);
#pragma unroll
            for (int e = 0; e < VX; ++e) samp[e] = __fadd_rn(samp[e], __fmul_rn(wgt, v[e]));
          }
        }
        store_vec<float, VX>(s_a + m * lda + c0, samp);
      }
    }
    __syncthreads();
    // (3) the product, accumulated in f32 across taps
    for (int ci = 0; ci < c; ++ci) {
      float av[16], bv[4];
#pragma unroll
      for (int i = 0; i < 16; ++i) av[i] = s_a[(warp + 8 * i) * lda + ci];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_b[ci * ldb + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the next tap overwrites s_a, s_b and the corners
  }

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int pix = p0 + warp + 8 * i;
    if (pix >= num_pixels) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = lane + 32 * j;
      if (n < ncols) out[(int64_t)pix * o + o0 + n] = acc[i][j];
    }
  }
}

template <int VX, int VW>
int launch_fma(const void* x, const void* a0, const void* b0, const void* fy, const void* fx,
               const void* wm, const void* kernel, void* out, int num_pixels, int h, int w,
               int c, int o, cudaStream_t stream) {
  const int64_t bytes = fma_smem_bytes(c);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dcn_fused_fma<VX, VW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((num_pixels + kFmaBM - 1) / kFmaBM),
                  (unsigned)((o + kFmaBN - 1) / kFmaBN));
  dcn_fused_fma<VX, VW><<<grid, kFmaThreads, (size_t)bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(a0),
      static_cast<const int32_t*>(b0), static_cast<const float*>(fy),
      static_cast<const float*>(fx), static_cast<const float*>(wm),
      static_cast<const float*>(kernel), static_cast<float*>(out), num_pixels, h, w, c, o);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16. x: (N, H, W, C) contiguous, N*H*W < 2^31; a0, b0 int32 and fy, fx,
// wm f32, each (N, H, W, 9) contiguous (the planes for any d); wpack: the
// kernel as ops/dcn_fused.py:pack_wgmma_kernel lays it out, (ceil(C/64), 9,
// ceil(O/128), 128, 64) bf16, 16-byte aligned; out: (N, H, W, O) bf16.
// Launches on `stream`; returns the launch's CUDA error.
extern "C" int dcn_fused_bf16_launch(const void* x, const void* a0, const void* b0,
                                     const void* fy, const void* fx, const void* wm,
                                     const void* wpack, void* out, int n, int h, int w, int c,
                                     int o, void* stream) {
  const int64_t num_pixels = (int64_t)n * h * w;
  if (num_pixels <= 0 || num_pixels > INT_MAX || c <= 0 || o <= 0 ||
      reinterpret_cast<uintptr_t>(wpack) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const TcArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(a0),
                 static_cast<const int32_t*>(b0), static_cast<const float*>(fy),
                 static_cast<const float*>(fx), static_cast<const float*>(wm),
                 static_cast<const __nv_bfloat16*>(wpack), static_cast<__nv_bfloat16*>(out),
                 (int)num_pixels, h, w, c, o, (c + kBK - 1) / kBK, (o + kBN - 1) / kBN};
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && c % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_tc<true>(a, s) : launch_tc<false>(a, s);
}

// kernel: (9, C, O) bf16 contiguous; packed: (ceil(C/64), 9, ceil(O/128),
// 128, 64) bf16, 16-byte aligned. Launches on `stream`; returns its error.
extern "C" int dcn_fused_pack_launch(const void* kernel, void* packed, int c, int o,
                                     void* stream) {
  if (c <= 0 || o <= 0 || reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int otiles = (o + kBN - 1) / kBN;
  const int64_t groups = (int64_t)((c + kBK - 1) / kBK) * kTaps * otiles * kBN * 8;
  pack_w_kernel<<<(unsigned)((groups + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(kernel), static_cast<__nv_bfloat16*>(packed), c, o,
      otiles, groups);
  return (int)cudaGetLastError();
}

// The bf16 kernel's build: out[0] registers a thread, out[1] local
// (spilled) bytes a thread, out[2] static shared bytes, out[3] dynamic
// shared bytes a block, out[4] pipeline stages. Returns a CUDA error.
extern "C" int dcn_fused_bf16_info(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, dcn_fused_tc<true>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kTcSmemBytes;
  out[4] = kStages;
  return 0;
}

// f32. x, the planes and out as above in f32; kernel: (9, C, O) f32. Returns
// cudaErrorInvalidValue when C is over the 208 channels whose tiles fit one
// block's shared memory.
extern "C" int dcn_fused_f32_launch(const void* x, const void* a0, const void* b0,
                                    const void* fy, const void* fx, const void* wm,
                                    const void* kernel, void* out, int n, int h, int w, int c,
                                    int o, void* stream) {
  const int64_t num_pixels = (int64_t)n * h * w;
  if (num_pixels <= 0 || num_pixels > INT_MAX || c <= 0 || o <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int p = (int)num_pixels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vx = reinterpret_cast<uintptr_t>(x) % 16 == 0 && c % 4 == 0;
  const bool vw = reinterpret_cast<uintptr_t>(kernel) % 16 == 0 && o % 4 == 0;
  if (vx && vw) return launch_fma<4, 4>(x, a0, b0, fy, fx, wm, kernel, out, p, h, w, c, o, s);
  if (vx) return launch_fma<4, 1>(x, a0, b0, fy, fx, wm, kernel, out, p, h, w, c, o, s);
  if (vw) return launch_fma<1, 4>(x, a0, b0, fy, fx, wm, kernel, out, p, h, w, c, o, s);
  return launch_fma<1, 1>(x, a0, b0, fy, fx, wm, kernel, out, p, h, w, c, o, s);
}
