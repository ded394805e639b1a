// The port's 3x3 SAME convolution, NHWC, as an implicit GEMM on Hopper's
// tensor cores (wgmma), fp32 accurate by the 3xTF32 split: the conv stages of
// the dense-block kernels K1 and K4 (rdb.cu) and the standalone conv K10
// (conv3x3.cu). Each includer gets its own instantiations (anonymous
// namespace); the epilogue is a compile-time mode.
//
// It serves the TPU kernels deepbedmap_tpu/ops/pallas_rdb.py:rdb_pallas_flat
// (:587, call :635) and rrdb_pallas_flat (:854, call :908), whose
// _band_compute runs each stage as three MXU dots, one per kernel row, with
// the three column taps packed into the contraction, and
// deepbedmap_tpu/ops/pallas_conv.py:conv3x3_pallas (:102, call :166). Here
// the tensor cores are the MXU's counterpart.
//
// What bounds it on an H100: tensor-core operations. A stage with C_in inputs
// and C_out outputs does 2 x 9 x C_in x C_out flops per pixel against a few
// bytes. One TF32 pass keeps 10 mantissa bits, which misses the port's fp32
// contract (about 4e-4 of a conv output's spread); three passes,
//   a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi,
//   x_hi = tf32(x), x_lo = tf32(x - x_hi),
// accumulated in fp32, are as accurate as an fp32 FMA sum. So the bound is
// 3 x flops at the dense TF32 rate (495 TFLOP/s): 0.475 ms for a whole dense
// block at the main-path shape (2 x 286 x 286 x 64), against 1.170 ms for the
// same flops on the fp32 units.
//
// Design. GEMM M = the output pixels of a block's tile (kTileRows rows of 16
// pixels), N = the stage's whole C_out (32, or 64 for stage 5), K = 9 taps x
// C_in, swept as (8-channel chunk, tap). For each chunk a block stages the
// tile's halo (8 floats a pixel) and the chunk's weights with 16-byte
// cp.async; out-of-image pixels are zero-filled by cp.async itself (source
// size 0), which is the SAME padding. Both are then split into TF32 hi/lo once
// (the halo into [pixel][channel pair] {hi, hi, lo, lo} float4s, the weights
// into wgmma's K-major core matrices), and the next chunk's copy is issued, so
// it overlaps this chunk's products. A tap is a shifted view of the staged
// halo, so there is no im2col buffer, and one block covers all of C_out, so
// every input byte is staged once per stage.
//
// A block is 4 warpgroups (512 threads, up to 128 registers each, so one
// block per SM; asking ptxas for two blocks per SM, 64 registers, spills and
// runs slower). Each warpgroup owns 4 tile rows, M = 64: warp w of the group
// holds row w's 16 pixels as the A fragment of wgmma.m64nNk8 (TF32, A from
// registers, B = the tap's weights from shared memory, fp32 accumulators in
// registers). The contraction index k of a step is permuted so that a lane's
// two k slots (t, t + 4) are the adjacent channels (2t, 2t + 1): one 16-byte
// load gives a lane a pixel's hi and lo of both, free of bank conflicts, and
// the weights' core matrices are laid out in the same order. Per kernel row
// the group issues its three taps' products, small ones first (lo.hi, hi.lo,
// hi.hi), into a fresh partial sum, waits, and adds it to the running sum with
// an fp32 add. The tensor cores do not round their fp32 sums to nearest: one
// chain of all 3 x 9 x C_in / 8 products on one accumulator drifts further
// than chip_smoke.py's 3xTF32 precision check allows; chains of three taps
// keep the drift below fp32 round-off.
//
// bf16 multiplicands (the TPU kernels' mxu_bf16: pallas_rdb.py:124-128,
// pallas_conv.py:77, 131-132) take a route of their own below,
// conv3x3_tc_stage_bf16: one pass of bf16 wgmma.m64nNk16 (the bf16 peak,
// 989 TFLOP/s, twice TF32's) on a halo rounded to bf16 once per chunk and
// weights packed in bf16 by the host, with persistent blocks. Its bound is
// the flops at the bf16 peak or, for K10, the fp32 bytes it must move.
//
// Route: wgmma, Hopper's warpgroup MMA, from inline PTX (no new build
// dependency). A first version of this design on mma.sync.m16n8k8 (the Ampere
// instruction) was clearly slower: per warp and per 16 x 8 tile, the hi/lo
// split, the fragment loads and the adds took as many issue slots as the
// products. wgmma takes B straight from shared memory and a 64-row tile per
// instruction, so those costs fall by an order of magnitude.
//
// The input is read with a channel pitch (a stage reads the first C_in
// channels of the (N, H, W, 192) workspace) and the output is written with
// its own pitch. Weights are the packed layout of ops/rdb.py:
// pack_rdb_weights, per stage [C_out/32][C_in][9][32] (K10's
// ops/conv3x3.py:pack_conv_weight is the same layout), or on the bf16 route
// its bf16 layout [C_in/16][9][C_out/8][2][8][8]. Epilogues, applied to
// v = acc + bias[co] before the only store, in the rounding order of the
// plain composition: lrelu(v) (stages 1-4, K10), res + s v (stage 5),
// skip + s (res + s v) (K4's last stage 5, the outer skip folded in), and
// K10's v, v + res and lrelu(v + res).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 16;                 // tile columns: one m16 row per warp
constexpr int kTileRows = 16;              // tile rows
constexpr int kGroups = kTileRows / 4;     // warpgroups: 4 rows (M = 64) each
constexpr int kHaloW = kTileW + 2, kHaloH = kTileRows + 2;
constexpr int kHaloPix = kHaloW * kHaloH;  // staged pixels
constexpr int kCK = 8;                     // input channels per chunk: one k8 step
constexpr int kHaloFloats = kHaloPix * kCK;
constexpr int kThreads = 128 * kGroups;

enum EpilogueMode : int {
  kLrelu,       // out = lrelu(v)                  stages 1-4, K10
  kScaledSkip,  // out = res + s * v               stage 5
  kDoubleSkip,  // out = skip + s * (res + s * v)  K4, last stage 5
  kLinear,      // out = v                         K10
  kAdd,         // out = v + res                   K10
  kAddLrelu,    // out = lrelu(v + res)            K10
};

// Where the epilogue writes and what it adds. Element (pixel p, channel co) is
// out[p * out_pitch + co], res[p * res_pitch + co], skip[p * 64 + co].
struct Epilogue {
  float* out;
  int out_pitch;
  const float* res;
  int res_pitch;
  const float* skip;
  float scaling;
};

template <int kCout>
struct StageShape {
  static_assert(kCout == 32 || kCout == 64, "C_out must be 32 or 64");
  static constexpr int kRawFloats = kCK * 9 * kCout;  // one chunk's weights
  // the chunk's halo and weights as copied, and their hi/lo splits
  static constexpr size_t kSmemBytes = sizeof(float) * 3 * (kHaloFloats + kRawFloats);
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

// cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// {hi(a), hi(b), lo(a), lo(b)}: x = hi + lo, both TF32
__device__ __forceinline__ float4 split_pair(float a, float b) {
  const uint32_t ha = tf32_rna(a), hb = tf32_rna(b);
  const uint32_t la = tf32_rna(a - __uint_as_float(ha));
  const uint32_t lb = tf32_rna(b - __uint_as_float(hb));
  return make_float4(__uint_as_float(ha), __uint_as_float(hb), __uint_as_float(la),
                     __uint_as_float(lb));
}

// 16-byte cp.async; with valid false it reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// wgmma matrix descriptor of a K-major operand without swizzle: core matrices
// of 8 rows x 16 bytes (4 TF32 or 8 bf16 values a row), 128 B apart along K
// (leading byte offset) and 256 B apart along N (stride byte offset), both
// in 16-byte units
__device__ __forceinline__ uint64_t weight_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// Keep the compiler from moving register accesses across wgmma's asynchronous
// reads and writes of them.
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= a b for one wgmma.m64nNk8 TF32 step: a from registers, b from the
// descriptor; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_k8(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_k8(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The epilogue of one warp's tile row: v = acc + bias[co] through the mode,
// the only store. Accumulator i: n tile j = i / 4, pixel g (i % 4 < 2) or
// g + 8 of the row, channel 8 j + 2 t + i % 2 (wgmma's D fragment, the same
// for both routes).
template <int kCout, int kMode>
__device__ __forceinline__ void store_row(const float (&acc)[kCout / 2], int n, int gy, int x0,
                                          int g, int t, const float* __restrict__ bias,
                                          float* out, int out_pitch,
                                          const float* __restrict__ res, int res_pitch,
                                          const float* __restrict__ skip, float scaling,
                                          int H, int W) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gx = x0 + g + 8 * half;
    if (gy >= H || gx >= W) continue;
    const size_t pix = (size_t)(n * H + gy) * W + gx;
#pragma unroll
    for (int j = 0; j < kCout / 8; ++j) {
      const int co = 8 * j + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(bias + co);
      const float v0 = acc[4 * j + 2 * half] + b.x;
      const float v1 = acc[4 * j + 2 * half + 1] + b.y;
      float2 o;
      if constexpr (kMode == kLrelu) {
        o = make_float2(lrelu(v0), lrelu(v1));
      } else if constexpr (kMode == kLinear) {
        o = make_float2(v0, v1);
      } else if constexpr (kMode == kAdd || kMode == kAddLrelu) {
        const float2 r = *reinterpret_cast<const float2*>(res + pix * res_pitch + co);
        o = make_float2(v0 + r.x, v1 + r.y);
        if constexpr (kMode == kAddLrelu) o = make_float2(lrelu(o.x), lrelu(o.y));
      } else if constexpr (kMode == kScaledSkip) {
        const float2 r = *reinterpret_cast<const float2*>(res + pix * res_pitch + co);
        o = make_float2(r.x + scaling * v0, r.y + scaling * v1);
      } else {
        static_assert(kMode == kDoubleSkip, "unknown epilogue mode");
        const float2 r = *reinterpret_cast<const float2*>(res + pix * res_pitch + co);
        const float2 k = *reinterpret_cast<const float2*>(skip + pix * 64 + co);
        o = make_float2(k.x + scaling * (r.x + scaling * v0),
                        k.y + scaling * (r.y + scaling * v1));
      }
      *reinterpret_cast<float2*>(out + pix * out_pitch + co) = o;
    }
  }
}

template <int kCout, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tc_stage(const float* __restrict__ in, int in_pitch, int cin,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* out, int out_pitch, const float* __restrict__ res,
                 int res_pitch, const float* __restrict__ skip, float scaling, int H,
                 int W) {
  using S = StageShape<kCout>;
  constexpr int kSlice = kCK * 9 * 32;  // floats of one chunk's 32-output slice
  constexpr int kAcc = kCout / 2;       // accumulator floats per thread
  extern __shared__ float4 smem4[];
  // cp.async targets: the chunk's halo [pixel][8 ch] and weights
  // [C_out/32][8 ch][9 taps][32]. Their splits: s_halo[pixel * 4 + t] =
  // {hi(x[2t]), hi(x[2t+1]), lo(x[2t]), lo(x[2t+1])}; s_w, per (tap, hi|lo), the
  // K-major B operand as core matrices [n / 8][k / 4][n % 8][k % 4], where k
  // slot s is channel 2 (s % 4) + s / 4 (the A fragments' order).
  float* s_raw_halo = reinterpret_cast<float*>(smem4);
  float* s_raw_w = s_raw_halo + kHaloFloats;
  float4* s_halo = reinterpret_cast<float4*>(s_raw_w + S::kRawFloats);
  float* s_w = reinterpret_cast<float*>(s_halo + kHaloFloats / 2);

  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileRows, n = blockIdx.z;

  auto stage_chunk = [&](int c0) {
    for (int i = tid; i < 2 * kHaloPix; i += kThreads) {
      const int p = i >> 1, half = i & 1;
      const int gy = y0 + p / kHaloW - 1, gx = x0 + p % kHaloW - 1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src =
          inside ? in + ((size_t)(n * H + gy) * W + gx) * in_pitch + c0 + 4 * half : in;
      cp_async16(s_raw_halo + p * kCK + 4 * half, src, inside);
    }
    for (int i = tid; i < (kCout / 32) * kSlice / 4; i += kThreads) {
      const int ct = i / (kSlice / 4), r = i % (kSlice / 4);
      cp_async16(s_raw_w + ct * kSlice + 4 * r,
                 w + ((size_t)ct * cin + c0) * 9 * 32 + 4 * r, true);
    }
    cp_async_commit();
  };

  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int chunks = cin / kCK;
  stage_chunk(0);
  for (int q = 0; q < chunks; ++q) {
    cp_async_wait_all();
    __syncthreads();  // chunk q has landed; every warpgroup is done with chunk q - 1
    for (int i = tid; i < kHaloPix * kCK / 2; i += kThreads) {
      const float2 v = reinterpret_cast<const float2*>(s_raw_halo)[i];
      s_halo[i] = split_pair(v.x, v.y);
    }
    // one core-matrix row (4 k slots of one output channel, hi and lo) per item
    for (int i = tid; i < 9 * kCout * 2; i += kThreads) {
      const int tap = i / (2 * kCout), co = (i >> 1) % kCout, kc = i & 1;
      const float* r = s_raw_w + (co >> 5) * kSlice + kc * 9 * 32 + tap * 32 + (co & 31);
      const float4 a = split_pair(r[0], r[2 * 9 * 32]);
      const float4 b = split_pair(r[4 * 9 * 32], r[6 * 9 * 32]);
      float* d = s_w + tap * 2 * kCout * kCK + (co >> 3) * 64 + kc * 32 + (co & 7) * 4;
      *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(d + kCout * kCK) = make_float4(a.z, a.w, b.z, b.w);
    }
    // make the split weights visible to wgmma's reads (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // splits ready, cp.async targets free
    if (q + 1 < chunks) stage_chunk((q + 1) * kCK);

#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
      uint32_t ah[3][4], al[3][4];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // A rows: pixels g and g + 8 of the warp's tile row, shifted by the tap
        const float4* p = s_halo + ((row + ky) * kHaloW + g + kx) * 4 + t;
        const float4 v0 = p[0], v8 = p[8 * 4];
        ah[kx][0] = __float_as_uint(v0.x);
        ah[kx][1] = __float_as_uint(v8.x);
        ah[kx][2] = __float_as_uint(v0.y);
        ah[kx][3] = __float_as_uint(v8.y);
        al[kx][0] = __float_as_uint(v0.z);
        al[kx][1] = __float_as_uint(v8.z);
        al[kx][2] = __float_as_uint(v0.w);
        al[kx][3] = __float_as_uint(v8.w);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* bw = s_w + (3 * ky + kx) * 2 * kCout * kCK;
        wgmma_k8(part, al[kx], weight_desc(bw), kx > 0);          // lo . hi
        wgmma_k8(part, ah[kx], weight_desc(bw + kCout * kCK), 1);  // hi . lo
        wgmma_k8(part, ah[kx], weight_desc(bw), 1);                // hi . hi
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(part);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        fence_operands(ah[kx]);
        fence_operands(al[kx]);
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    }
  }

  store_row<kCout, kMode>(acc, n, y0 + row, x0, g, t, bias, out, out_pitch, res, res_pitch,
                          skip, scaling, H, W);
}

// ---------------------------------------------------------------------------
// The bf16 route (K1, K4 and K10 with bf16 multiplicands): the same tile,
// warpgroups, A/D fragment rows and epilogues, on
// wgmma.m64nNk16.f32.bf16.bf16 (A from registers as bf16x2, B from shared
// memory). Products of two bf16 values are exact in the fp32 accumulator, so
// one pass is the function of bf16 multiplicands with fp32 accumulation.
//
// - The halo is rounded to bf16 once per chunk (cvt.rn.bf16x2.f32, round to
//   nearest even as XLA's astype) into [16-channel plane][pixel][16] bf16:
//   each thread lands its own 16-byte fp32 pieces of the chunk by cp.async
//   two steps ahead (zero fill outside the image: the SAME padding) and
//   rounds them itself one step ahead, while the current step's products
//   run, so neither needs a barrier of its own.
// - The k slots of a k16 step are ordered so that a lane's four A values
//   (slots 2t, 2t + 1, 2t + 8, 2t + 9) are the adjacent channels 4t..4t + 3:
//   one 8-byte shared load gives a lane a pixel's pair of registers, and a
//   warp's 32 loads are 256 contiguous bytes (no bank conflict).
// - The weights come packed by the host (ops/conv3x3.py:pack_conv_weight
//   with mxu_bf16) in bf16, per 16 input channels and tap, in the exact
//   K-major core-matrix layout the B descriptor reads, [n / 8][k / 8][n % 8]
//   [k % 8] (the TF32 descriptor's strides: a core matrix is 8 rows of 16
//   bytes either way); a chunk's weights are contiguous and copied straight
//   into place by 16-byte cp.async, one step ahead. No split pass.
// - One barrier per chunk of kBfChunk channels, a 2-slot ring for the
//   weights, the rounded halo and the fp32 landing area.
// - Per 16 channels a warpgroup loads its nine taps' A fragments and starts
//   the nine products (one wgmma.wait_group), onto the stage's one
//   accumulator: every product of a stage is one chain. The tensor cores'
//   truncating fp32 sums drift with the chain's length, but a bf16 product
//   is exact and the whole-stage chain stays well inside phase 28's
//   tolerances. chip_conv_variants.py measures it beside a fresh partial
//   sum per nine taps added in fp32 (2-5% slower) and kBfChunk 16 (twice
//   the barriers, 14-17% slower).
// - Persistent blocks: one per SM walks the tiles blockIdx.x, + gridDim.x,
//   ...; the ring runs on across tiles, so a tile's epilogue overlaps the
//   next tile's copies.

constexpr int kBfChunk = 32;  // input channels per chunk (per barrier)

template <int kCout>
struct Bf16Shape {
  static_assert(kCout == 32 || kCout == 64, "C_out must be 32 or 64");
  static constexpr int kSteps = kBfChunk / 16;              // k16 steps per chunk
  static constexpr int kPieces = kHaloPix * kBfChunk / 4;   // 16-byte fp32 pieces
  static constexpr int kHaloElems = kHaloPix * kBfChunk;    // one slot's halo values
  static constexpr int kWElems = kBfChunk * 9 * kCout;      // one chunk's weights
  // per slot: bf16 weights, bf16 halo, fp32 landing area
  static constexpr size_t kSmemBytes = 2 * (2 * kWElems + 2 * kHaloElems + 4 * kHaloElems);
};

// {bf16(lo), bf16(hi)} as bf16x2, lo in the low half; round to nearest even
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}

// d (+)= a b for one wgmma.m64nNk16 bf16 step: a from registers (bf16x2),
// b from the descriptor (K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int kCout, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tc_stage_bf16(const float* __restrict__ in, int in_pitch, int cin,
                      const uint16_t* __restrict__ w, const float* __restrict__ bias,
                      float* out, int out_pitch, const float* __restrict__ res,
                      int res_pitch, const float* __restrict__ skip, float scaling, int N,
                      int H, int W) {
  using S = Bf16Shape<kCout>;
  constexpr int kAcc = kCout / 2;
  extern __shared__ float4 smem4[];
  // per slot: s_w [k16 step][tap][n / 8][k / 8][n % 8][k % 8] (the packer's
  // layout), s_halo [k16 step][pixel][16], s_land [piece][4] (each thread's
  // own pieces, fp32)
  uint16_t* s_w = reinterpret_cast<uint16_t*>(smem4);
  uint16_t* s_halo = s_w + 2 * S::kWElems;
  float* s_land = reinterpret_cast<float*>(s_halo + 2 * S::kHaloElems);

  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileRows - 1) / kTileRows;
  const int tiles = tiles_x * tiles_y * N;
  const int chunks = cin / kBfChunk;
  // step s of this block: chunk s % chunks of its tile s / chunks
  const int steps = ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * chunks;

  auto tile_of = [&](int s, int& n, int& y0, int& x0) {
    const int tile = blockIdx.x + (s / chunks) * gridDim.x;
    x0 = tile % tiles_x * kTileW;
    y0 = tile / tiles_x % tiles_y * kTileRows;
    n = tile / (tiles_x * tiles_y);
  };
  // step s's halo, fp32, into landing slot s & 1: this thread's pieces only
  auto land = [&](int s) {
    int n, y0, x0;
    tile_of(s, n, y0, x0);
    const int c0 = s % chunks * kBfChunk;
    float* dst = s_land + (s & 1) * S::kHaloElems;
    for (int i = tid; i < S::kPieces; i += kThreads) {
      const int p = i / (kBfChunk / 4), c4 = i % (kBfChunk / 4);
      const int gy = y0 + p / kHaloW - 1, gx = x0 + p % kHaloW - 1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src =
          inside ? in + ((size_t)(n * H + gy) * W + gx) * in_pitch + c0 + 4 * c4 : in;
      cp_async16(dst + 4 * i, src, inside);
    }
  };
  // step s's weights (contiguous in the packed layout) into slot s & 1
  auto stage_w = [&](int s) {
    const uint16_t* src = w + (size_t)(s % chunks) * S::kWElems;
    uint16_t* dst = s_w + (s & 1) * S::kWElems;
    for (int i = tid; i < S::kWElems / 8; i += kThreads)
      cp_async16(dst + 8 * i, src + 8 * i, true);
  };
  // this thread's landed pieces of step s, rounded to bf16, into halo slot s & 1
  auto round_halo = [&](int s) {
    const float* src = s_land + (s & 1) * S::kHaloElems;
    uint16_t* dst = s_halo + (s & 1) * S::kHaloElems;
    for (int i = tid; i < S::kPieces; i += kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(src + 4 * i);
      const int p = i / (kBfChunk / 4), c4 = i % (kBfChunk / 4);
      *reinterpret_cast<uint2*>(dst + ((c4 >> 2) * kHaloPix + p) * 16 + 4 * (c4 & 3)) =
          make_uint2(bf16x2_rn(v.x, v.y), bf16x2_rn(v.z, v.w));
    }
  };

  float acc[kAcc];
  stage_w(0);
  land(0);
  cp_async_commit();
  if (steps > 1) land(1);
  cp_async_commit();
  cp_async_wait<1>();
  round_halo(0);

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int q = s % chunks;
    cp_async_wait<0>();  // this thread's copies of w(s) and of step s + 1's halo
    // make the copied weights visible to wgmma's reads (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // w(s) and halo(s) ready; every warpgroup is done with step s - 1
    if (s + 1 < steps) stage_w(s + 1);
    if (s + 2 < steps) land(s + 2);
    cp_async_commit();
    if (q == 0) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    }
    const uint16_t* halo = s_halo + (s & 1) * S::kHaloElems;
    const uint16_t* ws = s_w + (s & 1) * S::kWElems;
#pragma unroll
    for (int k = 0; k < S::kSteps; ++k) {
      // A rows: pixels g and g + 8 of the warp's tile row, shifted by the tap;
      // one 8-byte load gives a pixel's channels 4t..4t + 3 of the plane
      uint32_t a[9][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint16_t* p =
            halo + (k * kHaloPix + (row + tap / 3) * kHaloW + g + tap % 3) * 16 + 4 * t;
        const uint2 v0 = *reinterpret_cast<const uint2*>(p);
        const uint2 v8 = *reinterpret_cast<const uint2*>(p + 8 * 16);
        a[tap][0] = v0.x;
        a[tap][1] = v8.x;
        a[tap][2] = v0.y;
        a[tap][3] = v8.y;
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        wgmma_bf16(acc, a[tap], weight_desc(ws + (k * 9 + tap) * 16 * kCout), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (k == 0 && s + 1 < steps) round_halo(s + 1);  // under the products
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) fence_operands(a[tap]);
    }
    if (q == chunks - 1) {
      int n, y0, x0;
      tile_of(s, n, y0, x0);
      store_row<kCout, kMode>(acc, n, y0 + row, x0, g, t, bias, out, out_pitch, res,
                              res_pitch, skip, scaling, H, W);
    }
  }
}

// One stage: the first `cin` channels of `in` (channel pitch `in_pitch`) ->
// kCout channels through the epilogue, in 3xTF32 (`w`: floats in
// pack_conv_weight's layout) or, with kBf16, on bf16 multiplicands (`w`: bf16
// in pack_conv_weight(mxu_bf16)'s layout; cin a multiple of kBfChunk). cin
// must be a multiple of 8; `in`, `w`, `bias` and the epilogue's pointers
// 8-byte aligned (16 for `in` and `w`, with pitches that keep every pixel
// 16-byte aligned). Returns cudaGetLastError().
template <int kCout, int kMode, bool kBf16 = false>
cudaError_t launch_conv3x3_tc(const float* in, int in_pitch, int cin, const void* w,
                              const float* bias, const Epilogue& ep, int N, int H, int W,
                              cudaStream_t s) {
  if constexpr (kBf16) {
    using S = Bf16Shape<kCout>;
    if (cin % kBfChunk != 0) return cudaErrorInvalidValue;
    auto kernel = conv3x3_tc_stage_bf16<kCout, kMode>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)S::kSmemBytes);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    const long long tiles = (long long)((W + kTileW - 1) / kTileW) *
                            ((H + kTileRows - 1) / kTileRows) * N;
    const int grid = (int)(tiles < sms ? tiles : sms);
    kernel<<<grid, kThreads, S::kSmemBytes, s>>>(
        in, in_pitch, cin, static_cast<const uint16_t*>(w), bias, ep.out, ep.out_pitch,
        ep.res, ep.res_pitch, ep.skip, ep.scaling, N, H, W);
  } else {
    using S = StageShape<kCout>;
    cudaError_t err = cudaFuncSetAttribute(conv3x3_tc_stage<kCout, kMode>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)S::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileRows - 1) / kTileRows, N);
    conv3x3_tc_stage<kCout, kMode><<<grid, kThreads, S::kSmemBytes, s>>>(
        in, in_pitch, cin, static_cast<const float*>(w), bias, ep.out, ep.out_pitch, ep.res,
        ep.res_pitch, ep.skip, ep.scaling, H, W);
  }
  return cudaGetLastError();
}

}  // namespace
