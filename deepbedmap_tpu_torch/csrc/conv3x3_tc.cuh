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
// bf16 multiplicands (kBf16, the TPU kernels' mxu_bf16: pallas_rdb.py:124-128,
// pallas_conv.py:77, 131-132): the weights arrive rounded to bf16 by the
// packer (ops/rdb.py, ops/conv3x3.py, round to nearest even), each staged
// activation is rounded to bf16 at its dot by cvt.rn.bf16x2.f32 (round to
// nearest even, as XLA's astype; cvt.rna.tf32 would round ties away from
// zero), and one TF32 pass, hi.hi, does the products: a bf16 value is exact
// in TF32 and the product of two is exact in fp32, so this is the function
// of bf16 multiplicands with fp32 accumulation, in one wgmma where 3xTF32
// takes three. Biases, LeakyReLU, the dense concat and the residuals stay
// fp32; a stage reads the fp32 outputs of the stages before it and rounds
// them only at its own dot.
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
// ops/conv3x3.py:pack_conv_weight is the same layout). Epilogues, applied to
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

// {bf16(a), bf16(b), 0, 0}: both rounded to nearest even (cvt.rn.bf16x2.f32
// puts a in the upper half), widened back to fp32 (exact, and exact in TF32)
__device__ __forceinline__ float4 bf16_pair(float a, float b) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(a), "f"(b));
  return make_float4(__uint_as_float(r & 0xFFFF0000u), __uint_as_float(r << 16), 0.f, 0.f);
}

// a pair as a stage's A operand takes it: TF32 hi/lo (3xTF32) or bf16
template <bool kBf16>
__device__ __forceinline__ float4 operand_pair(float a, float b) {
  if constexpr (kBf16) {
    return bf16_pair(a, b);
  } else {
    return split_pair(a, b);
  }
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
// of 8 rows x 16 bytes, 128 B apart along K (leading byte offset) and 256 B
// apart along N (stride byte offset), both in 16-byte units
__device__ __forceinline__ uint64_t weight_desc(const float* p) {
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

template <int kCout, int kMode, bool kBf16>
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
      s_halo[i] = operand_pair<kBf16>(v.x, v.y);
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
        if constexpr (kBf16) {
          wgmma_k8(part, ah[kx], weight_desc(bw), kx > 0);         // bf16 . bf16
        } else {
          wgmma_k8(part, al[kx], weight_desc(bw), kx > 0);          // lo . hi
          wgmma_k8(part, ah[kx], weight_desc(bw + kCout * kCK), 1);  // hi . lo
          wgmma_k8(part, ah[kx], weight_desc(bw), 1);                // hi . hi
        }
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

  // accumulator i: n tile j = i / 4, pixel g (i % 4 < 2) or g + 8 of the
  // warp's row, channel 8 j + 2 t + i % 2
  const int gy = y0 + row;
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

// One stage: the first `cin` channels of `in` (channel pitch `in_pitch`) ->
// kCout channels through the epilogue, in 3xTF32 or, with kBf16, on bf16
// multiplicands (`w` then holds bf16 values). cin must be a multiple of 8; `in`,
// `w`, `bias` and the epilogue's pointers 8-byte aligned (16 for `in` and
// `w`, with pitches that keep every pixel 16-byte aligned). Returns
// cudaGetLastError().
template <int kCout, int kMode, bool kBf16 = false>
cudaError_t launch_conv3x3_tc(const float* in, int in_pitch, int cin, const float* w,
                              const float* bias, const Epilogue& ep, int N, int H, int W,
                              cudaStream_t s) {
  using S = StageShape<kCout>;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_tc_stage<kCout, kMode, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileRows - 1) / kTileRows, N);
  conv3x3_tc_stage<kCout, kMode, kBf16><<<grid, kThreads, S::kSmemBytes, s>>>(
      in, in_pitch, cin, w, bias, ep.out, ep.out_pitch, ep.res, ep.res_pitch, ep.skip,
      ep.scaling, H, W);
  return cudaGetLastError();
}

}  // namespace
