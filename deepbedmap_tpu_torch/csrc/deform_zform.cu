// K9: the deformable conv with the tap projection inside the kernel ("zform"),
// fp32, NHWC, 3x3 kernel, padding 1:
//   out(p) = b + sum_t bilinear(z_t, p + tap_t + clamp(off_t(p))),
//   z_t = W_t^T x  (C_in -> C_out, the projection of the input through tap
//   t's weights).
// Sampling is linear in the channels, so this is the deformable conv of
// deform_tail.cu (K2/K7) with the channel contraction moved before the
// sampling; the kernel keeps that order (projection, then sampling), as the
// TPU kernel does. Offsets follow the JAX layout, [0, 9) dy and [9, 18) dx;
// each is clamped to [-clamp, clamp], the base corner is the floor (also at
// integers), and corners outside the image count zero: here because z is
// the projection of a zero-padded x, so it is exactly zero outside the image.
//
// Replaces the TPU kernel deepbedmap_tpu/ops/pallas_kernels.py:
// deform_conv2d_pallas_zform (:1063, call :1119, body _deform_zform_kernel
// :912), which projects each window row through the tap weights on the MXU
// and evaluates the (2 clamp + 2)^2 masked-shift terms on the projections.
// Here the four bilinear corners are read directly: the same function.
//
// What bounds it on an H100. C_out 64 (and 16): operations. The function's
// own work is K7's, the 9 C_in -> C_out contraction (3xTF32 on the tensor
// cores: 3 x flops at 495 TFLOP/s) and 9 x C_out bilinear samples per pixel
// (fp32 units), 1.350 ms at (2, 1144, 1144, 64) -> 64. Projecting first
// costs more than the function's MACs: every position of a tap's sample
// window is projected, not only the pixels' own samples. C_out 1: bytes, x
// and the offsets read once and one channel written (0.259 ms at the same
// shape); the 64 -> 9 projection is 2.3 GFLOP.
//
// Design, C_out 64 and 16 (deform_zform_tc_kernel). A block owns a 7 x 16
// output tile and four warpgroups (conv3x3_tc.cuh's 512 threads). It stages
// the input window every tap's samples can reach, 14 x 23 pixels (3 px of
// tap and clamp reach before the tile, 4 after it for the second corner),
// with zero-filling 16-byte cp.async, as K2's [16-channel block][pixel][16]
// layout, C_in zero-padded to a whole block. Per tap t it projects the
// 12 x 21 = 252 window positions that tap t's corners can touch: a GEMM with
// M = those positions padded to 256 rows, one 64-row block per warpgroup
// (rows past 252 read a valid pixel and are dropped), N = C_out
// (wgmma.m64n64k8 / m64n16k8), K = C_in in k8 steps. A is read from the raw
// fp32 window (lane (g, t) reads channels 4t .. 4t + 3 of a block, the slots
// t and t + 4 of its two k8 steps) and split into TF32 hi/lo in registers
// (split_pair); B is the tap's weights, split once per model by
// ops/deform_conv.py:pack_deform64_weight_tc (K2's layout, C_in padded to 16,
// N = C_out), copied per tap with cp.async into a double buffer while the
// previous tap runs. Each window block (two k8 steps, six products lo.hi,
// hi.lo, hi.hi) goes into a fresh partial sum added to the running sum in
// fp32: the tensor cores do not round their sums to nearest, and short
// chains keep their drift below fp32 round-off. The projection is stored to
// shared memory in fp32 ([position][C_out + 8], a pitch that makes the
// fragments' float2 stores conflict-free); then C_out / 8 threads per
// output pixel read its four corners, 8 channels each, and accumulate in
// registers (at C_out 64 each thread takes two pixels, and the eight
// threads of a pixel read its 128 contiguous bytes per corner and channel
// group, free of bank conflicts). The bias is added before the only store.
// A tap's projection executes 256 / 112 = 2.29x the function's MACs; a
// 7-row tile (not 8) makes the padded M exactly four 64-row blocks, so no
// warpgroup does a second block. Shared memory at C_in 64, C_out 64: window 82,432 B,
// z_t 72,576 B, B 2 x 32,768 B = 220,544 B, one block per SM.
//
// Design, C_out 1 (deform_zform1_kernel). A block owns a 32 x 32 tile and
// 512 threads, one block per SM (226,912 B at C_in 64). It projects the
// whole 39 x 39 input window (1.49x the tile's pixels; 16 x 32 and 8 x 32
// tiles read 1.75x and 2.28x; chip_zform_variants.py times both) onto the
// nine tap fields once, on the fp32 units. The window arrives one 8-channel chunk at
// a time by zero-filling 16-byte cp.async ([4-channel group][pixel][4],
// consecutive threads on consecutive 16-byte runs) into a ring of three
// buffers, two chunks ahead of the arithmetic, with one barrier per chunk;
// the weights (zero past C_in) and the tile's offsets (pitch 19, odd) come
// by 4-byte cp.async with the first chunk. Each thread accumulates the nine
// fields of its three window pixels in registers, reading each channel's
// weights once for all three (the same address across the warp: a
// broadcast); with one pixel per thread, as many threads as pixels, the
// weight loads alone kept shared memory busy. The fields then go to shared
// memory over the spent ring ([pixel][9], odd pitch) and are sampled as K3
// samples its tap fields (deform_tail.cu): two pixels per thread. z never
// reaches device memory, unlike K8's projection and K3.
//
// Clamps of at most 2 px are supported (the windows are sized for them).

#include <cstdint>

#include <cuda_runtime.h>

#include "conv3x3_tc.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kReach = 2;            // largest clamp
constexpr int kHaloLo = kReach + 1;  // window rows / cols before the tile
constexpr int kBlk = 16;             // channels of one window block: two k8 steps

// C_out 64 and 16: a 7 x 16 tile, conv3x3_tc.cuh's four warpgroups (kThreads)
constexpr int kTH = 7, kTW = 16;
constexpr int kXH = kTH + 2 * kHaloLo + 1;  // 14: input window
constexpr int kXW = kTW + 2 * kHaloLo + 1;  // 23
constexpr int kXPix = kXH * kXW;            // 322
constexpr int kZH = kTH + 2 * kReach + 1;   // 12: one tap's projection window
constexpr int kZW = kTW + 2 * kReach + 1;   // 21
constexpr int kZPix = kZH * kZW;            // 252
static_assert(kZPix <= 64 * kGroups, "a tap's window needs more than one M block per warpgroup");

// C_out 1: a 32 x 32 tile, 512 threads
constexpr int k1TH = 32, k1TW = 32;
constexpr int k1Threads = k1TH * k1TW < 512 ? k1TH * k1TW : 512;
constexpr int k1OPT = k1TH * k1TW / k1Threads;               // output pixels per thread
constexpr int k1XH = k1TH + 2 * kHaloLo + 1;  // 39
constexpr int k1XW = k1TW + 2 * kHaloLo + 1;  // 39
constexpr int k1XPix = k1XH * k1XW;           // 1521
constexpr int k1PPT = (k1XPix + k1Threads - 1) / k1Threads;  // window pixels per thread
constexpr int k1Chunk = 8;                    // channels of one staged chunk
constexpr int kChunkFloats = k1XPix * k1Chunk;
constexpr int kWPitch = 12;                   // a channel's nine tap weights, padded
constexpr int kOffPitch = 2 * kTaps + 1;      // odd: conflict-free
constexpr int kRing = 3;                      // chunk buffers: two chunks in flight
static_assert(k1XPix * kTaps <= kRing * kChunkFloats, "the fields do not fit over the ring");

// 4-byte cp.async; with valid false it reads nothing and writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float clamped(float d, float clamp) {
  return fminf(fmaxf(d, -clamp), clamp);
}

// d (+)= a b for one wgmma.m64n16k8 TF32 step (conv3x3_tc.cuh has N = 32, 64)
__device__ __forceinline__ void wgmma_k8(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// floats of the tensor-core kernel's shared memory for `blocks` window blocks
template <int kCout>
constexpr size_t tc_smem_floats(int blocks) {
  return 2 * (size_t)(2 * 2 * blocks * 8 * kCout) + (size_t)blocks * kXPix * kBlk +
         (size_t)kZPix * (kCout + 8);
}

template <int kCout>
__global__ void __launch_bounds__(kThreads, 1)
deform_zform_tc_kernel(const float* __restrict__ x, const float* __restrict__ off,
                       const float* __restrict__ w,  // pack_deform64_weight_tc
                       const float* __restrict__ bias, float* __restrict__ out, int H,
                       int W, int cin, int blocks, float clamp) {
  constexpr int kAcc = kCout / 2;     // accumulator floats per thread
  constexpr int kZPitch = kCout + 8;  // z_t's pixel pitch
  // sampling: kTPP threads per pixel, each 8 channels (4 q + 4 kTPP i,
  // i = 0, 1) of kSPix pixels; at C_out 64 a quarter warp reads one
  // pixel's 128 contiguous bytes per load, free of bank conflicts
  constexpr int kTPP = kCout / 8;
  constexpr int kSPix = kCout == 64 ? 2 : 1;
  constexpr int kSPixStride = kTH * kTW / kSPix;  // between a thread's pixels
  static_assert(kTH * kTW * kTPP / kSPix <= kThreads, "more sampling threads than threads");
  const int steps = 2 * blocks;
  const int tap_w = 2 * steps * 8 * kCout;  // one tap's B, hi then lo
  extern __shared__ float4 smem4[];
  // s_w: two taps' B, [buffer][hi | lo][k8 step][n / 8][k / 4][n % 8][k % 4];
  // s_win: the window, [channel block][pixel][16]; s_z: z_t, [position][kZPitch]
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_win = s_w + 2 * tap_w;
  float* s_z = s_win + blocks * kXPix * kBlk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, n = blockIdx.z;

  auto load_tap = [&](int tap) {
    const float* src = w + (size_t)tap * tap_w;
    float* dst = s_w + (tap & 1) * tap_w;
    for (int i = tid; i < tap_w / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i, true);
    cp_async_commit();
  };

  // the window: rows y0 - 3 .. y0 + kTH + 3, cols x0 - 3 .. x0 + kTW + 3;
  // sixteen items per pixel, one per 4-channel group (those past the last
  // block skipped, those past cin zero-filled)
  for (int i = tid; i < kXPix * 16; i += kThreads) {
    const int p = i >> 4, c4 = i & 15;
    if (c4 >= 4 * blocks) continue;
    const int gy = y0 - kHaloLo + p / kXW, gx = x0 - kHaloLo + p % kXW;
    const bool valid = 4 * c4 < cin && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* src = valid ? x + ((size_t)(n * H + gy) * W + gx) * cin + 4 * c4 : x;
    cp_async16(s_win + ((c4 >> 2) * kXPix + p) * kBlk + 4 * (c4 & 3), src, valid);
  }
  load_tap(0);  // one commit group with the window

  // the lane's two M rows: positions r[h] of the tap window (warpgroup
  // warp / 4 owns rows 64 (warp / 4) .. + 63, warp w of it rows 16 (w % 4)
  // + g and + 8); xpos[h] is the window pixel of position r[h] for tap 0
  int r[2], xpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r[h] = 16 * warp + g + 8 * h;
    const int p = min(r[h], kZPix - 1);
    xpos[h] = (p / kZW) * kXW + p % kZW;
  }
  // the sampling thread's output pixels (ly[k], lx[k]) and part q of the
  // channels
  const int q = tid % kTPP, sp = tid / kTPP;
  int ly[kSPix], lx[kSPix];
  bool inside[kSPix];
  const float* offp[kSPix];
#pragma unroll
  for (int k = 0; k < kSPix; ++k) {
    const int pix = sp + k * kSPixStride;
    ly[k] = pix / kTW;
    lx[k] = pix % kTW;
    const int gy = y0 + ly[k], gx = x0 + lx[k];
    inside[k] = sp < kSPixStride && gy < H && gx < W;
    offp[k] = off + ((size_t)(n * H + min(gy, H - 1)) * W + min(gx, W - 1)) * 2 * kTaps;
  }
  float acc_s[kSPix][8];
#pragma unroll
  for (int k = 0; k < kSPix; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_s[k][j] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < kTaps; ++tap) {
    cp_async_wait_all();
    // make the copied weights visible to wgmma's reads (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tap's B (and the window) landed; every thread is done with z_{t-1}
    if (tap + 1 < kTaps) load_tap(tap + 1);

    const int shift = (tap / 3) * kXW + tap % 3;
    const float* bw = s_w + (tap & 1) * tap_w;
    float acc[kAcc], part[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int b = 0; b < blocks; ++b) {
      const float* wb = s_win + b * kXPix * kBlk + 4 * t;
      const float4 v0 = *reinterpret_cast<const float4*>(wb + (xpos[0] + shift) * kBlk);
      const float4 v8 = *reinterpret_cast<const float4*>(wb + (xpos[1] + shift) * kBlk);
      // step e of the block: slot t <- channel 4t + 2e, slot t + 4 <- 4t + 2e + 1
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 p0 = e ? split_pair(v0.z, v0.w) : split_pair(v0.x, v0.y);  // row g
        const float4 p8 = e ? split_pair(v8.z, v8.w) : split_pair(v8.x, v8.y);  // row g + 8
        ah[e][0] = __float_as_uint(p0.x);
        ah[e][1] = __float_as_uint(p8.x);
        ah[e][2] = __float_as_uint(p0.y);
        ah[e][3] = __float_as_uint(p8.y);
        al[e][0] = __float_as_uint(p0.z);
        al[e][1] = __float_as_uint(p8.z);
        al[e][2] = __float_as_uint(p0.w);
        al[e][3] = __float_as_uint(p8.w);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* bh = bw + (2 * b + e) * 8 * kCout;
        const float* bl = bh + steps * 8 * kCout;
        wgmma_k8(part, al[e], weight_desc(bh), e > 0);  // lo . hi
        wgmma_k8(part, ah[e], weight_desc(bl), 1);      // hi . lo
        wgmma_k8(part, ah[e], weight_desc(bh), 1);      // hi . hi
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(part);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        fence_operands(ah[e]);
        fence_operands(al[e]);
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    }
    // accumulator i: n tile j = i / 4, row g (i % 4 < 2) or g + 8, channel
    // 8 j + 2 t + i % 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r[h] >= kZPix) continue;
#pragma unroll
      for (int j = 0; j < kCout / 8; ++j)
        *reinterpret_cast<float2*>(s_z + r[h] * kZPitch + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    __syncthreads();  // z_t complete

#pragma unroll
    for (int k = 0; k < kSPix; ++k) {
      if (!inside[k]) continue;
      const float dy = clamped(__ldg(offp[k] + tap), clamp);
      const float dx = clamped(__ldg(offp[k] + kTaps + tap), clamp);
      const float iy = floorf(dy), ix = floorf(dx);
      const float fy = dy - iy, fx = dx - ix;
      const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
      const float w10 = fy * (1.f - fx), w11 = fy * fx;
      // z_t's window starts at image row y0 + u - 3: the corner rows
      // y0 + ly + u - 1 + iy + {0, 1} are its rows ly + iy + 2 + {0, 1}
      const float* zp =
          s_z + ((ly[k] + kReach + (int)iy) * kZW + lx[k] + kReach + (int)ix) * kZPitch + 4 * q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // channels 4 q + 4 kTPP i .. + 3
        const float* zc = zp + 4 * kTPP * i;
        const float4 c00 = *reinterpret_cast<const float4*>(zc);
        const float4 c01 = *reinterpret_cast<const float4*>(zc + kZPitch);
        const float4 c10 = *reinterpret_cast<const float4*>(zc + kZW * kZPitch);
        const float4 c11 = *reinterpret_cast<const float4*>(zc + (kZW + 1) * kZPitch);
        float* a = acc_s[k] + 4 * i;
        a[0] += w00 * c00.x + w01 * c01.x + w10 * c10.x + w11 * c11.x;
        a[1] += w00 * c00.y + w01 * c01.y + w10 * c10.y + w11 * c11.y;
        a[2] += w00 * c00.z + w01 * c01.z + w10 * c10.z + w11 * c11.z;
        a[3] += w00 * c00.w + w01 * c01.w + w10 * c10.w + w11 * c11.w;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSPix; ++k) {
    if (!inside[k]) continue;
    float* o = out + ((size_t)(n * H + y0 + ly[k]) * W + x0 + lx[k]) * kCout;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int co = 4 * q + 4 * kTPP * i;
      const float4 b = *reinterpret_cast<const float4*>(bias + co);
      *reinterpret_cast<float4*>(o + co) =
          make_float4(acc_s[k][4 * i] + b.x, acc_s[k][4 * i + 1] + b.y,
                      acc_s[k][4 * i + 2] + b.z, acc_s[k][4 * i + 3] + b.w);
    }
  }
}

__global__ void __launch_bounds__(k1Threads, 1)
deform_zform1_kernel(const float* __restrict__ x, const float* __restrict__ off,
                     const float* __restrict__ w,  // (cin, 9)
                     const float* __restrict__ bias, float* __restrict__ out, int H,
                     int W, int cin, int chunks, float clamp) {
  extern __shared__ float4 smem4[];
  // s_x: the ring of window chunks, [buffer][4-channel group][pixel][4];
  // once spent, s_z, the nine fields, [pixel][9]; s_off: the tile's
  // offsets, [pixel][19]; s_w: [channel][12]
  float* s_x = reinterpret_cast<float*>(smem4);
  float* s_z = s_x;
  float* s_off = s_x + kRing * kChunkFloats;
  float* s_w = s_off + k1TH * k1TW * kOffPitch;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * k1TW, y0 = blockIdx.y * k1TH, n = blockIdx.z;

  // window rows y0 - 3 .. y0 + 35, cols x0 - 3 .. x0 + 35; two items per
  // pixel, zero outside the image and past cin
  auto stage_chunk = [&](int chunk) {
    float* dst = s_x + (chunk % kRing) * kChunkFloats;
    for (int i = tid; i < k1XPix * 2; i += k1Threads) {
      const int p = i >> 1, c4 = 2 * chunk + (i & 1);
      const int gy = y0 - kHaloLo + p / k1XW, gx = x0 - kHaloLo + p % k1XW;
      const bool valid = 4 * c4 < cin && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = valid ? x + ((size_t)(n * H + gy) * W + gx) * cin + 4 * c4 : x;
      cp_async16(dst + ((i & 1) * k1XPix + p) * 4, src, valid);
    }
    cp_async_commit();
  };
  // the weights, zero past cin and past tap 8, and the tile's offsets, 18
  // per pixel at pitch 19, in the first chunk's group
  for (int i = tid; i < chunks * k1Chunk * kWPitch; i += k1Threads) {
    const int c = i / kWPitch, tp = i % kWPitch;
    const bool valid = c < cin && tp < kTaps;
    cp_async4(s_w + i, valid ? w + c * kTaps + tp : w, valid);
  }
  for (int i = tid; i < k1TH * k1TW * 2 * kTaps; i += k1Threads) {
    const int row = i / (k1TW * 2 * kTaps), j = i % (k1TW * 2 * kTaps);
    const int gy = y0 + row, gx = x0 + j / (2 * kTaps);
    const bool valid = gy < H && gx < W;
    cp_async4(s_off + (row * k1TW + j / (2 * kTaps)) * kOffPitch + j % (2 * kTaps),
              valid ? off + ((size_t)(n * H + gy) * W + gx) * 2 * kTaps + j % (2 * kTaps)
                    : off,
              valid);
  }
  stage_chunk(0);
  if (chunks > 1) stage_chunk(1);

  // window pixels tid, tid + 512 and tid + 1024 (the last only for tid < 497)
  float z[k1PPT][kTaps];
#pragma unroll
  for (int k = 0; k < k1PPT; ++k)
#pragma unroll
    for (int tp = 0; tp < kTaps; ++tp) z[k][tp] = 0.f;

#pragma unroll 1
  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk + 1 < chunks) {
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      cp_async_wait_all();
    }
    // the chunk (and the weights and offsets) landed; every thread is done
    // with chunk - 1, whose buffer chunk + 2 takes
    __syncthreads();
    if (chunk + 2 < chunks) stage_chunk(chunk + 2);
    const float* xs = s_x + (chunk % kRing) * kChunkFloats;
#pragma unroll
    for (int c4 = 0; c4 < 2; ++c4) {
      float4 xv[k1PPT];
#pragma unroll
      for (int k = 0; k < k1PPT; ++k) {
        const int p = min(tid + k * k1Threads, k1XPix - 1);
        xv[k] = *reinterpret_cast<const float4*>(xs + (c4 * k1XPix + p) * 4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* wr = s_w + (k1Chunk * chunk + 4 * c4 + e) * kWPitch;
        const float4 wa = *reinterpret_cast<const float4*>(wr);
        const float4 wb = *reinterpret_cast<const float4*>(wr + 4);
        const float w8 = wr[8];
#pragma unroll
        for (int k = 0; k < k1PPT; ++k) {
          if (k == k1PPT - 1 && tid + k * k1Threads >= k1XPix) continue;
          const float a = e == 0 ? xv[k].x : e == 1 ? xv[k].y : e == 2 ? xv[k].z : xv[k].w;
          z[k][0] += a * wa.x;
          z[k][1] += a * wa.y;
          z[k][2] += a * wa.z;
          z[k][3] += a * wa.w;
          z[k][4] += a * wb.x;
          z[k][5] += a * wb.y;
          z[k][6] += a * wb.z;
          z[k][7] += a * wb.w;
          z[k][8] += a * w8;
        }
      }
    }
  }
  __syncthreads();  // the ring is spent
#pragma unroll
  for (int k = 0; k < k1PPT; ++k) {
    const int p = tid + k * k1Threads;
    if (p >= k1XPix) continue;
#pragma unroll
    for (int tp = 0; tp < kTaps; ++tp) s_z[p * kTaps + tp] = z[k][tp];
  }
  __syncthreads();  // the fields stored

  // output pixels tid and tid + 512
#pragma unroll
  for (int k = 0; k < k1OPT; ++k) {
    const int op = tid + k * k1Threads;
    const int ly = op / k1TW, lx = op % k1TW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const float* o = s_off + op * kOffPitch;
    float acc = 0.f;
#pragma unroll
    for (int tp = 0; tp < kTaps; ++tp) {
      const float dy = clamped(o[tp], clamp), dx = clamped(o[kTaps + tp], clamp);
      const float iy = floorf(dy), ix = floorf(dx);
      const float fy = dy - iy, fx = dx - ix;
      // image row gy + tp / 3 - 1 + iy is window row ly + tp / 3 + iy + 2
      const float* zp = s_z + ((ly + tp / 3 + (int)iy + kReach) * k1XW + lx + tp % 3 +
                               (int)ix + kReach) * kTaps + tp;
      acc += (1.f - fy) * (1.f - fx) * zp[0];
      acc += (1.f - fy) * fx * zp[kTaps];
      acc += fy * (1.f - fx) * zp[k1XW * kTaps];
      acc += fy * fx * zp[(k1XW + 1) * kTaps];
    }
    out[(size_t)(n * H + gy) * W + gx] = acc + bias[0];
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

template <int kCout>
int launch_tc(const float* x, const float* off, const float* w, const float* bias,
              float* out, int N, int H, int W, int cin, float clamp, void* stream) {
  const int blocks = (cin + kBlk - 1) / kBlk;
  const size_t smem = sizeof(float) * tc_smem_floats<kCout>(blocks);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N);
  return launch(deform_zform_tc_kernel<kCout>, grid, kThreads, smem, stream, x, off, w,
                bias, out, H, W, cin, blocks, clamp);
}

}  // namespace

// x: (N, H, W, cin), cin a multiple of 4 in [4, 64]; off: (N, H, W, 18);
// w_packed: for cout 64 and 16 ops/deform_conv.py:pack_deform64_weight_tc,
// flat (9 * 2 * cin16 * cout,) with cin16 = cin rounded up to 16; for cout 1
// (cin, 9) with [ci][t] = weight[0, ci, t / 3, t % 3]; bias: (cout,);
// out: (N, H, W, cout), cout in {1, 16, 64}; 0 <= clamp <= 2. Returns
// cudaErrorInvalidValue for any other shape, else cudaGetLastError().
extern "C" int deform_zform(const float* x, const float* off, const float* w_packed,
                            const float* bias, float* out, int N, int H, int W,
                            int cin, int cout, float clamp, void* stream) {
  if (cin < 4 || cin > 64 || cin % 4 != 0 || !(clamp >= 0.f && clamp <= kReach))
    return (int)cudaErrorInvalidValue;
  switch (cout) {
    case 64:
      return launch_tc<64>(x, off, w_packed, bias, out, N, H, W, cin, clamp, stream);
    case 16:
      return launch_tc<16>(x, off, w_packed, bias, out, N, H, W, cin, clamp, stream);
    case 1: {
      const int chunks = (cin + k1Chunk - 1) / k1Chunk;
      const size_t smem = sizeof(float) * (kRing * (size_t)kChunkFloats +
                                           (size_t)k1TH * k1TW * kOffPitch +
                                           (size_t)chunks * k1Chunk * kWPitch);
      const dim3 grid((W + k1TW - 1) / k1TW, (H + k1TH - 1) / k1TH, N);
      return launch(deform_zform1_kernel, grid, k1Threads, smem, stream, x, off, w_packed,
                    bias, out, H, W, cin, chunks, clamp);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
