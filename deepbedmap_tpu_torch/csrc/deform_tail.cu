// K2 and K3: the two deformable output layers of the generator tail, fp32,
// NHWC. Offsets follow the JAX layout: channels [0, 9) are the row (dy)
// displacements and [9, 18) the column (dx) displacements, taps row-major
// over the 3x3 kernel. Both clamp each displacement to [-clamp, clamp] and
// take the bilinear sample at p + (u - 1, v - 1) + (dy, dx) with
// floor(dy) / floor(dx) as the base corner; corners outside the image count
// as zero. That is exactly the masked-shift sum of
// deepbedmap_tpu/ops/deform_conv.py:_deform_conv_shifts, whose weights are
// (1 - f) on the floor shift and f on the next one and zero elsewhere.
//
// Both kernels stage, per output tile, the window of the input that every
// tap's samples can reach: 3 px of tap and clamp reach before the tile and 4
// after it (the second corner), zero outside the image. When a displacement
// is exactly +clamp the far corner has weight 0 and is still read, from the
// window's last row or column. The windows are sized for clamp <= 2 (the JAX
// kernels assert the same reach, pallas_kernels.py:_LANE_HALO); the entry
// points refuse any other clamp.
//
// K2 deform64_lrelu replaces stage A of
// deepbedmap_tpu/ops/pallas_tail.py:_fused_tail_pallas, the body
// deepbedmap_tpu/ops/pallas_kernels.py:_deform_stacked_kernel (pack_taps,
// apply_lrelu): a 64 -> 64 deformable conv with the bias and LeakyReLU(0.2),
// which samples every tap and runs one (C_out, 9 C) @ (9 C, 128) contraction
// on the MXU. K7 deform_conv replaces deepbedmap_tpu/ops/pallas_kernels.py:
// deform_conv2d_pallas, whose default body is the same _deform_stacked_kernel
// without the LeakyReLU: it is the same kernel with the LeakyReLU switched off
// at compile time (the unfused tail applies it outside, as JAX does).
// What bounds it on an H100: the 576 -> 64 contraction, 193 GFLOP at the
// main-path shape (2 x 1144 x 1144 x 64), on the tensor cores as 3xTF32 (the
// split of conv3x3_tc.cuh: lo.hi + hi.lo + hi.hi in fp32 accumulators), plus
// the bilinear blend of 9 x 64 samples per pixel on the fp32 units.
// Design: an implicit GEMM on wgmma.m64n64k8 (TF32, A from registers, B from
// shared memory), with the 16 x 16 tile and the four warpgroups of
// conv3x3_tc.cuh: M = the tile's pixels (warp w holds tile row w, its lane
// (g, t) pixels g and g + 8), N = all 64 outputs, K = 9 taps x 64 channels.
// A is each tap's blended bilinear samples: a lane reads its two pixels' four
// corners straight from the shared-memory window, blends them in fp32 and
// splits the result into TF32 hi/lo in registers (split_pair), so no sample
// tile is stored. The window holds a pixel's channels in 16-channel blocks,
// [block][pixel][16], and lane t's 16-byte read of a block gives channels
// 4t .. 4t + 3: slots t and t + 4 of one k8 step take channels 4t + 2e and
// 4t + 2e + 1 (e = 0, 1 for the block's two steps). B is the tap's weights,
// split into hi/lo once per model by ops/deform_conv.py:
// pack_deform64_weight_tc in wgmma's K-major core-matrix layout with the same
// channel order, copied per tap with cp.async into a double buffer while the
// previous tap runs. Each group of two k8 steps (one window block) goes into
// a fresh partial sum (six products) that is added to the running sum in
// fp32: the tensor cores do not round their sums to nearest, and short chains
// keep their drift below fp32 round-off (as in conv3x3_tc.cuh). A warpgroup
// samples a group, issues its products and waits for them; the four
// warpgroups of a block overlap one another's sampling and products. The
// epilogue adds the bias and applies the LeakyReLU before the only store.
//
// K3 deform_zproj1 replaces stage B of the same function, the body
// deepbedmap_tpu/ops/pallas_kernels.py:_deform_zproj1_kernel: the 64 -> 1
// deformable conv computed projection first. Its input is z (N, H, W, 9),
// the nine tap fields z_t = a5 . W2_t; the kernel sums, over the nine taps,
// the clamped bilinear sample of field t at tap t's shifted position, and adds
// the bias. z is zero outside the image, which is the halo masking the TPU
// kernel does by hand. What bounds it: memory (z and the offsets read once,
// the output written once). Design: a block owns an 8 x 32 output tile and
// stages its z window (15 x 39 pixels x 9 fields) and its offsets (pitch 19,
// odd, so one pixel per lane reads them free of bank conflicts) with
// coalesced loads of whole row segments; each thread then reads its pixel's
// 36 corners from shared memory (the 9-float pixel pitch is odd too).
// K8 (deepbedmap_tpu/ops/pallas_kernels.py:deform_conv2d_pallas_zproj1) is
// the same function behind a standalone 64 -> 1 deformable conv: its wrapper
// computes z with a matmul and launches this same entry. On the TPU the two
// also share one body (_deform_zproj1_kernel).

#include <cstdint>

#include <cuda_runtime.h>

#include "conv3x3_tc.cuh"

namespace {

constexpr int kC = 64;      // channels of the 64 -> 64 layer
constexpr int kTaps = 9;
constexpr int kReach = 2;   // largest clamp the windows are sized for
constexpr int kHaloLo = kReach + 1;  // window rows / cols before the tile

// K2 / K7: conv3x3_tc.cuh's 16 x 16 tile (kTileW, kTileRows), four
// warpgroups (kThreads)
constexpr int kWinW = kTileW + 2 * kHaloLo + 1;     // 23
constexpr int kWinH = kTileRows + 2 * kHaloLo + 1;  // 23
constexpr int kWinPix = kWinW * kWinH;
constexpr int kBlk = 16;                 // channels of one window block
constexpr int kStepFloats = 8 * kC;      // one k8 step of B: 64 x 8
constexpr int kTapW = 2 * 8 * kStepFloats;  // one tap's B, hi then lo
// k8 steps per wgmma group (one window block): 3 x 2 products per partial
// sum. Four steps need 128 registers against 112 and ran slower on an H100
// (chip_tail_variants.py).
constexpr int kGroupSteps = 2;
constexpr int kTapGroups = 8 / kGroupSteps;  // wgmma groups per tap
constexpr size_t kSmem64 = sizeof(float) * (2 * (size_t)kTapW + (size_t)kWinPix * kC);

// K3
constexpr int kZTH = 8, kZTW = 32;
constexpr int kThreadsZ = kZTH * kZTW;                // one pixel per thread
constexpr int kZWinH = kZTH + 2 * kHaloLo + 1;        // 15
constexpr int kZWinW = kZTW + 2 * kHaloLo + 1;        // 39
constexpr int kOffPitch = 2 * kTaps + 1;              // odd: conflict-free

__device__ __forceinline__ float clamped(float d, float clamp) {
  return fminf(fmaxf(d, -clamp), clamp);
}

template <bool kApplyLrelu>
__global__ void __launch_bounds__(kThreads, 1)
deform64_tc_kernel(const float* __restrict__ x, const float* __restrict__ off,
                   const float* __restrict__ w,  // pack_deform64_weight_tc
                   const float* __restrict__ bias, float* __restrict__ out, int H,
                   int W, float clamp) {
  extern __shared__ float4 smem4[];
  // s_w: two taps' B, [buffer][hi | lo][k8 step][n / 8][k / 4][n % 8][k % 4];
  // s_win: the window, [channel block][pixel][16 channels]
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_win = s_w + 2 * kTapW;

  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileRows, n = blockIdx.z;

  auto load_tap = [&](int tap) {
    const float* src = w + (size_t)tap * kTapW;
    float* dst = s_w + (tap & 1) * kTapW;
    for (int i = tid; i < kTapW / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i, true);
    cp_async_commit();
  };

  // the window: rows y0 - 3 .. y0 + 19, cols x0 - 3 .. x0 + 19; sixteen
  // threads copy one pixel's 64 channels, 16 bytes each, four per block
  for (int i = tid; i < kWinPix * kC / 4; i += kThreads) {
    const int p = i >> 4, c4 = i & 15;
    const int gy = y0 - kHaloLo + p / kWinW, gx = x0 - kHaloLo + p % kWinW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* src = inside ? x + ((size_t)(n * H + gy) * W + gx) * kC + 4 * c4 : x;
    cp_async16(s_win + ((c4 >> 2) * kWinPix + p) * kBlk + 4 * (c4 & 3), src, inside);
  }
  load_tap(0);  // one commit group with the window

  // the lane's two pixels: tile row `row`, columns g and g + 8 (clamped into
  // the image, so that lanes past its edge read finite offsets; their
  // results are never stored)
  const float* offp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    offp[h] = off + ((size_t)(n * H + min(y0 + row, H - 1)) * W +
                     min(x0 + g + 8 * h, W - 1)) * 2 * kTaps;

  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < kTaps; ++tap) {
    cp_async_wait_all();
    // make the copied weights visible to wgmma's reads (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tap's B (and the window) landed; every warpgroup is done with tap - 1
    if (tap + 1 < kTaps) load_tap(tap + 1);

    // corners: window pixel base[h] and its right, lower and lower-right
    // neighbours, with weights cw[h][0..3]
    const int u = tap / 3, v = tap % 3;
    int base[2];
    float cw[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float dy = clamped(__ldg(offp[h] + tap), clamp);
      const float dx = clamped(__ldg(offp[h] + kTaps + tap), clamp);
      const float iy = floorf(dy), ix = floorf(dx);
      const float fy = dy - iy, fx = dx - ix;
      // image row y0 + row + u - 1 + iy is window row row + u + iy + 2
      base[h] = (row + u + (int)iy + kReach) * kWinW + g + 8 * h + v + (int)ix + kReach;
      cw[h][0] = (1.f - fy) * (1.f - fx);
      cw[h][1] = (1.f - fy) * fx;
      cw[h][2] = fy * (1.f - fx);
      cw[h][3] = fy * fx;
    }
    const float* bw = s_w + (tap & 1) * kTapW;

#pragma unroll 1
    for (int grp = 0; grp < kTapGroups; ++grp) {
      uint32_t ah[kGroupSteps][4], al[kGroupSteps][4];
#pragma unroll
      for (int b = 0; b < kGroupSteps / 2; ++b) {
        const float* wb = s_win + (grp * kGroupSteps / 2 + b) * kWinPix * kBlk + 4 * t;
        float s[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* p = wb + base[h] * kBlk;
          const float4 c00 = *reinterpret_cast<const float4*>(p);
          const float4 c01 = *reinterpret_cast<const float4*>(p + kBlk);
          const float4 c10 = *reinterpret_cast<const float4*>(p + kWinW * kBlk);
          const float4 c11 = *reinterpret_cast<const float4*>(p + (kWinW + 1) * kBlk);
          s[h][0] = cw[h][0] * c00.x + cw[h][1] * c01.x + cw[h][2] * c10.x + cw[h][3] * c11.x;
          s[h][1] = cw[h][0] * c00.y + cw[h][1] * c01.y + cw[h][2] * c10.y + cw[h][3] * c11.y;
          s[h][2] = cw[h][0] * c00.z + cw[h][1] * c01.z + cw[h][2] * c10.z + cw[h][3] * c11.z;
          s[h][3] = cw[h][0] * c00.w + cw[h][1] * c01.w + cw[h][2] * c10.w + cw[h][3] * c11.w;
        }
        // step e of the block: slot t <- channel 4t + 2e, slot t + 4 <- 4t + 2e + 1
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 p0 = split_pair(s[0][2 * e], s[0][2 * e + 1]);  // pixel g
          const float4 p8 = split_pair(s[1][2 * e], s[1][2 * e + 1]);  // pixel g + 8
          const int k = 2 * b + e;
          ah[k][0] = __float_as_uint(p0.x);
          ah[k][1] = __float_as_uint(p8.x);
          ah[k][2] = __float_as_uint(p0.y);
          ah[k][3] = __float_as_uint(p8.y);
          al[k][0] = __float_as_uint(p0.z);
          al[k][1] = __float_as_uint(p8.z);
          al[k][2] = __float_as_uint(p0.w);
          al[k][3] = __float_as_uint(p8.w);
        }
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < kGroupSteps; ++k) {
        const float* bh = bw + (grp * kGroupSteps + k) * kStepFloats;
        const float* bl = bh + 8 * kStepFloats;
        wgmma_k8(part, al[k], weight_desc(bh), k > 0);  // lo . hi
        wgmma_k8(part, ah[k], weight_desc(bl), 1);      // hi . lo
        wgmma_k8(part, ah[k], weight_desc(bh), 1);      // hi . hi
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(part);
#pragma unroll
      for (int k = 0; k < kGroupSteps; ++k) {
        fence_operands(ah[k]);
        fence_operands(al[k]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
    }
  }

  // accumulator i: n tile j = i / 4, pixel g (i % 4 < 2) or g + 8 of the
  // warp's row, channel 8 j + 2 t + i % 2
  const int gy = y0 + row;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + g + 8 * h;
    if (gy >= H || gx >= W) continue;
    const size_t pix = (size_t)(n * H + gy) * W + gx;
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
      const int co = 8 * j + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(bias + co);
      float2 o = make_float2(acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);
      if (kApplyLrelu) o = make_float2(lrelu(o.x), lrelu(o.y));
      *reinterpret_cast<float2*>(out + pix * kC + co) = o;
    }
  }
}

__global__ void __launch_bounds__(kThreadsZ)
deform_zproj1_kernel(const float* __restrict__ z, const float* __restrict__ off,
                     const float* __restrict__ bias, float* __restrict__ out, int H,
                     int W, float clamp) {
  __shared__ float s_z[kZWinH * kZWinW * kTaps];
  __shared__ float s_off[kThreadsZ * kOffPitch];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kZTW, y0 = blockIdx.y * kZTH, n = blockIdx.z;

  // z window rows y0 - 3 .. y0 + 11, each a run of 39 x 9 floats of one image
  // row (cols x0 - 3 .. x0 + 35), zero outside the image
  for (int i = tid; i < kZWinH * kZWinW * kTaps; i += kThreadsZ) {
    const int r = i / (kZWinW * kTaps), j = i % (kZWinW * kTaps);
    const int gy = y0 - kHaloLo + r, gx = x0 - kHaloLo + j / kTaps;
    float val = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = z[((size_t)(n * H + gy) * W + gx) * kTaps + j % kTaps];
    s_z[i] = val;
  }
  // the tile's offsets, 18 per pixel, stored at pitch 19
  for (int i = tid; i < kZTH * kZTW * 2 * kTaps; i += kThreadsZ) {
    const int r = i / (kZTW * 2 * kTaps), j = i % (kZTW * 2 * kTaps);
    const int gy = y0 + r, gx = x0 + j / (2 * kTaps);
    float val = 0.f;
    if (gy < H && gx < W) val = off[((size_t)(n * H + gy) * W + gx) * 2 * kTaps + j % (2 * kTaps)];
    s_off[(r * kZTW + j / (2 * kTaps)) * kOffPitch + j % (2 * kTaps)] = val;
  }
  __syncthreads();

  const int ly = tid / kZTW, lx = tid % kZTW;
  const int gy = y0 + ly, gx = x0 + lx;
  if (gy >= H || gx >= W) return;
  const float* o = s_off + tid * kOffPitch;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float dy = clamped(o[t], clamp), dx = clamped(o[kTaps + t], clamp);
    const float iy = floorf(dy), ix = floorf(dx);
    const float fy = dy - iy, fx = dx - ix;
    // image row gy + t / 3 - 1 + iy is window row ly + t / 3 + iy + 2
    const float* zp = s_z +
        ((ly + t / 3 + (int)iy + kReach) * kZWinW + lx + t % 3 + (int)ix + kReach) * kTaps + t;
    acc += (1.f - fy) * (1.f - fx) * zp[0];
    acc += (1.f - fy) * fx * zp[kTaps];
    acc += fy * (1.f - fx) * zp[kZWinW * kTaps];
    acc += fy * fx * zp[(kZWinW + 1) * kTaps];
  }
  out[(size_t)(n * H + gy) * W + gx] = acc + bias[0];
}

bool clamp_in_window(float clamp) { return clamp >= 0.f && clamp <= kReach; }

template <bool kApplyLrelu>
int launch_deform64(const float* x, const float* off, const float* w_packed,
                    const float* bias, float* out, int N, int H, int W, float clamp,
                    void* stream) {
  if (!clamp_in_window(clamp)) return (int)cudaErrorInvalidValue;
  auto kernel = deform64_tc_kernel<kApplyLrelu>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem64);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileRows - 1) / kTileRows, N);
  kernel<<<grid, kThreads, kSmem64, static_cast<cudaStream_t>(stream)>>>(
      x, off, w_packed, bias, out, H, W, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// Both: x, out: (N, H, W, 64); off: (N, H, W, 18); w_packed: (9 * 8192,) from
// ops/deform_conv.py:pack_deform64_weight_tc; bias: (64,); 0 <= clamp <= 2.
// Return cudaErrorInvalidValue for another clamp, else cudaGetLastError().
// K2: out = lrelu(deform_conv(x) + bias).
extern "C" int deform64_lrelu(const float* x, const float* off,
                              const float* w_packed, const float* bias,
                              float* out, int N, int H, int W, float clamp,
                              void* stream) {
  return launch_deform64<true>(x, off, w_packed, bias, out, N, H, W, clamp, stream);
}

// K7: out = deform_conv(x) + bias.
extern "C" int deform_conv(const float* x, const float* off,
                           const float* w_packed, const float* bias, float* out,
                           int N, int H, int W, float clamp, void* stream) {
  return launch_deform64<false>(x, off, w_packed, bias, out, N, H, W, clamp, stream);
}

// z: (N, H, W, 9); off: (N, H, W, 18); bias: (1,); out: (N, H, W, 1);
// 0 <= clamp <= 2. Returns cudaErrorInvalidValue for another clamp, else
// cudaGetLastError().
extern "C" int deform_zproj1(const float* z, const float* off, const float* bias,
                             float* out, int N, int H, int W, float clamp,
                             void* stream) {
  if (!clamp_in_window(clamp)) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kZTW - 1) / kZTW, (H + kZTH - 1) / kZTH, N);
  deform_zproj1_kernel<<<grid, kThreadsZ, 0, static_cast<cudaStream_t>(stream)>>>(
      z, off, bias, out, H, W, clamp);
  return (int)cudaGetLastError();
}
