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

// ---------------------------------------------------------------------------
// The backward kernels of K2 / K7 and of K3 / K8. The TPU kernels have none:
// JAX's VJPs are autodiff of the plain composition (pallas_tail.py:_fused_bwd,
// deform_conv.py:_pallas_bwd). These compute, in closed form, the gradient
// that autograd of the port's masked-shift plain versions gives
// (ops/deform_conv.py: deform_conv_shifts [+ leaky_relu], sample_tap_fields),
// with their conventions: a displacement is clamped to [-clamp, clamp] and its
// gradient passes where -clamp <= d <= clamp (torch.clamp's backward), 0
// beyond; the base corner is floor(d) and the fraction f = d - floor(d) has
// derivative 1, so the sample's derivative in dy is the x-blend of row iy + 1
// less that of row iy, also at an integer d where f = 0; a corner outside the
// image reads 0 and takes no gradient; K2's LeakyReLU passes 1 where the
// pre-activation is >= 0 and 0.2 elsewhere, read from the sign of K2's saved
// output. Everything is fp32 FMA, and no float atomics: cross-block sums are
// partials added in a fixed order, so a gradient repeats bit for bit.
//
// K2 / K7, with g' the upstream gradient through the LeakyReLU, S_t a tap's
// bilinear samples, W_t its (C_out, C_in) weights:
//   dW_t = S_t^T g',  db = sum g',  dS_t = g' W_t,
//   d dy_t = sum_c dS_t (x-blend of row iy + 1 - of row iy), d dx_t alike,
//   dx(r) = sum_t sum over the samples with a corner on r: weight . dS_t.
// What bounds it at a training step's shape (128, 36, 36, 64): the two
// 64 x 64 products per tap and pixel, 2 x 12.2 GFLOP on the fp32 units
// (0.36 ms at 67 TFLOP/s); its bytes (x, offsets, output, gradient in; dx,
// d offsets out; ~0.2 GB) take ~0.06 ms. Three launches:
// 1. deform64_bwd_tap_kernel: block (b, tap) walks the 8 x 8 pixel tiles b,
//    b + B, ... for its one tap. Per tile it stages the 13 x 13 window of x
//    that the tap's samples reach (as K2's forward window, clamp <= 2), g'
//    and the tap's corner weights, rebuilds S_t in shared memory, and with a
//    4 x 4 register tile a thread forms dS_t = g' W_t (to a scratch
//    (N, H, W, 9, 64) for launch 2), the offsets' gradient from dS_t and the
//    window (summed over the 16 lanes that hold a pixel's channels), and
//    S_t^T g' into the block's dW_t partial, held in registers across its
//    tiles (tap 0 also the bias').
// 2. deform64_bwd_dx_kernel: dx by gather. Each input pixel of an 8 x 8 tile
//    sums, per tap, the 6 x 6 output pixels whose sample can have a corner on
//    it (the masked shifts read backwards), weighted by the plain version's
//    shift masks, from shared-memory windows of dS_t and the offsets.
// 3. deform64_bwd_reduce_kernel: the B partials of dW and db, summed in
//    block order into OIHW.
// K3 / K8 (deform_zproj1_bwd_kernel): a bandwidth pass on K3's 8 x 32 tile:
// d offsets from the forward's z window, dz by the same gather over the
// candidates' g and offsets, the tile's sum of g for the bias, then one
// block adds the tiles' sums (sum_partials_kernel).

constexpr float kSlope = 0.2f;                 // LeakyReLU's negative slope
constexpr int kBT = 8;                         // the backward's tiles: 8 x 8 pixels
constexpr int kBPix = kBT * kBT;
constexpr int kBWin = kBT + 2 * kReach + 1;    // 13: a tap's sample rows of a tile
constexpr int kBWinPix = kBWin * kBWin;
constexpr int kShifts = 2 * kReach + 2;        // integer shifts a sample's corners span
constexpr int kBThreads = 256;
constexpr int kPitch = kC + 4;                 // rows of W_t, g' and S_t in shared memory
static_assert(kBPix == kC, "the 4 x 4 register tiles assume 64 pixels and 64 channels");
constexpr size_t kSmemBwd =
    sizeof(float) * (3 * (size_t)kC * kPitch + (size_t)kBWinPix * kC + 8 * kBPix) +
    sizeof(int) * kBPix;
constexpr size_t kSmemZBwd = sizeof(float) * (size_t)kZWinH * kZWinW * (kTaps + 1 + kOffPitch);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// the plain version's mask weight of integer shift s for a sample with base
// i and fraction f: (1 - f) [i == s] + f [i == s - 1]
__device__ __forceinline__ float shift_weight(float i, float f, float s) {
  return i == s ? 1.f - f : (i == s - 1.f ? f : 0.f);
}

template <bool kApplyLrelu>
__global__ void __launch_bounds__(kBThreads, 2)
deform64_bwd_tap_kernel(const float* __restrict__ x, const float* __restrict__ off,
                        const float* __restrict__ w,   // OIHW (64, 64, 3, 3)
                        const float* __restrict__ y,   // the forward's output
                        const float* __restrict__ gy,  // its gradient
                        float* __restrict__ ds, float* __restrict__ doff,
                        float* __restrict__ part, int N, int H, int W, float clamp) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [c_out][kPitch]: W_t
  float* s_g = s_w + kC * kPitch;                // [pixel][kPitch]: g'
  float* s_s = s_g + kBPix * kPitch;             // [pixel][kPitch]: S_t
  float* s_win = s_s + kBPix * kPitch;           // [window pixel][64]: x
  float* s_cw = s_win + kBWinPix * kC;           // [pixel][4]: corner weights
  float* s_fy = s_cw + 4 * kBPix;                // [pixel]: fractions and clamp masks
  float* s_fx = s_fy + kBPix;
  float* s_my = s_fx + kBPix;
  float* s_mx = s_my + kBPix;
  int* s_base = reinterpret_cast<int*>(s_mx + kBPix);  // [pixel]: corner 0's window pixel

  const int tap = blockIdx.y, u = tap / 3, v = tap % 3;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles_x = (W + kBT - 1) / kBT, tiles_img = tiles_x * ((H + kBT - 1) / kBT);
  const int tiles = N * tiles_img;

  for (int i = tid; i < kC * kC; i += kBThreads)  // i = o * 64 + c
    s_w[(i / kC) * kPitch + i % kC] = w[(size_t)i * kTaps + tap];

  float dw[4][4];  // dW_t[4 ty + a][4 tx + b], over the block's tiles
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dw[a][b] = 0.f;
  float db = 0.f;  // tap 0: db[tid], tid < 64

#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / tiles_img, rem = tile % tiles_img;
    const int i0 = rem / tiles_x * kBT, j0 = rem % tiles_x * kBT;
    // image row i0 + u - 1 - kReach is window row 0
    const int wr0 = i0 + u - 1 - kReach, wc0 = j0 + v - 1 - kReach;
    __syncthreads();  // every thread is done with the last tile
    for (int i = tid; i < kBWinPix * (kC / 4); i += kBThreads) {
      const int p = i >> 4, c4 = i & 15;
      const int gr = wr0 + p / kBWin, gc = wc0 + p % kBWin;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr >= 0 && gr < H && gc >= 0 && gc < W)
        val = ld4(x + ((size_t)(n * H + gr) * W + gc) * kC + 4 * c4);
      st4(s_win + p * kC + 4 * c4, val);
    }
    for (int i = tid; i < kBPix * (kC / 4); i += kBThreads) {
      const int p = i >> 4, c4 = i & 15;
      const int gr = i0 + p / kBT, gc = j0 + p % kBT;
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);  // 0 past the image's edge
      if (gr < H && gc < W) {
        const size_t e = ((size_t)(n * H + gr) * W + gc) * kC + 4 * c4;
        g = ld4(gy + e);
        if (kApplyLrelu) {
          const float4 o = ld4(y + e);
          g.x *= o.x >= 0.f ? 1.f : kSlope;
          g.y *= o.y >= 0.f ? 1.f : kSlope;
          g.z *= o.z >= 0.f ? 1.f : kSlope;
          g.w *= o.w >= 0.f ? 1.f : kSlope;
        }
      }
      st4(s_g + p * kPitch + 4 * c4, g);
    }
    if (tid < kBPix) {
      // pixels past the image's edge read an edge pixel's offsets: finite,
      // and their g' is 0
      const int ly = tid / kBT, lx = tid % kBT;
      const float* o = off + ((size_t)(n * H + min(i0 + ly, H - 1)) * W +
                              min(j0 + lx, W - 1)) * 2 * kTaps;
      const float ry = o[tap], rx = o[kTaps + tap];
      const float dy = clamped(ry, clamp), dx = clamped(rx, clamp);
      const float iy = floorf(dy), ix = floorf(dx);
      const float fy = dy - iy, fx = dx - ix;
      s_base[tid] = (ly + (int)iy + kReach) * kBWin + lx + (int)ix + kReach;
      st4(s_cw + 4 * tid, make_float4((1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                                      fy * (1.f - fx), fy * fx));
      s_fy[tid] = fy;
      s_fx[tid] = fx;
      s_my[tid] = ry >= -clamp && ry <= clamp ? 1.f : 0.f;
      s_mx[tid] = rx >= -clamp && rx <= clamp ? 1.f : 0.f;
    }
    __syncthreads();

    // S_t: thread (ty, tx) blends channels 4 tx .. 4 tx + 3 of pixels ty + 16 k
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = ty + 16 * k;
      const float* q = s_win + s_base[p] * kC + 4 * tx;
      const float4 c00 = ld4(q), c01 = ld4(q + kC), c10 = ld4(q + kBWin * kC),
                   c11 = ld4(q + (kBWin + 1) * kC);
      const float4 cw = ld4(s_cw + 4 * p);
      st4(s_s + p * kPitch + 4 * tx,
          make_float4(cw.x * c00.x + cw.y * c01.x + cw.z * c10.x + cw.w * c11.x,
                      cw.x * c00.y + cw.y * c01.y + cw.z * c10.y + cw.w * c11.y,
                      cw.x * c00.z + cw.y * c01.z + cw.z * c10.z + cw.w * c11.z,
                      cw.x * c00.w + cw.y * c01.w + cw.z * c10.w + cw.w * c11.w));
    }
    __syncthreads();

    // dS_t[ty + 16 k][4 tx + b] = sum_o g'[p][o] W_t[o][c]
    float d[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b) d[k][b] = 0.f;
#pragma unroll 4
    for (int o = 0; o < kC; o += 4) {
      float4 gk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) gk[k] = ld4(s_g + (ty + 16 * k) * kPitch + o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 wr = ld4(s_w + (o + e) * kPitch + 4 * tx);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float gv = lane4(gk[k], e);
          d[k][0] = fmaf(gv, wr.x, d[k][0]);
          d[k][1] = fmaf(gv, wr.y, d[k][1]);
          d[k][2] = fmaf(gv, wr.z, d[k][2]);
          d[k][3] = fmaf(gv, wr.w, d[k][3]);
        }
      }
    }
    // dW_t[4 ty + a][4 tx + b] += sum_p g'[p][o] S_t[p][c]
#pragma unroll 4
    for (int p = 0; p < kBPix; ++p) {
      const float4 gp = ld4(s_g + p * kPitch + 4 * ty);
      const float4 sp = ld4(s_s + p * kPitch + 4 * tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ga = lane4(gp, a);
        dw[a][0] = fmaf(ga, sp.x, dw[a][0]);
        dw[a][1] = fmaf(ga, sp.y, dw[a][1]);
        dw[a][2] = fmaf(ga, sp.z, dw[a][2]);
        dw[a][3] = fmaf(ga, sp.w, dw[a][3]);
      }
    }
    if (tap == 0 && tid < kC)
      for (int p = 0; p < kBPix; ++p) db += s_g[p * kPitch + tid];

    // dS_t out, and the offsets' gradient of each pixel: dS_t against the
    // window's differences, summed over the 16 lanes (one half-warp) that
    // hold the pixel's 64 channels
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = ty + 16 * k;
      const float* q = s_win + s_base[p] * kC + 4 * tx;
      const float4 c00 = ld4(q), c01 = ld4(q + kC), c10 = ld4(q + kBWin * kC),
                   c11 = ld4(q + (kBWin + 1) * kC);
      const float fy = s_fy[p], fx = s_fx[p];
      float gdy = d[k][0] * ((1.f - fx) * (c10.x - c00.x) + fx * (c11.x - c01.x));
      gdy = fmaf(d[k][1], (1.f - fx) * (c10.y - c00.y) + fx * (c11.y - c01.y), gdy);
      gdy = fmaf(d[k][2], (1.f - fx) * (c10.z - c00.z) + fx * (c11.z - c01.z), gdy);
      gdy = fmaf(d[k][3], (1.f - fx) * (c10.w - c00.w) + fx * (c11.w - c01.w), gdy);
      float gdx = d[k][0] * ((1.f - fy) * (c01.x - c00.x) + fy * (c11.x - c10.x));
      gdx = fmaf(d[k][1], (1.f - fy) * (c01.y - c00.y) + fy * (c11.y - c10.y), gdx);
      gdx = fmaf(d[k][2], (1.f - fy) * (c01.z - c00.z) + fy * (c11.z - c10.z), gdx);
      gdx = fmaf(d[k][3], (1.f - fy) * (c01.w - c00.w) + fy * (c11.w - c10.w), gdx);
#pragma unroll
      for (int m = 8; m >= 1; m >>= 1) {
        gdy += __shfl_xor_sync(0xffffffffu, gdy, m);
        gdx += __shfl_xor_sync(0xffffffffu, gdx, m);
      }
      const int gr = i0 + p / kBT, gc = j0 + p % kBT;
      if (gr < H && gc < W) {
        const size_t pix = (size_t)(n * H + gr) * W + gc;
        st4(ds + (pix * kTaps + tap) * kC + 4 * tx,
            make_float4(d[k][0], d[k][1], d[k][2], d[k][3]));
        if (tx == 0) {
          doff[pix * 2 * kTaps + tap] = s_my[p] != 0.f ? gdy : 0.f;
          doff[pix * 2 * kTaps + kTaps + tap] = s_mx[p] != 0.f ? gdx : 0.f;
        }
      }
    }
  }

  // partials: [tap][block][o][c], then the bias' [block][o]
  float* pw = part + ((size_t)tap * gridDim.x + blockIdx.x) * kC * kC;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    st4(pw + (4 * ty + a) * kC + 4 * tx, make_float4(dw[a][0], dw[a][1], dw[a][2], dw[a][3]));
  if (tap == 0 && tid < kC)
    part[(size_t)kTaps * gridDim.x * kC * kC + (size_t)blockIdx.x * kC + tid] = db;
}

__global__ void __launch_bounds__(kBThreads)
deform64_bwd_dx_kernel(const float* __restrict__ off, const float* __restrict__ ds,
                       float* __restrict__ dx, int H, int W, float clamp) {
  __shared__ float4 s_ds[kBWinPix * kC / 4];  // [candidate pixel][16 float4]: dS_t
  __shared__ float4 s_par[kBWinPix];          // [candidate pixel]: iy, fy, ix, fx
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.y * kBT, q0 = blockIdx.x * kBT, n = blockIdx.z;

  float acc[4][4];  // dx[pixel ty + 16 k][channel 4 tx + b]
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[k][b] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < kTaps; ++tap) {
    const int u = tap / 3, v = tap % 3;
    // output pixel i reaches input row r by the shift s = r - i - (u - 1) in
    // [-kReach, kReach + 1]: the tile's candidates start at row r0 - u - kReach
    const int cr0 = r0 - u - kReach, cc0 = q0 - v - kReach;
    __syncthreads();  // every thread is done with the last tap
    for (int i = tid; i < kBWinPix * (kC / 4); i += kBThreads) {
      const int p = i >> 4, c4 = i & 15;
      const int gr = cr0 + p / kBWin, gc = cc0 + p % kBWin;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr >= 0 && gr < H && gc >= 0 && gc < W)
        val = ld4(ds + (((size_t)(n * H + gr) * W + gc) * kTaps + tap) * kC + 4 * c4);
      s_ds[i] = val;
    }
    for (int p = tid; p < kBWinPix; p += kBThreads) {
      const int gr = cr0 + p / kBWin, gc = cc0 + p % kBWin;
      float4 par = make_float4(1e4f, 0.f, 1e4f, 0.f);  // outside the image: no shift matches
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
        const float* o = off + ((size_t)(n * H + gr) * W + gc) * 2 * kTaps;
        const float dy = clamped(o[tap], clamp), dxv = clamped(o[kTaps + tap], clamp);
        const float iy = floorf(dy), ix = floorf(dxv);
        par = make_float4(iy, dy - iy, ix, dxv - ix);
      }
      s_par[p] = par;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = ty + 16 * k, lr = p / kBT, lq = p % kBT;
#pragma unroll
      for (int a = 0; a < kShifts; ++a) {
        const float sy = (float)(kReach + 1 - a);  // candidate row cr0 + lr + a
#pragma unroll
        for (int b = 0; b < kShifts; ++b) {
          const int cp = (lr + a) * kBWin + lq + b;
          const float4 par = s_par[cp];
          const float wgt = shift_weight(par.x, par.y, sy) *
                            shift_weight(par.z, par.w, (float)(kReach + 1 - b));
          if (wgt != 0.f) {
            const float4 dv = s_ds[cp * (kC / 4) + tx];
            acc[k][0] = fmaf(wgt, dv.x, acc[k][0]);
            acc[k][1] = fmaf(wgt, dv.y, acc[k][1]);
            acc[k][2] = fmaf(wgt, dv.z, acc[k][2]);
            acc[k][3] = fmaf(wgt, dv.w, acc[k][3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = ty + 16 * k, gr = r0 + p / kBT, gc = q0 + p % kBT;
    if (gr < H && gc < W)
      st4(dx + ((size_t)(n * H + gr) * W + gc) * kC + 4 * tx,
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]));
  }
}

__global__ void deform64_bwd_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ dw, float* __restrict__ db,
                                           int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kTaps * kC * kC) {
    const int tap = i / (kC * kC), oc = i % (kC * kC);  // oc = o * 64 + c
    const float* p = part + (size_t)tap * blocks * kC * kC + oc;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += p[(size_t)b * kC * kC];
    dw[(size_t)oc * kTaps + tap] = s;  // OIHW
  } else if (i < kTaps * kC * kC + kC) {
    const int o = i - kTaps * kC * kC;
    const float* p = part + (size_t)kTaps * blocks * kC * kC + o;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += p[(size_t)b * kC];
    db[o] = s;
  }
}

__global__ void __launch_bounds__(kThreadsZ)
deform_zproj1_bwd_kernel(const float* __restrict__ z, const float* __restrict__ off,
                         const float* __restrict__ gy, float* __restrict__ dz,
                         float* __restrict__ doff, float* __restrict__ part, int H, int W,
                         float clamp) {
  extern __shared__ float4 smem4[];
  // the forward's z window (origin y0 - 3, x0 - 3), then the candidates'
  // gradient and offsets (origin y0 - 4, x0 - 4: an output pixel reaches
  // input rows -3 .. +4 of its own, so an input pixel is reached from -4 .. +3)
  float* s_z = reinterpret_cast<float*>(smem4);  // [15][39][9]
  float* s_g = s_z + kZWinH * kZWinW * kTaps;    // [15][39]
  float* s_o = s_g + kZWinH * kZWinW;            // [15][39][kOffPitch]
  __shared__ float s_sum[kThreadsZ / 32];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kZTW, y0 = blockIdx.y * kZTH, n = blockIdx.z;

  for (int i = tid; i < kZWinH * kZWinW * kTaps; i += kThreadsZ) {
    const int r = i / (kZWinW * kTaps), j = i % (kZWinW * kTaps);
    const int gr = y0 - kHaloLo + r, gc = x0 - kHaloLo + j / kTaps;
    float val = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      val = z[((size_t)(n * H + gr) * W + gc) * kTaps + j % kTaps];
    s_z[i] = val;
  }
  const int cy0 = y0 - kHaloLo - 1, cx0 = x0 - kHaloLo - 1;
  for (int i = tid; i < kZWinH * kZWinW; i += kThreadsZ) {
    const int gr = cy0 + i / kZWinW, gc = cx0 + i % kZWinW;
    s_g[i] = gr >= 0 && gr < H && gc >= 0 && gc < W ? gy[(size_t)(n * H + gr) * W + gc] : 0.f;
  }
  for (int i = tid; i < kZWinH * kZWinW * 2 * kTaps; i += kThreadsZ) {
    const int p = i / (2 * kTaps), j = i % (2 * kTaps);
    const int gr = cy0 + p / kZWinW, gc = cx0 + p % kZWinW;
    float val = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      val = off[((size_t)(n * H + gr) * W + gc) * 2 * kTaps + j];
    s_o[p * kOffPitch + j] = val;
  }
  __syncthreads();

  const int ly = tid / kZTW, lx = tid % kZTW;
  const int gr = y0 + ly, gc = x0 + lx;
  const int self = (ly + kHaloLo + 1) * kZWinW + lx + kHaloLo + 1;
  const float g = s_g[self];  // 0 past the image's edge
  // the bias: the tile's sum of g, in a fixed order
  float t = g;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) t += __shfl_xor_sync(0xffffffffu, t, m);
  if ((tid & 31) == 0) s_sum[tid >> 5] = t;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreadsZ / 32; ++i) s += s_sum[i];
    part[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
  }
  if (gr >= H || gc >= W) return;
  const size_t pix = (size_t)(n * H + gr) * W + gc;

  // the offsets' gradient at this output pixel
  const float* o = s_o + self * kOffPitch;
#pragma unroll
  for (int tp = 0; tp < kTaps; ++tp) {
    const float ry = o[tp], rx = o[kTaps + tp];
    const float dy = clamped(ry, clamp), dx = clamped(rx, clamp);
    const float iy = floorf(dy), ix = floorf(dx);
    const float fy = dy - iy, fx = dx - ix;
    // as the forward: image row gr + tp / 3 - 1 + iy is window row ly + tp / 3 + iy + 2
    const float* zp = s_z +
        ((ly + tp / 3 + (int)iy + kReach) * kZWinW + lx + tp % 3 + (int)ix + kReach) * kTaps + tp;
    const float z00 = zp[0], z01 = zp[kTaps], z10 = zp[kZWinW * kTaps],
                z11 = zp[(kZWinW + 1) * kTaps];
    const float gdy = g * ((1.f - fx) * (z10 - z00) + fx * (z11 - z01));
    const float gdx = g * ((1.f - fy) * (z01 - z00) + fy * (z11 - z10));
    doff[pix * 2 * kTaps + tp] = ry >= -clamp && ry <= clamp ? gdy : 0.f;
    doff[pix * 2 * kTaps + kTaps + tp] = rx >= -clamp && rx <= clamp ? gdx : 0.f;
  }

  // dz of this input pixel: per tap the 6 x 6 output pixels (gr - u - kReach
  // + a, gc - v - kReach + b), which reach it by the shift kReach + 1 - a
#pragma unroll 1
  for (int tp = 0; tp < kTaps; ++tp) {
    const int u = tp / 3, v = tp % 3;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < kShifts; ++a) {
      const float sy = (float)(kReach + 1 - a);
#pragma unroll
      for (int b = 0; b < kShifts; ++b) {
        const int cp = (ly + kHaloLo + 1 - kReach - u + a) * kZWinW +
                       lx + kHaloLo + 1 - kReach - v + b;
        const float* co = s_o + cp * kOffPitch;
        const float dy = clamped(co[tp], clamp), dx = clamped(co[kTaps + tp], clamp);
        const float iy = floorf(dy), ix = floorf(dx);
        const float wgt = shift_weight(iy, dy - iy, sy) *
                          shift_weight(ix, dx - ix, (float)(kReach + 1 - b));
        acc = fmaf(wgt, s_g[cp], acc);
      }
    }
    dz[pix * kTaps + tp] = acc;
  }
}

// out[0] = the sum of part[0 .. count), in a fixed order
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int count) {
  __shared__ float s[256];
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += 256) acc += part[i];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int m = 128; m > 0; m >>= 1) {
    if (threadIdx.x < m) s[threadIdx.x] += s[threadIdx.x + m];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = s[0];
}

template <bool kApplyLrelu>
int launch_deform64_bwd(const float* x, const float* off, const float* w, const float* y,
                        const float* gy, float* dx, float* doff, float* dw, float* db,
                        float* ds, float* part, int N, int H, int W, float clamp, int blocks,
                        void* stream) {
  if (!clamp_in_window(clamp) || blocks < 1) return (int)cudaErrorInvalidValue;
  auto tap_kernel = deform64_bwd_tap_kernel<kApplyLrelu>;
  cudaError_t err = cudaFuncSetAttribute(
      tap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBwd);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tap_kernel<<<dim3(blocks, kTaps), kBThreads, kSmemBwd, s>>>(x, off, w, y, gy, ds, doff,
                                                              part, N, H, W, clamp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid((W + kBT - 1) / kBT, (H + kBT - 1) / kBT, N);
  deform64_bwd_dx_kernel<<<grid, kBThreads, 0, s>>>(off, ds, dx, H, W, clamp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int outs = kTaps * kC * kC + kC;
  deform64_bwd_reduce_kernel<<<(outs + 255) / 256, 256, 0, s>>>(part, dw, db, blocks);
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

// The backward of K2 (lrelu 1) and K7 (lrelu 0): x, y (the forward's output),
// gy (its gradient), dx, ds: (N, H, W, 64), ds (N, H, W, 9, 64) scratch;
// off, doff: (N, H, W, 18); w, dw: OIHW (64, 64, 3, 3); db: (64,); part:
// (9 * 4096 + 64) * blocks scratch, blocks in [1, tiles] where tiles =
// N * ceil(H / 8) * ceil(W / 8); 0 <= clamp <= 2. Writes every gradient
// whole. Returns cudaErrorInvalidValue for another clamp, else
// cudaGetLastError().
extern "C" int deform64_bwd(const float* x, const float* off, const float* w,
                            const float* y, const float* gy, float* dx, float* doff,
                            float* dw, float* db, float* ds, float* part, int N, int H,
                            int W, float clamp, int lrelu, int blocks, void* stream) {
  return lrelu ? launch_deform64_bwd<true>(x, off, w, y, gy, dx, doff, dw, db, ds, part, N,
                                           H, W, clamp, blocks, stream)
               : launch_deform64_bwd<false>(x, off, w, y, gy, dx, doff, dw, db, ds, part, N,
                                            H, W, clamp, blocks, stream);
}

// The backward of K3 / K8: z, dz: (N, H, W, 9); off, doff: (N, H, W, 18); gy:
// (N, H, W, 1); db: (1,); part: ceil(W / 32) * ceil(H / 8) * N scratch;
// 0 <= clamp <= 2. Returns cudaErrorInvalidValue for another clamp, else
// cudaGetLastError().
extern "C" int deform_zproj1_bwd(const float* z, const float* off, const float* gy,
                                 float* dz, float* doff, float* db, float* part, int N,
                                 int H, int W, float clamp, void* stream) {
  if (!clamp_in_window(clamp)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      deform_zproj1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemZBwd);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kZTW - 1) / kZTW, (H + kZTH - 1) / kZTH, N);
  deform_zproj1_bwd_kernel<<<grid, kThreadsZ, kSmemZBwd, s>>>(z, off, gy, dz, doff, part, H,
                                                               W, clamp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, 256, 0, s>>>(part, db, (int)(grid.x * grid.y * grid.z));
  return (int)cudaGetLastError();
}
