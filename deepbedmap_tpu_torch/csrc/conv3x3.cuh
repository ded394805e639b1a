// The port's one direct 3x3 SAME convolution, fp32, NHWC, shared by the
// dense-block kernels K1 and K4 (rdb.cu) and the standalone conv K10
// (conv3x3.cu). Each includer gets its own instantiations (anonymous
// namespace); the epilogue is a compile-time mode.
//
// What bounds it on an H100: arithmetic. At every shape the port runs it
// (64-192 input channels, 32 or 64 outputs, 286^2 to 1144^2 pixels) a conv
// does 2 x 9 x C_in flops per output value against a few bytes, far above the
// fp32 ridge point, so the SMs' fp32 FMA rate is the limit (no tensor cores
// in this first version).
//
// Design: a block computes a 16 x 16 pixel tile for 32 output channels,
// staging a 18 x 18 input halo tile and the matching weight slice in shared
// memory 16 input channels at a time; each thread keeps 8 rows x 8 channels
// of accumulators in registers and reuses every input value it loads across
// the three row taps. Zero padding outside the image is written into the
// staged tile. The input is read with a channel pitch, so a stage can read the
// first C_in channels of a wider workspace; the output is written with its
// own pitch for the same reason. Weights are packed [C_out/32][C_in][9][32].

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;   // output tile side in pixels
constexpr int kHalo = kTile + 2;
constexpr int kCK = 16;     // input channels staged per pass
constexpr int kCOT = 32;    // output channels per block
constexpr int kConvThreads = 128;
constexpr int kRows = 8;    // output rows per thread
constexpr int kCPT = 8;     // output channels per thread

// The epilogue applied to v = acc + bias[co] before the only store.
enum EpilogueMode : int {
  kLrelu,       // out = lrelu(v)                            K1/K4 stages 1-4, K10
  kScaledSkip,  // out = res + s * v                         K1/K4 stage 5
  kDoubleSkip,  // out = skip + s * (res + s * v)            K4, last stage 5
  kLinear,      // out = v                                   K10
  kAdd,         // out = v + res                             K10
  kAddLrelu,    // out = lrelu(v + res)                      K10
};

// Where the epilogue writes and what it adds (host side; the kernel takes the
// fields as parameters). Element (pixel p, channel co) is
// out[p * out_pitch + co], res[p * res_pitch + co], skip[p * 64 + co].
struct Epilogue {
  float* out;
  int out_pitch;
  const float* res;
  int res_pitch;
  const float* skip;
  float scaling;
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

// The epilogue's pointers are separate kernel parameters (not the Epilogue
// struct) and the launch bounds ask for 3 blocks per SM. Neither changes the
// arithmetic: both steer ptxas's register allocation and the schedule of the
// main loop, to which this kernel's speed is very sensitive (PERF.md, PR 2:
// with the struct and no bound, K1 ran 7% slower than its PR 1 version).
template <int kMode>
__global__ void __launch_bounds__(kConvThreads, 3)
conv3x3_stage(const float* __restrict__ in, int in_pitch, int cin,
              const float* __restrict__ w, const float* __restrict__ bias,
              float* out, int out_pitch, const float* __restrict__ res,
              int res_pitch, const float* __restrict__ skip, float scaling,
              int H, int W, int cout_tiles) {
  __shared__ float s_in[kCK][kHalo][kHalo];
  __shared__ __align__(16) float s_w[kCK][9][kCOT];

  const int tid = threadIdx.x;
  const int cg = tid & 3;            // channels cg*8 .. cg*8+7 of the tile
  const int pg = tid >> 2;           // 0..31
  const int px = pg & 15;            // tile column
  const int py0 = (pg >> 4) * kRows; // first tile row (0 or 8)
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int n = blockIdx.z / cout_tiles;
  const int ct = blockIdx.z % cout_tiles;

  float acc[kRows][kCPT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCPT; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCK) {
    for (int i = tid; i < kCK * kHalo * kHalo; i += kConvThreads) {
      const int c = i % kCK;
      const int p = i / kCK;
      const int ly = p / kHalo, lx = p % kHalo;
      const int gy = y0 + ly - 1, gx = x0 + lx - 1;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = in[((size_t)(n * H + gy) * W + gx) * in_pitch + c0 + c];
      s_in[c][ly][lx] = v;
    }
    const float4* wsrc = reinterpret_cast<const float4*>(
        w + ((size_t)ct * cin + c0) * 9 * kCOT);
    float4* wdst = reinterpret_cast<float4*>(&s_w[0][0][0]);
    for (int i = tid; i < kCK * 9 * kCOT / 4; i += kConvThreads) wdst[i] = wsrc[i];
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kCK; ++c) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float col[kRows + 2];
#pragma unroll
        for (int r = 0; r < kRows + 2; ++r) col[r] = s_in[c][py0 + r][px + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4* wp =
              reinterpret_cast<const float4*>(&s_w[c][ky * 3 + kx][cg * kCPT]);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[kCPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int j = 0; j < kCPT; ++j) acc[r][j] += col[r + ky] * wv[j];
        }
      }
    }
    __syncthreads();
  }

  const int gx = x0 + px;
  if (gx >= W) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gy = y0 + py0 + r;
    if (gy >= H) continue;
    const size_t pix = (size_t)(n * H + gy) * W + gx;
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int co = ct * kCOT + cg * kCPT + j;
      const float v = acc[r][j] + bias[co];
      float o;
      if constexpr (kMode == kLrelu) {
        o = lrelu(v);
      } else if constexpr (kMode == kScaledSkip) {
        o = res[pix * res_pitch + co] + scaling * v;
      } else if constexpr (kMode == kDoubleSkip) {
        o = skip[pix * 64 + co] +
            scaling * (res[pix * res_pitch + co] + scaling * v);
      } else if constexpr (kMode == kLinear) {
        o = v;
      } else if constexpr (kMode == kAdd) {
        o = v + res[pix * res_pitch + co];
      } else {
        static_assert(kMode == kAddLrelu, "unknown epilogue mode");
        o = lrelu(v + res[pix * res_pitch + co]);
      }
      out[pix * out_pitch + co] = o;
    }
  }
}

// One conv launch: the first `cin` channels of `in` (channel pitch
// `in_pitch`) -> `cout` channels through the epilogue. cin must be a multiple
// of 16 and cout of 32. Returns cudaGetLastError().
template <int kMode>
cudaError_t launch_conv3x3(const float* in, int in_pitch, int cin,
                           const float* w, const float* bias, int cout,
                           const Epilogue& ep, int N, int H, int W,
                           cudaStream_t s) {
  const int cout_tiles = cout / kCOT;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N * cout_tiles);
  conv3x3_stage<kMode><<<grid, kConvThreads, 0, s>>>(
      in, in_pitch, cin, w, bias, ep.out, ep.out_pitch, ep.res, ep.res_pitch,
      ep.skip, ep.scaling, H, W, cout_tiles);
  return cudaGetLastError();
}

}  // namespace
