// K1: one residual dense block (RDB) forward, fp32, NHWC.
//
// Replaces the TPU kernel deepbedmap_tpu/ops/pallas_rdb.py:rdb_pallas_flat
// (_rdb_flat_kernel, body _band_compute): five chained 3x3 SAME convs with
// inputs of 64/96/128/160/192 channels and outputs of 32/32/32/32/64, dense
// concatenation, LeakyReLU(0.2) after conv1-4, and out = x + s * conv5.
//
// What bounds it on an H100: arithmetic. One block at the main-path shape
// (2 x 286 x 286 x 64) is 78 GFLOP against ~0.4 GB of activation traffic, so
// it sits far above the fp32 ridge point; the fp32 FMA rate of the SMs is the
// limit (no tensor cores in this first version).
//
// Design: the TPU kernel keeps every intermediate of a row band in VMEM. This
// first Hopper version keeps them in a dense NHWC workspace (N, H, W, 192) in
// device memory instead: x is copied into channels 0-63 and stage j writes
// its 32 outputs into channels 64 + 32 (j - 1), so stage j's input is simply
// the first 64 + 32 (j - 1) channels. Each stage is one launch of a direct
// 3x3 conv: a block computes a 16 x 16 pixel tile for 32 output channels,
// staging a 18 x 18 input halo tile and the matching weight slice in shared
// memory 16 input channels at a time; each thread keeps 8 rows x 8 channels
// of accumulators in registers and reuses every input value it loads across
// the three row taps. Zero padding outside the image is written into the
// staged tile. Intermediates in shared memory and wgmma are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 64;        // block input/output channels
constexpr int kGrowth = 32;      // channels added by conv1-4
constexpr int kWsC = kFeat + 4 * kGrowth;  // workspace channels: 192
constexpr int kTile = 16;        // output tile side in pixels
constexpr int kHalo = kTile + 2;
constexpr int kCK = 16;          // input channels staged per pass
constexpr int kCOT = 32;         // output channels per block
constexpr int kThreads = 128;
constexpr int kRows = 8;         // output rows per thread
constexpr int kCPT = 8;          // output channels per thread

// One 3x3 SAME conv stage. `in` is NHWC with channel pitch `in_pitch`; the
// first `cin` channels are read. `w` is packed [cout / 32][cin][9][32].
// res == nullptr: out[pix * out_pitch + out_off + co] = lrelu(acc + b)
// res != nullptr: out[pix * kFeat + co] = res[pix * kFeat + co] + s * (acc + b)
__global__ void __launch_bounds__(kThreads)
conv3x3_stage(const float* __restrict__ in, int in_pitch, int cin,
              const float* __restrict__ w, const float* __restrict__ bias,
              float* out, int out_pitch, int out_off,
              const float* __restrict__ res, float scaling,
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
    for (int i = tid; i < kCK * kHalo * kHalo; i += kThreads) {
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
    for (int i = tid; i < kCK * 9 * kCOT / 4; i += kThreads) wdst[i] = wsrc[i];
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
      float v = acc[r][j] + bias[co];
      if (res == nullptr) {
        out[pix * out_pitch + out_off + co] = v >= 0.f ? v : 0.2f * v;
      } else {
        out[pix * kFeat + co] = res[pix * kFeat + co] + scaling * v;
      }
    }
  }
}

// x (P, 64) -> ws[:, 0:64] of the (P, 192) workspace, one float4 per thread.
__global__ void copy_into_workspace(const float4* __restrict__ x,
                                    float4* __restrict__ ws, long long total4) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const long long pix = i / (kFeat / 4), q = i % (kFeat / 4);
  ws[pix * (kWsC / 4) + q] = x[i];
}

}  // namespace

// x, out: (N, H, W, 64); ws: (N, H, W, 192) scratch; w_packed: the five
// stages' [cout/32][cin][9][32] blocks back to back; bias: b1|b2|b3|b4|b5
// (192 floats). Returns cudaGetLastError() after the last launch.
extern "C" int rdb_forward(const float* x, float* ws, float* out,
                           const float* w_packed, const float* bias, int N,
                           int H, int W, float scaling, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total4 = (long long)N * H * W * (kFeat / 4);
  const int copy_threads = 256;
  copy_into_workspace<<<(unsigned)((total4 + copy_threads - 1) / copy_threads),
                        copy_threads, 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(ws), total4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 tiles((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, 1);
  const float* wj = w_packed;
  for (int j = 0; j < 5; ++j) {
    const int cin = kFeat + kGrowth * j;
    const int cout = j < 4 ? kGrowth : kFeat;
    const int cout_tiles = cout / kCOT;
    const dim3 grid(tiles.x, tiles.y, N * cout_tiles);
    const float* bj = bias + kGrowth * j;
    if (j < 4) {
      conv3x3_stage<<<grid, kThreads, 0, s>>>(ws, kWsC, cin, wj, bj, ws, kWsC,
                                              cin, nullptr, 0.f, H, W,
                                              cout_tiles);
    } else {
      conv3x3_stage<<<grid, kThreads, 0, s>>>(ws, kWsC, cin, wj, bj, out, kFeat,
                                              0, x, scaling, H, W, cout_tiles);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wj += (size_t)cin * 9 * cout;
  }
  return (int)cudaGetLastError();
}
