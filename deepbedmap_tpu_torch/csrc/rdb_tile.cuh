// A tile-local residual dense block, fp32, NHWC: the shared body of K6
// (rdb_banded.cu) and K5 (rrdb_sweep.cu).
//
// One thread block computes one 8 x 8 output tile of
//   out = x + s * conv5([x, a1, a2, a3, a4]),  a_j = lrelu(conv_j([x, ..]))
// with every intermediate in shared memory, as the TPU kernels keep a row
// band's intermediates in VMEM (deepbedmap_tpu/ops/pallas_rdb.py:
// _band_compute, _MARGIN = 5). Five chained 3x3 convs consume one pixel of
// margin each, so the block input is staged with a 5-px halo (18 x 18 x 64)
// and stage j computes a (18 - 2j)^2 window: a1 16^2 x 32, a2 14^2 x 32,
// a3 12^2 x 32, a4 10^2 x 32, conv5 8^2 x 64. That is 43,008 floats
// (172 KB, plus 36 KB of weight buffers), so one block per SM, in dynamic
// shared memory. No device-memory workspace is used: HBM sees the input
// window once and the output once. The price is the halo recompute: 1.77x
// the MACs of the tile's own output (3.01 M against 1.70 M multiplies per
// input-channel tap, x 9 taps).
//
// What bounds it on an H100: arithmetic. A tile does 27.1 M multiply-adds
// (its own 15.3 M and the halo's) against 83 KB of input window and 16 KB of
// output, and its 958 KB of weights come from L2; the SMs' fp32 FMA rate is
// the limit (no tensor cores in this first version).
//
// SAME padding holds at every stage: a window position outside the image
// holds zero in x and in every a_j (not a conv value computed from the padded
// input), which is the TPU kernel's masking (pallas_rdb.py:243-244).
//
// Weights use the direct conv's packed layout (conv3x3.cuh, ops/rdb.py:
// pack_rdb_weights): per stage [C_out/32][C_in][9][32], the five stages back
// to back. They stream from L2 in chunks of 8 input channels (all taps, all
// outputs of the stage), double-buffered with cp.async so the next chunk's
// copy overlaps this chunk's FMAs.
//
// Work mapping: stage j's outputs are split into units of kR rows x 1 column
// x 8 channels, one unit per thread (at most 256 units a stage); each thread
// keeps its kR x 8 accumulators in registers and reuses every input value it
// loads across the three row taps, as conv3x3.cuh does.

#pragma once

#include <cuda_runtime.h>

namespace rdbtile {

constexpr int kFeat = 64;      // block input / output channels
constexpr int kGrowth = 32;    // channels of a1..a4
constexpr int kT = 8;          // output tile side (and K5's band height)
constexpr int kMargin = 5;     // halo of the block input window
constexpr int kThreads = 256;
constexpr int kCK = 8;         // input channels per weight chunk
constexpr int kChunks = (64 + 96 + 128 + 160 + 192) / kCK;  // 80 per block
constexpr int kChunkFloats = kCK * 9 * 64;                    // largest chunk
constexpr size_t kBlockWeights =
    9 * (size_t)(64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64);

// window side of source k (0 = the block input x, 1..4 = a_k) and the side of
// stage j's output (stage 5 -> the 8 x 8 tile)
__host__ __device__ constexpr int side(int k) { return kT + 2 * (kMargin - k); }
__host__ __device__ constexpr int channels(int k) { return k == 0 ? kFeat : kGrowth; }
// channel planes are padded by one float against shared-memory bank conflicts
__host__ __device__ constexpr int plane(int k) { return side(k) * side(k) + 1; }
__host__ __device__ constexpr int src_offset(int k) {
  int off = 0;
  for (int m = 0; m < k; ++m) off += channels(m) * plane(m);
  return off;
}
// Stage 2's last row group computes two rows past its window; its loads run
// up to two rows into the next plane. The slack keeps them inside the buffer.
constexpr int kSlack = 64;
constexpr int kWbufOffset = src_offset(5) + kSlack;
constexpr int kSmemFloats = kWbufOffset + 2 * kChunkFloats;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
static_assert(kSmemBytes <= 232448, "tile does not fit in shared memory");

__host__ __device__ constexpr int stage_cin(int j) { return kFeat + kGrowth * (j - 1); }
__host__ __device__ constexpr int stage_cout(int j) { return j < 5 ? kGrowth : kFeat; }
__host__ __device__ constexpr size_t stage_woff(int j) {
  size_t off = 0;
  for (int m = 1; m < j; ++m) off += 9 * (size_t)stage_cin(m) * stage_cout(m);
  return off;
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start the copy of the block's weight chunk q (0..79) into `dst`, laid out
// [C_out/32][8 channels][9][32].
__device__ __forceinline__ void load_chunk(float* dst, const float* w, int q) {
  int j = 1, first = 0;
  while (q >= first + stage_cin(j) / kCK) {
    first += stage_cin(j) / kCK;
    ++j;
  }
  const int cin = stage_cin(j);
  const int per_ct = kCK * 9 * 32 / 4;  // float4s of one 32-channel slice
  const float* src = w + stage_woff(j) + (size_t)(q - first) * kCK * 9 * 32;
  for (int i = threadIdx.x; i < (stage_cout(j) / 32) * per_ct; i += kThreads) {
    const int ct = i / per_ct, r = i % per_ct;
    cp_async16(dst + ct * (kCK * 9 * 32) + 4 * r,
               src + (size_t)ct * cin * 9 * 32 + 4 * r);
  }
}

// Stage the block input window, rows ty0-5 .. ty0+12, cols tx0-5 .. tx0+12,
// channel-major, zero outside the image. `ld(gy, gx, c4)` returns channels
// 4 c4 .. 4 c4 + 3 of pixel (gy, gx); it is called only for in-image pixels.
template <class Loader>
__device__ __forceinline__ void load_input(float* smem, const Loader& ld, int ty0,
                                           int tx0, int H, int W) {
  constexpr int S = side(0);
  for (int i = threadIdx.x; i < S * S * (kFeat / 4); i += kThreads) {
    const int p = i / (kFeat / 4), c4 = i % (kFeat / 4);
    const int gy = ty0 - kMargin + p / S, gx = tx0 - kMargin + p % S;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = ld(gy, gx, c4);
    float* d = smem + 4 * c4 * plane(0) + p;
    d[0] = v.x;
    d[plane(0)] = v.y;
    d[2 * plane(0)] = v.z;
    d[3 * plane(0)] = v.w;
  }
}

// acc += the 8 input channels at `src` (row stride ss, channel stride ps)
// times the staged chunk `wc` (this thread's 8 outputs), over the 3 x 3 taps.
template <int kR>
__device__ __forceinline__ void accumulate(float (&acc)[kR][8], const float* src,
                                           int ss, int ps, const float* wc) {
#pragma unroll 2
  for (int c = 0; c < kCK; ++c) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      float col[kR + 2];
#pragma unroll
      for (int r = 0; r < kR + 2; ++r) col[r] = src[c * ps + r * ss + kx];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float4* wp = reinterpret_cast<const float4*>(wc + (c * 9 + ky * 3 + kx) * 32);
        const float4 wa = wp[0], wb = wp[1];
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[r][jj] += col[r + ky] * wv[jj];
      }
    }
  }
}

// Stage kJ (1..5) of the tile whose output origin is (ty0, tx0); q counts the
// block's weight chunks (chunk q is already in flight on entry). Stages 1-4
// write lrelu(conv + b) into a_kJ, zero outside the image; stage 5 calls
// epi(gy, gx, co, v, x) for each in-image output, v = conv5 + b5 and x the
// block input at that pixel.
template <int kJ, int kR, class Epilogue>
__device__ __forceinline__ void stage(float* smem, const float* w, const float* bias,
                                      int& q, int ty0, int tx0, int H, int W,
                                      const Epilogue& epi) {
  constexpr int S = side(kJ);
  constexpr int CG = stage_cout(kJ) / 8;
  constexpr int NRG = (S + kR - 1) / kR;
  static_assert(S * CG * NRG <= kThreads, "more units than threads");
  const int u = threadIdx.x;
  const bool active = u < S * CG * NRG;
  const int px = u % S, cg = (u / S) % CG, rg = u / (S * CG);
  float acc[kR][8];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[r][jj] = 0.f;

  for (int ci0 = 0; ci0 < stage_cin(kJ); ci0 += kCK, ++q) {
    float* wbuf = smem + kWbufOffset;
    if (q + 1 < kChunks) load_chunk(wbuf + ((q + 1) & 1) * kChunkFloats, w, q + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (active) {
      const int k = ci0 < kFeat ? 0 : 1 + (ci0 - kFeat) / kGrowth;
      const int cl = ci0 < kFeat ? ci0 : (ci0 - kFeat) % kGrowth;
      const int ss = side(k) , ps = plane(k);
      const int d = kJ - 1 - k;  // stage kJ's window sits d px inside source k's
      const float* src = smem + src_offset(k) + cl * ps + (rg * kR + d) * ss + px + d;
      const float* wc = wbuf + (q & 1) * kChunkFloats + (cg >> 2) * (kCK * 9 * 32) +
                        (cg & 3) * 8;
      accumulate<kR>(acc, src, ss, ps, wc);
    }
    __syncthreads();
  }
  if (!active) return;

  const int oy0 = ty0 - (kMargin - kJ), ox0 = tx0 - (kMargin - kJ);
  const int gx = ox0 + px;
  const float* b = bias + kGrowth * (kJ - 1) + cg * 8;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int oy = rg * kR + r;
    if (oy >= S) continue;
    const int gy = oy0 + oy;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    if constexpr (kJ < 5) {
      float* dst = smem + src_offset(kJ) + (cg * 8) * plane(kJ) + oy * S + px;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        dst[jj * plane(kJ)] = in ? lrelu(acc[r][jj] + b[jj]) : 0.f;
    } else {
      if (!in) continue;
      const float* xs = smem + (cg * 8) * plane(0) + (oy + kMargin) * side(0) + px + kMargin;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        epi(gy, gx, cg * 8 + jj, acc[r][jj] + b[jj], xs[jj * plane(0)]);
    }
  }
}

// The whole dense block on one 8 x 8 tile. `w` / `bias` are the block's
// packed weights and its 192 biases. Ends with a barrier, so the caller may
// start the next tile at once.
template <class Loader, class Epilogue>
__device__ __forceinline__ void dense_block_tile(float* smem, const Loader& ld,
                                                 const float* w, const float* bias,
                                                 int ty0, int tx0, int H, int W,
                                                 const Epilogue& epi) {
  int q = 0;
  load_chunk(smem + kWbufOffset, w, 0);
  cp_async_commit();
  load_input(smem, ld, ty0, tx0, H, W);
  stage<1, 4>(smem, w, bias, q, ty0, tx0, H, W, epi);
  stage<2, 4>(smem, w, bias, q, ty0, tx0, H, W, epi);
  stage<3, 3>(smem, w, bias, q, ty0, tx0, H, W, epi);
  stage<4, 2>(smem, w, bias, q, ty0, tx0, H, W, epi);
  stage<5, 2>(smem, w, bias, q, ty0, tx0, H, W, epi);
  __syncthreads();
}

}  // namespace rdbtile
