// A tile-local residual dense block, fp32, NHWC, on Hopper's tensor cores:
// the shared body of K6 (rdb_banded.cu) and K5 (rrdb_sweep.cu).
//
// One thread block computes one 8 x 16 output tile (8 rows, 16 columns) of
//   out = x + s * conv5([x, a1, a2, a3, a4]),  a_j = lrelu(conv_j([x, ..]))
// with every intermediate in shared memory, as the TPU kernels keep a row
// band's intermediates in VMEM (deepbedmap_tpu/ops/pallas_rdb.py:
// _band_compute, _MARGIN = 5). Five chained 3x3 convs consume one pixel of
// margin each, so stage j computes the window of a_j that the later stages
// read: (18 - 2j) x (26 - 2j) pixels, a1 16 x 24, a2 14 x 22, a3 12 x 20,
// a4 10 x 18, conv5 the 8 x 16 tile. a1..a4 stay resident (139 KB); the
// block input x (an 18 x 26 window) is not held whole but staged one 8-channel
// chunk at a time when a stage reads it, from L2 or HBM. No device-memory
// workspace is used. The price is the halo recompute: the padded stage
// windows cost 1.58x the MACs of the tile's own output (48.4 M against
// 30.7 M).
//
// SAME padding holds at every stage: a window position outside the image
// holds zero in x and in every a_j (not a conv value computed from the padded
// input), which is the TPU kernel's masking (pallas_rdb.py:243-244).
//
// What bounds it on an H100: tensor-core operations (the function's own work
// in 3xTF32 is 0.475 ms for a dense block at the main-path shape). Each stage
// is an implicit GEMM on wgmma.m64n32k8 (TF32, A from registers, B from
// shared memory), made fp32-accurate by the 3xTF32 split of conv3x3_tc.cuh,
// whose primitives it uses:
// - M = the stage window's pixels, flattened and padded to 64-row blocks
//   (384 / 320 / 256 / 192 / 128 rows); N = 32 outputs per item (stage 5's
//   64 as two halves); K = 8-channel chunks x 9 taps. Work items (M block,
//   N half) go round-robin to the four warpgroups (6 / 5 / 4 / 3 / 4 items).
//   Rows past the window read its last pixel and are never stored.
// - A: warp w of a warpgroup holds rows 16 w .. 16 w + 15 of its M block; a
//   lane (g, t) reads channels 2t and 2t + 1 of its rows g and g + 8 (the
//   permuted k order of conv3x3_tc.cuh: slot t <- channel 2t, slot t + 4 <-
//   2t + 1) as one 8-byte load and splits them into TF32 hi/lo in registers.
//   a1..a4 are stored [pixel][chunk ^ (pixel & 3)][8], so the four pixels of
//   a half-warp's load fall in four different 8-bank groups; the staged x
//   chunk is [pixel][8], already conflict-free.
// - B: the stage's weights, split into hi/lo once per model by
//   ops/rdb.py:pack_rdb_weights_tc in wgmma's K-major core-matrix layout and
//   streamed per (chunk, kernel row), a unit: 3 taps x {hi, lo} x 8 x C_out
//   floats (6 / 12 KB) into a 3-slot ring, two units ahead, with 16-byte
//   cp.async.cg; one barrier per unit, 240 per tile.
// - Per unit a warpgroup issues, for each of its items, the three taps'
//   products, small ones first (lo.hi, hi.lo, hi.hi), into a fresh partial
//   sum, waits, and adds it to the running sum in fp32: one chain per stage
//   would drift past the float64 precision check (the tensor cores do not
//   round their sums to nearest), chains of nine products do not. The four
//   warpgroups overlap one another's loads and products.
// - Every branch and loop around the wgmma instructions is uniform in the
//   warp as the compiler sees it (the warpgroup index is broadcast with a
//   shuffle, copies are predicated rather than branched): the same code
//   with branches on the thread index runs slower (chip_tile_variants.py's
//   "divergent" variant).
// Shared memory: a1..a4 142,336 B, two x-chunk slots 29,952 B, the weight
// ring 36,864 B: 209,152 B, one block (512 threads, <= 128 registers) per SM.
//
// bf16 multiplicands (the TPU kernels' mxu_bf16, pallas_rdb.py:124-128) take
// a route of their own, stage_bf16 below (route (a)): the same tile, windows,
// work items, A rows and epilogues on wgmma.m64n32k16.f32.bf16.bf16, with no
// TF32 pass and no hi/lo. What bounds it: the flops at the bf16 peak (989
// TFLOP/s), 0.079 ms a dense block at (2, 286, 286, 64), 0.238 ms an RRDB;
// its own floor is the 1.58x halo recompute above, plus one dense block's
// bf16 weights (479 KB) streamed from L2 per tile: 621 MB per K6 launch over
// its 1296 tiles, 1.86 GB per K5 launch.
// - The block input's 18 x 26 x 64 window is landed as fp32 by cp.async.cg,
//   its four 16-channel planes with stage 1's units, each thread its own
//   16-byte pieces, into two fp32 landing slots that alias the a-region
//   (free until stage 1's epilogue); each thread rounds its own pieces to
//   bf16 (cvt.rn.bf16x2.f32, to nearest even) at the unit's barrier into the
//   resident x: [plane][pixel][16] bf16, 59,904 B, kept for all five stages.
//   No x chunk is staged again.
// - Stages 1-4's epilogues write a_j = bf16(lrelu(conv + b)) (zero outside
//   the image), which is what rounding at every later read gave, into
//   [plane][pixel][16] bf16 (71,168 B for a1..a4). A lane's 8-byte load gives
//   a pixel's channels 4t..4t + 3 of a plane, the k slot order of
//   conv3x3_tc.cuh's conv3x3_tc_stage_bf16; a half-warp's four pixels are
//   consecutive along a window row, so only a load whose four rows wrap
//   across an odd-width shift falls into one bank group twice (rare: no
//   swizzle).
// - The weights come packed in bf16 by ops/rdb.py:pack_rdb_weights_tc(
//   mxu_bf16=True), the bytes of K1's pack_rdb_weights(mxu_bf16=True):
//   per stage [C_in/16][tap][C_out/8][2][8][8], the B descriptor's K-major
//   core matrices; stage 5's two N halves are the same blocks read from 4
//   core-matrix rows (1024 B) further on. A unit is 32 input channels (two
//   k16 steps) x 9 taps (18,432 / 36,864 B), copied straight into a 2-slot
//   ring one unit ahead, one barrier per unit: 20 a tile. Units of 16
//   channels in a 3-slot ring two ahead (40 barriers) ran 14-15% slower
//   (chip_tile_variants.py's "unit16").
// - Per k16 step a warpgroup issues, for each of its items, the nine taps'
//   products as one commit group onto the item's accumulator: one chain per
//   stage (bf16 products are exact in fp32; a partial sum per nine taps ran
//   2-6% slower, chip_tile_variants.py's "partial").
// Shared memory: a1..a4 71,168 B, x 59,904 B, the weight ring 73,728 B:
// 204,800 B, one block (512 threads, <= 128 registers) per SM.
//
// Every read of the block input goes through L2 (cp.async.cg in the staging,
// the loader's own choice in the epilogue), because K5's block inputs are ring
// slots that other blocks rewrite between grid barriers.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "conv3x3_tc.cuh"

namespace rdbtile {

constexpr int kFeat = 64;    // block input / output channels
constexpr int kGrowth = 32;  // channels of a1..a4
constexpr int kTH = 8;       // tile rows (and K5's band height)
constexpr int kTW = 16;      // tile columns
constexpr int kMargin = 5;   // halo of the block input window
constexpr int kThreads = 512;
constexpr int kCK = 8;       // input channels per chunk: one k8 step

// window of source k (0 = the block input x, 1..4 = a_k, 5 = the tile)
__host__ __device__ constexpr int win_rows(int k) { return kTH + 2 * (kMargin - k); }
__host__ __device__ constexpr int win_cols(int k) { return kTW + 2 * (kMargin - k); }
__host__ __device__ constexpr int win_pix(int k) { return win_rows(k) * win_cols(k); }

__host__ __device__ constexpr int stage_cin(int j) { return kFeat + kGrowth * (j - 1); }
__host__ __device__ constexpr int stage_cout(int j) { return j < 5 ? kGrowth : kFeat; }
// floats of one streamed weight unit: 3 taps x {hi, lo} x 8 x C_out
__host__ __device__ constexpr int unit_floats(int j) { return 3 * 2 * kCK * stage_cout(j); }
__host__ __device__ constexpr int stage_units(int j) { return 3 * stage_cin(j) / kCK; }
__host__ __device__ constexpr size_t stage_woff(int j) {
  size_t off = 0;
  for (int m = 1; m < j; ++m) off += (size_t)stage_units(m) * unit_floats(m);
  return off;
}
constexpr int kUnits = stage_units(1) + stage_units(2) + stage_units(3) + stage_units(4) +
                       stage_units(5);  // 240 per tile
// floats of one dense block's packed weights (hi and lo): 2 x 9 x sum C_in C_out
constexpr size_t kBlockWeights = stage_woff(6);

// shared memory, in floats
__host__ __device__ constexpr int act_offset(int k) {  // a_k, k = 1..4
  int off = 0;
  for (int m = 1; m < k; ++m) off += win_pix(m) * kGrowth;
  return off;
}
constexpr int kXSlotFloats = win_pix(0) * kCK;
constexpr int kXOffset = act_offset(5);
constexpr int kSlotFloats = unit_floats(5);
constexpr int kRingSlots = 3;
constexpr int kRingOffset = kXOffset + 2 * kXSlotFloats;
constexpr int kSmemFloats = kRingOffset + kRingSlots * kSlotFloats;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
static_assert(kSmemBytes <= 232448, "tile does not fit in shared memory");
static_assert(kXOffset % 4 == 0 && kRingOffset % 4 == 0, "16-byte alignment");
static_assert(unit_floats(5) / 4 <= 2 * kThreads && 2 * win_pix(0) <= 2 * kThreads,
              "a unit's copies take at most two rounds of the block");

// 16-byte cp.async.cg of src_bytes (16, or 0 to zero-fill) issued where
// `pred` holds, as one predicated instruction rather than a branch, so that
// every loop of the tile stays convergent (see above).
__device__ __forceinline__ void cp_async16_pred(void* dst, const void* src, int src_bytes,
                                                bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n" ::"r"(s),
      "l"(src), "r"(src_bytes), "r"((int)pred));
}

// One tile's pipeline: the weight ring and the x-chunk slots, fed two units
// ahead. `src.pixel(gy, gx)` points at the 64 channels of the block input at
// an in-image pixel.
template <class Source>
struct Pipe {
  float* smem;
  const Source& src;
  const float* w;  // the block's pack_rdb_weights_tc weights
  int ty0, tx0, H, W;

  // Start the copies of unit u (0..239, in the order stage, chunk, kernel
  // row) as one commit group, empty past the last unit: its weights into ring
  // slot u % 3 and, for a stage's first unit of an x chunk c, that chunk's
  // window into x slot c % 2, zero outside the image.
  __device__ void issue(int u) const {
    if (u < kUnits) {
      int j = 1, first = 0;
      while (u >= first + stage_units(j)) first += stage_units(j++);
      const int c = (u - first) / 3, ky = (u - first) % 3;
      const int n4 = unit_floats(j) / 4;
      const float* ws = w + stage_woff(j) + (size_t)(u - first) * unit_floats(j);
      float* dst = smem + kRingOffset + (u % kRingSlots) * kSlotFloats;
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // n4 <= 2 kThreads
        const int i = threadIdx.x + k * kThreads;
        cp_async16_pred(dst + 4 * i, ws + 4 * i, 16, i < n4);
      }
      if (ky == 0 && c < kFeat / kCK) {
        float* xs = smem + kXOffset + (c & 1) * kXSlotFloats;
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // 2 x 468 items <= 2 kThreads
          const int i = threadIdx.x + k * kThreads;
          const int p = i >> 1, half = i & 1;
          const int gy = ty0 - kMargin + p / win_cols(0), gx = tx0 - kMargin + p % win_cols(0);
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const float* s = inside ? src.pixel(gy, gx) + kCK * c + 4 * half : w;
          cp_async16_pred(xs + kCK * p + 4 * half, s, inside ? 16 : 0, i < 2 * win_pix(0));
        }
      }
    }
    cp_async_commit();
  }

  // Before unit u: its copies have landed and every warpgroup is done with
  // unit u - 1, whose ring slot unit u + 2 then takes.
  __device__ void advance(int u) const {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    // make the copied weights visible to wgmma's reads (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    issue(u + 2);
  }
};

// Stage kJ (1..5) of the tile; its first unit is u0. Stages 1-4 write
// lrelu(conv + b) into a_kJ, zero outside the image; stage 5 calls
// epi(gy, gx, co, v0, v1) for each in-image output pixel and channel pair
// co, co + 1, v = conv5 + b5.
template <int kJ, class Source, class Epilogue>
__device__ __forceinline__ void stage(const Pipe<Source>& pipe, const float* bias, int u0,
                                      const Epilogue& epi) {
  constexpr int kCols = win_cols(kJ), kPix = win_pix(kJ);
  constexpr int kHalves = stage_cout(kJ) / 32;
  constexpr int kWork = (kPix + 63) / 64 * kHalves;  // items: M block x N half
  constexpr int kMine = (kWork + 3) / 4;            // at most, per warpgroup
  constexpr int kCout = stage_cout(kJ);
  float* smem = pipe.smem;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup, broadcast so that the compiler sees it uniform in the warp
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), row = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;

  // the lane's two rows (g, g + 8 of its warp) in each of its items, as
  // (window row, window column); rows past the window take its last pixel
  int oy[kMine][2], ox[kMine][2];
#pragma unroll
  for (int m = 0; m < kMine; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * ((wg + 4 * m) / kHalves) + 16 * row + g + 8 * h;
      const int p = r < kPix ? r : kPix - 1;
      oy[m][h] = p / kCols;
      ox[m][h] = p % kCols;
    }
  float acc[kMine][16], part[16];
#pragma unroll
  for (int m = 0; m < kMine; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;

#pragma unroll 1
  for (int c = 0; c < stage_cin(kJ) / kCK; ++c) {
    // source k of chunk c: the staged x chunk, or chunk cl of a_k
    const bool from_x = c < kFeat / kCK;
    const int k = from_x ? 0 : 1 + (c - kFeat / kCK) / (kGrowth / kCK);
    const int cl = from_x ? 0 : (c - kFeat / kCK) % (kGrowth / kCK);
    const float* base = from_x ? smem + kXOffset + (c & 1) * kXSlotFloats
                               : smem + act_offset(k);
    const int pitch = from_x ? kCK : kGrowth, swz = from_x ? 0 : 3;
    const int cols = win_cols(k), d = kJ - 1 - k;  // stage kJ sits d px inside source k
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
      const int u = u0 + 3 * c + ky;
      pipe.advance(u);
      const float* bslot = smem + kRingOffset + (u % kRingSlots) * kSlotFloats;
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        const int item = wg + 4 * m;
        if (item >= kWork) continue;  // uniform in the warpgroup
        uint32_t ah[3][4], al[3][4];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float2 v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = (oy[m][h] + ky + d) * cols + ox[m][h] + kx + d;
            v[h] = *reinterpret_cast<const float2*>(base + q * pitch +
                                                    ((cl ^ (q & swz)) << 3) + 2 * t);
          }
          const float4 p0 = split_pair(v[0].x, v[0].y), p8 = split_pair(v[1].x, v[1].y);
          ah[kx][0] = __float_as_uint(p0.x);
          ah[kx][1] = __float_as_uint(p8.x);
          ah[kx][2] = __float_as_uint(p0.y);
          ah[kx][3] = __float_as_uint(p8.y);
          al[kx][0] = __float_as_uint(p0.z);
          al[kx][1] = __float_as_uint(p8.z);
          al[kx][2] = __float_as_uint(p0.w);
          al[kx][3] = __float_as_uint(p8.w);
        }
        const float* bn = bslot + (item % kHalves) * 32 * kCK;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* bh = bn + kx * 2 * kCK * kCout;
          wgmma_k8(part, al[kx], weight_desc(bh), kx > 0);               // lo . hi
          wgmma_k8(part, ah[kx], weight_desc(bh + kCK * kCout), 1);      // hi . lo
          wgmma_k8(part, ah[kx], weight_desc(bh), 1);                    // hi . hi
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
        for (int i = 0; i < 16; ++i) acc[m][i] += part[i];
      }
    }
  }

  // accumulator i: n8 tile jn = i / 4, row g (i % 4 < 2) or g + 8, channel
  // 8 jn + 2t + i % 2 of the item's N half
  const int oy0 = pipe.ty0 - (kMargin - kJ), ox0 = pipe.tx0 - (kMargin - kJ);
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const int item = wg + 4 * m;
    if (item >= kWork) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * (item / kHalves) + 16 * row + g + 8 * h;
      if (r >= kPix) continue;
      const int gy = oy0 + oy[m][h], gx = ox0 + ox[m][h];
      const bool in = gy >= 0 && gy < pipe.H && gx >= 0 && gx < pipe.W;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int co = 32 * (item % kHalves) + 8 * jn + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(bias + kGrowth * (kJ - 1) + co);
        const float v0 = acc[m][4 * jn + 2 * h] + b.x, v1 = acc[m][4 * jn + 2 * h + 1] + b.y;
        if constexpr (kJ < 5) {
          float* dst = smem + act_offset(kJ) + r * kGrowth + ((jn ^ (r & 3)) << 3) + 2 * t;
          *reinterpret_cast<float2*>(dst) =
              in ? make_float2(lrelu(v0), lrelu(v1)) : make_float2(0.f, 0.f);
        } else if (in) {
          epi(gy, gx, co, v0, v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 route (route (a); the header's note): x resident in bf16, a1..a4 in
// bf16, bf16 weight units streamed through a ring, wgmma.m64n32k16 bf16.

constexpr int kBfSteps = 2;                   // k16 steps per weight unit (32 channels)
constexpr int kBfRing = kBfSteps == 1 ? 3 : 2;  // weight ring slots
constexpr int kBfAhead = kBfRing - 1;         // units in flight ahead of the current one
constexpr int kXPlanes = kFeat / 16;          // x's 16-channel planes

__host__ __device__ constexpr int bf_step_elems(int j) { return 16 * 9 * stage_cout(j); }
__host__ __device__ constexpr int bf_stage_units(int j) {
  return stage_cin(j) / 16 / kBfSteps;
}
__host__ __device__ constexpr size_t bf_stage_woff(int j) {  // in bf16 values
  size_t off = 0;
  for (int m = 1; m < j; ++m) off += (size_t)9 * stage_cin(m) * stage_cout(m);
  return off;
}
constexpr int kBfUnits = bf_stage_units(1) + bf_stage_units(2) + bf_stage_units(3) +
                         bf_stage_units(4) + bf_stage_units(5);  // 20 per tile
constexpr int kXUnits = kXPlanes / kBfSteps;  // stage 1's units: they land x
// bf16 values of one dense block's packed weights: 9 x sum C_in C_out
constexpr size_t kBfBlockWeights = bf_stage_woff(6);

// shared memory, in bf16 values
__host__ __device__ constexpr int bf_act_offset(int k) {  // a_k, k = 1..4
  int off = 0;
  for (int m = 1; m < k; ++m) off += win_pix(m) * kGrowth;
  return off;
}
constexpr int kBfXOffset = bf_act_offset(5);
constexpr int kBfXElems = win_pix(0) * kFeat;
constexpr int kBfSlotElems = kBfSteps * bf_step_elems(5);
constexpr int kBfRingOffset = kBfXOffset + kBfXElems;
constexpr size_t kBfSmemBytes = 2 * ((size_t)kBfRingOffset + kBfRing * kBfSlotElems);
constexpr int kXPlaneElems = win_pix(0) * 16;  // one plane of x, bf16 or fp32
// x's fp32 landing slots (plane p in slot p % 2), at the start of the a-region
constexpr int kLandPieces = kXPlaneElems / 4;  // 16-byte pieces of one plane
static_assert(kBfSmemBytes <= 232448, "bf16 tile does not fit in shared memory");
static_assert(2 * sizeof(float) * kXPlaneElems <= 2 * (size_t)kBfXOffset,
              "x's landing slots must fit in the a-region");
static_assert(kBfSteps * kBfAhead <= 2,
              "a landing slot is reused only after its plane was rounded");
static_assert(kBfXOffset % 8 == 0 && kBfRingOffset % 8 == 0 && kBfSlotElems % 8 == 0,
              "16-byte alignment");

// One tile's bf16 pipeline: the weight ring, x landed and rounded once.
template <class Source>
struct PipeBf16 {
  uint16_t* smem;
  const Source& src;
  const uint16_t* w;  // the block's pack_rdb_weights_tc(mxu_bf16=True) weights
  int ty0, tx0, H, W;

  __device__ float* land(int plane) const {
    return reinterpret_cast<float*>(smem) + (plane & 1) * kXPlaneElems;
  }

  // Start the copies of unit u (0..19, in the order stage, k16 steps) as one
  // commit group, empty past the last unit: its weights into ring slot
  // u % kBfRing and, for stage 1's units, their x planes into the landing
  // slots, this thread's own pieces, zero outside the image.
  __device__ void issue(int u) const {
    if (u < kBfUnits) {
      int j = 1, first = 0;
      while (u >= first + bf_stage_units(j)) first += bf_stage_units(j++);
      const int unit = kBfSteps * bf_step_elems(j), n8 = unit / 8;  // 16-byte pieces
      const uint16_t* ws = w + bf_stage_woff(j) + (size_t)(u - first) * unit;
      uint16_t* dst = smem + kBfRingOffset + (u % kBfRing) * kBfSlotElems;
#pragma unroll
      for (int k = 0; k < (kBfSlotElems / 8 + kThreads - 1) / kThreads; ++k) {
        const int i = threadIdx.x + k * kThreads;
        cp_async16_pred(dst + 8 * i, ws + 8 * i, 16, i < n8);
      }
      if (u < kXUnits) {
#pragma unroll
        for (int e = 0; e < kBfSteps; ++e) {
          const int plane = u * kBfSteps + e;
          float* ls = land(plane);
#pragma unroll
          for (int k = 0; k < (kLandPieces + kThreads - 1) / kThreads; ++k) {
            const int i = threadIdx.x + k * kThreads;
            const int p = i >> 2, c4 = i & 3;
            const int gy = ty0 - kMargin + p / win_cols(0), gx = tx0 - kMargin + p % win_cols(0);
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            const float* s = inside ? src.pixel(gy, gx) + 16 * plane + 4 * c4
                                    : reinterpret_cast<const float*>(w);
            cp_async16_pred(ls + 4 * i, s, inside ? 16 : 0, i < kLandPieces);
          }
        }
      }
    }
    cp_async_commit();
  }

  // Before unit u: its copies have landed, this thread has rounded its own
  // pieces of u's x planes into the resident x, and every warpgroup is done
  // with unit u - 1, whose ring slot unit u + kBfAhead then takes.
  __device__ void advance(int u) const {
    cp_async_wait<kBfAhead - 1>();
    if (u < kXUnits) {
#pragma unroll
      for (int e = 0; e < kBfSteps; ++e) {
        const int plane = u * kBfSteps + e;
        const float* ls = land(plane);
        uint16_t* xb = smem + kBfXOffset + plane * kXPlaneElems;
#pragma unroll
        for (int k = 0; k < (kLandPieces + kThreads - 1) / kThreads; ++k) {
          const int i = threadIdx.x + k * kThreads;
          if (i < kLandPieces) {
            const float4 v = *reinterpret_cast<const float4*>(ls + 4 * i);
            *reinterpret_cast<uint2*>(xb + 4 * i) =
                make_uint2(bf16x2_rn(v.x, v.y), bf16x2_rn(v.z, v.w));
          }
        }
      }
    }
    // make the copied weights visible to wgmma's reads (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    issue(u + kBfAhead);
  }
};

// Stage kJ (1..5) of the tile on the bf16 route; its first unit is u0.
// Stages 1-4 write bf16(lrelu(conv + b)) into a_kJ, zero outside the image;
// stage 5 calls epi(gy, gx, co, v0, v1) as stage() does.
template <int kJ, class Source, class Epilogue>
__device__ __forceinline__ void stage_bf16(const PipeBf16<Source>& pipe, const float* bias,
                                           int u0, const Epilogue& epi) {
  constexpr int kCols = win_cols(kJ), kPix = win_pix(kJ);
  constexpr int kHalves = stage_cout(kJ) / 32;
  constexpr int kWork = (kPix + 63) / 64 * kHalves;  // items: M block x N half
  constexpr int kMine = (kWork + 3) / 4;            // at most, per warpgroup
  constexpr int kCout = stage_cout(kJ);
  uint16_t* smem = pipe.smem;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup, broadcast so that the compiler sees it uniform in the warp
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), row = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;

  // the lane's two rows (g, g + 8 of its warp) in each of its items, as
  // (window row, window column); rows past the window take its last pixel
  int oy[kMine][2], ox[kMine][2];
#pragma unroll
  for (int m = 0; m < kMine; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * ((wg + 4 * m) / kHalves) + 16 * row + g + 8 * h;
      const int p = r < kPix ? r : kPix - 1;
      oy[m][h] = p / kCols;
      ox[m][h] = p % kCols;
    }
  float acc[kMine][16];
#pragma unroll
  for (int m = 0; m < kMine; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;

#pragma unroll 1
  for (int uu = 0; uu < bf_stage_units(kJ); ++uu) {
    const int u = u0 + uu;
    pipe.advance(u);
    const uint16_t* slot = smem + kBfRingOffset + (u % kBfRing) * kBfSlotElems;
#pragma unroll
    for (int e = 0; e < kBfSteps; ++e) {
      // k16 step s of the stage reads x plane s, or plane (s - 4) % 2 of a_k
      const int s = uu * kBfSteps + e;
      const bool from_x = s < kXPlanes;
      const int k = from_x ? 0 : 1 + (s - kXPlanes) / 2;
      const uint16_t* base =
          from_x ? smem + kBfXOffset + s * kXPlaneElems
                 : smem + bf_act_offset(k) + ((s - kXPlanes) & 1) * win_pix(k) * 16;
      const int cols = win_cols(k), d = kJ - 1 - k;  // stage kJ sits d px inside source k
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        const int item = wg + 4 * m;
        if (item >= kWork) continue;  // uniform in the warpgroup
        // A of each tap: rows g and g + 8, channels 4t..4t + 3 of the plane
        uint32_t a[9][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          uint2 v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = (oy[m][h] + tap / 3 + d) * cols + ox[m][h] + tap % 3 + d;
            v[h] = *reinterpret_cast<const uint2*>(base + q * 16 + 4 * t);
          }
          a[tap][0] = v[0].x;
          a[tap][1] = v[1].x;
          a[tap][2] = v[0].y;
          a[tap][3] = v[1].y;
        }
        // the item's N half: 4 core-matrix rows (512 values) further on
        const uint16_t* bn = slot + e * bf_step_elems(kJ) + (item % kHalves) * 512;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          wgmma_bf16(acc[m], a[tap], weight_desc(bn + tap * 16 * kCout), 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(acc[m]);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) fence_operands(a[tap]);
      }
    }
  }

  // accumulator i: n8 tile jn = i / 4, row g (i % 4 < 2) or g + 8, channel
  // 8 jn + 2t + i % 2 of the item's N half
  const int oy0 = pipe.ty0 - (kMargin - kJ), ox0 = pipe.tx0 - (kMargin - kJ);
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const int item = wg + 4 * m;
    if (item >= kWork) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * (item / kHalves) + 16 * row + g + 8 * h;
      if (r >= kPix) continue;
      const int gy = oy0 + oy[m][h], gx = ox0 + ox[m][h];
      const bool in = gy >= 0 && gy < pipe.H && gx >= 0 && gx < pipe.W;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int co = 32 * (item % kHalves) + 8 * jn + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(bias + kGrowth * (kJ - 1) + co);
        const float v0 = acc[m][4 * jn + 2 * h] + b.x, v1 = acc[m][4 * jn + 2 * h + 1] + b.y;
        if constexpr (kJ < 5) {
          uint16_t* dst = smem + bf_act_offset(kJ) + ((co >> 4) * kPix + r) * 16 + (co & 15);
          *reinterpret_cast<uint32_t*>(dst) = in ? bf16x2_rn(lrelu(v0), lrelu(v1)) : 0u;
        } else if (in) {
          epi(gy, gx, co, v0, v1);
        }
      }
    }
  }
}

// The packed weights' element type: fp32 (3xTF32), or bf16 bits (kBf16).
template <bool kBf16>
using WeightT = std::conditional_t<kBf16, uint16_t, float>;
// one dense block's packed weights, in values, and the tile's shared memory
template <bool kBf16>
constexpr size_t kTileWeights = kBf16 ? kBfBlockWeights : kBlockWeights;
template <bool kBf16>
constexpr size_t kTileSmemBytes = kBf16 ? kBfSmemBytes : kSmemBytes;

// The whole dense block on the 8 x 16 tile whose origin is (ty0, tx0). `w` /
// `bias` are the block's pack_rdb_weights_tc weights (with mxu_bf16 for
// kBf16, the bf16 route) and its 192 biases. Ends with every copy drained
// and a barrier, so the caller may start the next tile at once.
template <bool kBf16, class Source, class Epilogue>
__device__ __forceinline__ void dense_block_tile(void* smem, const Source& src,
                                                 const WeightT<kBf16>* w, const float* bias,
                                                 int ty0, int tx0, int H, int W,
                                                 const Epilogue& epi) {
  if constexpr (kBf16) {
    const PipeBf16<Source> pipe{static_cast<uint16_t*>(smem), src, w, ty0, tx0, H, W};
#pragma unroll
    for (int u = 0; u < kBfAhead; ++u) pipe.issue(u);
    constexpr int u2 = bf_stage_units(1), u3 = u2 + bf_stage_units(2),
                  u4 = u3 + bf_stage_units(3), u5 = u4 + bf_stage_units(4);
    stage_bf16<1>(pipe, bias, 0, epi);
    stage_bf16<2>(pipe, bias, u2, epi);
    stage_bf16<3>(pipe, bias, u3, epi);
    stage_bf16<4>(pipe, bias, u4, epi);
    stage_bf16<5>(pipe, bias, u5, epi);
  } else {
    const Pipe<Source> pipe{static_cast<float*>(smem), src, w, ty0, tx0, H, W};
    pipe.issue(0);
    pipe.issue(1);
    constexpr int u2 = stage_units(1), u3 = u2 + stage_units(2), u4 = u3 + stage_units(3),
                  u5 = u4 + stage_units(4);
    stage<1>(pipe, bias, 0, epi);
    stage<2>(pipe, bias, u2, epi);
    stage<3>(pipe, bias, u3, epi);
    stage<4>(pipe, bias, u4, epi);
    stage<5>(pipe, bias, u5, epi);
  }
  cp_async_wait_all();
  __syncthreads();
}

}  // namespace rdbtile
