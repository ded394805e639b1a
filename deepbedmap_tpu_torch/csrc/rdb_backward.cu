// K1's backward: the gradient of the residual dense block (rdb.cu's
// rdb_forward on its fp32 route) in 3xTF32 on the tensor cores, read from
// the forward's own (N, H, W, 192) workspace.
//
// The TPU kernel has none: JAX's VJP (deepbedmap_tpu/ops/pallas_rdb.py
// :_rdb_flat_bwd) is autodiff of the plain composition recomputed from the
// saved input. K1's forward already leaves x and a1..a4 in its workspace, so
// the backward reads them there and recomputes nothing. With g the upstream
// gradient, s the residual scaling, a_j = lrelu(z_j) and W_j the stage's OIHW
// kernel:
//   g_z5 = s g
//   g_ws[:, :192] = dgrad5(g_z5)
//   for j = 4..1: g_z_j = g_ws[slice j] * (a_j >= 0 ? 1 : 0.2)
//                 g_ws[:, :64 + 32 (j - 1)] += dgrad_j(g_z_j)
//   g_x = g + g_ws[:, :64]
//   dW_j = sum_p ws(p + tap) (x) g_z_j(p),  db_j = sum_p g_z_j(p)
// The LeakyReLU's branch is read from the saved activation (a >= 0 exactly
// when z >= 0), so the backward follows the kernel's own forward.
//
// What bounds it on an H100: tensor-core operations, twice the forward's. At
// a training step's shape (128, 9, 9, 64) a block's backward is 9.9 GFLOP
// (dgrad and weight gradients, 4.97 each); in three TF32 passes at 495
// TFLOP/s that is 0.060 ms, against ~8 MB of workspace and gradients.
//
// Design. Three kernels, seven launches, no float atomics:
// 1. rdb_dgrad_stage, once a stage (5, 4, 3, 2, 1): dgrad_j is a 3x3 SAME
//    conv of g_z_j with W_j transposed and flipped, run on conv3x3_tc.cuh's
//    3xTF32 wgmma mainloop (per 8-channel chunk the halo and weights staged
//    by cp.async and split into TF32 hi/lo once; per kernel row three taps of
//    lo.hi + hi.lo + hi.hi into a fresh partial sum added in fp32). The
//    weights are ops/rdb.py:pack_rdb_dgrad_weights, pack_conv_weight's layout
//    of each transposed, flipped kernel. Tiles run along the flattened
//    (image, row) axis, min(W, 16) columns wide (Tiling), so the training
//    shape's 9 x 9 images fill 126 of a tile's 128 rows (a 16 x 16 tile would
//    hold 81 of 256): a flattened row's neighbours above and below belong to
//    the same image only away from its first and last row, so each lane
//    zeroes its A values of the rows outside its image itself. A block covers
//    32 of the stage's output channels (grid.y), so 2 to 6 blocks share a
//    tile. The epilogue adds into g_ws, applies the LeakyReLU's slope of the
//    slice this stage completes (channels mask_from on: a_{j-1}'s), and in
//    stage 1 adds g and writes g_x.
// 2. rdb_wgrad, once: block (split, unit) with unit = (stage, kernel row ky,
//    64-channel block of the stage's input) and one warpgroup per kernel
//    column kx; 33 units. GEMM M = the 64 input channels (rows past C_in are
//    never stored), N = the stage's outputs (32, 64 for stage 5), K = pixels:
//    A = the workspace shifted by the tap, from registers (each lane loads its
//    four values from a staged, padded [pixel][72] copy and splits them),
//    B = g_z transposed into wgmma's K-major core matrices, hi and lo. A block
//    walks the tiles split, split + splits, ... with the next tile's rows in
//    flight (cp.async into a second slot, its g_z in registers) and keeps
//    its dW block in registers; the kernel row ky = 1, block 0 also sums g_z
//    for the bias. Each split writes one partial of every dW and db.
// 3. rdb_grad_reduce: the splits' partials added in split order (bit for bit
//    repeatable), stage 5's scaled by s.

#include <cstdint>

#include <cuda_runtime.h>

#include "conv3x3_tc.cuh"

namespace {

constexpr int kFeat = 64;                  // block input/output channels
constexpr int kGrowth = 32;                // channels added by conv1-4
constexpr int kWsC = kFeat + 4 * kGrowth;  // workspace channels: 192
constexpr float kSlope = 0.2f;             // LeakyReLU's negative slope

__host__ __device__ constexpr int stage_cin(int j) { return kFeat + kGrowth * j; }
__host__ __device__ constexpr int stage_cout(int j) { return j < 4 ? kGrowth : kFeat; }
// offset of stage j's OIHW kernel in the flat gradient (and of its transposed
// weights in the packed dgrad weights); [5]: the biases, b1..b5
__host__ __device__ constexpr int weight_off(int j) {
  return j == 0 ? 0 : weight_off(j - 1) + 9 * stage_cin(j - 1) * stage_cout(j - 1);
}
constexpr int kGradValues = weight_off(5) + kWsC;  // dW1..dW5, then b1..b5: 239,808

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Tiles of the flattened (image, row) axis: `rows` rows of `tw` columns.
struct Tiling {
  int tw;       // tile columns: min(W, 16)
  int rows;     // tile rows
  int tiles_x;  // tiles across a row
  int tiles;    // tiles in all
};

// `max_pix` pixels at most a tile, `max_stage` staged at most: (rows + 2) x
// (tw + 2) with the rows above and below (row_halo), rows x (tw + 2) without.
Tiling make_tiling(int NH, int W, int max_pix, int max_stage, bool row_halo) {
  Tiling tl;
  tl.tw = W < kTileW ? W : kTileW;
  int rows = max_pix / tl.tw;
  const int cap = max_stage / (tl.tw + 2) - (row_halo ? 2 : 0);
  tl.rows = rows < cap ? rows : cap;
  tl.tiles_x = (W + tl.tw - 1) / tl.tw;
  tl.tiles = tl.tiles_x * ((NH + tl.rows - 1) / tl.rows);
  return tl;
}

// ---------------------------------------------------------------------------
// 1. dgrad stages

constexpr int kDGroups = 2;                // warpgroups a block
constexpr int kDThreads = 128 * kDGroups;  // 256
constexpr int kDM = 64 * kDGroups;         // GEMM rows (pixels) a tile: 128
constexpr int kDHalo = 180;                // staged pixels a tile, at most
constexpr int kDN = 32;                    // output channels a block
constexpr int kDRawW = kCK * 9 * kDN;      // one chunk's weights of a block's 32 outputs
constexpr size_t kDSmem =
    sizeof(float) * ((size_t)kDHalo * kCK * 3 + (size_t)kDRawW * 3);

// Where stage j's dgrad goes. Element (pixel p, channel co):
//   v = scale * (product) [+ acc[p * 192 + co]]
//   v *= ws[p * 192 + co] >= 0 ? 1 : 0.2        for co >= mask_from
//   out[p * out_pitch + co] = [skip[p * 64 + co] +] v
struct DgradEpilogue {
  float* out;
  int out_pitch;
  const float* acc;   // g_ws, or nullptr (stage 5 writes first)
  const float* ws;    // the forward's workspace
  int mask_from;      // the slice this stage completes
  const float* skip;  // g, added by stage 1, or nullptr
  float scale;        // s for stage 5, else 1
};

__global__ void __launch_bounds__(kDThreads, 2)
rdb_dgrad_stage(const float* __restrict__ in, int in_pitch, int cin,
                const float* __restrict__ w, DgradEpilogue ep, int NH, int H, int W,
                Tiling tl) {
  extern __shared__ float4 smem4[];
  // as conv3x3_tc_stage's: the chunk's halo [pixel][8 ch] and weights
  // [8 ch][9 taps][32] as copied, the halo split [pixel][pair] {hi, hi, lo, lo}
  // and the weights split per (tap, hi|lo) into core matrices
  float* s_raw_halo = reinterpret_cast<float*>(smem4);
  float* s_raw_w = s_raw_halo + kDHalo * kCK;
  float4* s_halo = reinterpret_cast<float4*>(s_raw_w + kDRawW);
  float* s_w = reinterpret_cast<float*>(s_halo + kDHalo * kCK / 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slice = blockIdx.y;
  const int r0 = blockIdx.x / tl.tiles_x * tl.rows, x0 = blockIdx.x % tl.tiles_x * tl.tw;
  const int hw = tl.tw + 2, halo_pix = (tl.rows + 2) * hw;

  auto stage_chunk = [&](int c0) {
    for (int i = tid; i < 2 * halo_pix; i += kDThreads) {
      const int p = i >> 1, half = i & 1;
      const int fr = r0 + p / hw - 1, gx = x0 + p % hw - 1;
      const bool inside = fr >= 0 && fr < NH && gx >= 0 && gx < W;
      const float* src = inside ? in + ((size_t)fr * W + gx) * in_pitch + c0 + 4 * half : in;
      cp_async16(s_raw_halo + p * kCK + 4 * half, src, inside);
    }
    const float* wsrc = w + ((size_t)slice * cin + c0) * 9 * 32;
    for (int i = tid; i < kDRawW / 4; i += kDThreads) cp_async16(s_raw_w + 4 * i, wsrc + 4 * i, true);
    cp_async_commit();
  };

  // this lane's GEMM rows: pixels m = 16 warp + g and m + 8 of the tile, their
  // halo position at tap (0, 0), and whether the rows above and below lie in
  // the same image
  int base[2];
  bool up[2], down[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * warp + g + 8 * h, i = m / tl.tw;
    const bool in_tile = i < tl.rows;
    base[h] = in_tile ? i * hw + m % tl.tw : 0;
    const int y = (r0 + i) % H;
    up[h] = in_tile && y > 0;
    down[h] = in_tile && y < H - 1;
  }

  float acc[kDN / 2], part[kDN / 2];
#pragma unroll
  for (int i = 0; i < kDN / 2; ++i) acc[i] = 0.f;

  const int chunks = cin / kCK;
  stage_chunk(0);
  for (int q = 0; q < chunks; ++q) {
    cp_async_wait_all();
    __syncthreads();  // chunk q has landed; every warpgroup is done with chunk q - 1
    for (int i = tid; i < halo_pix * kCK / 2; i += kDThreads) {
      const float2 v = reinterpret_cast<const float2*>(s_raw_halo)[i];
      s_halo[i] = split_pair(v.x, v.y);
    }
    for (int i = tid; i < 9 * kDN * 2; i += kDThreads) {
      const int tap = i / (2 * kDN), co = (i >> 1) % kDN, kc = i & 1;
      const float* r = s_raw_w + kc * 9 * 32 + tap * 32 + co;
      const float4 a = split_pair(r[0], r[2 * 9 * 32]);
      const float4 b = split_pair(r[4 * 9 * 32], r[6 * 9 * 32]);
      float* d = s_w + tap * 2 * kDN * kCK + (co >> 3) * 64 + kc * 32 + (co & 7) * 4;
      *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(d + kDN * kCK) = make_float4(a.z, a.w, b.z, b.w);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // splits ready, cp.async targets free
    if (q + 1 < chunks) stage_chunk((q + 1) * kCK);

#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
      const bool ok0 = ky == 0 ? up[0] : (ky == 2 ? down[0] : true);
      const bool ok8 = ky == 0 ? up[1] : (ky == 2 ? down[1] : true);
      uint32_t ah[3][4], al[3][4];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 v0 = ok0 ? s_halo[(base[0] + ky * hw + kx) * 4 + t] : zero;
        const float4 v8 = ok8 ? s_halo[(base[1] + ky * hw + kx) * 4 + t] : zero;
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
        const float* bw = s_w + (3 * ky + kx) * 2 * kDN * kCK;
        wgmma_k8(part, al[kx], weight_desc(bw), kx > 0);        // lo . hi
        wgmma_k8(part, ah[kx], weight_desc(bw + kDN * kCK), 1);  // hi . lo
        wgmma_k8(part, ah[kx], weight_desc(bw), 1);              // hi . hi
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
      for (int i = 0; i < kDN / 2; ++i) acc[i] += part[i];
    }
  }

  // accumulator i: channel 8 (i / 4) + 2 t + i % 2 of the slice, pixel m or
  // m + 8 (wgmma's D fragment, as conv3x3_tc.cuh's store_row reads it)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * warp + g + 8 * h, i = m / tl.tw;
    const int fr = r0 + i, gx = x0 + m % tl.tw;
    if (i >= tl.rows || fr >= NH || gx >= W) continue;
    const size_t pix = (size_t)fr * W + gx;
#pragma unroll
    for (int j = 0; j < kDN / 8; ++j) {
      const int co = slice * kDN + 8 * j + 2 * t;
      float v0 = ep.scale * acc[4 * j + 2 * h], v1 = ep.scale * acc[4 * j + 2 * h + 1];
      if (ep.acc != nullptr) {
        const float2 a = ld2(ep.acc + pix * kWsC + co);
        v0 = a.x + v0;
        v1 = a.y + v1;
      }
      if (co >= ep.mask_from) {
        const float2 a = ld2(ep.ws + pix * kWsC + co);
        v0 *= a.x >= 0.f ? 1.f : kSlope;
        v1 *= a.y >= 0.f ? 1.f : kSlope;
      }
      if (ep.skip != nullptr) {
        const float2 k = ld2(ep.skip + pix * kFeat + co);
        v0 = k.x + v0;
        v1 = k.y + v1;
      }
      *reinterpret_cast<float2*>(ep.out + pix * ep.out_pitch + co) = make_float2(v0, v1);
    }
  }
}

cudaError_t launch_dgrad(const float* in, int in_pitch, int j, const float* wt,
                         const DgradEpilogue& ep, int NH, int H, int W, const Tiling& tl,
                         cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      rdb_dgrad_stage, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tl.tiles, stage_cin(j) / kDN);
  rdb_dgrad_stage<<<grid, kDThreads, kDSmem, s>>>(in, in_pitch, stage_cout(j),
                                                  wt + weight_off(j), ep, NH, H, W, tl);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2. weight gradients

constexpr int kWGroups = 3;                // one warpgroup per kernel column kx
constexpr int kWThreads = 128 * kWGroups;  // 384
constexpr int kWK = 128;                   // GEMM K (pixels) a tile, at most
constexpr int kWSteps = kWK / kCK;         // its k8 steps
constexpr int kWStage = 176;               // staged pixels a tile, at most
constexpr int kWPitch = 72;                // floats a staged pixel: 64 channels + 8
constexpr int kWPerPartial = 4;            // k8 steps (12 products) a partial sum
// units: (stage j, kernel row ky, 64-channel block of C_in_j)
__host__ __device__ constexpr int stage_blocks(int j) { return (stage_cin(j) + 63) / 64; }
constexpr int kUnits = 3 * (stage_blocks(0) + stage_blocks(1) + stage_blocks(2) +
                            stage_blocks(3) + stage_blocks(4));
constexpr size_t kWSmem =
    sizeof(float) * (2 * (size_t)kWStage * kWPitch + (size_t)kWSteps * 2 * 8 * kFeat) +
    sizeof(int) * kWK;

// One unit of one split: dW_j[:, cb * 64 : cb * 64 + 64, ky, kx] with kx this
// warpgroup's, summed over the split's tiles, into this split's partial; with
// `bias` also db_j.
template <int kN>
__device__ __forceinline__ void wgrad_unit(const float* __restrict__ ws,
                                           const float* __restrict__ gz, int gz_pitch,
                                           float* __restrict__ dw, float* __restrict__ db,
                                           int cin, int ky, int cb, int NH, int H, int W,
                                           const Tiling& tl, float* smem) {
  constexpr int kAcc = kN / 2;
  constexpr int kQuads = kN / 4;                                      // float4s a pixel of g_z
  constexpr int kLoads = (kWK * kQuads + kWThreads - 1) / kWThreads;  // a thread's, a tile
  static_assert(kWThreads % kQuads == 0, "a thread keeps one channel quad");
  // s_stage [slot][pixel][kWPitch]: the tile's rows shifted by ky, columns -1
  // .. tw, channels cb * 64 on; s_b [k8 step][hi|lo][n / 8][k / 4][n % 8][k % 4]:
  // g_z transposed, K-major core matrices; s_off [pixel]: its staged position
  // at kx = 0, or -1 where the tap reads outside its image
  float* s_stage = smem;
  float* s_b = s_stage + 2 * kWStage * kWPitch;
  int* s_off = reinterpret_cast<int*>(s_b + kWSteps * 2 * 8 * kFeat);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kx = warp >> 2, wq = warp & 3;
  const int sw = tl.tw + 2, stage_pix = tl.rows * sw;
  const int kpix = tl.rows * tl.tw, steps = (kpix + kCK - 1) / kCK;
  const int c4 = tid % kQuads;  // the channel quad of every g_z float4 this thread loads

  auto stage = [&](int tile, int slot) {
    const int r0 = tile / tl.tiles_x * tl.rows, x0 = tile % tl.tiles_x * tl.tw;
    float* dst = s_stage + slot * kWStage * kWPitch;
    for (int i = tid; i < stage_pix * 16; i += kWThreads) {
      const int p = i >> 4, q = i & 15;
      const int fr = r0 + p / sw + ky - 1, gx = x0 + p % sw - 1;
      const bool inside = fr >= 0 && fr < NH && gx >= 0 && gx < W;
      const float* src = inside ? ws + ((size_t)fr * W + gx) * kWsC + cb * 64 + 4 * q : ws;
      cp_async16(dst + p * kWPitch + 4 * q, src, inside);
    }
    cp_async_commit();
  };
  float4 gv[kLoads];
  auto load_g = [&](int tile) {
    const int r0 = tile / tl.tiles_x * tl.rows, x0 = tile % tl.tiles_x * tl.tw;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int k = (tid + l * kWThreads) / kQuads;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < kpix) {
        const int fr = r0 + k / tl.tw, gx = x0 + k % tl.tw;
        if (fr < NH && gx < W) v = ld4(gz + ((size_t)fr * W + gx) * gz_pitch + 4 * c4);
      }
      gv[l] = v;
    }
  };

  float acc[kAcc], prt[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float4 bsum = make_float4(0.f, 0.f, 0.f, 0.f);

  const int first = blockIdx.x, stride = gridDim.x;
  if (first < tl.tiles) {
    stage(first, 0);
    load_g(first);
  }
  int slot = 0;
  for (int tile = first; tile < tl.tiles; tile += stride, slot ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // the tile's rows have landed; every warpgroup is done with the last tile
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int k = (tid + l * kWThreads) / kQuads;
      if (k >= steps * kCK) continue;
      const float4 v = gv[l];
      if (db != nullptr) {
        bsum.x += v.x;
        bsum.y += v.y;
        bsum.z += v.z;
        bsum.w += v.w;
      }
      float* d = s_b + (k >> 3) * 2 * 8 * kN + ((k & 7) >> 2) * 32 + (k & 3);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 4 * c4 + r;
        const uint32_t hi = tf32_rna(e[r]);
        const uint32_t lo = tf32_rna(e[r] - __uint_as_float(hi));
        float* dn = d + (n >> 3) * 64 + (n & 7) * 4;
        dn[0] = __uint_as_float(hi);
        dn[8 * kN] = __uint_as_float(lo);
      }
    }
    {
      const int r0 = tile / tl.tiles_x * tl.rows, x0 = tile % tl.tiles_x * tl.tw;
      for (int k = tid; k < steps * kCK; k += kWThreads) {
        int o = -1;
        if (k < kpix) {
          const int i = k / tl.tw, jc = k % tl.tw, y = (r0 + i) % H + ky - 1;
          if (r0 + i < NH && x0 + jc < W && y >= 0 && y < H) o = i * sw + jc;
        }
        s_off[k] = o;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // B and the offsets ready; the other slot is free
    const int next = tile + stride;
    if (next < tl.tiles) {
      stage(next, slot ^ 1);
      load_g(next);
    }

    const float* st = s_stage + slot * kWStage * kWPitch + 16 * wq + g;
#pragma unroll 1
    for (int s0 = 0; s0 < steps; s0 += kWPerPartial) {
      uint32_t ah[kWPerPartial][4], al[kWPerPartial][4];
#pragma unroll
      for (int e = 0; e < kWPerPartial; ++e) {
        // A rows: channels 16 wq + g and + 8; k slots t and t + 4: pixels
        // 8 kk + t and 8 kk + t + 4, shifted by the tap
        const int kk = s0 + e;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (kk < steps) {
          const int oa = s_off[8 * kk + t], ob = s_off[8 * kk + t + 4];
          if (oa >= 0) {
            a[0] = st[(oa + kx) * kWPitch];
            a[1] = st[(oa + kx) * kWPitch + 8];
          }
          if (ob >= 0) {
            a[2] = st[(ob + kx) * kWPitch];
            a[3] = st[(ob + kx) * kWPitch + 8];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ah[e][r] = tf32_rna(a[r]);
          al[e][r] = tf32_rna(a[r] - __uint_as_float(ah[e][r]));
        }
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int e = 0; e < kWPerPartial; ++e) {
        if (s0 + e >= steps) break;
        const float* b = s_b + (s0 + e) * 2 * 8 * kN;
        wgmma_k8(prt, al[e], weight_desc(b), e > 0);          // lo . hi
        wgmma_k8(prt, ah[e], weight_desc(b + 8 * kN), 1);      // hi . lo
        wgmma_k8(prt, ah[e], weight_desc(b), 1);              // hi . hi
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(prt);
#pragma unroll
      for (int e = 0; e < kWPerPartial; ++e) {
        fence_operands(ah[e]);
        fence_operands(al[e]);
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += prt[i];
    }
  }

  // D rows: input channels cb * 64 + 16 wq + g (+ 8); columns: outputs
  // 8 (i / 4) + 2 t + i % 2. OIHW: dw[((co * cin + c) * 3 + ky) * 3 + kx]
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int c = cb * 64 + 16 * wq + g + ((i & 2) ? 8 : 0);
    const int co = 8 * (i >> 2) + 2 * t + (i & 1);
    if (c < cin) dw[((size_t)co * cin + c) * 9 + 3 * ky + kx] = acc[i];
  }
  if (db != nullptr) {
    // the threads' sums of each channel quad, added in thread order
    __syncthreads();
    float4* s_sum = reinterpret_cast<float4*>(smem);
    s_sum[tid] = bsum;
    __syncthreads();
    if (tid < kQuads) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = tid; r < kWThreads; r += kQuads) {
        const float4 v = s_sum[r];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      *reinterpret_cast<float4*>(db + 4 * tid) = sum;
    }
  }
}

__global__ void __launch_bounds__(kWThreads, 1)
rdb_wgrad(const float* __restrict__ ws, const float* __restrict__ g_ws,
          const float* __restrict__ g_out, float* __restrict__ part, int NH, int H, int W,
          Tiling tl) {
  extern __shared__ float4 smem4[];
  int u = blockIdx.y, j = 0;
  while (u >= 3 * stage_blocks(j)) u -= 3 * stage_blocks(j++);
  const int ky = u / stage_blocks(j), cb = u % stage_blocks(j);
  float* p = part + (size_t)blockIdx.x * kGradValues;
  float* db = ky == 1 && cb == 0 ? p + weight_off(5) + (j < 4 ? kGrowth * j : 128) : nullptr;
  float* smem = reinterpret_cast<float*>(smem4);
  if (j == 4)
    wgrad_unit<kFeat>(ws, g_out, kFeat, p + weight_off(4), db, stage_cin(4), ky, cb, NH, H, W,
                      tl, smem);
  else
    wgrad_unit<kGrowth>(ws, g_ws + kFeat + kGrowth * j, kWsC, p + weight_off(j), db,
                        stage_cin(j), ky, cb, NH, H, W, tl, smem);
}

// 3. the splits' partials in split order; stage 5's dW and db times s
__global__ void __launch_bounds__(256)
rdb_grad_reduce(const float* __restrict__ part, float* __restrict__ grad, int splits,
                float scaling) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= kGradValues) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[(size_t)s * kGradValues + i];
  const bool last = (i >= weight_off(4) && i < weight_off(5)) || i >= weight_off(5) + 128;
  grad[i] = last ? scaling * sum : sum;
}

}  // namespace

// ws: the forward's (N, H, W, 192) workspace (x, a1..a4); g_out, g_x: (N, H,
// W, 64), the output's gradient and x's; wt: ops/rdb.py:pack_rdb_dgrad_weights;
// g_ws: (N, H, W, 192) scratch; part: splits x 239,808 scratch; grad: 239,808,
// the five OIHW kernels' gradients back to back, then the five biases'.
// Returns cudaGetLastError() after the last launch.
extern "C" int rdb_backward(const float* ws, const float* g_out, const float* wt, float* g_ws,
                            float* g_x, float* part, float* grad, int N, int H, int W,
                            float scaling, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NH = N * H;
  const Tiling dt = make_tiling(NH, W, kDM, kDHalo, true);
  // stage 5: g_ws = dgrad5(s g), a4's slope on channels 160..191
  DgradEpilogue ep{g_ws, kWsC, nullptr, ws, stage_cin(3), nullptr, scaling};
  cudaError_t err = launch_dgrad(g_out, kFeat, 4, wt, ep, NH, H, W, dt, s);
  // stages 4..2: g_ws[:, :C_in_j] += dgrad_j(g_z_j), a_{j-1}'s slope on its slice
  for (int j = 3; j >= 1 && err == cudaSuccess; --j) {
    ep = DgradEpilogue{g_ws, kWsC, g_ws, ws, stage_cin(j - 1), nullptr, 1.f};
    err = launch_dgrad(g_ws + stage_cin(j), kWsC, j, wt, ep, NH, H, W, dt, s);
  }
  // stage 1: g_x = g + g_ws[:, :64] + dgrad1(g_z1)
  if (err == cudaSuccess) {
    ep = DgradEpilogue{g_x, kFeat, g_ws, ws, kFeat, g_out, 1.f};
    err = launch_dgrad(g_ws + kFeat, kWsC, 0, wt, ep, NH, H, W, dt, s);
  }
  if (err != cudaSuccess) return (int)err;

  if ((err = cudaFuncSetAttribute(rdb_wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kWSmem)) != cudaSuccess)
    return (int)err;
  const Tiling wt_tl = make_tiling(NH, W, kWK, kWStage, false);
  rdb_wgrad<<<dim3(splits, kUnits), kWThreads, kWSmem, s>>>(ws, g_ws, g_out, part, NH, H, W,
                                                           wt_tl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rdb_grad_reduce<<<(kGradValues + 255) / 256, 256, 0, s>>>(part, grad, splits, scaling);
  return (int)cudaGetLastError();
}
