// K5: a whole residual-in-residual dense block in one launch, as one sweep
// over row bands, fp32, NHWC: out = x + s * rdb3(rdb2(rdb1(x))), the function
// of K4 (rdb.cu rrdb_forward) and of ops/rdb.py:rrdb_reference.
//
// Replaces the TPU kernel deepbedmap_tpu/ops/pallas_rdb.py:
// rrdb_sweep_pallas_flat (body _rrdb_sweep_kernel): the three dense blocks
// advance together over row bands, one band apart, with the RDB1 and RDB2
// outputs in 3-slot VMEM rings, so HBM sees x and the output and no
// intermediate image.
//
// What bounds it on an H100: tensor-core operations. The function's work at
// the main-path shape (2 x 286 x 286 x 64) is K4's, 235 GFLOP against ~0.1 GB
// in and out, 1.425 ms as 3xTF32 at 495 TFLOP/s. Each dense block runs
// rdb_tile.cuh on the tensor cores, whose halo recompute costs 1.58x those
// MACs.
//
// Design: Hopper has no ordered sequential grid, so the sweep is one
// cooperative launch (cudaLaunchCooperativeKernel, the grid sized to
// co-residency: one 209 KB block per SM) whose blocks walk the 8 x 16 tiles
// of one wavefront step and then meet at a grid-wide barrier
// (cooperative_groups grid.sync(), which with CUDA 12.8 needs no
// -rdc=true and no device link). Step s computes RDB1 band s, RDB2 band
// s - 2 and RDB3 band s - 4 (bands of 8 rows, the tile height). The lag is
// two bands, not the TPU's one: a step's tiles run in parallel, so RDB2 band
// j, whose window reaches 5 rows into band j + 1, may start only in the step
// after RDB1 band j + 1 finished. The RDB1 and RDB2 outputs live in rings of
// 4 band slots (N x 8 x W x 64 floats each, sized by the band and not the
// image): at step s the t1 ring holds bands s-3..s and the t2 ring bands
// s-5..s-2, so no slot is written while it is read. Rows outside the image
// read zero, never ring contents (the TPU's assemble()). Each dense block's
// intermediates stay in shared memory; the last stage folds the outer skip,
// out = x + s * (t2 + s * (conv5 + b5)), in rrdb_reference's rounding order.
//
// bf16 multiplicands (bf16 nonzero) run each tile on rdb_tile.cuh's bf16
// route (bf16 wgmma k16, bf16-packed weights, the block input's window
// rounded once per tile from x or the rings, a1..a4 in bf16; 205 KB, still
// one block per SM). Its bound is 0.238 ms at the bf16 peak; its own floor
// the 1.58x halo recompute plus 479 KB of weights from L2 per tile, 1.86 GB
// per launch. The sweep's 40 wavefront steps hold at most 108 tiles each,
// under one wave on 132 SMs, so one tile's latency sets each step's pace.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rdb_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSlots = 4;  // ring slots: the reader's three bands + the writer's
constexpr int kLag = 2;    // bands between consecutive dense blocks

struct Sweep {
  const float* x;      // (N, H, W, 64)
  float* ring[2];      // t1, t2: (kSlots, N, 8, W, 64)
  float* out;          // (N, H, W, 64)
  int N, H, W;
  float s;

  // pixel (gy, gx) of image n in ring r
  __device__ float* ring_px(int r, int n, int gy, int gx) const {
    const int slot = (gy / rdbtile::kTH) % kSlots;
    return ring[r] +
           ((((size_t)slot * N + n) * rdbtile::kTH + gy % rdbtile::kTH) * W + gx) *
               rdbtile::kFeat;
  }
  __device__ size_t x_index(int n, int gy, int gx) const {
    return (((size_t)n * H + gy) * W + gx) * rdbtile::kFeat;
  }
};

// Dense block p's input: x, t1 or t2. The tile body stages it with
// cp.async.cg, which reads through L2 only: ring slots are rewritten by other
// blocks between grid barriers, so no stale L1 line may serve them.
struct SweepSource {
  Sweep sw;
  int p, n;
  __device__ const float* pixel(int gy, int gx) const {
    return p == 0 ? sw.x + sw.x_index(n, gy, gx) : sw.ring_px(p - 1, n, gy, gx);
  }
};

struct SweepStore {  // t1, t2 = a + s * v; out = x + s * (t2 + s * v)
  Sweep sw;
  int p, n;
  __device__ void operator()(int gy, int gx, int co, float v0, float v1) const {
    const size_t i = sw.x_index(n, gy, gx) + co;
    const float2 a = p == 0 ? *reinterpret_cast<const float2*>(sw.x + i)
                            : __ldcg(reinterpret_cast<const float2*>(
                                  sw.ring_px(p - 1, n, gy, gx) + co));
    const float2 t = make_float2(a.x + sw.s * v0, a.y + sw.s * v1);
    if (p < 2) {
      *reinterpret_cast<float2*>(sw.ring_px(p, n, gy, gx) + co) = t;
    } else {
      const float2 xv = *reinterpret_cast<const float2*>(sw.x + i);
      *reinterpret_cast<float2*>(sw.out + i) =
          make_float2(xv.x + sw.s * t.x, xv.y + sw.s * t.y);
    }
  }
};

template <bool kBf16>
__global__ void __launch_bounds__(rdbtile::kThreads, 1)
rrdb_sweep_kernel(Sweep sw, const rdbtile::WeightT<kBf16>* __restrict__ w,
                  const float* __restrict__ bias) {
  extern __shared__ float4 smem4[];
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (sw.W + rdbtile::kTW - 1) / rdbtile::kTW;
  const int bands = (sw.H + rdbtile::kTH - 1) / rdbtile::kTH;
  const int per_band = sw.N * tiles_x;

  for (int step = 0; step < bands + 2 * kLag; ++step) {
    int live = 0;  // dense blocks with a band in this step
    for (int p = 0; p < 3; ++p) {
      const int b = step - kLag * p;
      live += b >= 0 && b < bands;
    }
    for (int t = blockIdx.x; t < live * per_band; t += gridDim.x) {
      // the (t / per_band)-th live block, in the order RDB1, RDB2, RDB3
      int p = 0, k = t / per_band;
      for (;; ++p) {
        const int b = step - kLag * p;
        if (b >= 0 && b < bands && k-- == 0) break;
      }
      const int band = step - kLag * p;
      const int n = (t % per_band) / tiles_x, tx = t % tiles_x;
      rdbtile::dense_block_tile<kBf16>(
          smem4, SweepSource{sw, p, n}, w + p * rdbtile::kTileWeights<kBf16>,
          bias + p * (rdbtile::kFeat + 4 * rdbtile::kGrowth), band * rdbtile::kTH,
          tx * rdbtile::kTW, sw.H, sw.W, SweepStore{sw, p, n});
    }
    grid.sync();
  }
}

template <bool kBf16>
cudaError_t rrdb_sweep(const float* x, float* ring1, float* ring2, float* out,
                       const void* w_packed, const float* bias, int N, int H, int W,
                       float scaling, cudaStream_t s) {
  constexpr size_t smem = rdbtile::kTileSmemBytes<kBf16>;
  cudaError_t err = cudaFuncSetAttribute(rrdb_sweep_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, rrdb_sweep_kernel<kBf16>, rdbtile::kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  Sweep sw{x, {ring1, ring2}, out, N, H, W, scaling};
  const rdbtile::WeightT<kBf16>* w = static_cast<const rdbtile::WeightT<kBf16>*>(w_packed);
  void* args[] = {&sw, (void*)&w, (void*)&bias};
  err = cudaLaunchCooperativeKernel((const void*)rrdb_sweep_kernel<kBf16>,
                                    dim3(per_sm * sms), dim3(rdbtile::kThreads), args,
                                    smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x, out: (N, H, W, 64), out must not alias x; ring1, ring2: (4, N, 8, W, 64)
// scratch each; w_packed: the three blocks' pack_rdb_weights_tc weights back
// to back (ops/rdb.py:pack_rrdb_weights_tc: floats, or with bf16 nonzero,
// bf16 multiplicands, bf16 values); bias: the three blocks' 192 biases back
// to back. One cooperative launch. Returns the launch's error
// (cudaErrorCooperativeLaunchTooLarge if the card cannot hold one block per
// SM) or cudaGetLastError().
extern "C" int rrdb_sweep_forward(const float* x, float* ring1, float* ring2,
                                  float* out, const void* w_packed,
                                  const float* bias, int N, int H, int W,
                                  float scaling, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)rrdb_sweep<true>(x, ring1, ring2, out, w_packed, bias, N, H, W,
                                      scaling, s)
              : (int)rrdb_sweep<false>(x, ring1, ring2, out, w_packed, bias, N, H, W,
                                       scaling, s);
}
