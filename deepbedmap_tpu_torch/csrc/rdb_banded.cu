// K6: the residual dense block with its intermediates in shared memory, fp32,
// NHWC: out = x + s * conv5(dense(x)), LeakyReLU(0.2) after conv1-4, the
// function of K1 (rdb.cu) and of ops/rdb.py:rdb_reference.
//
// Replaces the TPU kernel deepbedmap_tpu/ops/pallas_rdb.py:rdb_pallas (body
// _rdb_kernel -> _band_compute), the dense block of the non-resident trunk
// (GeneratorConfig(rdb_resident="never")): each row band, with a 5-row margin
// gathered by XLA, is computed in VMEM and written once.
//
// What bounds it on an H100: tensor-core operations. The function's work at
// the main-path shape (2 x 286 x 286 x 64) is K1's, 78 GFLOP against ~0.1 GB
// in and out, 0.475 ms as 3xTF32 at the tensor cores' 495 TFLOP/s. The
// tile-local design below recomputes the halo, 1.58x those MACs.
//
// Design: one launch, one thread block per 8 x 16 output tile, the whole block
// on the tensor cores with its intermediates in shared memory (rdb_tile.cuh:
// the four 32-channel intermediates on shrinking windows, the input window
// staged one 8-channel chunk at a time, 209 KB, so one block per SM). Unlike
// K1 there is no (N, H, W, 192) workspace in device memory: HBM sees x once
// (plus the halo rows and columns of neighbouring tiles, from L2) and the
// output once; the wrapper allocates only the output. This is the TPU
// kernel's design carried over to shared memory; K1 is the other design
// (workspace in device memory, five conv launches), kept for the resident
// trunk, so the card gives an A/B of the two.
//
// bf16 multiplicands (bf16 nonzero) take rdb_tile.cuh's bf16 route: bf16
// wgmma k16 on weights packed in bf16 (pack_rdb_weights_tc(mxu_bf16=True)),
// the input window rounded to bf16 once per tile and kept for all five
// stages, a1..a4 stored in bf16, 205 KB of shared memory. Its bound is the
// flops at the bf16 peak, 0.079 ms at the main-path shape; its own floor is
// the 1.58x halo recompute plus 479 KB of weights from L2 per tile, 621 MB
// over the launch's 1296 tiles.

#include <cuda_runtime.h>

#include "rdb_tile.cuh"

namespace {

struct ImageSource {
  const float* x;  // this image, (H, W, 64)
  int W;
  __device__ const float* pixel(int gy, int gx) const {
    return x + ((size_t)gy * W + gx) * rdbtile::kFeat;
  }
};

struct SkipStore {  // out = x + s * v
  const float* x;  // this image, (H, W, 64)
  float* out;
  int W;
  float s;
  __device__ void operator()(int gy, int gx, int co, float v0, float v1) const {
    const size_t i = ((size_t)gy * W + gx) * rdbtile::kFeat + co;
    const float2 a = __ldg(reinterpret_cast<const float2*>(x + i));
    *reinterpret_cast<float2*>(out + i) = make_float2(a.x + s * v0, a.y + s * v1);
  }
};

template <bool kBf16>
__global__ void __launch_bounds__(rdbtile::kThreads, 1)
rdb_banded_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const rdbtile::WeightT<kBf16>* __restrict__ w,
                  const float* __restrict__ bias, int H, int W, float scaling) {
  extern __shared__ float4 smem4[];
  const size_t img = (size_t)blockIdx.z * H * W * rdbtile::kFeat;
  rdbtile::dense_block_tile<kBf16>(smem4, ImageSource{x + img, W}, w, bias,
                                   blockIdx.y * rdbtile::kTH, blockIdx.x * rdbtile::kTW, H,
                                   W, SkipStore{x + img, out + img, W, scaling});
}

template <bool kBf16>
cudaError_t rdb_banded(const float* x, float* out, const void* w_packed,
                       const float* bias, int N, int H, int W, float scaling,
                       cudaStream_t s) {
  constexpr size_t smem = rdbtile::kTileSmemBytes<kBf16>;
  cudaError_t err = cudaFuncSetAttribute(rdb_banded_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + rdbtile::kTW - 1) / rdbtile::kTW,
                  (H + rdbtile::kTH - 1) / rdbtile::kTH, N);
  rdb_banded_kernel<kBf16><<<grid, rdbtile::kThreads, smem, s>>>(
      x, out, static_cast<const rdbtile::WeightT<kBf16>*>(w_packed), bias, H, W, scaling);
  return cudaGetLastError();
}

}  // namespace

// x, out: (N, H, W, 64), out must not alias x; w_packed: the five stages'
// weights back to back, split into TF32 hi/lo (ops/rdb.py:pack_rdb_weights_tc,
// floats), or with bf16 nonzero (bf16 multiplicands) in bf16
// (pack_rdb_weights_tc(mxu_bf16=True)); bias: b1|b2|b3|b4|b5 (192 floats).
// Returns cudaGetLastError().
extern "C" int rdb_banded_forward(const float* x, float* out, const void* w_packed,
                                  const float* bias, int N, int H, int W,
                                  float scaling, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)rdb_banded<true>(x, out, w_packed, bias, N, H, W, scaling, s)
              : (int)rdb_banded<false>(x, out, w_packed, bias, N, H, W, scaling, s);
}
