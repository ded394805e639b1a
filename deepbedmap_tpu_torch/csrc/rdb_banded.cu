// K6: the residual dense block with its intermediates in shared memory, fp32,
// NHWC: out = x + s * conv5(dense(x)), LeakyReLU(0.2) after conv1-4, the
// function of K1 (rdb.cu) and of ops/rdb.py:rdb_reference.
//
// Replaces the TPU kernel deepbedmap_tpu/ops/pallas_rdb.py:rdb_pallas (body
// _rdb_kernel -> _band_compute), the dense block of the non-resident trunk
// (GeneratorConfig(rdb_resident="never")): each row band, with a 5-row margin
// gathered by XLA, is computed in VMEM and written once.
//
// What bounds it on an H100: arithmetic. The function's work at the main-path
// shape (2 x 286 x 286 x 64) is K1's, 78 GFLOP against ~0.1 GB in and out,
// 1.170 ms at the fp32 FMA peak (no tensor cores in this version). The
// tile-local design below recomputes the halo, 1.77x those MACs.
//
// Design: one launch, one thread block per 8 x 8 output tile, the whole block
// in shared memory (rdb_tile.cuh): the input window with a 5-px halo and the
// four 32-channel intermediates on shrinking windows, 172 KB, so one block
// per SM. Unlike K1 there is no (N, H, W, 192) workspace in device memory:
// HBM sees x once (plus the halo rows of neighbouring tiles, from L2) and the
// output once; the wrapper allocates only the output. This is the TPU
// kernel's design carried over to shared memory; K1 is the other design
// (workspace in device memory, five conv launches), kept for the resident
// trunk, so the card gives an A/B of the two.

#include <cuda_runtime.h>

#include "rdb_tile.cuh"

namespace {

struct ImageLoader {
  const float* x;  // this image, (H, W, 64)
  int W;
  __device__ float4 operator()(int gy, int gx, int c4) const {
    return __ldg(reinterpret_cast<const float4*>(x + ((size_t)gy * W + gx) * rdbtile::kFeat) + c4);
  }
};

struct SkipStore {  // out = x + s * v
  float* out;  // this image, (H, W, 64)
  int W;
  float s;
  __device__ void operator()(int gy, int gx, int co, float v, float x) const {
    out[((size_t)gy * W + gx) * rdbtile::kFeat + co] = x + s * v;
  }
};

__global__ void __launch_bounds__(rdbtile::kThreads, 1)
rdb_banded_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  int H, int W, float scaling) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t img = (size_t)blockIdx.z * H * W * rdbtile::kFeat;
  rdbtile::dense_block_tile(smem, ImageLoader{x + img, W}, w, bias,
                            blockIdx.y * rdbtile::kT, blockIdx.x * rdbtile::kT, H,
                            W, SkipStore{out + img, W, scaling});
}

}  // namespace

// x, out: (N, H, W, 64), out must not alias x; w_packed: the five stages'
// [cout/32][cin][9][32] blocks back to back (ops/rdb.py:pack_rdb_weights);
// bias: b1|b2|b3|b4|b5 (192 floats). Returns cudaGetLastError().
extern "C" int rdb_banded_forward(const float* x, float* out, const float* w_packed,
                                  const float* bias, int N, int H, int W,
                                  float scaling, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rdb_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)rdbtile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + rdbtile::kT - 1) / rdbtile::kT, (H + rdbtile::kT - 1) / rdbtile::kT,
                  N);
  rdb_banded_kernel<<<grid, rdbtile::kThreads, rdbtile::kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(x, out, w_packed, bias, H,
                                                           W, scaling);
  return (int)cudaGetLastError();
}
