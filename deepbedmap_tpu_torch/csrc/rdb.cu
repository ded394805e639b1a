// K1 and K4: the residual dense block (RDB) and the whole residual-in-residual
// dense block (RRDB), fp32, NHWC.
//
// K1 rdb_forward replaces the TPU kernel
// deepbedmap_tpu/ops/pallas_rdb.py:rdb_pallas_flat (_rdb_flat_kernel, body
// _band_compute): five chained 3x3 SAME convs with inputs of 64/96/128/160/192
// channels and outputs of 32/32/32/32/64, dense concatenation, LeakyReLU(0.2)
// after conv1-4, and out = x + s * conv5.
//
// K4 rrdb_forward replaces deepbedmap_tpu/ops/pallas_rdb.py:rrdb_pallas_flat
// (_rrdb_flat_kernel): three chained dense blocks and the scaled outer skip,
// out = x + s * rdb3(rdb2(rdb1(x))), in one host call.
//
// What bounds them on an H100: tensor-core operations. One block at the
// main-path shape (2 x 286 x 286 x 64) is 78 GFLOP against ~0.1 GB of input
// and output, far above the ridge point. Each conv stage runs on the tensor
// cores in 3xTF32 (conv3x3_tc.cuh), which is as accurate as fp32 FMAs: three
// TF32 passes of 78 GFLOP at 495 TFLOP/s bound one block at 0.475 ms. A whole
// RRDB is three times that.
//
// Design: the TPU kernels keep every intermediate of a row band in VMEM.
// Here they live in a dense NHWC workspace (N, H, W, 192) in device memory:
// the block input sits in channels 0-63 and stage j writes its 32 outputs into
// channels 64 + 32 (j - 1), so stage j's input is simply the first
// 64 + 32 (j - 1) channels. Each stage is one launch of the implicit-GEMM
// conv (conv3x3_tc.cuh); one block covers the stage's whole C_out, so stage 5
// reads its 192-channel input once. K1 copies x into its workspace first (6
// launches per block). K4 runs its 15 stages on two workspaces in ping-pong:
// stage 5 of blocks 1 and 2 writes a + s * conv5 straight into channels 0-63
// of the other workspace, which is the next block's input, so only block 1
// needs the copy; it cannot write in place, because neighbouring tiles of the
// same launch still read channels 0-63. Stage 5 of block 3 folds the outer
// skip into its epilogue, out = x + s * (t2 + s * (conv5 + b)), rounded in the
// order of the plain composition. So one RRDB is 16 device launches (1 copy +
// 15 convs) instead of 3 x 6 + 2. Intermediates in shared memory are later
// work.
//
// bf16 multiplicands (the TPU kernels' mxu_bf16, pallas_rdb.py:124-128): with
// bf16 != 0 every stage runs conv3x3_tc.cuh's bf16 route (bf16 wgmma k16 on
// the workspace rounded to bf16 at each stage's staging, round to nearest
// even; w_packed then holds bf16 weights in the route's core-matrix layout,
// ops/rdb.py:pack_rdb_weights(mxu_bf16=True)). The workspace, the biases,
// the LeakyReLUs and the skips stay fp32.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "conv3x3_tc.cuh"

namespace {

constexpr int kFeat = 64;        // block input/output channels
constexpr int kGrowth = 32;      // channels added by conv1-4
constexpr int kWsC = kFeat + 4 * kGrowth;  // workspace channels: 192
// values (fp32, or bf16 on the bf16 route) of one block's packed weights:
// 9 x sum_j C_in_j x C_out_j
constexpr size_t kBlockWeights =
    9 * (size_t)(64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64);

// x (P, 64) -> ws[:, 0:64] of the (P, 192) workspace, one float4 per thread.
__global__ void copy_into_workspace(const float4* __restrict__ x,
                                    float4* __restrict__ ws, long long total4) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const long long pix = i / (kFeat / 4), q = i % (kFeat / 4);
  ws[pix * (kWsC / 4) + q] = x[i];
}

cudaError_t launch_copy(const float* x, float* ws, int N, int H, int W,
                        cudaStream_t s) {
  const long long total4 = (long long)N * H * W * (kFeat / 4);
  const int threads = 256;
  copy_into_workspace<<<(unsigned)((total4 + threads - 1) / threads), threads, 0,
                        s>>>(reinterpret_cast<const float4*>(x),
                             reinterpret_cast<float4*>(ws), total4);
  return cudaGetLastError();
}

// The packed weights' element type: fp32, or bf16 bits on the bf16 route.
template <bool kBf16>
using WeightT = std::conditional_t<kBf16, uint16_t, float>;

// Stages 1-4 of one dense block on `ws`, whose channels 0-63 hold its input.
// `w` / `bias` point at the block's packed weights / its 192 biases; on
// return they have advanced to stage 5's.
template <bool kBf16>
cudaError_t dense_stages(float* ws, const WeightT<kBf16>*& w, const float*& bias, int N,
                         int H, int W, cudaStream_t s) {
  for (int j = 0; j < 4; ++j) {
    const int cin = kFeat + kGrowth * j;
    const Epilogue ep{ws + cin, kWsC, nullptr, 0, nullptr, 0.f};
    cudaError_t err =
        launch_conv3x3_tc<kGrowth, kLrelu, kBf16>(ws, kWsC, cin, w, bias, ep, N, H, W, s);
    if (err != cudaSuccess) return err;
    w += (size_t)cin * 9 * kGrowth;
    bias += kGrowth;
  }
  return cudaSuccess;
}

template <bool kBf16>
cudaError_t rdb(const float* x, float* ws, float* out, const void* w_packed,
                const float* bias, int N, int H, int W, float scaling, cudaStream_t s) {
  cudaError_t err = launch_copy(x, ws, N, H, W, s);
  if (err != cudaSuccess) return err;
  const WeightT<kBf16>* w = static_cast<const WeightT<kBf16>*>(w_packed);
  const float* b = bias;
  err = dense_stages<kBf16>(ws, w, b, N, H, W, s);
  if (err != cudaSuccess) return err;
  const Epilogue ep{out, kFeat, x, kFeat, nullptr, scaling};
  return launch_conv3x3_tc<kFeat, kScaledSkip, kBf16>(ws, kWsC, kWsC, w, b, ep, N, H, W, s);
}

template <bool kBf16>
cudaError_t rrdb(const float* x, float* ws_a, float* ws_b, float* out,
                 const void* w_packed, const float* bias, int N, int H, int W,
                 float scaling, cudaStream_t s) {
  cudaError_t err = launch_copy(x, ws_a, N, H, W, s);
  if (err != cudaSuccess) return err;
  float* cur = ws_a;
  float* nxt = ws_b;
  for (int p = 0; p < 3; ++p) {
    const WeightT<kBf16>* w = static_cast<const WeightT<kBf16>*>(w_packed) + p * kBlockWeights;
    const float* b = bias + p * kWsC;
    err = dense_stages<kBf16>(cur, w, b, N, H, W, s);
    if (err != cudaSuccess) return err;
    if (p < 2) {
      // a_{p+1} = a_p + s * (conv5 + b5) -> channels 0-63 of the other workspace
      const Epilogue ep{nxt, kWsC, cur, kWsC, nullptr, scaling};
      err = launch_conv3x3_tc<kFeat, kScaledSkip, kBf16>(cur, kWsC, kWsC, w, b, ep, N, H,
                                                         W, s);
      float* t = cur;
      cur = nxt;
      nxt = t;
    } else {
      // out = x + s * (a_2 + s * (conv5 + b5))
      const Epilogue ep{out, kFeat, cur, kWsC, x, scaling};
      err = launch_conv3x3_tc<kFeat, kDoubleSkip, kBf16>(cur, kWsC, kWsC, w, b, ep, N, H,
                                                         W, s);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: (N, H, W, 64); ws: (N, H, W, 192) scratch; w_packed: the five
// stages' [cout/32][cin][9][32] float blocks back to back, or with bf16
// nonzero (bf16 multiplicands) their [cin/16][9][cout/8][2][8][8] bf16
// blocks; bias: b1|b2|b3|b4|b5 (192 floats). Returns cudaGetLastError()
// after the last launch.
extern "C" int rdb_forward(const float* x, float* ws, float* out,
                           const void* w_packed, const float* bias, int N,
                           int H, int W, float scaling, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)rdb<true>(x, ws, out, w_packed, bias, N, H, W, scaling, s)
              : (int)rdb<false>(x, ws, out, w_packed, bias, N, H, W, scaling, s);
}

// x, out: (N, H, W, 64), out must not alias x; ws_a, ws_b: (N, H, W, 192)
// scratch; w_packed: the three blocks' rdb_forward weight packs back to back;
// bias: the three blocks' 192 biases back to back; bf16 as rdb_forward's.
// Returns cudaGetLastError() after the last launch.
extern "C" int rrdb_forward(const float* x, float* ws_a, float* ws_b, float* out,
                            const void* w_packed, const float* bias, int N,
                            int H, int W, float scaling, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)rrdb<true>(x, ws_a, ws_b, out, w_packed, bias, N, H, W, scaling, s)
              : (int)rrdb<false>(x, ws_a, ws_b, out, w_packed, bias, N, H, W, scaling, s);
}
