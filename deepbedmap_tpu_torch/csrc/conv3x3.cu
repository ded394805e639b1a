// K10: a standalone 3x3 SAME convolution with its epilogue, fp32, NHWC:
// out = [lrelu]((conv(x) + b) [+ res]), C_in in {64, 128}, C_out = 64.
//
// Replaces the TPU kernel deepbedmap_tpu/ops/pallas_conv.py:conv3x3_pallas
// (body _conv3x3_kernel): the generator's pre-residual (128 -> 64, LeakyReLU),
// post-residual (64 -> 64, + the long skip) and two post-upsample (64 -> 64,
// LeakyReLU) convs.
//
// What bounds it on an H100: arithmetic, 2 x 9 x C_in flops per output value
// (24 to 193 GFLOP per call at the main-path shapes) against one read of x
// [and res] and one write of out.
//
// Design: it is one launch of the port's shared direct conv (conv3x3.cuh),
// the same code K1 and K4 run, with the bias, the residual add and the
// LeakyReLU in the epilogue before the only store. The TPU kernel's padded
// row pitch and lane-rolled [x[m-1] | x[m] | x[m+1]] operand exist to feed
// its 128-wide matrix unit one dot per row band; here the staged halo tile
// already gives each thread its nine taps, so neither is carried over.

#include <cuda_runtime.h>

#include "conv3x3.cuh"

// x: (N, H, W, cin); w_packed: [64/32][cin][9][32]; bias: (64,);
// res: (N, H, W, 64) or null; out: (N, H, W, 64). Returns cudaGetLastError().
extern "C" int conv3x3_forward(const float* x, const float* w_packed,
                               const float* bias, const float* res, float* out,
                               int N, int H, int W, int cin, int leaky,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kCout = 64;
  const Epilogue ep{out, kCout, res, kCout, nullptr, 0.f};
  if (res == nullptr) {
    return leaky ? (int)launch_conv3x3<kLrelu>(x, cin, cin, w_packed, bias, kCout, ep,
                                               N, H, W, s)
                 : (int)launch_conv3x3<kLinear>(x, cin, cin, w_packed, bias, kCout,
                                                ep, N, H, W, s);
  }
  return leaky ? (int)launch_conv3x3<kAddLrelu>(x, cin, cin, w_packed, bias, kCout, ep,
                                                N, H, W, s)
               : (int)launch_conv3x3<kAdd>(x, cin, cin, w_packed, bias, kCout, ep, N,
                                           H, W, s);
}
