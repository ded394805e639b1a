// K10: a standalone 3x3 SAME convolution with its epilogue, fp32, NHWC:
// out = [lrelu]((conv(x) + b) [+ res]), C_in in {64, 128}, C_out = 64.
//
// Replaces the TPU kernel deepbedmap_tpu/ops/pallas_conv.py:conv3x3_pallas
// (:102, call :166, body _conv3x3_kernel :62): the generator's pre-residual
// (128 -> 64, LeakyReLU), post-residual (64 -> 64, + the long skip) and two
// post-upsample (64 -> 64, LeakyReLU) convs.
//
// What bounds it on an H100: tensor-core operations. A call does
// 2 x 9 x C_in x 64 flops per pixel against one read of x [and res] and one
// write of out; fp32 accuracy on the tensor cores takes three TF32 passes
// (3xTF32), so the bound is 3 x flops at 495 TFLOP/s: 0.146, 0.073, 0.292
// and 1.170 ms for the four calls of one forward at the main-path shapes
// (286^2 x 128, 286^2 x 64 with the residual, 572^2 and 1144^2 x 64).
//
// Design: one launch of the dense-block stages' tensor-core conv
// (conv3x3_tc.cuh: a 16 x 16 pixel tile per block, N = all 64 outputs,
// K = 8-channel chunks x 9 taps on wgmma.m64n64k8, lo.hi + hi.lo + hi.hi
// into a partial sum per kernel row), reading x with its own channel pitch
// and weights in pack_conv_weight's layout, which is the stages' layout. The
// bias, the residual add and the LeakyReLU are epilogue modes applied before
// the only store, in the plain version's rounding order. The TPU kernel's
// padded row pitch and lane-rolled [x[m-1] | x[m] | x[m+1]] operand exist to
// feed its 128-wide matrix unit one dot per row band; here each tap is a
// shifted view of the staged halo, so neither is carried over. With bf16
// multiplicands (the TPU kernel's mxu_bf16, pallas_conv.py:77, 131-132) the
// launch takes conv3x3_tc.cuh's bf16 route: bf16 wgmma k16 on x rounded to
// bf16 (to nearest even) once per chunk, bf16 weights packed by the host,
// persistent blocks. Its bound is the fp32 bytes it must move (0.575 ms for
// the four calls), the products at the bf16 peak being a third of that.

#include <cuda_runtime.h>

#include "conv3x3_tc.cuh"

namespace {

template <bool kBf16>
cudaError_t conv3x3(const float* x, const void* w_packed, const float* bias,
                    const float* res, float* out, int N, int H, int W, int cin, int leaky,
                    cudaStream_t s) {
  constexpr int kCout = 64;
  const Epilogue ep{out, kCout, res, kCout, nullptr, 0.f};
  if (res == nullptr) {
    return leaky ? launch_conv3x3_tc<kCout, kLrelu, kBf16>(x, cin, cin, w_packed, bias, ep,
                                                           N, H, W, s)
                 : launch_conv3x3_tc<kCout, kLinear, kBf16>(x, cin, cin, w_packed, bias, ep,
                                                            N, H, W, s);
  }
  return leaky ? launch_conv3x3_tc<kCout, kAddLrelu, kBf16>(x, cin, cin, w_packed, bias, ep,
                                                            N, H, W, s)
               : launch_conv3x3_tc<kCout, kAdd, kBf16>(x, cin, cin, w_packed, bias, ep, N,
                                                       H, W, s);
}

}  // namespace

// x: (N, H, W, cin); w_packed: [64/32][cin][9][32] floats, or bf16 in
// [cin/16][9][8][2][8][8] when bf16 is nonzero
// (ops/conv3x3.py:pack_conv_weight(mxu_bf16=True)); bias: (64,); res: (N, H,
// W, 64) or null; out: (N, H, W, 64); bf16: nonzero for bf16 multiplicands
// (conv3x3_tc.cuh's bf16 route). Returns cudaGetLastError().
extern "C" int conv3x3_forward(const float* x, const void* w_packed,
                               const float* bias, const float* res, float* out,
                               int N, int H, int W, int cin, int leaky, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)conv3x3<true>(x, w_packed, bias, res, out, N, H, W, cin, leaky, s)
              : (int)conv3x3<false>(x, w_packed, bias, res, out, N, H, W, cin, leaky, s);
}
