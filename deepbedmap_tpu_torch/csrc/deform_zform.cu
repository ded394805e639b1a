// K9: the deformable conv with the tap projection inside the kernel ("zform"),
// fp32, NHWC, 3x3 kernel, padding 1:
//   out(p) = b + sum_t bilinear(z_t, p + tap_t + clamp(off_t(p))),
//   z_t = W_t^T x  (C_in -> C_out, the projection of the input through tap
//   t's weights).
// Sampling is linear in the channels, so this is the deformable conv of
// deform_tail.cu (K2/K7) with the channel contraction moved before the
// sampling. Offsets follow the JAX layout, [0, 9) dy and [9, 18) dx; each is
// clamped to [-clamp, clamp], the base corner is the floor (also at
// integers), and corners outside the image count zero: here because z is the
// projection of a zero-padded x, so it is exactly zero outside the image.
//
// Replaces the TPU kernel deepbedmap_tpu/ops/pallas_kernels.py:
// deform_conv2d_pallas_zform (body _deform_zform_kernel), which projects each
// window row through the tap weights on the MXU and evaluates the
// (2 clamp + 2)^2 masked-shift terms on the projections. Here the four
// bilinear corners are read directly: the same function.
//
// What bounds it on an H100: for C_out = 64, arithmetic: the function's work
// is K7's, the 576 -> 64 contraction and 9 x 64 samples per pixel (3.060 ms at
// (2, 1144, 1144, 64) at the fp32 FMA peak); projecting the whole sample
// window instead of each output pixel's samples costs 2.13x those MACs. For
// C_out = 1 it is bytes: x is read once and one channel written.
//
// Design: a block owns an 8 x 16 output tile. It stages the input window that
// every tap's samples can reach (15 x 23 pixels: 3 px of tap and clamp reach
// each side, one more on the far side for the second corner), channel-major
// in shared memory, zero outside the image. For each tap t it projects the
// 13 x 21 window of positions that tap t's corners can touch into z_t (shared
// memory, one plane per output channel), with tap t + 1's weights already in
// flight (cp.async, double-buffered); then each thread gathers the four
// corners of its pixel's sample from z_t for its output channels and
// accumulates in registers. The bias is added before the only store.
// Clamps of at most 2 px are supported (the window is sized for them).

#include <cuda_runtime.h>

namespace {

constexpr int kTH = 8, kTW = 16;              // output tile
constexpr int kThreads = 256;
constexpr int kReach = 2;                     // largest clamp
constexpr int kXH = kTH + 2 * (kReach + 1) + 1;  // 15: input window
constexpr int kXW = kTW + 2 * (kReach + 1) + 1;  // 23
constexpr int kXPix = kXH * kXW;                 // 345
constexpr int kZH = kTH + 2 * kReach + 1;        // 13: one tap's projection window
constexpr int kZW = kTW + 2 * kReach + 1;        // 21
constexpr int kZPix = kZH * kZW;                 // 273
constexpr int kTaps = 9;

// floats of z_t's planes, rounded up so that the weight buffers after them
// stay 16-byte aligned for cp.async
__host__ __device__ constexpr int z_floats(int cout) { return (kZPix * cout + 3) / 4 * 4; }
__host__ __device__ constexpr size_t smem_floats(int cin, int cout) {
  return (size_t)kXPix * cin + z_floats(cout) + 2 * (size_t)cin * cout;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Tap t's (C_in, C_out) weights -> dst, asynchronously (one commit group).
__device__ __forceinline__ void load_tap(float* dst, const float* w, int t, int n4) {
  const float4* src = reinterpret_cast<const float4*>(w) + (size_t)t * n4;
  for (int i = threadIdx.x; i < n4; i += kThreads) cp_async16(dst + 4 * i, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// kCout output channels; the projection gives each thread kPX window
// positions x kCPT channels, the sampling kSC channels of one pixel.
template <int kCout, int kPX>
__global__ void __launch_bounds__(kThreads)
deform_zform_kernel(const float* __restrict__ x, const float* __restrict__ off,
                    const float* __restrict__ w,  // [9][cin][kCout]
                    const float* __restrict__ bias, float* __restrict__ out,
                    int H, int W, int cin, float clamp) {
  constexpr int kCPT = kCout < 8 ? kCout : 8;
  constexpr int kCG = kCout / kCPT;
  constexpr int kNB = (kZPix + kPX - 1) / kPX;
  static_assert(kNB * kCG <= kThreads, "more projection units than threads");
  constexpr int kSplit = kCout >= 2 ? 2 : 1;  // threads per output pixel
  constexpr int kSC = kCout / kSplit;
  static_assert(kTH * kTW * kSplit <= kThreads, "more sampling units than threads");

  extern __shared__ float4 smem4[];
  float* s_x = reinterpret_cast<float*>(smem4);
  float* s_z = s_x + kXPix * cin;
  float* s_w = s_z + z_floats(kCout);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, n = blockIdx.z;
  const int n4 = cin * kCout / 4;

  load_tap(s_w, w, 0, n4);
  // input window: rows y0-3 .. y0+kTH+3, cols x0-3 .. x0+kTW+3
  for (int i = tid; i < kXPix * cin; i += kThreads) {
    const int p = i / cin, c = i % cin;
    const int gy = y0 - (kReach + 1) + p / kXW, gx = x0 - (kReach + 1) + p % kXW;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = x[((size_t)(n * H + gy) * W + gx) * cin + c];
    s_x[c * kXPix + p] = v;
  }

  // projection unit: window positions pb + k * kNB, channels cg * kCPT + ..
  const bool proj = tid < kNB * kCG;
  const int pb = tid % kNB, pcg = tid / kNB;
  int xbase[kPX];
#pragma unroll
  for (int k = 0; k < kPX; ++k) {
    const int p = min(pb + k * kNB, kZPix - 1);
    xbase[k] = (p / kZW) * kXW + p % kZW;
  }
  // sampling unit: output pixel (ly, lx), channels half * kSC + ..
  const bool samp = tid < kTH * kTW * kSplit;
  const int op = tid % (kTH * kTW), half = tid / (kTH * kTW);
  const int ly = op / kTW, lx = op % kTW;
  const int gy = y0 + ly, gx = x0 + lx;
  const bool inside = samp && gy < H && gx < W;
  const float* offp = off + ((size_t)(n * H + min(gy, H - 1)) * W + min(gx, W - 1)) * 2 * kTaps;
  float acc_s[kSC];
#pragma unroll
  for (int j = 0; j < kSC; ++j) acc_s[j] = 0.f;

  for (int t = 0; t < kTaps; ++t) {
    if (t + 1 < kTaps) {
      load_tap(s_w + ((t + 1) & 1) * cin * kCout, w, t + 1, n4);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int u = t / 3, v = t % 3;
    if (proj) {
      float acc[kPX][kCPT];
#pragma unroll
      for (int k = 0; k < kPX; ++k)
#pragma unroll
        for (int j = 0; j < kCPT; ++j) acc[k][j] = 0.f;
      const float* xs = s_x + u * kXW + v;
      const float* ws = s_w + (t & 1) * cin * kCout + pcg * kCPT;
#pragma unroll 4
      for (int c = 0; c < cin; ++c) {
        float wv[kCPT];
        if constexpr (kCPT == 8) {
          const float4 wa = reinterpret_cast<const float4*>(ws + c * kCout)[0];
          const float4 wb = reinterpret_cast<const float4*>(ws + c * kCout)[1];
          wv[0] = wa.x; wv[1] = wa.y; wv[2] = wa.z; wv[3] = wa.w;
          wv[4] = wb.x; wv[5] = wb.y; wv[6] = wb.z; wv[7] = wb.w;
        } else {
#pragma unroll
          for (int j = 0; j < kCPT; ++j) wv[j] = ws[c * kCout + j];
        }
#pragma unroll
        for (int k = 0; k < kPX; ++k) {
          const float a = xs[c * kXPix + xbase[k]];
#pragma unroll
          for (int j = 0; j < kCPT; ++j) acc[k][j] += a * wv[j];
        }
      }
#pragma unroll
      for (int k = 0; k < kPX; ++k) {
        const int p = pb + k * kNB;
        if (p < kZPix) {
#pragma unroll
          for (int j = 0; j < kCPT; ++j) s_z[(pcg * kCPT + j) * kZPix + p] = acc[k][j];
        }
      }
    }
    __syncthreads();
    if (inside) {
      const float dy = fminf(fmaxf(offp[t], -clamp), clamp);
      const float dx = fminf(fmaxf(offp[kTaps + t], -clamp), clamp);
      const float iy = floorf(dy), ix = floorf(dx);
      const float fy = dy - iy, fx = dx - ix;
      // z_t's window starts at (y0 + u - 3, x0 + v - 3); the corner rows are
      // y0 + ly + u - 1 + iy + {0, 1}
      const int zi = (ly + kReach + (int)iy) * kZW + lx + kReach + (int)ix;
      const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
      const float w10 = fy * (1.f - fx), w11 = fy * fx;
      const float* zp = s_z + half * kSC * kZPix + zi;
#pragma unroll
      for (int j = 0; j < kSC; ++j) {
        const float* zc = zp + j * kZPix;
        acc_s[j] += w00 * zc[0] + w01 * zc[1] + w10 * zc[kZW] + w11 * zc[kZW + 1];
      }
    }
  }
  if (!inside) return;
  float* o = out + ((size_t)(n * H + gy) * W + gx) * kCout + half * kSC;
#pragma unroll
  for (int j = 0; j < kSC; ++j) o[j] = acc_s[j] + bias[half * kSC + j];
}

template <int kCout, int kPX>
int launch(const float* x, const float* off, const float* w, const float* bias,
           float* out, int N, int H, int W, int cin, float clamp, void* stream) {
  const size_t smem = sizeof(float) * smem_floats(cin, kCout);
  cudaError_t err = cudaFuncSetAttribute(deform_zform_kernel<kCout, kPX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N);
  deform_zform_kernel<kCout, kPX><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, off, w, bias, out, H, W, cin, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, H, W, cin), cin a multiple of 4 in [4, 64]; off: (N, H, W, 18);
// w_packed: (9, cin, cout) with [t][ci][co] = weight[co, ci, t / 3, t % 3];
// bias: (cout,); out: (N, H, W, cout), cout in {1, 16, 64}; 0 <= clamp <= 2.
// Returns cudaErrorInvalidValue for any other shape, else cudaGetLastError().
extern "C" int deform_zform(const float* x, const float* off, const float* w_packed,
                            const float* bias, float* out, int N, int H, int W,
                            int cin, int cout, float clamp, void* stream) {
  if (cin < 4 || cin > 64 || cin % 4 != 0 || !(clamp >= 0.f && clamp <= kReach))
    return (int)cudaErrorInvalidValue;
  switch (cout) {
    case 64: return launch<64, 9>(x, off, w_packed, bias, out, N, H, W, cin, clamp, stream);
    case 16: return launch<16, 3>(x, off, w_packed, bias, out, N, H, W, cin, clamp, stream);
    case 1: return launch<1, 2>(x, off, w_packed, bias, out, N, H, W, cin, clamp, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
