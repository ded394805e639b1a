// K2 and K3: the two deformable output layers of the generator tail, fp32,
// NHWC. Offsets follow the JAX layout: channels [0, 9) are the row (dy)
// displacements and [9, 18) the column (dx) displacements, taps row-major
// over the 3x3 kernel. Both clamp each displacement to [-clamp, clamp] and
// take the bilinear sample at p + (u - 1, v - 1) + (dy, dx) with
// floor(dy) / floor(dx) as the base corner; corners outside the image count
// as zero. That is exactly the masked-shift sum of
// deepbedmap_tpu/ops/deform_conv.py:_deform_conv_shifts, whose weights are
// (1 - f) on the floor shift and f on the next one and zero elsewhere.
//
// K2 deform64_lrelu replaces stage A of
// deepbedmap_tpu/ops/pallas_tail.py:_fused_tail_pallas, the body
// deepbedmap_tpu/ops/pallas_kernels.py:_deform_stacked_kernel (pack_taps,
// apply_lrelu): a 64 -> 64 deformable conv with the bias and LeakyReLU(0.2).
// K7 deform_conv replaces deepbedmap_tpu/ops/pallas_kernels.py:
// deform_conv2d_pallas, whose default body is the same _deform_stacked_kernel
// without the LeakyReLU: it is the same kernel with the LeakyReLU switched off
// at compile time (the unfused tail applies it outside, as JAX does).
// What bounds it on an H100: arithmetic. At the main-path shape
// (2 x 1144 x 1144 x 64) the 576 -> 64 tap contraction is 193 GFLOP while the
// bilinear gathers read ~4 x 9 x 64 floats per pixel, mostly from L2.
// Design: a block owns 64 consecutive pixels of one image row and all 64
// output channels. For each tap it computes the 64 pixels' bilinear corners
// once, gathers the 64 x 64 sampled values into shared memory (one channel per
// thread, so each corner read is one coalesced 256-byte row of x), stages the
// tap's 64 x 64 weight slice beside them, and accumulates the contraction in
// registers (4 pixels x 4 channels per thread). The epilogue adds the bias
// and applies the LeakyReLU before the only write of the output.
//
// K3 deform_zproj1 replaces stage B of the same function, the body
// deepbedmap_tpu/ops/pallas_kernels.py:_deform_zproj1_kernel: the 64 -> 1
// deformable conv computed projection first. Its input is z (N, H, W, 9),
// the nine tap fields z_t = a5 . W2_t; the kernel sums, over the nine taps,
// the clamped bilinear sample of field t at tap t's shifted position, and adds
// the bias. z is zero outside the image, which is the halo masking the TPU
// kernel does by hand. What bounds it: memory. It reads ~4 x 9 gathered
// floats and 18 offsets per pixel and does a few FLOPs on each, so one thread
// per pixel is enough; the gathers hit neighbouring pixels and stay in L1/L2.
// K8 (deepbedmap_tpu/ops/pallas_kernels.py:deform_conv2d_pallas_zproj1) is
// the same function behind a standalone 64 -> 1 deformable conv: its wrapper
// computes z with a matmul and launches this same entry. On the TPU the two
// also share one body (_deform_zproj1_kernel).

#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;        // channels of the 64 -> 64 layer
constexpr int kTaps = 9;
constexpr int kPX = 64;       // pixels per K2 block (one row segment)
constexpr int kThreads2 = 256;
constexpr int kThreads3 = 256;

// Bilinear corners of tap t for output pixel (n, y, gx): flat pixel index of
// each of the four corners (-1 when outside the image) and its weight.
__device__ __forceinline__ void tap_corners(const float* __restrict__ off,
                                            size_t pix, int t, int n, int y,
                                            int gx, int H, int W, float clamp,
                                            int idx[4], float cw[4]) {
  const float dy = fminf(fmaxf(off[pix * 2 * kTaps + t], -clamp), clamp);
  const float dx = fminf(fmaxf(off[pix * 2 * kTaps + kTaps + t], -clamp), clamp);
  const float iy = floorf(dy), ix = floorf(dx);
  const float fy = dy - iy, fx = dx - ix;
  const int r0 = y + t / 3 - 1 + (int)iy;
  const int c0 = gx + t % 3 - 1 + (int)ix;
  const float wy[2] = {1.f - fy, fy};
  const float wx[2] = {1.f - fx, fx};
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = r0 + a, c = c0 + b, k = 2 * a + b;
      const bool in = r >= 0 && r < H && c >= 0 && c < W;
      idx[k] = in ? (n * H + r) * W + c : -1;
      cw[k] = in ? wy[a] * wx[b] : 0.f;
    }
}

template <bool kApplyLrelu>
__global__ void __launch_bounds__(kThreads2)
deform64_kernel(const float* __restrict__ x, const float* __restrict__ off,
                      const float* __restrict__ w,  // [9][64 ci][64 co]
                      const float* __restrict__ bias, float* __restrict__ out,
                      int H, int W, float clamp) {
  __shared__ float s_samp[kPX][kC + 1];
  __shared__ __align__(16) float s_w[kC][kC];
  __shared__ int s_idx[4][kPX];
  __shared__ float s_cw[4][kPX];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kPX;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  const int cg = tid & 15;  // output channels cg*4 .. cg*4+3
  const int pg = tid >> 4;  // pixels pg*4 .. pg*4+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < kTaps; ++t) {
    if (tid < kPX) {
      const int gx = x0 + tid;
      int idx[4] = {-1, -1, -1, -1};
      float cw[4] = {0.f, 0.f, 0.f, 0.f};
      if (gx < W)
        tap_corners(off, (size_t)(n * H + y) * W + gx, t, n, y, gx, H, W, clamp,
                    idx, cw);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_idx[k][tid] = idx[k];
        s_cw[k][tid] = cw[k];
      }
    }
    const float4* wsrc = reinterpret_cast<const float4*>(w + (size_t)t * kC * kC);
    float4* wdst = reinterpret_cast<float4*>(&s_w[0][0]);
    for (int i = tid; i < kC * kC / 4; i += kThreads2) wdst[i] = wsrc[i];
    __syncthreads();

    {
      const int ci = tid & (kC - 1);
      for (int p = tid >> 6; p < kPX; p += kThreads2 / kC) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int id = s_idx[k][p];
          if (id >= 0) v += s_cw[k][p] * x[(size_t)id * kC + ci];
        }
        s_samp[p][ci] = v;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int ci = 0; ci < kC; ++ci) {
      const float4 wv = *reinterpret_cast<const float4*>(&s_w[ci][cg * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = s_samp[pg * 4 + i][ci];
        acc[i][0] += a * wv.x;
        acc[i][1] += a * wv.y;
        acc[i][2] += a * wv.z;
        acc[i][3] += a * wv.w;
      }
    }
    __syncthreads();
  }

  const float4 b = *reinterpret_cast<const float4*>(bias + cg * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gx = x0 + pg * 4 + i;
    if (gx >= W) continue;
    float v[4] = {acc[i][0] + b.x, acc[i][1] + b.y, acc[i][2] + b.z,
                  acc[i][3] + b.w};
    if (kApplyLrelu) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = v[j] >= 0.f ? v[j] : 0.2f * v[j];
    }
    const size_t pix = (size_t)(n * H + y) * W + gx;
    *reinterpret_cast<float4*>(out + pix * kC + cg * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(kThreads3)
deform_zproj1_kernel(const float* __restrict__ z, const float* __restrict__ off,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int N, int H, int W, float clamp) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)N * H * W) return;
  const int gx = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int n = (int)(i / ((long long)W * H));
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    int idx[4];
    float cw[4];
    tap_corners(off, (size_t)i, t, n, y, gx, H, W, clamp, idx, cw);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (idx[k] >= 0) acc += cw[k] * z[(size_t)idx[k] * kTaps + t];
  }
  out[i] = acc + bias[0];
}

template <bool kApplyLrelu>
int launch_deform64(const float* x, const float* off, const float* w_packed,
                    const float* bias, float* out, int N, int H, int W,
                    float clamp, void* stream) {
  const dim3 grid((W + kPX - 1) / kPX, H, N);
  deform64_kernel<kApplyLrelu>
      <<<grid, kThreads2, 0, static_cast<cudaStream_t>(stream)>>>(
          x, off, w_packed, bias, out, H, W, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// Both: x, out: (N, H, W, 64); off: (N, H, W, 18); w_packed: (9 * 64, 64)
// with row t * 64 + ci; bias: (64,). Return cudaGetLastError().
// K2: out = lrelu(deform_conv(x) + bias).
extern "C" int deform64_lrelu(const float* x, const float* off,
                              const float* w_packed, const float* bias,
                              float* out, int N, int H, int W, float clamp,
                              void* stream) {
  return launch_deform64<true>(x, off, w_packed, bias, out, N, H, W, clamp, stream);
}

// K7: out = deform_conv(x) + bias.
extern "C" int deform_conv(const float* x, const float* off,
                           const float* w_packed, const float* bias, float* out,
                           int N, int H, int W, float clamp, void* stream) {
  return launch_deform64<false>(x, off, w_packed, bias, out, N, H, W, clamp, stream);
}

// z: (N, H, W, 9); off: (N, H, W, 18); bias: (1,); out: (N, H, W, 1).
// Returns cudaGetLastError().
extern "C" int deform_zproj1(const float* z, const float* off, const float* bias,
                             float* out, int N, int H, int W, float clamp,
                             void* stream) {
  const long long total = (long long)N * H * W;
  const unsigned blocks = (unsigned)((total + kThreads3 - 1) / kThreads3);
  deform_zproj1_kernel<<<blocks, kThreads3, 0, static_cast<cudaStream_t>(stream)>>>(
      z, off, bias, out, N, H, W, clamp);
  return (int)cudaGetLastError();
}
