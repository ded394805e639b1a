// Shifted-window multi-head self-attention of a Swin layer, fp32, in token
// order: out = the heads' softmax(q k^T * scale + B [+ M]) v over 8 x 8
// windows of the grid rolled by -shift, put back and rolled by +shift.
//
// Replaces no TPU kernel: the JAX package has no attention. It serves the
// port's SwinIR generator (models/swinir.py; ops/window_attn.py holds the
// plain version and the published semantics): one launch per Swin layer,
// between the qkv linear and proj.
//
// What bounds it on an H100: per window and head two 64 x 64 x d products
// (d = 30 at SwinIR-M: 0.49 MFLOP) against 3 x 64 x d floats read and
// 64 x d written, so ~7.6 GFLOP and ~0.48 GB a call at (2, 288, 288, 180);
// at fp32 on the CUDA cores (67 TFLOP/s) the products take ~0.11 ms, the
// bytes ~0.14 ms at 3.35 TB/s. The qkv and proj linears around it are ~5.6x
// its operations; the benchmark reads its share over the whole layer
// (swin.msa).
//
// Design: one 256-thread block per (window, head), the heads of a window on
// neighbouring blocks so that they share the window's qkv rows in L2.
// - The roll and the window partition are indexing: window position (r, c)
//   of window (wy, wx) reads and writes grid pixel ((8 wy + r + shift) % H,
//   (8 wx + c + shift) % W). No roll, no partition copy.
// - q (times scale, rounded as the plain version's q * scale), k and v land
//   in shared memory row by row ([token][channel], pitch 36), a warp
//   reading one token's contiguous d channels of one part, each thread 12
//   independent loads in flight before it stores them; the head width is
//   padded to 32 with zeros (in shared memory only).
// - S = q k^T: each thread 4 rows x 4 columns (columns 16 apart, so that
//   the 16-byte reads of k are free of bank conflicts), fp32 FMA over the
//   32 channels. The relative-position bias comes from the head's column
//   of the table staged in shared memory; the mask (-100 between the
//   regions that the roll brings together, calculate_mask's 9 regions) is
//   computed from each token's region label, so no mask tensor is read.
// - The softmax in fp32 (expf) in registers: a row's 64 scores sit in 16
//   lanes of one half-warp, reduced with shuffles; P goes to shared memory
//   over q and k.
// - O = P v: each thread 4 rows x 2 channels, fp32 FMA over 64 tokens;
//   the padded channels are not stored.
// Both products are fp32 on the CUDA cores, not TF32: the configuration
// states fp32, and a TF32 pass would fail the benchmark's check.

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 8;
constexpr int kTok = kWin * kWin;                       // tokens of a window
constexpr int kDim = 32;                                 // head width, padded
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTable = (2 * kWin - 1) * (2 * kWin - 1);  // 225 bias rows
constexpr int kPitch = kDim + 4;                         // q, k, v row pitch (floats)
constexpr int kPPitch = kTok + 4;                        // P's row pitch (floats)
constexpr float kMask = -100.f;

// the region of a coordinate of the rolled grid of size n: calculate_mask's
// slices (0, -8), (-8, -shift), (-shift, None)
__device__ __forceinline__ int region(int a, int n, int shift) {
  return a < n - kWin ? 0 : (a < n - shift ? 1 : 2);
}

__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const float* __restrict__ qkv, const float* __restrict__ table,
                   float* __restrict__ out, int H, int W, int C, int heads, int d,
                   int shift, float scale) {
  // q and k, then P over them once the scores are in registers
  __shared__ __align__(16) float qk[2 * kTok * kPitch];
  __shared__ __align__(16) float vs[kTok][kPitch];
  __shared__ float bias[kTable];
  __shared__ int pix[kTok];
  __shared__ int lab[kTok];
  static_assert(kTok * kPPitch <= 2 * kTok * kPitch, "P must fit over q and k");
  float (*qs)[kPitch] = reinterpret_cast<float (*)[kPitch]>(qk);
  float (*ks)[kPitch] = reinterpret_cast<float (*)[kPitch]>(qk + kTok * kPitch);
  float (*ps)[kPPitch] = reinterpret_cast<float (*)[kPPitch]>(qk);

  const int tid = threadIdx.x;
  const int head = blockIdx.x % heads;
  const int win = blockIdx.x / heads;
  const int nwx = W / kWin;
  const int wy = win / nwx, wx = win % nwx;
  const int n = blockIdx.y;

  if (tid < kTok) {
    const int a = wy * kWin + (tid >> 3), b = wx * kWin + (tid & 7);
    const int y = (a + shift) % H, x = (b + shift) % W;
    pix[tid] = (n * H + y) * W + x;
    lab[tid] = shift ? 3 * region(a, H, shift) + region(b, W, shift) : 0;
  }
  for (int i = tid; i < kTable; i += kThreads) bias[i] = table[i * heads + head];
  __syncthreads();

  // q, k, v of the window's tokens: a warp reads one token's d contiguous
  // channels of one part (lane = channel; the lanes past d give zeros),
  // each thread a batch of independent loads before it stores them
  static_assert(kDim == 32, "a lane per channel");
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kRows = 3 * kTok / kWarps;  // (token, part) rows a warp
  constexpr int kBatch = 12;
  const int C3 = 3 * C;
  const float* src = qkv + head * d + lane;
#pragma unroll
  for (int k0 = 0; k0 < kRows; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = warp + kWarps * (k0 + k), tok = e / 3;
      v[k] = lane < d ? src[(size_t)pix[tok] * C3 + (e - 3 * tok) * C] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = warp + kWarps * (k0 + k), tok = e / 3, part = e - 3 * tok;
      if (part == 0) {
        qs[tok][lane] = v[k] * scale;
      } else if (part == 1) {
        ks[tok][lane] = v[k];
      } else {
        vs[tok][lane] = v[k];
      }
    }
  }
  __syncthreads();

  // S = q k^T + B [+ M]: thread (ty, tx) holds rows 4 ty + a and columns
  // tx + 16 b, so that the 8 lanes of a 16-byte phase read 8 rows of k
  const int ty = tid >> 4, tx = tid & 15;
  const int i0 = ty * 4;
  float s[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 2
  for (int e = 0; e < kDim; e += 4) {
    float4 qa[4], kb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = *reinterpret_cast<const float4*>(&qs[i0 + a][e]);
#pragma unroll
    for (int b = 0; b < 4; ++b) kb[b] = *reinterpret_cast<const float4*>(&ks[tx + 16 * b][e]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a].x, kb[b].x, s[a][b]);
        s[a][b] = fmaf(qa[a].y, kb[b].y, s[a][b]);
        s[a][b] = fmaf(qa[a].z, kb[b].z, s[a][b]);
        s[a][b] = fmaf(qa[a].w, kb[b].w, s[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tx + 16 * b;
      s[a][b] += bias[((i >> 3) - (j >> 3) + kWin - 1) * (2 * kWin - 1) +
                      ((i & 7) - (j & 7) + kWin - 1)];
      if (shift && lab[i] != lab[j]) s[a][b] += kMask;
    }
  }
  __syncthreads();  // every thread is done with q and k: P goes over them

  // softmax along each row: a row's 64 scores are in the 16 lanes of a
  // half-warp that share ty
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float m = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s[a][b] = expf(s[a][b] - m);
      sum += s[a][b];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int b = 0; b < 4; ++b) ps[i0 + a][tx + 16 * b] = s[a][b] / sum;
  }
  __syncthreads();

  // O = P v: 4 rows x 2 channels a thread
  const int c0 = tx * 2;
  float o[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) o[a][0] = o[a][1] = 0.f;
#pragma unroll 2
  for (int j = 0; j < kTok; j += 4) {
    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 t = *reinterpret_cast<const float4*>(&ps[i0 + a][j]);
      p[a][0] = t.x; p[a][1] = t.y; p[a][2] = t.z; p[a][3] = t.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float2 v = *reinterpret_cast<const float2*>(&vs[j + jj][c0]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        o[a][0] = fmaf(p[a][jj], v.x, o[a][0]);
        o[a][1] = fmaf(p[a][jj], v.y, o[a][1]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float* dst = out + (size_t)pix[i0 + a] * C + head * d;
    if (c0 < d) dst[c0] = o[a][0];
    if (c0 + 1 < d) dst[c0 + 1] = o[a][1];
  }
}

}  // namespace

// qkv: (N, H, W, 3C) float32, channel = part * C + head * d + i (part q, k,
// v); table: ((2 * 8 - 1)^2, heads) float32; out: (N, H, W, C) float32;
// H and W multiples of 8, d = C / heads <= 32, 0 <= shift < 8; scale =
// d^-0.5. Returns cudaGetLastError().
extern "C" int window_attn(const float* qkv, const float* table, float* out, int N, int H,
                           int W, int C, int heads, int shift, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = C / heads;
  if (H % kWin || W % kWin || d > kDim || C % heads || shift < 0 || shift >= kWin) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((H / kWin) * (W / kWin) * heads, N);
  window_attn_kernel<<<grid, kThreads, 0, s>>>(qkv, table, out, H, W, C, heads, d, shift,
                                               scale);
  return (int)cudaGetLastError();
}
