// Windowed multi-head attention of a HAT layer, fp32, in token order, tiled
// over the keys with an online softmax. Two cases, one kernel:
//
// (a) self-attention (Swin's W-MSA, HAT's HAB): out = the heads' softmax(q
//     k^T * scale + B [+ M]) v over ws x ws windows of the grid rolled by
//     -shift, put back and rolled by +shift; B from the ((2 ws - 1)^2,
//     heads) table as Swin's relative_position_index reads it, M = -100
//     between the regions that the roll brings together (calculate_mask's 9);
// (b) overlapping cross-attention (HAT's OCAB): each ws x ws query window
//     (no roll) attends to the ow x ow key window centred on it, ow = ws +
//     2 pad, read from the same qkv grid: positions outside the grid are
//     zero keys and values that stay in the softmax (their score is the bias
//     alone), as the published nn.Unfold(ow, stride ws, padding pad) gives;
//     B from the ((ws + ow - 1)^2, heads) table indexed by the key's offset
//     from its query, (dy + ws - 1 + pad) (ws + ow - 1) + dx + ws - 1 + pad.
//
// Replaces no TPU kernel: the JAX package has no attention. It serves the
// port's HAT generator (models/hat.py; ops/window_attn.py holds the plain
// versions and the published semantics): one launch per HAB (case a, window
// 16) and per OCAB (case b, 16 x 16 queries onto 24 x 24 keys). SwinIR's
// 8 x 8 windows stay on csrc/window_attn.cu, which holds a whole window in
// shared memory; at window 16 a window's q, k and v are 96 KB and its scores
// 256 KB a head, so this kernel tiles.
//
// What bounds it on an H100: per window and head two (ws^2 x ow^2 x d)
// products (d = 30 at HAT: 3.9 MFLOP for case a, 8.8 for case b) against
// (ws^2 + 2 ow^2) d floats read, so at (2, 288, 288, 180) ~30.6 GFLOP a call
// of case a and ~68.8 of case b against ~0.36 GB of qkv read: the products
// bound it, 0.46 / 1.03 ms at fp32 on the CUDA cores (67 TFLOP/s). The qkv
// and proj linears around it are ~2.8x (a) and ~1.3x (b) its operations;
// the benchmark reads its shares over the whole layers (swin.msa, hat.oca).
//
// Design: one 256-thread block per (window, head, tile of 128 queries), the
// query tiles and heads of a window on neighbouring blocks so that they
// share the window's qkv rows in L2.
// - Indexing only: query (r, c) of window (wy, wx) is grid pixel ((ws wy + r
//   + shift) % H, (ws wx + c + shift) % W); key (ky, kx) of case b is (ws wy
//   - pad + ky, ws wx - pad + kx), or none. No roll, no partition, no unfold
//   copy. The keys' pixels, bias rows and region labels are tabled in
//   shared memory once a block; the bias row of a pair is the key's part
//   plus the query's. The head's column of the bias table is staged in
//   shared memory (reversed for case a, so that both cases index it by the
//   key's offset from the query).
// - q (times scale, rounded as the plain version's q * scale) stays in
//   shared memory for the block; keys and values come in chunks of 64
//   tokens ([token][channel], pitch 36, a warp reading one token's
//   contiguous d channels of one part, 16 independent loads a thread in
//   flight); the head width is padded to 32 with zeros in shared memory.
// - S = q k^T of a chunk: each thread 8 rows x 4 columns (columns 16 apart,
//   so that the 16-byte reads of k are free of bank conflicts), fp32 FMA;
//   then the bias and the mask.
// - Online softmax in fp32 (expf): a row's 64 scores of the chunk sit in the
//   16 lanes of a half-warp; its running max and sum stay in registers;
//   the chunk's probabilities go to shared memory, each row's rescale
//   factor beside them.
// - O += P v: each thread 4 rows x 4 channels (another mapping than S's, so
//   that both products read 8 floats of shared memory per 8 FMAs or fewer),
//   rescaled by its rows' factors first; divided by the rows' sums at the
//   end, the padded channels not stored.
// Both products are fp32 on the CUDA cores, not TF32: the configuration
// states fp32, and a TF32 pass would fail the benchmark's check.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kDim = 32;                // head width, padded
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 128;                 // queries a block
constexpr int kK = 64;                  // keys a chunk
constexpr int kPitch = kDim + 4;        // q, k, v row pitch (floats)
constexpr int kPPitch = kK + 4;         // P's row pitch (floats)
constexpr int kMaxKeys = 1024;          // key window tokens (ow <= 32)
constexpr int kMaxTable = 4096;         // bias rows (ws + ow - 1 <= 64)
constexpr float kMask = -100.f;

// dynamic shared memory, in floats: q, one chunk of k and v, P, the rows'
// rescale factors and sums, then the bias column
constexpr int kSmemFixed = kQ * kPitch + 2 * kK * kPitch + kQ * kPPitch + 2 * kQ;

struct Args {
  const float* qkv;
  const float* table;
  float* out;
  int H, W, C, heads, d, ws, ow, pad, shift, cross, T;
  float scale;
};

// the region of a coordinate of the rolled grid of size n: calculate_mask's
// slices (0, -ws), (-ws, -shift), (-shift, None)
__device__ __forceinline__ int region(int a, int n, int ws, int shift) {
  return a < n - ws ? 0 : (a < n - shift ? 1 : 2);
}

__global__ void __launch_bounds__(kThreads, 2)
window_attn_tiled_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  float (*qs)[kPitch] = reinterpret_cast<float (*)[kPitch]>(smem);
  float (*ks)[kPitch] = reinterpret_cast<float (*)[kPitch]>(smem + kQ * kPitch);
  float (*vs)[kPitch] = reinterpret_cast<float (*)[kPitch]>(smem + (kQ + kK) * kPitch);
  float (*ps)[kPPitch] =
      reinterpret_cast<float (*)[kPPitch]>(smem + (kQ + 2 * kK) * kPitch);
  float* alpha_s = smem + (kQ + 2 * kK) * kPitch + kQ * kPPitch;
  float* sum_s = alpha_s + kQ;
  float* bias = sum_s + kQ;
  __shared__ int kpix[kMaxKeys];
  __shared__ int kkey[kMaxKeys];
  __shared__ signed char klab[kMaxKeys];
  __shared__ int qpix[kQ];
  __shared__ int qkey[kQ];
  __shared__ int qlab[kQ];

  const int tid = threadIdx.x;
  const int qtiles = p.ws * p.ws / kQ;
  const int qt = blockIdx.x % qtiles;
  const int head = (blockIdx.x / qtiles) % p.heads;
  const int win = blockIdx.x / (qtiles * p.heads);
  const int nwx = p.W / p.ws;
  const int wy = win / nwx, wx = win % nwx;
  const int n = blockIdx.y;
  const int side = p.ws + p.ow - 1;
  const bool masked = !p.cross && p.shift;

  // the queries' and keys' pixels, bias parts and region labels
  for (int i = tid; i < kQ; i += kThreads) {
    const int t = qt * kQ + i, r = t / p.ws, c = t - r * p.ws;
    const int a = wy * p.ws + r, b = wx * p.ws + c;
    qpix[i] = (n * p.H + (a + p.shift) % p.H) * p.W + (b + p.shift) % p.W;
    qkey[i] = (p.ws - 1 - r) * side + (p.ws - 1 - c);
    qlab[i] = masked ? 3 * region(a, p.H, p.ws, p.shift) + region(b, p.W, p.ws, p.shift) : 0;
  }
  const int nkeys = p.ow * p.ow;
  for (int j = tid; j < nkeys; j += kThreads) {
    const int ky = j / p.ow, kx = j - ky * p.ow;
    kkey[j] = ky * side + kx;
    if (p.cross) {
      const int y = wy * p.ws - p.pad + ky, x = wx * p.ws - p.pad + kx;
      kpix[j] = (y >= 0 && y < p.H && x >= 0 && x < p.W) ? (n * p.H + y) * p.W + x : -1;
      klab[j] = 0;
    } else {
      const int a = wy * p.ws + ky, b = wx * p.ws + kx;
      kpix[j] = (n * p.H + (a + p.shift) % p.H) * p.W + (b + p.shift) % p.W;
      klab[j] = masked ? 3 * region(a, p.H, p.ws, p.shift) + region(b, p.W, p.ws, p.shift)
                       : 0;
    }
  }
  for (int i = tid; i < p.T; i += kThreads) {
    bias[i] = p.table[(p.cross ? i : p.T - 1 - i) * p.heads + head];
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int C3 = 3 * p.C;
  const float* src = p.qkv + head * p.d + lane;
  const bool live = lane < p.d;

  // q of the tile: a warp reads one token's d contiguous channels (lane =
  // channel; the lanes past d give zeros)
  {
    constexpr int kRows = kQ / kWarps;
    float v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      v[k] = live ? src[(size_t)qpix[warp + kWarps * k] * C3] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) qs[warp + kWarps * k][lane] = v[k] * p.scale;
  }

  // S's mapping: rows 8 ty + a, columns tx + 16 b; O's: rows 4 oy + a,
  // channels 4 ox + c
  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * 8;
  const int oy = tid >> 3, ox = tid & 7;
  float m[8], l[8], o[4][4];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.f;

  for (int k0 = 0; k0 < nkeys; k0 += kK) {
    __syncthreads();  // the last chunk's P v is done with k, v and P
    {
      // k and v of the chunk's 64 keys: rows (key, part) of 2 x 64
      constexpr int kRows = 2 * kK / kWarps;
      float v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int e = warp + kWarps * k, key = e >> 1;
        const int pix = kpix[k0 + key];
        v[k] = live && pix >= 0 ? src[(size_t)pix * C3 + (1 + (e & 1)) * p.C] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int e = warp + kWarps * k, key = e >> 1;
        if (e & 1) {
          vs[key][lane] = v[k];
        } else {
          ks[key][lane] = v[k];
        }
      }
    }
    __syncthreads();

    // S = q k^T
    float s[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 2
    for (int e = 0; e < kDim; e += 4) {
      float4 kb[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = *reinterpret_cast<const float4*>(&ks[tx + 16 * b][e]);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float4 qa = *reinterpret_cast<const float4*>(&qs[r0 + a][e]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qa.x, kb[b].x, s[a][b]);
          s[a][b] = fmaf(qa.y, kb[b].y, s[a][b]);
          s[a][b] = fmaf(qa.z, kb[b].z, s[a][b]);
          s[a][b] = fmaf(qa.w, kb[b].w, s[a][b]);
        }
      }
    }

    // + B [+ M]; the online softmax's update of each row
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = r0 + a;
      const int qk = qkey[i], ql = qlab[i];
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = k0 + tx + 16 * b;
        s[a][b] += bias[kkey[j] + qk];
        if (masked && ql != klab[j]) s[a][b] += kMask;
        mx = fmaxf(mx, s[a][b]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float mnew = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float e = expf(s[a][b] - mnew);
        ps[i][tx + 16 * b] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[a] = l[a] * alpha + sum;
      m[a] = mnew;
      if (tx == 0) alpha_s[i] = alpha;
    }
    __syncthreads();

    // O = O * alpha + P v
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float al = alpha_s[4 * oy + a];
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][c] *= al;
    }
#pragma unroll 2
    for (int j = 0; j < kK; j += 4) {
      float4 v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) v[jj] = *reinterpret_cast<const float4*>(&vs[j + jj][4 * ox]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 pa = *reinterpret_cast<const float4*>(&ps[4 * oy + a][j]);
        const float pj[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          o[a][0] = fmaf(pj[jj], v[jj].x, o[a][0]);
          o[a][1] = fmaf(pj[jj], v[jj].y, o[a][1]);
          o[a][2] = fmaf(pj[jj], v[jj].z, o[a][2]);
          o[a][3] = fmaf(pj[jj], v[jj].w, o[a][3]);
        }
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 8; ++a) sum_s[r0 + a] = l[a];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = 4 * oy + a;
    const float sum = sum_s[i];
    float* dst = p.out + (size_t)qpix[i] * p.C + head * p.d;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (4 * ox + c < p.d) dst[4 * ox + c] = o[a][c] / sum;
    }
  }
}

}  // namespace

// qkv: (N, H, W, 3C) float32, channel = part * C + head * d + i (part q, k,
// v); out: (N, H, W, C) float32. window: ws, with ws^2 a multiple of 128 and
// H, W multiples of ws; d = C / heads <= 32; scale = d^-0.5.
// cross 0 (case a): key_window == ws, 0 <= shift < ws, table ((2 ws - 1)^2,
// heads). cross 1 (case b): key_window ow = ws + 2 pad >= ws, ow^2 a multiple
// of 64 and at most 1024, shift 0, table ((ws + ow - 1)^2, heads).
// Returns cudaGetLastError().
extern "C" int window_attn_tiled(const float* qkv, const float* table, float* out, int N,
                                 int H, int W, int C, int heads, int window, int key_window,
                                 int shift, int cross, float scale, void* stream) {
  Args p;
  p.qkv = qkv;
  p.table = table;
  p.out = out;
  p.H = H;
  p.W = W;
  p.C = C;
  p.heads = heads;
  p.ws = window;
  p.ow = key_window;
  p.pad = (key_window - window) / 2;
  p.shift = shift;
  p.cross = cross ? 1 : 0;
  p.scale = scale;
  const int side = window + key_window - 1;
  p.T = side * side;
  p.d = heads > 0 ? C / heads : 0;
  const bool ok = heads > 0 && C % heads == 0 && p.d <= kDim && window > 0 &&
                  (window * window) % kQ == 0 && H % window == 0 && W % window == 0 &&
                  (key_window * key_window) % kK == 0 &&
                  key_window * key_window <= kMaxKeys && p.T <= kMaxTable &&
                  (cross ? (key_window >= window && (key_window - window) % 2 == 0 &&
                            shift == 0)
                         : (key_window == window && shift >= 0 && shift < window));
  if (!ok) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kSmemFixed + p.T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H / window) * (W / window) * heads * (window * window / kQ), N);
  window_attn_tiled_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
