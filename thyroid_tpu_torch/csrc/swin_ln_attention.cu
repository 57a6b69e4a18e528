// LayerNorm + QKV projection + shifted-window attention from the raw stream.
//
// tt_swin_ln_attention replaces the TPU kernel thyroid_tpu/ops/attention.py
// _swin_ln_kernel (pallas_call in fused_swin_ln_attention), the serving
// path of WindowAttention(ln_kernel=True).
//
// What it computes, for x (B, H, W, C) in the compute type (the residual
// stream, already rolled if the block is shifted), for every ws x ws
// window and its tokens t:
//   xn = ((x - mu) * rsqrt(max(0, E[x^2] - mu^2) + eps)) * gamma + beta
//        in f32, rounded to the compute type;
//   q, k, v = xn W (W (C, 3C) in the compute type, f32 accumulation)
//             + the f32 QKV bias; q *= scale in f32;
// then per head, in f32, S = q k^T + bias[head] (+ mask[window]),
// P = softmax(S), O = P v, stored in the compute type at the window's own
// positions of the (B, H, W, C) output (before the out-projection).
// Window partition and reverse are index arithmetic, never a copy.
//
// Bound on the H100: per window 2*N*C*3C operations for the projection and
// 4*N^2*C for attention (about 75 GFLOP over swin_tiny's 12 blocks at batch
// 32, about 0.08 ms at the bf16 tensor-core peak), on 2*N*C elements moved
// plus the weight; the projection's operations bound it. Design (simple
// first): one block of 256 threads per window and group of heads (all the
// heads where the windows fill the card, fewer in the late stages; see
// heads_per_block). A warp per token computes
// the LayerNorm and stores xn (N x C, the compute type) in shared memory:
// 150 KB at C = 768 in f32, 75 KB in bf16. The (C, 3C) weight does not fit
// beside it, so per head its q, k, v columns (3*dh) stream through shared
// memory in 32 x 128 tiles into register accumulators (rows ty + 8*i,
// columns tx + 32*j of the tile); the epilogue adds the bias and the scale
// into the f32 Qs, Ks, Vs of swin_window.cuh's core, whose scores, softmax
// and P v follow. Scalar f32 FMAs; tensor-core tiles, and a block that
// keeps the weight tile for several windows, are later work. In f32 a C
// above about 900 does not fit in shared memory, and the launch is refused.
#include "swin_window.cuh"

namespace {

using swin::kThreads;
using swin::kWarps;
constexpr int kCols = 128;  // projection column tile (local q|k|v columns of one head)
constexpr int kBK = 32;     // projection K chunk

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

template <typename T>
size_t smem_bytes(int n, int c, int dh) {
  return align16(sizeof(T) * static_cast<size_t>(n) * c) +
         sizeof(float) * (static_cast<size_t>(kBK) * kCols + 2 * static_cast<size_t>(n) * (dh + 1) +
                          static_cast<size_t>(n) * dh + static_cast<size_t>(n) * (n + 1));
}

// Heads per block: all of them where the windows alone give at least two
// blocks per SM; else the most that still do, so that the late stages'
// few windows (32 at swin_tiny's last stage and batch 32) fill the card.
// Each block of a window recomputes its LayerNorm, a small share of the
// projection's work.
int heads_per_block(int windows, int heads) {
  constexpr int kEnough = 2 * 132;
  for (int hpb = heads; hpb > 1; --hpb) {
    if (static_cast<long long>(windows) * ((heads + hpb - 1) / hpb) >= kEnough) return hpb;
  }
  return 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swin_ln_attention_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const T* __restrict__ w,
                         const float* __restrict__ bqkv, const float* __restrict__ bias,
                         const float* __restrict__ mask, T* __restrict__ out, int hh, int ww,
                         int c, int heads, int hpb, int ws, float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ws * ws, dh = c / heads, cols = 3 * dh;
  const swin::Window win = swin::window_of(blockIdx.x, hh, ww, ws);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  T* Xn = reinterpret_cast<T*>(smem_raw);  // n x c, the compute type
  float* Ws = reinterpret_cast<float*>(smem_raw + align16(sizeof(T) * static_cast<size_t>(n) * c));
  float* Qs = Ws + kBK * kCols;    // n x (dh + 1)
  float* Ks = Qs + n * (dh + 1);   // n x (dh + 1)
  float* Vs = Ks + n * (dh + 1);   // n x dh
  float* Ss = Vs + n * dh;         // n x (n + 1)

  // LayerNorm, a warp per token, statistics in f32
  for (int t = warp; t < n; t += kWarps) {
    const T* xr = x + win.token(t) * c;
    float s = 0.f, s2 = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float v = to_f32(xr[j]);
      s += v;
      s2 = fmaf(v, v, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / c;
    const float rs = rsqrtf(fmaxf(0.f, s2 / c - mu * mu) + eps);
    for (int j = lane; j < c; j += 32) {
      Xn[t * c + j] = from_f32<T>((to_f32(xr[j]) - mu) * rs * gamma[j] + beta[j]);
    }
  }
  __syncthreads();

  const int ty = tid / 32, tx = tid % 32;
  const int h_begin = static_cast<int>(blockIdx.y) * hpb;
  const int h_end = min(heads, h_begin + hpb);
  for (int h = h_begin; h < h_end; ++h) {
    // q, k, v of head h: local column lc of 3*dh is global column
    // (lc / dh) * c + h * dh + lc % dh of W
    for (int cb = 0; cb < cols; cb += kCols) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < c; k0 += kBK) {
        for (int i = tid; i < kBK * kCols; i += kThreads) {
          const int kk = i / kCols, lc = cb + i % kCols, k = k0 + kk;
          Ws[i] = (k < c && lc < cols)
                      ? to_f32(w[static_cast<size_t>(k) * 3 * c + (lc / dh) * c + h * dh + lc % dh])
                      : 0.f;
        }
        __syncthreads();
        const int kmax = min(kBK, c - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Ws[kk * kCols + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = ty + 8 * i;
            if (r < n) {
              const float a = to_f32(Xn[r * c + k0 + kk]);
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 8 * i;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lc = cb + tx + 32 * j;
          if (lc >= cols) continue;
          const int part = lc / dh, d = lc % dh;
          const float y = acc[i][j] + (bqkv != nullptr ? bqkv[part * c + h * dh + d] : 0.f);
          if (part == 0) {
            Qs[r * (dh + 1) + d] = y * scale;
          } else if (part == 1) {
            Ks[r * (dh + 1) + d] = y;
          } else {
            Vs[r * dh + d] = y;
          }
        }
      }
    }
    __syncthreads();
    swin::scores_softmax(bias + static_cast<size_t>(h) * n * n,
                         mask != nullptr ? mask + static_cast<size_t>(win.wi) * n * n : nullptr,
                         n, dh, Qs, Ks, Ss);
    swin::head_pv(Ss, Vs, dh, n, dh, [&](int r, int d, float o) {
      out[win.token(r) * c + h * dh + d] = from_f32<T>(o);
    });
  }
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, const void* w,
           const float* bqkv, const float* bias, const float* mask, void* out, int b, int hh,
           int ww, int c, int heads, int ws, float scale, float eps, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  const size_t smem = smem_bytes<T>(n, c, dh);
  cudaError_t err = cudaFuncSetAttribute(swin_ln_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = b * (hh / ws) * (ww / ws);
  const int hpb = heads_per_block(windows, heads);
  const dim3 grid(windows, (heads + hpb - 1) / hpb);
  swin_ln_attention_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w), bqkv, bias, mask,
      static_cast<T*>(out), hh, ww, c, heads, hpb, ws, scale, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (b, hh, ww, c) in the compute type; gamma, beta (c,) f32; w (c, 3c)
// in the compute type; bqkv (3c,) f32 or null; bias (heads, n, n) f32; mask
// (nW, n, n) f32 or null.
TT_EXPORT int tt_swin_ln_attention(const void* x, const void* gamma, const void* beta,
                                   const void* w, const void* bqkv, const void* bias,
                                   const void* mask, void* out, int b, int hh, int ww, int c,
                                   int heads, int ws, float scale, float eps, int is_bf16,
                                   void* stream) {
  const float* fg = static_cast<const float*>(gamma);
  const float* fb = static_cast<const float*>(beta);
  const float* fq = static_cast<const float*>(bqkv);
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, fg, fb, w, fq, fbias, fmask, out, b, hh, ww, c,
                                         heads, ws, scale, eps, s)
                 : launch<float>(x, fg, fb, w, fq, fbias, fmask, out, b, hh, ww, c, heads, ws,
                                 scale, eps, s);
}
