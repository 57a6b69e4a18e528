// Pieces shared by the token backward kernels (ln_matmul_bwd.cu: kernel 9,
// ln_mlp_bwd.cu: kernels 10 and 11): GELU and its derivative, the LayerNorm
// statistics of a row, the LayerNorm backward of a row block whose dXn sits
// in shared memory (the float32 kernels), the LayerNorm backward pass of the
// bf16 tensor-core kernels, which read dXn as f32 partials from global
// memory (ln_bwd_pass), the same pass for rows wider than kMaxC in either
// type (ln_bwd_wide), and the fixed-order sum of per-block partials.
//
// Sums over tokens (dgamma, dbeta, dW1, db1, dW2) are deterministic: each
// block owns a fixed, strided set of row blocks and keeps its own sums, a
// column (or weight element) always in the same thread and in row order;
// it writes them as one partial, and sum_partials_kernel adds the partials
// in block order. No atomics.
#pragma once

#include "common.cuh"

namespace tokbwd {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 32;                 // token rows of a row block (kernels 9, 10)
constexpr int kMaxC = 768;              // widest row of the register-tile kernels;
                                        // wider rows take the wide path (ln_bwd_wide)
constexpr int kGroups = kMaxC / 64;     // 64-column groups of the register tile
constexpr int kSMs = 132;               // H100 SXM streaming multiprocessors

// Blocks of the persistent row-block grid of kernels 9 and 10: one per SM
// (their shared memory and registers allow one), fewer for short inputs.
inline int row_groups(int t) {
  const int blocks = (t + kBM - 1) / kBM;
  return blocks < 1 ? 1 : (blocks < kSMs ? blocks : kSMs);
}

// The register tile of the float32 kernels: a block's 256 threads as 16 x
// 16 (ty, tx), thread (ty, tx) holding rows ty and ty + 16 of a 32-row
// block and columns 64 g + 4 tx + e of a chunk of up to kMaxC columns.
using RowTile = float[2][kGroups][4];

__device__ __forceinline__ void zero_tile(RowTile& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
}

// The tile as rows [row0, row0 + kBM) x columns [c0, c0 + 64 ngroups) of
// an f32 (T x C) array (the wide paths' dXn), rows past t and columns past
// C left out.
__device__ __forceinline__ void store_tile(const RowTile& acc, float* __restrict__ out, int row0,
                                           int t, int c, int c0, int ngroups) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + ty + 16 * i, col = c0 + g * 64 + tx * 4 + e;
        if (g < ngroups && row < t && col < c) out[static_cast<size_t>(row) * c + col] = acc[i][g][e];
      }
}

constexpr float kSqrtHalf = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * kSqrtHalf));
}

// d/dv gelu(v) = Phi(v) + v phi(v), exact erf.
__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.0f + erff(v * kSqrtHalf)) + v * expf(-0.5f * v * v) * kInvSqrt2Pi;
}

// flax LayerNorm statistics of one row of C values, taken by one warp:
// mean and rsqrt(max(0, E[x^2] - mean^2) + eps).
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ xr, int c, float eps,
                                          float& mu, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float v = to_f32(xr[k]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float cf = static_cast<float>(c);
  mu = s / cf;
  rstd = rsqrtf(fmaxf(0.f, ss / cf - mu * mu) + eps);
}

// x_hat = (x - mu) * rstd, and the backward's LN recompute x_hat * gamma +
// beta, each rounding step taken alone (no fused multiply-add), as the
// plain version's separate tensor operations take them.
__device__ __forceinline__ float xhat(float v, float mu, float rstd) {
  return __fmul_rn(__fsub_rn(v, mu), rstd);
}

__device__ __forceinline__ float ln_affine(float xh, float g, float b) {
  return __fadd_rn(__fmul_rn(xh, g), b);
}

// The LayerNorm backward of row block [row0, row0 + kBM) given its dXn
// (f32, row stride ld) in shared memory D and its statistics s_mu, s_r:
//   per row (one warp each): dXh = dXn * gamma,
//     dX = rstd * (dXh - mean(dXh) - x_hat * mean(dXh * x_hat)) (+ dY),
//     stored in T;
//   per column (one thread each, the same thread for every row block):
//     accg += sum over the block's rows of dXn * x_hat, accb += dXn.
// Rows at or past t are skipped. The caller synchronises before and after.
template <typename T>
__device__ void ln_backward_rows(const float* D, int ld, const T* __restrict__ x,
                                 const T* __restrict__ dy, const float* __restrict__ gamma,
                                 T* __restrict__ dx, const float* s_mu, const float* s_r,
                                 float* accg, float* accb, int row0, int t, int c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float cf = static_cast<float>(c);
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = row0 + r;
    if (row >= t) break;
    const size_t base = static_cast<size_t>(row) * c;
    const float* d = D + r * ld;
    const float mu = s_mu[r], rs = s_r[r];
    float m1 = 0.f, m2 = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float dxh = d[k] * gamma[k];
      m1 += dxh;
      m2 += dxh * xhat(to_f32(x[base + k]), mu, rs);
    }
    m1 = warp_sum(m1) / cf;
    m2 = warp_sum(m2) / cf;
    for (int k = lane; k < c; k += 32) {
      const float dxh = d[k] * gamma[k];
      const float xh = xhat(to_f32(x[base + k]), mu, rs);
      float v = rs * (dxh - m1 - xh * m2);
      if (dy != nullptr) v += to_f32(dy[base + k]);
      dx[base + k] = from_f32<T>(v);
    }
  }
  const int rows = min(kBM, t - row0);
  for (int k = tid; k < c; k += kThreads) {
    float sg = accg[k], sb = accb[k];
    for (int r = 0; r < rows; ++r) {
      const float d = D[r * ld + k];
      sg += d * xhat(to_f32(x[static_cast<size_t>(row0 + r) * c + k]), s_mu[r], s_r[r]);
      sb += d;
    }
    accg[k] = sg;
    accb[k] = sb;
  }
}

// out[i] = sum over g < groups, in order, of partial[g * n + i].
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int groups,
                    size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int g = 0; g < groups; ++g) s += partial[static_cast<size_t>(g) * n + i];
  out[i] = s;
}

inline cudaError_t sum_partials(const float* partial, float* out, int groups, size_t n,
                                cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sum_partials_kernel<<<blocks, kThreads, 0, s>>>(partial, out, groups, n);
  return cudaGetLastError();
}

// ---- the LayerNorm backward pass of the bf16 tensor-core kernels ----------
//
// Kernels 9 and 10 in bf16 write dXn (T x C) as f32 partials, one per split
// of their contraction (part[sp * T * C + row * C + k]); this pass adds them
// in split order and applies the LayerNorm backward of token_bwd's float32
// kernels with the same formulas and per-lane summation order: one warp a
// row, lane l taking columns l, l + 32, ... (EPL of them, held in
// registers: x loaded once, every load of the row in flight together), the
// row statistics again, m1 = mean(dXh), m2 = mean(dXh x_hat) by warp sums,
// dX = rstd (dXh - m1 - x_hat m2) (+ dY with the residual) in bf16. Each
// lane keeps its columns' dgamma / dbeta sums over the warp's rows (rows
// warp, warp + 8 G, ... of block b's warp: fixed by T); the block adds its
// eight warps' in warp order and writes one partial, which sum_partials adds
// in block order. Deterministic, no atomics.

constexpr int kPassBlocks = 4 * kSMs;  // most blocks of the pass

// Blocks of ln_bwd_pass_kernel: a warp a row, at most kPassBlocks.
inline int pass_groups(int t) {
  const int blocks = (t + kWarps - 1) / kWarps;
  return blocks < 1 ? 1 : (blocks < kPassBlocks ? blocks : kPassBlocks);
}

template <int EPL>
__global__ void __launch_bounds__(kThreads)
ln_bwd_pass_kernel(const float* __restrict__ part, int splits,
                   const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                   const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ partial, int t, int c, float eps, int residual) {
  extern __shared__ __align__(16) float red[];  // kWarps x 2C: each warp's sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float cf = static_cast<float>(c);
  const size_t n = static_cast<size_t>(t) * c;
  float g[EPL], accg[EPL], accb[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int k = lane + 32 * i;
    g[i] = k < c ? gamma[k] : 0.f;
    accg[i] = accb[i] = 0.f;
  }
  for (int row = blockIdx.x * kWarps + warp; row < t; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * c;
    float xh[EPL], d[EPL];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int k = lane + 32 * i;
      xh[i] = k < c ? to_f32(x[base + k]) : 0.f;
      d[i] = 0.f;
    }
    for (int sp = 0; sp < splits; ++sp) {
      const float* p = part + sp * n + base;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int k = lane + 32 * i;
        if (k < c) d[i] += p[k];
      }
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      if (lane + 32 * i < c) {
        s += xh[i];
        ss += xh[i] * xh[i];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / cf;
    const float rs = rsqrtf(fmaxf(0.f, ss / cf - mu * mu) + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      if (lane + 32 * i < c) {
        xh[i] = xhat(xh[i], mu, rs);
        const float dxh = d[i] * g[i];
        m1 += dxh;
        m2 += dxh * xh[i];
      }
    }
    m1 = warp_sum(m1) / cf;
    m2 = warp_sum(m2) / cf;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int k = lane + 32 * i;
      if (k < c) {
        float v = rs * (d[i] * g[i] - m1 - xh[i] * m2);
        if (residual) v += to_f32(dy[base + k]);
        dx[base + k] = __float2bfloat16_rn(v);
        accg[i] += d[i] * xh[i];
        accb[i] += d[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int k = lane + 32 * i;
    if (k < c) {
      red[warp * 2 * c + k] = accg[i];
      red[warp * 2 * c + c + k] = accb[i];
    }
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * c;
  for (int k = threadIdx.x; k < 2 * c; k += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * 2 * c + k];
    out[k] = v;
  }
}

// The pass over dXn's `splits` partials (f32, T x C each), then the sum of
// its block partials (pass_groups(t) x 2C f32) into dgb = [dgamma | dbeta].
inline cudaError_t ln_bwd_pass(const float* part, int splits, const void* x, const float* gamma,
                               const void* dy, void* dx, float* partial, float* dgb, int t,
                               int c, float eps, int residual, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using Pass = void (*)(const float*, int, const bf16*, const float*, const bf16*, bf16*, float*,
                        int, int, float, int);
  const int epl = (c + 31) / 32;
  const Pass kernel = epl <= 4    ? ln_bwd_pass_kernel<4>
                      : epl <= 8  ? ln_bwd_pass_kernel<8>
                      : epl <= 12 ? ln_bwd_pass_kernel<12>
                      : epl <= 16 ? ln_bwd_pass_kernel<16>
                                  : ln_bwd_pass_kernel<kMaxC / 32>;
  const int smem = static_cast<int>(sizeof(float) * kWarps * 2 * c);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int groups = pass_groups(t);
  kernel<<<groups, kThreads, smem, s>>>(part, splits, static_cast<const bf16*>(x), gamma,
                                        static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
                                        partial, t, c, eps, residual);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(partial, dgb, groups, 2 * static_cast<size_t>(c), s);
}

// ---- the LayerNorm backward of rows wider than kMaxC ------------------------
//
// Past kMaxC (swin_base's stage 4, C = 1024, and swin_large's, 1536) no
// kernel keeps a row in registers or a row block in shared memory: dXn
// arrives, in either type, as f32 partials over splits in global memory, as
// for ln_bwd_pass, and two kernels hold no per-column state but a loop
// index, so any width that fits the card's memory passes:
// - ln_bwd_wide_rows_kernel: one block a row (the wide rows belong to the
//   last stages, whose few tokens would leave a warp a row latency-bound),
//   thread i taking columns i, i + 256, ... in turn: the row statistics,
//   m1 = mean(dXh), m2 = mean(dXh x_hat) (block_sum2), then dX = rstd
//   (dXh - m1 - x_hat m2) (+ dY), each column's dXn the sum of its
//   partials in split order, as ln_bwd_pass adds them; it writes the row's
//   (mean, rstd);
// - ln_bwd_wide_cols_kernel: one thread a column over a fixed run of rows,
//   in row order: dgamma += dXn x_hat, dbeta += dXn, one partial per run,
//   which sum_partials adds in run order.
// Deterministic, no atomics.

// Rows a column thread sums: enough runs for about four blocks an SM.
inline int wide_rows_per(int t, int c) {
  const int col_blocks = (c + kThreads - 1) / kThreads;
  int runs = 4 * kSMs / col_blocks;
  runs = runs < 1 ? 1 : (runs > t ? t : runs);
  return (t + runs - 1) / runs;
}

// Partials of ln_bwd_wide (rows of 2C f32): one per run of rows.
inline int wide_groups(int t, int c) {
  if (t < 1) return 1;
  const int per = wide_rows_per(t, c);
  return (t + per - 1) / per;
}

__device__ __forceinline__ float split_sum(const float* __restrict__ part, int splits, size_t n,
                                           size_t i) {
  float d = 0.f;
  for (int sp = 0; sp < splits; ++sp) d += part[sp * n + i];
  return d;
}

// Sums a and b over the block's threads: each warp's by shuffles, then the
// eight warps' in warp order; every thread gets both.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // the last call's reads of red are done
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = b = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[w];
    b += red[kWarps + w];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_wide_rows_kernel(const float* __restrict__ part, int splits, const T* __restrict__ x,
                        const float* __restrict__ gamma, const T* __restrict__ dy,
                        T* __restrict__ dx, float2* __restrict__ stats, int t, int c, float eps,
                        int residual) {
  __shared__ float red[2 * kWarps];
  const int tid = threadIdx.x, row = blockIdx.x;
  const float cf = static_cast<float>(c);
  const size_t n = static_cast<size_t>(t) * c, base = static_cast<size_t>(row) * c;
  float s = 0.f, ss = 0.f;
  for (int k = tid; k < c; k += kThreads) {
    const float v = to_f32(x[base + k]);
    s += v;
    ss += v * v;
  }
  block_sum2(s, ss, red);
  const float mu = s / cf;
  const float rs = rsqrtf(fmaxf(0.f, ss / cf - mu * mu) + eps);
  float m1 = 0.f, m2 = 0.f;
  for (int k = tid; k < c; k += kThreads) {
    const float dxh = split_sum(part, splits, n, base + k) * gamma[k];
    m1 += dxh;
    m2 += dxh * xhat(to_f32(x[base + k]), mu, rs);
  }
  block_sum2(m1, m2, red);
  m1 /= cf;
  m2 /= cf;
  for (int k = tid; k < c; k += kThreads) {
    const float xh = xhat(to_f32(x[base + k]), mu, rs);
    float v = rs * (split_sum(part, splits, n, base + k) * gamma[k] - m1 - xh * m2);
    if (residual) v += to_f32(dy[base + k]);
    dx[base + k] = from_f32<T>(v);
  }
  if (tid == 0) stats[row] = make_float2(mu, rs);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_wide_cols_kernel(const float* __restrict__ part, int splits, const T* __restrict__ x,
                        const float2* __restrict__ stats, float* __restrict__ partial, int t,
                        int c, int rows_per) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= c) return;
  const size_t n = static_cast<size_t>(t) * c;
  const int r0 = blockIdx.y * rows_per, r1 = min(t, r0 + rows_per);
  float sg = 0.f, sb = 0.f;
  for (int row = r0; row < r1; ++row) {
    const size_t i = static_cast<size_t>(row) * c + k;
    const float d = split_sum(part, splits, n, i);
    const float2 st = stats[row];
    sg += d * xhat(to_f32(x[i]), st.x, st.y);
    sb += d;
  }
  float* out = partial + static_cast<size_t>(blockIdx.y) * 2 * c;
  out[k] = sg;
  out[c + k] = sb;
}

// The wide pass over dXn's `splits` partials (f32, T x C each); stats is a
// workspace of T float2, partial wide_groups(t, c) x 2C f32, dgb receives
// [dgamma | dbeta].
template <typename T>
inline cudaError_t ln_bwd_wide(const float* part, int splits, const void* x, const float* gamma,
                               const void* dy, void* dx, float2* stats, float* partial,
                               float* dgb, int t, int c, float eps, int residual,
                               cudaStream_t s) {
  ln_bwd_wide_rows_kernel<T><<<t, kThreads, 0, s>>>(
      part, splits, static_cast<const T*>(x), gamma, static_cast<const T*>(dy),
      static_cast<T*>(dx), stats, t, c, eps, residual);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per = wide_rows_per(t, c), groups = wide_groups(t, c);
  const dim3 grid((c + kThreads - 1) / kThreads, groups);
  ln_bwd_wide_cols_kernel<T><<<grid, kThreads, 0, s>>>(part, splits, static_cast<const T*>(x),
                                                       stats, partial, t, c, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(partial, dgb, groups, 2 * static_cast<size_t>(c), s);
}

inline size_t stats_bytes(int t) { return (static_cast<size_t>(t) * sizeof(float2) + 255) / 256 * 256; }

}  // namespace tokbwd
