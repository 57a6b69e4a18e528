// Pieces shared by the token backward kernels (ln_matmul_bwd.cu: kernel 9,
// ln_mlp_bwd.cu: kernels 10 and 11): GELU and its derivative, the LayerNorm
// statistics of a row, the LayerNorm backward of a row block whose dXn sits
// in shared memory, and the fixed-order sum of per-block partials.
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
constexpr int kMaxC = 768;              // widest token row the kernels take
constexpr int kGroups = kMaxC / 64;     // 64-column groups of the register tile
constexpr int kSMs = 132;               // H100 SXM streaming multiprocessors

// Blocks of the persistent row-block grid of kernels 9 and 10: one per SM
// (their shared memory and registers allow one), fewer for short inputs.
inline int row_groups(int t) {
  const int blocks = (t + kBM - 1) / kBM;
  return blocks < 1 ? 1 : (blocks < kSMs ? blocks : kSMs);
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

}  // namespace tokbwd
