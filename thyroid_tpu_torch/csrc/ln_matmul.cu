// fused_ln_matmul: y = LayerNorm(x) @ W + b on token rows.
//
// Replaces the TPU kernel thyroid_tpu/ops/token_fused.py _ln_matmul_kernel
// (pallas_call in _ln_matmul_fwd_call, public wrapper fused_ln_matmul):
// Swin's norm1 + QKV projection and PatchMerging's norm + reduction.
//
// What it computes, for x (T, C) and W (C, O) in the compute type (f32 or
// bf16): per row, flax LayerNorm numerics in f32 (mean and E[x^2] - mu^2
// clamped at 0, mul = rsqrt(var + eps) * gamma, (x - mu) * mul + beta), the
// normalised row rounded to the compute type, the product with f32
// accumulation, + b in f32, and the result stored in the compute type.
//
// Bound on the H100: at the Swin shapes the product does 2*C*O operations
// per row for (C + O) elements moved, far above the card's ~295 bf16
// operations per byte, so it is bound by operations. Design (simple first):
// a 64 x 64 output tile per block of 256 threads, each thread a 4 x 4
// register tile of scalar f32 FMAs; the block first computes the LN
// statistics of its 64 rows (a warp per row), then streams K in chunks of
// 16, normalising the x chunk on its way into shared memory so the
// normalised tensor never exists in global memory. Tensor-core (wgmma)
// tiles are later work.
#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;
constexpr int kLdA = kBM + 4;  // padded row of the transposed A tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_matmul_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ w,
                 const float* __restrict__ wb, T* __restrict__ y, int t, int c, int o,
                 float eps) {
  __shared__ float s_mu[kBM], s_rstd[kBM];
  __shared__ __align__(16) float As[kBK][kLdA];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const float cf = static_cast<float>(c);

  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = row0 + r;
    float s = 0.f, ss = 0.f;
    if (row < t) {
      const T* xr = x + static_cast<size_t>(row) * c;
      for (int k = lane; k < c; k += 32) {
        const float v = to_f32(xr[k]);
        s += v;
        ss += v * v;
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      const float mu = s / cf;
      const float var = fmaxf(0.f, ss / cf - mu * mu);
      s_mu[r] = mu;
      s_rstd[r] = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < c; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int row = row0 + r, k = k0 + kk;
      float v = 0.f;
      if (row < t && k < c) {
        const float mul = s_rstd[r] * gamma[k];
        v = round_to<T>((to_f32(x[static_cast<size_t>(row) * c + k]) - s_mu[r]) * mul + beta[k]);
      }
      As[kk][r] = v;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, nn = i % kBN;
      const int k = k0 + kk, col = col0 + nn;
      Bs[kk][nn] = (k < c && col < o) ? to_f32(w[static_cast<size_t>(k) * o + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < o) {
        const float v = acc[i][j] + (wb != nullptr ? wb[col] : 0.f);
        y[static_cast<size_t>(row) * o + col] = from_f32<T>(v);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* g, const float* b, const void* w, const float* wb,
           void* y, int t, int c, int o, float eps, cudaStream_t s) {
  const dim3 grid((t + kBM - 1) / kBM, (o + kBN - 1) / kBN);
  ln_matmul_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), g, b,
                                                static_cast<const T*>(w), wb,
                                                static_cast<T*>(y), t, c, o, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wb may be null (PatchMerging's reduction has no bias).
TT_EXPORT int tt_ln_matmul(const void* x, const void* gamma, const void* beta, const void* w,
                           const void* wb, void* y, int t, int c, int o, float eps,
                           int is_bf16, void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* bias = static_cast<const float*>(wb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, g, b, w, bias, y, t, c, o, eps, s)
                 : launch<float>(x, g, b, w, bias, y, t, c, o, eps, s);
}
