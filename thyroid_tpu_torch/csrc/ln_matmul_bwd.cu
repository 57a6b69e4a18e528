// fused_ln_matmul backward: dX, dgamma, dbeta of y = LayerNorm(x) @ W + b.
//
// Replaces the TPU kernel thyroid_tpu/ops/token_fused.py
// _ln_matmul_bwd_kernel (pallas_call in _ln_matmul_bwd_call, the custom_vjp
// backward of fused_ln_matmul): Swin's norm1 + QKV projection in training
// with train_token_kernels. dW = LN(x)^T dY and db = sum dY stay outside,
// as the JAX package leaves them to XLA.
//
// What it computes, for x (T, C), W (C, O) and dY (T, O) in the compute type
// (f32 or bf16), gamma f32: per row, the LN statistics again (flax's fast
// variance, f32), x_hat = (x - mu) * rstd, dXn = dY W^T with f32
// accumulation, and
//   dX = rstd * (dXh - mean(dXh) - x_hat * mean(dXh * x_hat)), dXh = dXn gamma,
// stored in the compute type; dgamma = sum over rows of dXn * x_hat and
// dbeta = sum of dXn, in f32, deterministic (token_bwd.cuh).
//
// Bound on the H100: 2*C*O operations per row for 2*C + O elements moved;
// at Swin's O = 3C and bf16 that is 0.6*C operations per byte, under the
// card's ~295 up to C = 384 (bound by bytes) and above it at C = 768 (bound
// by operations). Design (simple first): a persistent grid of
// one 256-thread block per SM walks row blocks of 32 rows; per row block the
// block streams O in chunks of 16, dY rows and W^T through shared memory,
// into a 32 x C register tile (2 rows x 48 columns a thread, as the LN+MLP
// forward); the tile goes to shared memory, where one warp per row applies
// the LN backward and one thread per column adds its dgamma/dbeta terms.
// The normalised tensor never exists in global memory. Scalar f32 FMAs;
// tensor-core tiles are later work. Takes C up to 768.
#include "token_bwd.cuh"

namespace {

using namespace tokbwd;

constexpr int kBK = 16;  // chunk of the contraction over O

__host__ __device__ inline int ncol_pad(int c) { return (c + 63) / 64 * 64; }

size_t smem_bytes(int c) {
  const int ldw = ncol_pad(c) + 4;
  return sizeof(float) * (static_cast<size_t>(kBK) * ldw + static_cast<size_t>(kBM) * (c + 4) +
                          kBM * (kBK + 1) + 2 * static_cast<size_t>(c) + 2 * kBM);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ln_matmul_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const T* __restrict__ w, const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ partial, int t, int c, int o, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncol = ncol_pad(c), ldw = ncol + 4, ngroups = ncol / 64, ld = c + 4;
  float* Ws = smem;                // kBK x ldw      W[:, o0:o0 + kBK]^T
  float* D = Ws + kBK * ldw;       // kBM x ld       dXn
  float* Ys = D + kBM * ld;        // kBM x (kBK+1)  dY[:, o0:o0 + kBK]
  float* accg = Ys + kBM * (kBK + 1);
  float* accb = accg + c;
  float* s_mu = accb + c;
  float* s_r = s_mu + kBM;
  for (int k = tid; k < c; k += kThreads) accg[k] = accb[k] = 0.f;

  const int ty = tid / 16, tx = tid % 16;  // rows ty, ty + 16
  const int nblocks = (t + kBM - 1) / kBM;
  for (int rb = blockIdx.x; rb < nblocks; rb += gridDim.x) {
    const int row0 = rb * kBM;
    for (int r = warp; r < kBM; r += kWarps) {
      float mu = 0.f, rs = 0.f;
      if (row0 + r < t) row_stats(x + static_cast<size_t>(row0 + r) * c, c, eps, mu, rs);
      if (lane == 0) {
        s_mu[r] = mu;
        s_r[r] = rs;
      }
    }

    float acc[2][kGroups][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

    for (int o0 = 0; o0 < o; o0 += kBK) {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, kk = i % kBK;
        const int row = row0 + r, oo = o0 + kk;
        Ys[r * (kBK + 1) + kk] =
            (row < t && oo < o) ? to_f32(dy[static_cast<size_t>(row) * o + oo]) : 0.f;
      }
      for (int i = tid; i < ncol * kBK; i += kThreads) {
        const int cc = i / kBK, kk = i % kBK, oo = o0 + kk;
        Ws[kk * ldw + cc] = (cc < c && oo < o) ? to_f32(w[static_cast<size_t>(cc) * o + oo]) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kBK; ++kk) {
        const float a0 = Ys[ty * (kBK + 1) + kk];
        const float a1 = Ys[(ty + 16) * (kBK + 1) + kk];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (g < ngroups) {
            const float4 b = *reinterpret_cast<const float4*>(&Ws[kk * ldw + g * 64 + tx * 4]);
            acc[0][g][0] = fmaf(a0, b.x, acc[0][g][0]);
            acc[0][g][1] = fmaf(a0, b.y, acc[0][g][1]);
            acc[0][g][2] = fmaf(a0, b.z, acc[0][g][2]);
            acc[0][g][3] = fmaf(a0, b.w, acc[0][g][3]);
            acc[1][g][0] = fmaf(a1, b.x, acc[1][g][0]);
            acc[1][g][1] = fmaf(a1, b.y, acc[1][g][1]);
            acc[1][g][2] = fmaf(a1, b.z, acc[1][g][2]);
            acc[1][g][3] = fmaf(a1, b.w, acc[1][g][3]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = g * 64 + tx * 4 + e;
          if (g < ngroups && col < c) D[(ty + 16 * i) * ld + col] = acc[i][g][e];
        }
    __syncthreads();
    ln_backward_rows<T>(D, ld, x, nullptr, gamma, dx, s_mu, s_r, accg, accb, row0, t, c);
    __syncthreads();
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * c;
  for (int k = tid; k < c; k += kThreads) {
    out[k] = accg[k];
    out[c + k] = accb[k];
  }
}

template <typename T>
int launch(const void* x, const float* g, const void* w, const void* dy, void* dx,
           float* partial, float* dgb, int t, int c, int o, float eps, cudaStream_t s) {
  const size_t smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = row_groups(t);
  ln_matmul_bwd_kernel<T><<<groups, kThreads, smem, s>>>(
      static_cast<const T*>(x), g, static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, t, c, o, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_partials(partial, dgb, groups, 2 * static_cast<size_t>(c), s));
}

}  // namespace

// Blocks of the grid: the wrapper sizes the partials (groups x 2 x C f32).
TT_EXPORT int tt_ln_bwd_groups(int t) { return row_groups(t); }

// dgb receives [dgamma | dbeta] (2 x C f32); C must be at most 768.
TT_EXPORT int tt_ln_matmul_bwd(const void* x, const void* gamma, const void* w, const void* dy,
                               void* dx, void* partial, void* dgb, int t, int c, int o,
                               float eps, int is_bf16, void* stream) {
  if (c > kMaxC || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(dgb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, g, w, dy, dx, part, out, t, c, o, eps, s)
                 : launch<float>(x, g, w, dy, dx, part, out, t, c, o, eps, s);
}
