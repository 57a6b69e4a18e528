// fused_ln_mlp_residual / fused_ln_mlp: y = [x +] fc2(gelu(fc1(LayerNorm(x))))
// on token rows.
//
// Replaces the TPU kernel thyroid_tpu/ops/token_fused.py _ln_mlp_kernel
// (pallas_call in _ln_mlp_fwd_call, public wrappers fused_ln_mlp_residual
// and fused_ln_mlp): Swin's norm2 + MLP, with the residual add when serving
// and without it in training (DropPath and the skip stay outside), as the
// TPU kernel's `residual` flag chooses.
//
// What it computes, for x (T, C), W1 (C, Hd), W2 (Hd, C) in the compute
// type (f32 or bf16): per row, flax LayerNorm numerics in f32, the
// normalised row rounded to the compute type; per hidden unit
// h = xn . W1 + b1 (f32 accumulation) rounded to the compute type, exact
// erf GELU in f32, rounded again; then acc = h . W2 in f32, and
// y = acc + b2 (+ x with the residual) stored in the compute type.
//
// Bound on the H100: 4*C*Hd operations per row for 2*C elements moved, so
// bound by operations. Design (simple first): a block owns 32 rows and up
// to 768 output columns (more columns take more blocks along y, each
// recomputing the hidden layer). The normalised rows stay in shared memory;
// the hidden layer is produced 128 units at a time into shared memory and
// consumed at once into per-thread f32 register accumulators (2 rows x 48
// columns a thread), so the 4C-wide hidden tensor never reaches global
// memory. W1 and W2 are streamed through shared memory in chunks. Scalar
// f32 FMAs; tensor-core tiles are later work. The f32 accumulator of a
// 64 x 768 tile would not fit beside the normalised rows in shared memory,
// which is why it lives in registers.
#include "common.cuh"

namespace {

constexpr int kBM = 32;        // rows per block
constexpr int kHC = 128;       // hidden units per chunk
constexpr int kLdH = kHC + 4;  // padded row of the hidden tile
constexpr int kBK1 = 32;       // K chunk of fc1
constexpr int kBK2 = 16;       // K chunk of fc2
constexpr int kGroups = 12;    // 64-column groups a block owns
constexpr int kCols = 64 * kGroups;
constexpr int kThreads = 256;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const T* __restrict__ w1,
              const float* __restrict__ b1, const T* __restrict__ w2,
              const float* __restrict__ b2, T* __restrict__ y, int t, int c, int hdim,
              float eps, int residual) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * kCols;
  const int ncol = min(kCols, c - c0);
  const int ncol_pad = (ncol + 63) / 64 * 64;
  const int ngroups = ncol_pad / 64;
  const int ldx = c + 4;
  float* Xs = smem;                 // kBM x ldx      normalised rows
  float* Hs = Xs + kBM * ldx;       // kBM x kLdH     hidden chunk
  float* W1s = Hs + kBM * kLdH;     // kBK1 x kHC
  float* W2s = W1s + kBK1 * kHC;    // kBK2 x ncol_pad
  const float cf = static_cast<float>(c);

  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = row0 + r;
    float* xs = Xs + r * ldx;
    if (row < t) {
      const T* xr = x + static_cast<size_t>(row) * c;
      float s = 0.f, ss = 0.f;
      for (int k = lane; k < c; k += 32) {
        const float v = to_f32(xr[k]);
        s += v;
        ss += v * v;
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      const float mu = s / cf;
      const float var = fmaxf(0.f, ss / cf - mu * mu);
      const float rstd = rsqrtf(var + eps);
      for (int k = lane; k < c; k += 32)
        xs[k] = round_to<T>((to_f32(xr[k]) - mu) * (rstd * gamma[k]) + beta[k]);
    } else {
      for (int k = lane; k < c; k += 32) xs[k] = 0.f;
    }
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;  // rows ty, ty + 16
  float acc[2][kGroups][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

  for (int h0 = 0; h0 < hdim; h0 += kHC) {
    // fc1 for hidden units [h0, h0 + kHC): 2 rows x 8 units a thread
    float hacc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) hacc[i][e] = 0.f;
    for (int k0 = 0; k0 < c; k0 += kBK1) {
      for (int i = tid; i < kBK1 * kHC; i += kThreads) {
        const int kk = i / kHC, jj = i % kHC;
        const int k = k0 + kk, hj = h0 + jj;
        W1s[i] = (k < c && hj < hdim) ? to_f32(w1[static_cast<size_t>(k) * hdim + hj]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(kBK1, c - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float a0 = Xs[ty * ldx + k0 + kk];
        const float a1 = Xs[(ty + 16) * ldx + k0 + kk];
        const float4 p = *reinterpret_cast<const float4*>(&W1s[kk * kHC + tx * 4]);
        const float4 q = *reinterpret_cast<const float4*>(&W1s[kk * kHC + 64 + tx * 4]);
        const float bv[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          hacc[0][e] = fmaf(a0, bv[e], hacc[0][e]);
          hacc[1][e] = fmaf(a1, bv[e], hacc[1][e]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int jj = (e < 4 ? tx * 4 + e : 64 + tx * 4 + e - 4);
        const int hj = h0 + jj;
        float v = 0.f;
        if (hj < hdim) v = round_to<T>(gelu_erf(round_to<T>(hacc[i][e] + b1[hj])));
        Hs[(ty + 16 * i) * kLdH + jj] = v;
      }
    }
    __syncthreads();

    // fc2: acc += H[:, chunk] . W2[chunk, c0:c0 + ncol]
    for (int k0 = 0; k0 < kHC; k0 += kBK2) {
      for (int i = tid; i < kBK2 * ncol_pad; i += kThreads) {
        const int kk = i / ncol_pad, jj = i % ncol_pad;
        const int hk = h0 + k0 + kk;
        W2s[i] = (hk < hdim && jj < ncol) ? to_f32(w2[static_cast<size_t>(hk) * c + c0 + jj])
                                          : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kBK2; ++kk) {
        const float a0 = Hs[ty * kLdH + k0 + kk];
        const float a1 = Hs[(ty + 16) * kLdH + k0 + kk];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (g < ngroups) {
            const float4 b = *reinterpret_cast<const float4*>(&W2s[kk * ncol_pad + g * 64 + tx * 4]);
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
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (g >= ngroups) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = g * 64 + tx * 4 + e;
        if (jl < ncol) {
          const size_t off = static_cast<size_t>(row) * c + c0 + jl;
          const float v = acc[i][g][e] + b2[c0 + jl];
          y[off] = from_f32<T>(residual ? v + to_f32(x[off]) : v);
        }
      }
    }
  }
}

size_t smem_bytes(int c) {
  const int ncol_pad = (min(kCols, c) + 63) / 64 * 64;
  return sizeof(float) * (static_cast<size_t>(kBM) * (c + 4) + kBM * kLdH + kBK1 * kHC +
                          static_cast<size_t>(kBK2) * ncol_pad);
}

template <typename T>
int launch(const void* x, const float* g, const float* b, const void* w1, const float* b1,
           const void* w2, const float* b2, void* y, int t, int c, int hdim, float eps,
           int residual, cudaStream_t s) {
  const size_t smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kBM - 1) / kBM, (c + kCols - 1) / kCols);
  ln_mlp_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), g, b, static_cast<const T*>(w1), b1, static_cast<const T*>(w2),
      b2, static_cast<T*>(y), t, c, hdim, eps, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// residual = 1: y = x + MLP(LN(x)) (fused_ln_mlp_residual); 0: y = MLP(LN(x)).
TT_EXPORT int tt_ln_mlp(const void* x, const void* gamma, const void* beta, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* y, int t, int c,
                        int hdim, float eps, int residual, int is_bf16, void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* bb1 = static_cast<const float*>(b1);
  const float* bb2 = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch<__nv_bfloat16>(x, g, b, w1, bb1, w2, bb2, y, t, c, hdim, eps, residual, s)
             : launch<float>(x, g, b, w1, bb1, w2, bb2, y, t, c, hdim, eps, residual, s);
}
