// fused_ln_mlp / fused_ln_mlp_residual backward, in two kernels:
//   dx: dX, dgamma, dbeta   (replaces _ln_mlp_bwd_dx_kernel)
//   dw: dW1, db1, dW2       (replaces _ln_mlp_bwd_dw_kernel)
// of y = [x +] fc2(gelu(fc1(LayerNorm(x)))).
//
// Replaces the TPU kernels of thyroid_tpu/ops/token_fused.py
// _ln_mlp_bwd_call (the custom_vjp backward of fused_ln_mlp and
// fused_ln_mlp_residual): Swin's norm2 + MLP in training with
// train_token_kernels. db2 = sum dY stays outside, as in the JAX package.
//
// What they compute, for x (T, C), W1 (C, Hd), W2 (Hd, C) and dY (T, C) in
// the compute type (f32 or bf16), gamma, beta, b1 f32, with every product
// accumulated in f32 and the JAX kernels' roundings to the compute type
// (round()):
//   x_hat, rstd = the LN statistics again; xn = round(x_hat * gamma + beta)
//   hr = round(xn W1 + b1)                 the forward's hidden layer
//   dH = round((dY W2^T) * gelu'(hr))       exact erf in gelu and gelu'
//   dx: dXn = dH W1^T; dX = rstd * (dXh - mean(dXh) - x_hat * mean(dXh *
//       x_hat)) with dXh = dXn gamma (+ dY with the residual), stored in the
//       compute type; dgamma = sum dXn * x_hat, dbeta = sum dXn (f32)
//   dw: a = round(gelu(hr)); dW1 = xn^T dH, dW2 = a^T dY, db1 = sum dH (f32)
// Neither T x Hd hidden tensor (hr, dH, a) ever reaches global memory: each
// kernel rebuilds the hidden layer one chunk at a time in shared memory.
// Sums over tokens are deterministic (token_bwd.cuh).
//
// Bound on the H100: dx does three products of 2*C*Hd operations per row,
// dw four, for about 3*C elements moved per row: bound by operations.
// Design (simple first, scalar f32 FMAs; tensor-core tiles are later work;
// C up to 768):
// - dx: a persistent grid of one 256-thread block per SM walks row blocks of
//   32 rows. The normalised rows stay in shared memory; per chunk of 128
//   hidden units the block recomputes hr (2 rows x 8 units a thread, W1
//   streamed), then dA from dY and W2 streamed in chunks, forms dH in
//   shared memory and adds dH W1^T into a 32 x C register tile (2 rows x 48
//   columns a thread, as the forward). The tile then goes to shared memory
//   for the LN backward (token_bwd.cuh).
// - dw: the grid is (chunks of 16 hidden units) x (token groups). A block
//   keeps its chunk of W1 and W2 in shared memory and walks its token
//   group 16 rows at a time: xn and dY rows into shared memory, each thread
//   one (row, unit) of hr, dA, dH and a, then each thread adds 16 rows into
//   its register sums (one hidden unit, every 16th column of dW1 and
//   dW2). The groups' sums are partials, added in group order. A thread
//   keeps 6, 12, 24 or 48 column sums of each, by the width, and the grid
//   holds about two waves of the blocks the card fits at once.
#include "token_bwd.cuh"

namespace {

using namespace tokbwd;

// ---- dx kernel -------------------------------------------------------------

constexpr int kHC = 128;       // hidden units per chunk
constexpr int kLdH = kHC + 4;  // padded row of a hidden tile
constexpr int kBK1 = 32;       // chunk of the contractions over C (fc1, dA)
constexpr int kBK2 = 16;       // chunk of the contraction over hidden units (dXn)

__host__ __device__ inline int ncol_pad(int c) { return (c + 63) / 64 * 64; }

__host__ __device__ inline size_t stage_floats(int c) {
  const size_t a = static_cast<size_t>(kBK1) * kLdH;
  const size_t b = static_cast<size_t>(kBK2) * (ncol_pad(c) + 4);
  return a > b ? a : b;
}

size_t dx_smem_bytes(int c) {
  return sizeof(float) * (stage_floats(c) + static_cast<size_t>(kBM) * (c + 4) + kBM * kLdH +
                          kBM * (kBK1 + 1) + 2 * static_cast<size_t>(c) + 2 * kBM);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ partial, int t, int c, int hdim, float eps,
                     int residual) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncol = ncol_pad(c), ldw = ncol + 4, ngroups = ncol / 64, ldx = c + 4;
  float* Stg = smem;                     // W1 / W2^T / W1^T chunks
  float* Xs = Stg + stage_floats(c);     // kBM x ldx: xn, then dXn
  float* Hs = Xs + kBM * ldx;            // kBM x kLdH: hr, then dH
  float* Ys = Hs + kBM * kLdH;           // kBM x (kBK1+1): dY chunk
  float* accg = Ys + kBM * (kBK1 + 1);
  float* accb = accg + c;
  float* s_mu = accb + c;
  float* s_r = s_mu + kBM;
  for (int k = tid; k < c; k += kThreads) accg[k] = accb[k] = 0.f;

  const int ty = tid / 16, tx = tid % 16;  // rows ty, ty + 16
  const int nblocks = (t + kBM - 1) / kBM;
  for (int rb = blockIdx.x; rb < nblocks; rb += gridDim.x) {
    const int row0 = rb * kBM;
    for (int r = warp; r < kBM; r += kWarps) {
      const int row = row0 + r;
      float* xs = Xs + r * ldx;
      float mu = 0.f, rs = 0.f;
      if (row < t) {
        const T* xr = x + static_cast<size_t>(row) * c;
        row_stats(xr, c, eps, mu, rs);
        for (int k = lane; k < c; k += 32)
          xs[k] = round_to<T>(ln_affine(xhat(to_f32(xr[k]), mu, rs), gamma[k], beta[k]));
      } else {
        for (int k = lane; k < c; k += 32) xs[k] = 0.f;
      }
      if (lane == 0) {
        s_mu[r] = mu;
        s_r[r] = rs;
      }
    }
    __syncthreads();

    float acc[2][kGroups][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

    for (int h0 = 0; h0 < hdim; h0 += kHC) {
      // hr for hidden units [h0, h0 + kHC): 2 rows x 8 units a thread
      float hacc[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) hacc[i][e] = 0.f;
      for (int k0 = 0; k0 < c; k0 += kBK1) {
        for (int i = tid; i < kBK1 * kHC; i += kThreads) {
          const int kk = i / kHC, jj = i % kHC;
          const int k = k0 + kk, hj = h0 + jj;
          Stg[kk * kLdH + jj] =
              (k < c && hj < hdim) ? to_f32(w1[static_cast<size_t>(k) * hdim + hj]) : 0.f;
        }
        __syncthreads();
        const int kmax = min(kBK1, c - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          const float a0 = Xs[ty * ldx + k0 + kk];
          const float a1 = Xs[(ty + 16) * ldx + k0 + kk];
          const float4 p = *reinterpret_cast<const float4*>(&Stg[kk * kLdH + tx * 4]);
          const float4 q = *reinterpret_cast<const float4*>(&Stg[kk * kLdH + 64 + tx * 4]);
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
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int jj = (e < 4 ? tx * 4 + e : 64 + tx * 4 + e - 4);
          const int hj = h0 + jj;
          Hs[(ty + 16 * i) * kLdH + jj] = hj < hdim ? round_to<T>(hacc[i][e] + b1[hj]) : 0.f;
        }

      // dA = dY W2[h0:h0 + kHC, :]^T, then dH = round(dA * gelu'(hr)) in Hs
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) hacc[i][e] = 0.f;
      for (int k0 = 0; k0 < c; k0 += kBK1) {
        for (int i = tid; i < kBM * kBK1; i += kThreads) {
          const int r = i / kBK1, kk = i % kBK1;
          const int row = row0 + r, k = k0 + kk;
          Ys[r * (kBK1 + 1) + kk] =
              (row < t && k < c) ? to_f32(dy[static_cast<size_t>(row) * c + k]) : 0.f;
        }
        for (int i = tid; i < kHC * kBK1; i += kThreads) {
          const int jj = i / kBK1, kk = i % kBK1;
          const int k = k0 + kk, hj = h0 + jj;
          Stg[kk * kLdH + jj] =
              (k < c && hj < hdim) ? to_f32(w2[static_cast<size_t>(hj) * c + k]) : 0.f;
        }
        __syncthreads();
        const int kmax = min(kBK1, c - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          const float a0 = Ys[ty * (kBK1 + 1) + kk];
          const float a1 = Ys[(ty + 16) * (kBK1 + 1) + kk];
          const float4 p = *reinterpret_cast<const float4*>(&Stg[kk * kLdH + tx * 4]);
          const float4 q = *reinterpret_cast<const float4*>(&Stg[kk * kLdH + 64 + tx * 4]);
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
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int jj = (e < 4 ? tx * 4 + e : 64 + tx * 4 + e - 4);
          float* hp = &Hs[(ty + 16 * i) * kLdH + jj];
          *hp = h0 + jj < hdim ? round_to<T>(hacc[i][e] * gelu_grad(*hp)) : 0.f;
        }
      __syncthreads();

      // dXn += dH W1[:, h0:h0 + kHC]^T
      for (int k0 = 0; k0 < kHC; k0 += kBK2) {
        for (int i = tid; i < ncol * kBK2; i += kThreads) {
          const int cc = i / kBK2, kk = i % kBK2;
          const int hj = h0 + k0 + kk;
          Stg[kk * ldw + cc] =
              (cc < c && hj < hdim) ? to_f32(w1[static_cast<size_t>(cc) * hdim + hj]) : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int kk = 0; kk < kBK2; ++kk) {
          const float a0 = Hs[ty * kLdH + k0 + kk];
          const float a1 = Hs[(ty + 16) * kLdH + k0 + kk];
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            if (g < ngroups) {
              const float4 b = *reinterpret_cast<const float4*>(&Stg[kk * ldw + g * 64 + tx * 4]);
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

    // dXn replaces xn in Xs (every read of xn ended before the last barrier)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = g * 64 + tx * 4 + e;
          if (g < ngroups && col < c) Xs[(ty + 16 * i) * ldx + col] = acc[i][g][e];
        }
    __syncthreads();
    ln_backward_rows<T>(Xs, ldx, x, residual ? dy : nullptr, gamma, dx, s_mu, s_r, accg, accb,
                        row0, t, c);
    __syncthreads();
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * c;
  for (int k = tid; k < c; k += kThreads) {
    out[k] = accg[k];
    out[c + k] = accb[k];
  }
}

// ---- dw kernel -------------------------------------------------------------

constexpr int kBR = 16;              // token rows per step
constexpr int kHW = 16;              // hidden units per block

size_t dw_smem_bytes(int c) {
  return sizeof(float) * (2 * static_cast<size_t>(c) * kHW + 2 * static_cast<size_t>(kBR) * (c + 1) +
                          2 * kBR * (kHW + 1) + 2 * kBR);
}

// P: columns of C a thread sums (every 16th), at least c / 16; the launch
// takes the smallest of 6, 12, 24 and 48 that covers the width, so a narrow
// stage keeps few registers and fits several blocks on an SM.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ln_mlp_bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ dy, float* __restrict__ partial, int t, int c,
                     int hdim, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kHW, ldx = c + 1;
  float* W1c = smem;                 // c x kHW: W1[:, j0:j0 + kHW]
  float* W2c = W1c + c * kHW;        // c x kHW: W2[j0:j0 + kHW, :]^T
  float* Xs = W2c + c * kHW;         // kBR x ldx: xn
  float* Ds = Xs + kBR * ldx;        // kBR x ldx: dY
  float* Hs = Ds + kBR * ldx;        // kBR x (kHW+1): dH
  float* As = Hs + kBR * (kHW + 1);  // kBR x (kHW+1): a = round(gelu(hr))

  for (int i = tid; i < c * kHW; i += kThreads) {
    const int k = i / kHW, j = i % kHW, hj = j0 + j;
    W1c[i] = hj < hdim ? to_f32(w1[static_cast<size_t>(k) * hdim + hj]) : 0.f;
  }
  for (int i = tid; i < c * kHW; i += kThreads) {
    const int j = i / c, k = i % c, hj = j0 + j;
    W2c[k * kHW + j] = hj < hdim ? to_f32(w2[static_cast<size_t>(hj) * c + k]) : 0.f;
  }

  const int tj = tid % kHW, tr = tid / kHW;  // step 2: row tr, unit tj; step 3: columns tr + 16 m
  const int hj = j0 + tj;
  const float bias1 = hj < hdim ? b1[hj] : 0.f;
  float acc1[P], acc2[P], db = 0.f;
#pragma unroll
  for (int m = 0; m < P; ++m) acc1[m] = acc2[m] = 0.f;

  const int nrows = (t + kBR - 1) / kBR;
  for (int rb = blockIdx.y; rb < nrows; rb += gridDim.y) {
    const int row0 = rb * kBR;
    __syncthreads();  // the previous step's reads of Xs, Ds, Hs, As are done
    for (int r = warp; r < kBR; r += kWarps) {
      const int row = row0 + r;
      float* xs = Xs + r * ldx;
      float* ds = Ds + r * ldx;
      if (row < t) {
        const size_t base = static_cast<size_t>(row) * c;
        float mu, rs;
        row_stats(x + base, c, eps, mu, rs);
        for (int k = lane; k < c; k += 32) {
          xs[k] = round_to<T>(ln_affine(xhat(to_f32(x[base + k]), mu, rs), gamma[k], beta[k]));
          ds[k] = to_f32(dy[base + k]);
        }
      } else {
        for (int k = lane; k < c; k += 32) xs[k] = ds[k] = 0.f;
      }
    }
    __syncthreads();

    {  // hr, dA for (row tr, unit tj); then dH and a
      const float* xs = Xs + tr * ldx;
      const float* ds = Ds + tr * ldx;
      float h = 0.f, da = 0.f;
#pragma unroll 4
      for (int k = 0; k < c; ++k) {
        h = fmaf(xs[k], W1c[k * kHW + tj], h);
        da = fmaf(ds[k], W2c[k * kHW + tj], da);
      }
      const bool valid = row0 + tr < t && hj < hdim;
      const float hr = round_to<T>(h + bias1);
      Hs[tr * (kHW + 1) + tj] = valid ? round_to<T>(da * gelu_grad(hr)) : 0.f;
      As[tr * (kHW + 1) + tj] = valid ? round_to<T>(gelu(hr)) : 0.f;
    }
    __syncthreads();

    for (int r = 0; r < kBR; ++r) {
      const float dh = Hs[r * (kHW + 1) + tj];
      const float a = As[r * (kHW + 1) + tj];
      db += dh;
      const float* xs = Xs + r * ldx;
      const float* ds = Ds + r * ldx;
#pragma unroll
      for (int m = 0; m < P; ++m) {
        const int k = tr + kHW * m;
        if (k < c) {
          acc1[m] = fmaf(xs[k], dh, acc1[m]);
          acc2[m] = fmaf(a, ds[k], acc2[m]);
        }
      }
    }
  }

  if (hj < hdim) {
    float* out = partial + static_cast<size_t>(blockIdx.y) * (2 * static_cast<size_t>(c) * hdim + hdim);
    float* dw2 = out + static_cast<size_t>(c) * hdim;
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const int k = tr + kHW * m;
      if (k < c) {
        out[static_cast<size_t>(k) * hdim + hj] = acc1[m];
        dw2[static_cast<size_t>(hj) * c + k] = acc2[m];
      }
    }
    if (tr == 0) out[2 * static_cast<size_t>(c) * hdim + hj] = db;
  }
}

template <typename T>
using DwKernel = void (*)(const T*, const float*, const float*, const T*, const float*, const T*,
                          const T*, float*, int, int, int, float);

template <typename T>
DwKernel<T> dw_kernel(int c) {
  if (c <= 6 * kHW) return ln_mlp_bwd_dw_kernel<T, 6>;
  if (c <= 12 * kHW) return ln_mlp_bwd_dw_kernel<T, 12>;
  if (c <= 24 * kHW) return ln_mlp_bwd_dw_kernel<T, 24>;
  return ln_mlp_bwd_dw_kernel<T, kMaxC / kHW>;
}

// Token groups of the dw grid: about two waves of the blocks that fit on
// the card at once, spread over the hidden chunks. Sets the kernel's shared
// memory limit, which the occupancy query reads.
template <typename T>
int dw_groups(int t, int c, int hdim, int* groups) {
  const DwKernel<T> kernel = dw_kernel<T>(c);
  const int smem = static_cast<int>(dw_smem_bytes(c));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (hdim + kHW - 1) / kHW;
  const int rows = (t + kBR - 1) / kBR;
  int g = (2 * (per_sm > 0 ? per_sm : 1) * kSMs + chunks - 1) / chunks;
  if (g > rows) g = rows;
  *groups = g < 1 ? 1 : g;
  return 0;
}

template <typename T>
int launch_dx(const void* x, const float* g, const float* b, const void* w1, const float* b1,
              const void* w2, const void* dy, void* dx, float* partial, float* dgb, int t, int c,
              int hdim, float eps, int residual, cudaStream_t s) {
  const size_t smem = dx_smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_bwd_dx_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = row_groups(t);
  ln_mlp_bwd_dx_kernel<T><<<groups, kThreads, smem, s>>>(
      static_cast<const T*>(x), g, b, static_cast<const T*>(w1), b1, static_cast<const T*>(w2),
      static_cast<const T*>(dy), static_cast<T*>(dx), partial, t, c, hdim, eps, residual);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_partials(partial, dgb, groups, 2 * static_cast<size_t>(c), s));
}

template <typename T>
int launch_dw(const void* x, const float* g, const float* b, const void* w1, const float* b1,
              const void* w2, const void* dy, float* partial, float* out, int t, int c, int hdim,
              float eps, cudaStream_t s) {
  int groups = 0;
  const int status = dw_groups<T>(t, c, hdim, &groups);
  if (status != 0) return status;
  const dim3 grid((hdim + kHW - 1) / kHW, groups);
  dw_kernel<T>(c)<<<grid, kThreads, dw_smem_bytes(c), s>>>(
      static_cast<const T*>(x), g, b, static_cast<const T*>(w1), b1, static_cast<const T*>(w2),
      static_cast<const T*>(dy), partial, t, c, hdim, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = 2 * static_cast<size_t>(c) * hdim + hdim;
  return static_cast<int>(sum_partials(partial, out, groups, n, s));
}

}  // namespace

// Blocks of the dx grid and token groups of the dw grid: the wrapper sizes
// the partials with them (groups x 2 x C, and groups x (2 C Hd + Hd), f32).
TT_EXPORT int tt_ln_mlp_bwd_dx_groups(int t) { return row_groups(t); }
// tt_ln_mlp_bwd_dw_groups returns the group count, or -1 when the occupancy
// query fails (the launch then reports the error).
TT_EXPORT int tt_ln_mlp_bwd_dw_groups(int t, int c, int hdim, int is_bf16) {
  int groups = 0;
  const int status = is_bf16 ? dw_groups<__nv_bfloat16>(t, c, hdim, &groups)
                             : dw_groups<float>(t, c, hdim, &groups);
  return status == 0 ? groups : -1;
}

// dgb receives [dgamma | dbeta] (2 x C f32); residual adds dY to dX.
TT_EXPORT int tt_ln_mlp_bwd_dx(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* dy,
                               void* dx, void* partial, void* dgb, int t, int c, int hdim,
                               float eps, int residual, int is_bf16, void* stream) {
  if (c > kMaxC || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* bb1 = static_cast<const float*>(b1);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(dgb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dx<__nv_bfloat16>(x, g, b, w1, bb1, w2, dy, dx, part, out, t, c, hdim,
                                            eps, residual, s)
                 : launch_dx<float>(x, g, b, w1, bb1, w2, dy, dx, part, out, t, c, hdim, eps,
                                    residual, s);
}

// out receives [dW1 (C x Hd) | dW2 (Hd x C) | db1 (Hd)], f32.
TT_EXPORT int tt_ln_mlp_bwd_dw(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* dy,
                               void* partial, void* out, int t, int c, int hdim, float eps,
                               int is_bf16, void* stream) {
  if (c > kMaxC || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* bb1 = static_cast<const float*>(b1);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dw<__nv_bfloat16>(x, g, b, w1, bb1, w2, dy, part, o, t, c, hdim, eps, s)
                 : launch_dw<float>(x, g, b, w1, bb1, w2, dy, part, o, t, c, hdim, eps, s);
}
