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
// Bound on the H100: dx does three products of 2*C*Hd operations per row
// (6*C*Hd), dw four (8*C*Hd), for about 3*C elements moved per row: bound by
// operations at every Swin width (8*C*Hd / (4*C) bytes = 2*Hd = 768
// operations per byte at C = 96, against the card's ~295).
//
// dx in bf16 (the flagged training step): mlp_tc.cuh's wgmma core. A pass
// writes xn = round(x_hat * gamma + beta) (bf16) to the workspace; a CTA of
// 64 rows x at most 512 dX columns (two consumer warpgroups of 192 at C =
// 384 and 768, one of 64-256 below) walks its hidden chunks (64 units per
// warpgroup) while one producer thread loads every operand tile (64 deep)
// by TMA into a ring of stages: hr = round(xn W1 + b1) with wgmma
// m64n64k16 (W1 the MN-major B), kept in registers packed as bf16 pairs;
// dA = dY W2^T with W2 as the K-major B; dH = round(dA * gelu'(hr)) goes
// to shared memory in bf16 as the A operand of dXn += dH W1^T (W1 the
// K-major B, wgmma m64nNk16), an f32 register tile. Budget at C = 768 (two
// column blocks of 384, each recomputing hr and dA: stage 4 does 1.67x
// the operations): 4 stages of 48 KB + dH (16 KB) = 209 KB of shared
// memory, 96 + 32 + 32 accumulator registers a thread, of which the 168
// a thread that nine warps leave spill 712 bytes (ptxas). C = 1024 and 1536
// take four and six column blocks of 256, one warpgroup each (no spills;
// mlp_tc.cuh make_plan). dXn goes
// to the workspace as f32 partials over hidden splits (the hidden axis is
// split where the CTAs would not fill two waves); token_bwd.cuh's
// ln_bwd_pass, which kernel 9 shares, adds them in split order and runs the
// LN backward (deterministic dgamma/dbeta partials, summed in block order),
// or past kMaxC (768) its ln_bwd_wide, which holds no row in registers.
//
// dw in bf16 (kernel 11, the flagged training step) also runs on wgmma. The
// same LN pass writes xn; a CTA owns one hidden chunk j (64 units), one dW
// column block (N = 64, 96, 128 or 192 columns of C: C = 96 one block of
// 96, 192 one of 192, 384 two and 768 four of 192) and one token split,
// and walks the split's 64-row token tiles. Per tile, one producer thread
// loads by TMA C / 64 stages of {xn, W1[k, j], dY, W2[j, k]} (64 x 64 bf16
// tiles, 128-byte swizzle) and then one of {xn, dY}[:, block], into a ring
// of 4-6 stages (mbarriers, 32-48 KB each). Two consumer warpgroups split
// the work evenly:
// - warpgroup 0: hr = xn W1[:, j] (wgmma m64n64k16, W1 the MN-major B), +
//   b1, rounded; hands hr (bf16, 8 KB) to warpgroup 1 through shared memory
//   between two named barriers; a = round(gelu(hr)) stored transposed
//   (64 units x 64 tokens, swizzled: the K-major A of a product over
//   tokens); dW2[j, block] += a^T dY[:, block] (wgmma m64nNk16, the dY tile
//   read as the MN-major B);
// - warpgroup 1: dA = dY W2[j, :]^T (W2 the K-major B); dH = round(dA *
//   gelu'(hr)) stored transposed; dW1^T[j, block] += dH^T xn[:, block]; db1
//   from the stored dH^T (each thread half a unit's 64 tokens, in f32)
//   while that product runs.
// imm-trans-a stays 0: the transposed stores make dH^T and a^T K-major
// (one shuffle pairs neighbouring tokens into 32-bit stores), and the token
// tiles that were the first products' K-major A serve the weight products
// as the MN-major B. Each k-tile of hr and dA is its own wgmma group, added
// in f32 on the CUDA cores (summed inside wgmma across k-tiles, their dW
// was 2-5x as far from float64 products as cuBLAS's float32 one at C =
// 768). The dW accumulators stay in registers over the split, N / 2 a
// thread beside 32 of hr or dA and 32 of a k-tile's product: at C = 768,
// 96 + 64 in the 168 a thread that nine warps leave, with 98 bytes
// spilled (ptxas; 8 at N = 128, none below); 4 stages of 48 KB + 24 KB (a^T,
// dH^T, the hr hand-over) = 218 KB of shared memory, one CTA an SM. Each
// column block recomputes hr and dA: the tensor cores do 8*C*Hd operations
// a row at C = 192, 12*C*Hd (1.5x) at 384, 20*C*Hd (2.5x) at 768, and at C
// = 96 9.3*C*Hd (the first products run 128 deep, 32 of them on zeros).
// The grid is chunks x column blocks x token splits, the splits enough for
// two waves of the 132 SMs, more where whole waves then cost fewer tiles
// (stage 1 of the flagged step: 6 x 1 x 44 CTAs; stage 3: 24 x 2 x 11,
// four full waves; stage 4: 48 x 4 x 2); each split writes [dW1 | dW2 |
// db1] as an f32 partial that sum_partials adds in split order:
// deterministic, no atomics.
// Widths that are not multiples of 8 read W1, W2 and dY from zero-padded
// copies in the workspace.
//
// float32 (the card-vs-CPU parity step) keeps the scalar dx and dw kernels
// below: TF32 tensor cores keep 10 mantissa bits and would not hold the
// 1e-4 float32 checks. Past kMaxC they hand over to the wide kernels
// (ln_mlp_dxn_wide_kernel, ln_mlp_dw_wide_kernel), which take any C.
#include "mlp_tc.cuh"

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

// dXn[rows, c0 : c0 + ncol] += dH W1[c0 : c0 + ncol, h0 : h0 + kHC]^T: dH
// (kBM x kHC) in Hs, W1^T streamed through Stg in chunks of kBK2 hidden
// units; columns past C read zeros.
template <typename T>
__device__ __forceinline__ void dh_w1t(RowTile& acc, const float* Hs, float* Stg,
                                       const T* __restrict__ w1, int c, int c0, int ncol,
                                       int hdim, int h0) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ldw = ncol + 4, ngroups = ncol / 64;
  for (int k0 = 0; k0 < kHC; k0 += kBK2) {
    for (int i = tid; i < ncol * kBK2; i += kThreads) {
      const int cc = i / kBK2, kk = i % kBK2, hj = h0 + k0 + kk;
      Stg[kk * ldw + cc] =
          (c0 + cc < c && hj < hdim) ? to_f32(w1[static_cast<size_t>(c0 + cc) * hdim + hj]) : 0.f;
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
  const int ncol = ncol_pad(c), ngroups = ncol / 64, ldx = c + 4;
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

    RowTile acc;
    zero_tile(acc);

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

      dh_w1t(acc, Hs, Stg, w1, c, 0, ncol, hdim, h0);
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
  return ln_mlp_bwd_dw_kernel<T, kMaxC / kHW>;  // wider rows take ln_mlp_dw_wide_kernel
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

int launch_dx_f32(const void* x, const float* g, const float* b, const void* w1,
                  const float* b1, const void* w2, const void* dy, void* dx, float* partial,
                  float* dgb, int t, int c, int hdim, float eps, int residual, cudaStream_t s) {
  const size_t smem = dx_smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_bwd_dx_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = row_groups(t);
  ln_mlp_bwd_dx_kernel<float><<<groups, kThreads, smem, s>>>(
      static_cast<const float*>(x), g, b, static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), static_cast<const float*>(dy), static_cast<float*>(dx),
      partial, t, c, hdim, eps, residual);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_partials(partial, dgb, groups, 2 * static_cast<size_t>(c), s));
}

// ---- float32 past kMaxC ----------------------------------------------------
//
// Neither scalar kernel above fits a row past kMaxC: the dx kernel keeps a
// 32 x C row block in shared memory and a 32 x C register tile, the dw
// kernel C / 16 columns a thread and W1, W2 chunks of C x 16. Past kMaxC a
// pass first writes xn = round(x_hat gamma + beta) (f32, mlptc::ln_rows) to
// the workspace, and
// - dx: a CTA takes a row block of kBM rows and a chunk of kMaxC dXn
//   columns and walks the hidden chunks as ln_mlp_bwd_dx_kernel does, with
//   xn and dY streaming from global memory in chunks of kBK1 (each column
//   chunk recomputes hr and dA), into the same register tile; dXn goes to
//   the workspace, and token_bwd.cuh's ln_bwd_wide applies the LN backward;
// - dw: a CTA takes 16 hidden units, a run of token rows and a chunk of
//   kWideCols output columns; hr and dA contract over C in chunks of kWideK
//   staged in shared memory, and the sums over tokens run as in
//   ln_mlp_bwd_dw_kernel over the chunk's columns.
// Both keep the narrow kernels' order of every sum, so a column's dXn, dW1
// and dW2 are the values the narrow kernels give.

size_t dx_wide_smem_bytes() {
  return sizeof(float) * (stage_floats(kMaxC) + kBM * kLdH + kBM * (kBK1 + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_dxn_wide_kernel(const T* __restrict__ xn, const T* __restrict__ w1,
                       const float* __restrict__ b1, const T* __restrict__ w2,
                       const T* __restrict__ dy, float* __restrict__ part, int t, int c,
                       int hdim) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // rows ty, ty + 16
  const int row0 = blockIdx.x * kBM, c0 = blockIdx.y * kMaxC;
  const int ncol = ncol_pad(min(kMaxC, c - c0));
  float* Stg = smem;                   // W1 / W2^T / W1^T chunks
  float* Hs = Stg + stage_floats(kMaxC);  // kBM x kLdH: hr, then dH
  float* As = Hs + kBM * kLdH;         // kBM x (kBK1+1): an xn or dY chunk

  // acc[i] (+)= A[rows, k0 : k0 + kBK1] B, A streamed from a (T x C) and B
  // the chunk load() staged in Stg: the hidden products of both kernels
  auto chunk_product = [&](float (&hacc)[2][8], const T* __restrict__ a, auto load) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) hacc[i][e] = 0.f;
    for (int k0 = 0; k0 < c; k0 += kBK1) {
      for (int i = tid; i < kBM * kBK1; i += kThreads) {
        const int r = i / kBK1, kk = i % kBK1;
        const int row = row0 + r, k = k0 + kk;
        As[r * (kBK1 + 1) + kk] = (row < t && k < c) ? to_f32(a[static_cast<size_t>(row) * c + k]) : 0.f;
      }
      load(k0);
      __syncthreads();
      const int kmax = min(kBK1, c - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float a0 = As[ty * (kBK1 + 1) + kk];
        const float a1 = As[(ty + 16) * (kBK1 + 1) + kk];
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
  };

  RowTile acc;
  zero_tile(acc);

  for (int h0 = 0; h0 < hdim; h0 += kHC) {
    float hacc[2][8];
    chunk_product(hacc, xn, [&](int k0) {  // W1[k0 : k0 + kBK1, h0 : h0 + kHC]
      for (int i = tid; i < kBK1 * kHC; i += kThreads) {
        const int kk = i / kHC, jj = i % kHC, k = k0 + kk, hj = h0 + jj;
        Stg[kk * kLdH + jj] = (k < c && hj < hdim) ? to_f32(w1[static_cast<size_t>(k) * hdim + hj]) : 0.f;
      }
    });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int jj = (e < 4 ? tx * 4 + e : 64 + tx * 4 + e - 4);
        const int hj = h0 + jj;
        Hs[(ty + 16 * i) * kLdH + jj] = hj < hdim ? round_to<T>(hacc[i][e] + b1[hj]) : 0.f;
      }
    chunk_product(hacc, dy, [&](int k0) {  // W2[h0 : h0 + kHC, k0 : k0 + kBK1]^T
      for (int i = tid; i < kHC * kBK1; i += kThreads) {
        const int jj = i / kBK1, kk = i % kBK1, k = k0 + kk, hj = h0 + jj;
        Stg[kk * kLdH + jj] = (k < c && hj < hdim) ? to_f32(w2[static_cast<size_t>(hj) * c + k]) : 0.f;
      }
    });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int jj = (e < 4 ? tx * 4 + e : 64 + tx * 4 + e - 4);
        float* hp = &Hs[(ty + 16 * i) * kLdH + jj];
        *hp = h0 + jj < hdim ? round_to<T>(hacc[i][e] * gelu_grad(*hp)) : 0.f;
      }
    __syncthreads();

    dh_w1t(acc, Hs, Stg, w1, c, c0, ncol, hdim, h0);
  }
  store_tile(acc, part, row0, t, c, c0, ncol / 64);
}

constexpr int kWideK = 64;                 // contraction chunk of hr and dA over C
constexpr int kWideP = 24;                 // output columns a thread sums
constexpr int kWideCols = kHW * kWideP;    // output columns of a dw CTA (384)

size_t dw_wide_smem_bytes() {
  return sizeof(float) * (2 * kWideK * kHW + 2 * kBR * (kWideK + 1) +
                          2 * kBR * (kWideCols + 1) + 2 * kBR * (kHW + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_mlp_dw_wide_kernel(const T* __restrict__ xn, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ dy, float* __restrict__ partial, int t, int c,
                      int hdim) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kHW, c0 = blockIdx.z * kWideCols;
  float* W1k = smem;                        // kWideK x kHW: W1[k0.., j0..]
  float* W2k = W1k + kWideK * kHW;          // kWideK x kHW: W2[j0.., k0..]^T
  float* Xk = W2k + kWideK * kHW;           // kBR x (kWideK+1): xn[:, k0..]
  float* Dk = Xk + kBR * (kWideK + 1);      // kBR x (kWideK+1): dY[:, k0..]
  float* Xc = Dk + kBR * (kWideK + 1);      // kBR x (kWideCols+1): xn[:, c0..]
  float* Dc = Xc + kBR * (kWideCols + 1);   // kBR x (kWideCols+1): dY[:, c0..]
  float* Hs = Dc + kBR * (kWideCols + 1);   // kBR x (kHW+1): dH
  float* As = Hs + kBR * (kHW + 1);         // kBR x (kHW+1): a = round(gelu(hr))

  const int tj = tid % kHW, tr = tid / kHW;  // hr, dA: row tr, unit tj; sums: columns tr + 16 m
  const int hj = j0 + tj;
  const float bias1 = hj < hdim ? b1[hj] : 0.f;
  float acc1[kWideP], acc2[kWideP], db = 0.f;
#pragma unroll
  for (int m = 0; m < kWideP; ++m) acc1[m] = acc2[m] = 0.f;

  const int nrows = (t + kBR - 1) / kBR;
  for (int rb = blockIdx.y; rb < nrows; rb += gridDim.y) {
    const int row0 = rb * kBR;
    float h = 0.f, da = 0.f;
    for (int k0 = 0; k0 < c; k0 += kWideK) {
      __syncthreads();  // the last chunk's (and the last step's) reads are done
      for (int i = tid; i < kWideK * kHW; i += kThreads) {
        const int kk = i / kHW, j = i % kHW, k = k0 + kk;
        const bool in = k < c && j0 + j < hdim;
        W1k[i] = in ? to_f32(w1[static_cast<size_t>(k) * hdim + j0 + j]) : 0.f;
        W2k[i] = in ? to_f32(w2[static_cast<size_t>(j0 + j) * c + k]) : 0.f;
      }
      for (int i = tid; i < kBR * kWideK; i += kThreads) {
        const int r = i / kWideK, kk = i % kWideK, row = row0 + r, k = k0 + kk;
        const bool in = row < t && k < c;
        Xk[r * (kWideK + 1) + kk] = in ? to_f32(xn[static_cast<size_t>(row) * c + k]) : 0.f;
        Dk[r * (kWideK + 1) + kk] = in ? to_f32(dy[static_cast<size_t>(row) * c + k]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(kWideK, c - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        h = fmaf(Xk[tr * (kWideK + 1) + kk], W1k[kk * kHW + tj], h);
        da = fmaf(Dk[tr * (kWideK + 1) + kk], W2k[kk * kHW + tj], da);
      }
    }
    for (int i = tid; i < kBR * kWideCols; i += kThreads) {
      const int r = i / kWideCols, kk = i % kWideCols, row = row0 + r, k = c0 + kk;
      const bool in = row < t && k < c;
      Xc[r * (kWideCols + 1) + kk] = in ? to_f32(xn[static_cast<size_t>(row) * c + k]) : 0.f;
      Dc[r * (kWideCols + 1) + kk] = in ? to_f32(dy[static_cast<size_t>(row) * c + k]) : 0.f;
    }
    const bool valid = row0 + tr < t && hj < hdim;
    const float hr = round_to<T>(h + bias1);
    Hs[tr * (kHW + 1) + tj] = valid ? round_to<T>(da * gelu_grad(hr)) : 0.f;
    As[tr * (kHW + 1) + tj] = valid ? round_to<T>(gelu(hr)) : 0.f;
    __syncthreads();

    for (int r = 0; r < kBR; ++r) {
      const float dh = Hs[r * (kHW + 1) + tj];
      const float a = As[r * (kHW + 1) + tj];
      db += dh;
      const float* xs = Xc + r * (kWideCols + 1);
      const float* ds = Dc + r * (kWideCols + 1);
#pragma unroll
      for (int m = 0; m < kWideP; ++m) {
        const int k = tr + kHW * m;
        if (c0 + k < c) {
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
    for (int m = 0; m < kWideP; ++m) {
      const int k = c0 + tr + kHW * m;
      if (k < c) {
        out[static_cast<size_t>(k) * hdim + hj] = acc1[m];
        dw2[static_cast<size_t>(hj) * c + k] = acc2[m];
      }
    }
    if (tr == 0 && blockIdx.z == 0) out[2 * static_cast<size_t>(c) * hdim + hj] = db;
  }
}

// Token groups of the wide dw grid: about two waves of the blocks that fit
// on the card at once, over hidden chunks x column chunks.
int dw_wide_groups(int t, int c, int hdim, int* groups) {
  const int smem = static_cast<int>(dw_wide_smem_bytes());
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_dw_wide_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_mlp_dw_wide_kernel<float>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (hdim + kHW - 1) / kHW * ((c + kWideCols - 1) / kWideCols);
  const int rows = (t + kBR - 1) / kBR;
  int g = (2 * (per_sm > 0 ? per_sm : 1) * kSMs + blocks - 1) / blocks;
  if (g > rows) g = rows;
  *groups = g < 1 ? 1 : g;
  return 0;
}

// The wide float32 workspace: xn (T x C f32), then for dx dXn (T x C f32)
// and the rows' statistics.
size_t wide_rows_bytes(int t, int c) {
  return mlptc::round256(static_cast<size_t>(t) * c * sizeof(float));
}

int launch_dx_f32_wide(const void* x, const float* g, const float* b, const void* w1,
                       const float* b1, const void* w2, const void* dy, void* dx,
                       float* partial, float* dgb, void* workspace, int t, int c, int hdim,
                       float eps, int residual, cudaStream_t s) {
  char* ws = static_cast<char*>(workspace);
  float* xn = reinterpret_cast<float*>(ws);
  float* part = reinterpret_cast<float*>(ws + wide_rows_bytes(t, c));
  float2* stats = reinterpret_cast<float2*>(ws + 2 * wide_rows_bytes(t, c));
  cudaError_t err = mlptc::ln_rows(x, g, b, xn, t, c, c, eps, 1, s);
  const size_t smem = dx_wide_smem_bytes();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ln_mlp_dxn_wide_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kBM - 1) / kBM, (c + kMaxC - 1) / kMaxC);
  ln_mlp_dxn_wide_kernel<float><<<grid, kThreads, smem, s>>>(
      xn, static_cast<const float*>(w1), b1, static_cast<const float*>(w2),
      static_cast<const float*>(dy), part, t, c, hdim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      ln_bwd_wide<float>(part, 1, x, g, dy, dx, stats, partial, dgb, t, c, eps, residual, s));
}

int launch_dw_f32_wide(const void* x, const float* g, const float* b, const void* w1,
                       const float* b1, const void* w2, const void* dy, float* partial,
                       float* out, void* workspace, int t, int c, int hdim, float eps,
                       cudaStream_t s) {
  float* xn = static_cast<float*>(workspace);
  cudaError_t err = mlptc::ln_rows(x, g, b, xn, t, c, c, eps, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int groups = 0;
  const int status = dw_wide_groups(t, c, hdim, &groups);
  if (status != 0) return status;
  const dim3 grid((hdim + kHW - 1) / kHW, groups, (c + kWideCols - 1) / kWideCols);
  ln_mlp_dw_wide_kernel<float><<<grid, kThreads, dw_wide_smem_bytes(), s>>>(
      xn, static_cast<const float*>(w1), b1, static_cast<const float*>(w2),
      static_cast<const float*>(dy), partial, t, c, hdim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = 2 * static_cast<size_t>(c) * hdim + hdim;
  return static_cast<int>(sum_partials(partial, out, groups, n, s));
}

// ---- dx in bf16: the tensor-core kernel ------------------------------------

using mlptc::bf16;
using mlptc::kTile;

// One CTA: rows [64 x, +64), dX columns [cblock y, +cblock) (capped at C),
// hidden chunks [cps z, +cps) of 64 NW units; writes its dXn as the f32
// partial of split z. Warpgroups 0..NW - 1 multiply; the first thread
// after them loads.
template <int NW, int NWC>
__global__ void __launch_bounds__(mlptc::threads(NW), 1)
ln_mlp_dx_tc_kernel(const __grid_constant__ CUtensorMap m_xn,
                    const __grid_constant__ CUtensorMap m_dy,
                    const __grid_constant__ CUtensorMap m_w1,
                    const __grid_constant__ CUtensorMap m_w2, const float* __restrict__ b1,
                    float* __restrict__ part, int t, int c, int hdim, int cblock, int cps,
                    int nchunks) {
  constexpr int kStage = mlptc::stage_bytes(NW, NWC), kStages = mlptc::stages(NW, NWC);
  constexpr int kDxBlocks = NW * NWC / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (wg::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t hbuf = base + kStages * kStage;  // dH of the chunk, 64 x 64 NW
  const uint32_t bars = hbuf + kTile * NW;        // kStages full, then kStages empty
  // the warpgroup index through a shuffle, so that the compiler sees it
  // warp-uniform and keeps the wgmma descriptors in uniform registers
  const int tid = threadIdx.x, wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int row0 = blockIdx.x * mlptc::kRows;
  const int c0 = blockIdx.y * cblock, ccap = min(c, c0 + cblock);
  const int ch0 = blockIdx.z * cps, nch = min(nchunks, ch0 + cps) - ch0;
  const int nk1 = (c + 63) / 64, tpc = 2 * nk1 + NW, ntiles = nch * tpc;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(bars + 8 * i, 1);
      wg::mbar_init(bars + 8 * (kStages + i), NW);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  // the producer: k-tile g is xn[:, 64 r..] and W1[64 r.., chunk] (hr) for
  // r < nk1; dY[:, 64 k..] and W2[chunk, 64 k..] (dA, k = r - nk1) for
  // r < 2 nk1; else W1[columns, chunk's 64 k..] (dXn, k = r - 2 nk1)
  if (wgi == NW) {
    if (tid == NW * 128) {
      for (int g = 0; g < ntiles; ++g) {
        const int s = g % kStages, h0 = (ch0 + g / tpc) * 64 * NW, r = g % tpc;
        const uint32_t st = base + s * kStage, full = bars + 8 * s;
        wg::mbar_wait(bars + 8 * (kStages + s), ((g / kStages) & 1) ^ 1);
        if (r < 2 * nk1) {
          const bool fc1 = r < nk1;
          const int k = 64 * (fc1 ? r : r - nk1);
          wg::mbar_expect_tx(full, kTile * (1 + NW));
          wg::tma_load(st, fc1 ? &m_xn : &m_dy, k, row0, full);
#pragma unroll
          for (int b = 0; b < NW; ++b) {
            if (fc1) wg::tma_load(st + kTile * (1 + b), &m_w1, h0 + 64 * b, k, full);
            else wg::tma_load(st + kTile * (1 + b), &m_w2, k, h0 + 64 * b, full);
          }
        } else {
          wg::mbar_expect_tx(full, kTile * kDxBlocks);
#pragma unroll
          for (int b = 0; b < kDxBlocks; ++b)
            wg::tma_load(st + kTile * b, &m_w1, h0 + 64 * (r - 2 * nk1), c0 + 64 * b, full);
        }
      }
    }
  } else {  // the consumers
    const int cw = wgi, lane = tid & 3;
    // k-tile g of the ring, as the producer counts them: wait for it, then
    // hand its stage back once this warpgroup's wgmma on it is done
    auto take = [&](int g) {
      wg::mbar_wait(bars + 8 * (g % kStages), (g / kStages) & 1);
      return base + (g % kStages) * kStage;
    };
    auto release = [&](int g) {
      wg::wait<0>();
      if ((tid & 127) == 0) wg::mbar_arrive(bars + 8 * (kStages + g % kStages));
    };
    float acc[NWC / 2], hr[32], da[32];
    __nv_bfloat162 hrp[16];  // hr, rounded to bf16 (exact) and packed
#pragma unroll
    for (int i = 0; i < NWC / 2; ++i) acc[i] = 0.f;
    int g = 0;
    for (int ch = 0; ch < nch; ++ch) {
      const int h0 = (ch0 + ch) * 64 * NW + 64 * cw;  // this warpgroup's units
      for (int k = 0; k < nk1; ++k, ++g) {  // hr = xn W1
        const uint32_t st = take(g);
        if (k == 0) mlptc::mma_tile<64, 1, true>(hr, st, st + kTile * (1 + cw));
        else mlptc::mma_tile<64, 1>(hr, st, st + kTile * (1 + cw));
        release(g);
      }
      wg::fence_regs(hr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // hr = round(xn W1 + b1)
          const int hj = h0 + 8 * j + 2 * lane;
          hrp[2 * j + i] = __floats2bfloat162_rn(
              hj < hdim ? hr[4 * j + 2 * i] + b1[hj] : 0.f,
              hj + 1 < hdim ? hr[4 * j + 2 * i + 1] + b1[hj + 1] : 0.f);
        }
      for (int k = 0; k < nk1; ++k, ++g) {  // dA = dY W2^T
        const uint32_t st = take(g);
        if (k == 0) mlptc::mma_tile<64, 0, true>(da, st, st + kTile * (1 + cw));
        else mlptc::mma_tile<64, 0>(da, st, st + kTile * (1 + cw));
        release(g);
      }
      wg::fence_regs(da);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          da[4 * j + 2 * i] *= tokbwd::gelu_grad(__low2float(hrp[2 * j + i]));
          da[4 * j + 2 * i + 1] *= tokbwd::gelu_grad(__high2float(hrp[2 * j + i]));
        }
      wg::bar_sync(1, NW * 128);  // every dXn of the last chunk is done with hbuf
      mlptc::store_hidden(da, hbuf + kTile * cw, h0,
                          [&](float v, int hj) { return hj < hdim ? v : 0.f; });
      wg::bar_sync(1, NW * 128);
      for (int k = 0; k < NW; ++k, ++g) {  // dXn += dH W1^T
        const uint32_t st = take(g);
        mlptc::mma_tile<NWC, 0>(acc, hbuf + kTile * k, st + NWC * 128 * cw);
        release(g);
      }
    }
    wg::fence_regs(acc);

    float* out = part + static_cast<size_t>(blockIdx.z) * t * c;
    mlptc::for_each_acc<NWC>(acc, row0, c0 + NWC * cw, [&](int row, int col, float v) {
      if (row < t && col < ccap) out[static_cast<size_t>(row) * c + col] = v;
    });
  }
}

template <int NW, int NWC>
int launch_dx_tc_kernel(const mlptc::Plan& p, const CUtensorMap (&maps)[4], const float* b1,
                        float* part, int t, int c, int hdim, cudaStream_t s) {
  constexpr int smem = mlptc::smem_bytes(NW, NWC);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_dx_tc_kernel<NW, NWC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.row_tiles, p.nblk, p.splits);
  ln_mlp_dx_tc_kernel<NW, NWC><<<grid, mlptc::threads(NW), smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], b1, part, t, c, hdim, p.cblock, p.cps, p.nchunks);
  return static_cast<int>(cudaGetLastError());
}

int launch_dx_bf16(const void* x, const float* g, const float* b, const void* w1,
                   const float* b1, const void* w2, const void* dy, void* dx, float* partial,
                   float* dgb, void* workspace, int t, int c, int hdim, float eps, int residual,
                   cudaStream_t s) {
  const mlptc::Plan p = mlptc::make_plan(t, c, hdim, true);
  const int cp = mlptc::round8(c), hp = mlptc::round8(hdim);
  char* ws = static_cast<char*>(workspace);
  bf16* xn = reinterpret_cast<bf16*>(ws);
  float* part = reinterpret_cast<float*>(ws + p.xn_bytes);
  cudaError_t err = mlptc::ln_rows(x, g, b, xn, t, c, cp, eps, 1, s);
  const void* dyk = dy;
  if (err == cudaSuccess && p.staged) {  // zero-padded copies of W1, W2 and dY
    void* w1p = ws + p.xn_bytes + p.part_bytes;
    void* w2p = static_cast<char*>(w1p) + p.w1_bytes;
    void* dyp = static_cast<char*>(w2p) + p.w2_bytes;
    err = cudaMemsetAsync(w1p, 0, p.w1_bytes + p.w2_bytes + p.dy_bytes, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(w1, w1p, c, hdim, hp, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(w2, w2p, hdim, c, cp, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(dy, dyp, t, c, cp, s);
    w1 = w1p;
    w2 = w2p;
    dyk = dyp;
  }
  const int lc = p.staged ? cp : c, lh = p.staged ? hp : hdim;
  CUtensorMap maps[4];
  if (err == cudaSuccess) err = mlptc::make_map(&maps[0], xn, t, c, cp);
  if (err == cudaSuccess) err = mlptc::make_map(&maps[1], dyk, t, c, lc);
  if (err == cudaSuccess) err = mlptc::make_map(&maps[2], w1, c, hdim, lh);
  if (err == cudaSuccess) err = mlptc::make_map(&maps[3], w2, hdim, c, lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  int status;
  const auto args = [&](auto launch) { return launch(p, maps, b1, part, t, c, hdim, s); };
  if (p.nw == 1 && p.nwc == 64) status = args(launch_dx_tc_kernel<1, 64>);
  else if (p.nw == 1 && p.nwc == 128) status = args(launch_dx_tc_kernel<1, 128>);
  else if (p.nw == 1 && p.nwc == 192) status = args(launch_dx_tc_kernel<1, 192>);
  else if (p.nw == 1 && p.nwc == 256) status = args(launch_dx_tc_kernel<1, 256>);
  else if (p.nw == 2 && p.nwc == 192) status = args(launch_dx_tc_kernel<2, 192>);
  else if (p.nw == 2 && p.nwc == 256) status = args(launch_dx_tc_kernel<2, 256>);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (status != 0) return status;
  if (c > kMaxC) {
    float2* stats = reinterpret_cast<float2*>(ws + p.total() - p.stats_bytes);
    return static_cast<int>(ln_bwd_wide<bf16>(part, p.splits, x, g, dy, dx, stats, partial, dgb,
                                              t, c, eps, residual, s));
  }
  return static_cast<int>(
      ln_bwd_pass(part, p.splits, x, g, dy, dx, partial, dgb, t, c, eps, residual, s));
}

int launch_dw_f32(const void* x, const float* g, const float* b, const void* w1, const float* b1,
                  const void* w2, const void* dy, float* partial, float* out, int t, int c,
                  int hdim, float eps, cudaStream_t s) {
  int groups = 0;
  const int status = dw_groups<float>(t, c, hdim, &groups);
  if (status != 0) return status;
  const dim3 grid((hdim + kHW - 1) / kHW, groups);
  dw_kernel<float>(c)<<<grid, kThreads, dw_smem_bytes(c), s>>>(
      static_cast<const float*>(x), g, b, static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), static_cast<const float*>(dy), partial, t, c, hdim, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = 2 * static_cast<size_t>(c) * hdim + hdim;
  return static_cast<int>(sum_partials(partial, out, groups, n, s));
}

// ---- dw in bf16: the tensor-core kernel ------------------------------------

// A CTA's tiles: hidden chunk j (64 units), dW column block cb (N columns
// of C), token split z (tps tiles of 64 rows). Per token tile, nk k-tiles
// of {xn, W1[k, chunk], dY, W2[chunk, k]} (the first products), then one of
// {xn[:, block], dY[:, block]} (the weight products).
struct DwPlan {
  int n, nblk;                // dW columns of a CTA (64, 96, 128 or 192); column blocks
  int chunks, tiles, tps, splits;
  bool staged;                // C or Hd not a multiple of 8: padded copies
  // workspace, in this order: xn (T x round8(C) bf16) and, when staged, the
  // padded W1 (C x round8(Hd)), W2 (Hd x round8(C)) and dY (T x round8(C))
  size_t xn_bytes, w1_bytes, w2_bytes, dy_bytes;
  size_t total() const { return xn_bytes + w1_bytes + w2_bytes + dy_bytes; }
};

inline DwPlan dw_plan(int t, int c, int hdim) {
  DwPlan p;
  p.nblk = (c + 191) / 192;
  const int per = (c + p.nblk - 1) / p.nblk;
  p.n = per <= 64 ? 64 : per <= 96 ? 96 : per <= 128 ? 128 : 192;
  p.chunks = (hdim + 63) / 64;
  p.tiles = (t + 63) / 64;
  // token splits: at least two waves of one CTA an SM, then up to four
  // times that many where whole waves take fewer modelled tile times (a
  // tile's four products at the 1.6 TFLOP/s a CTA reached at C = 384 on the
  // H100) plus the split's partial, written and read back at 3.35 TB/s
  const int base = p.chunks * p.nblk, nk = (c + 63) / 64;
  const double tile_s = 4.0 * 64 * 64 * (64.0 * nk + p.n) / 1.6e12;
  const double split_s = (2.0 * c * hdim + hdim) * 8 / 3.35e12;
  int s0 = (2 * kSMs + base - 1) / base;
  s0 = s0 < 1 ? 1 : (s0 > p.tiles ? p.tiles : s0);
  int sp = s0;
  double best = 0;
  for (int s = s0; s <= 4 * s0 && s <= p.tiles; ++s) {
    const double cost = static_cast<double>((base * s + kSMs - 1) / kSMs) *
                            ((p.tiles + s - 1) / s) * tile_s + s * split_s;
    if (s == s0 || cost < best) {
      best = cost;
      sp = s;
    }
  }
  p.tps = (p.tiles + sp - 1) / sp;
  p.splits = (p.tiles + p.tps - 1) / p.tps;
  p.staged = c % 8 != 0 || hdim % 8 != 0;
  const int cp = mlptc::round8(c), hp = mlptc::round8(hdim);
  p.xn_bytes = mlptc::round256(static_cast<size_t>(t) * cp * sizeof(bf16));
  p.w1_bytes = p.staged ? mlptc::round256(static_cast<size_t>(c) * hp * sizeof(bf16)) : 0;
  p.w2_bytes = p.staged ? mlptc::round256(static_cast<size_t>(hdim) * cp * sizeof(bf16)) : 0;
  p.dy_bytes = p.staged ? mlptc::round256(static_cast<size_t>(t) * cp * sizeof(bf16)) : 0;
  return p;
}

__host__ __device__ constexpr int dw_stage_bytes(int n) {
  return 2 * ((n + 63) / 64) > 4 ? 2 * ((n + 63) / 64) * kTile : 4 * kTile;
}
// the ring, then a^T, dH^T and the hr hand-over (8 KB each), then the mbarriers
__host__ __device__ constexpr int dw_stages(int n) {
  return (mlptc::kMaxSmem - 3 * kTile - 2048) / dw_stage_bytes(n) < 8
             ? (mlptc::kMaxSmem - 3 * kTile - 2048) / dw_stage_bytes(n)
             : 8;
}
__host__ __device__ constexpr int dw_tc_smem_bytes(int n) {
  return dw_stages(n) * dw_stage_bytes(n) + 3 * kTile + 2048;
}

// Stores a 64 token x 64 hidden fragment (f(j, i, e), already rounded, of
// accumulator 4 j + 2 i + e) transposed, as bf16, into the swizzled block
// at shared address blk: rows are hidden units, columns tokens, the K-major
// A operand of a product over tokens. Lanes l and l ^ 4 hold neighbouring
// tokens of the same units; one shuffle pairs them into a 32-bit store.
template <typename F>
__device__ __forceinline__ void store_transposed(uint32_t blk, F f) {
  const int lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
  const int odd = (lane >> 2) & 1;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v0 = f(j, i, 0), v1 = f(j, i, 1);
      const float other = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
      const int tok = (warp * 16 + (lane >> 2) + 8 * i) & ~1;
      const int hid = 8 * j + 2 * (lane & 3) + odd;
      const __nv_bfloat162 v = odd ? __floats2bfloat162_rn(other, v1)
                                   : __floats2bfloat162_rn(v0, other);
      wg::st_shared_b32(blk + wg::swz(hid, tok >> 3) + (tok & 7) * 2,
                        *reinterpret_cast<const uint32_t*>(&v));
    }
  wg::fence_proxy();
}

struct DwArgs {
  uint32_t base, at, dt, hx, bars;
  const float* b1;
  float* part;  // this split's [dW1 | dW2 | db1]
  int c, hdim, h0, c0, cb, ntile, nk;
};

// One consumer warpgroup of the dW kernel, over the CTA's token tiles.
// ROLE 0: hr = xn W1 (W1 the MN-major B), a = round(gelu(hr)), hands hr to
// warpgroup 1, dW2[chunk, block] += a^T dY[:, block]. ROLE 1: dA = dY W2^T
// (W2 the K-major B), dH = round(dA gelu'(hr)), dW1^T[chunk, block] +=
// dH^T xn[:, block], and db1. Both release every stage of the ring.
template <int N, int ROLE, int kStages, int kStage>
__device__ __forceinline__ void dw_consumer(const DwArgs& a) {
  constexpr int kB = (N + 63) / 64;
  const int lt = threadIdx.x & 127, lane = lt & 31;
  auto take = [&](int g) {
    wg::mbar_wait(a.bars + 8 * (g % kStages), (g / kStages) & 1);
    return a.base + (g % kStages) * kStage;
  };
  auto release = [&](int g) {
    wg::wait<0>();
    if (lt == 0) wg::mbar_arrive(a.bars + 8 * (kStages + g % kStages));
  };
  float acc[N / 2], hd[32];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  float db = 0.f;  // ROLE 1: sum of dH over tokens, unit lt / 2, tokens of half lt % 2
  int g = 0;
  for (int it = 0; it < a.ntile; ++it) {
    for (int k = 0; k < a.nk; ++k, ++g) {
      float part[32];  // this k-tile's product, added in f32 (see the header)
      const uint32_t st = take(g);
      if constexpr (ROLE == 0) mlptc::mma_tile<64, 1, true>(part, st, st + kTile);
      else mlptc::mma_tile<64, 0, true>(part, st + 2 * kTile, st + 3 * kTile);
      release(g);
      wg::fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) hd[i] = k == 0 ? part[i] : hd[i] + part[i];
    }
    uint32_t hp[16];  // hr = round(xn W1 + b1) as bf16 pairs, in fragment order
    if constexpr (ROLE == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int hj = a.h0 + 8 * j + 2 * (lane & 3);
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              hj < a.hdim ? hd[4 * j + 2 * i] + a.b1[hj] : 0.f,
              hj + 1 < a.hdim ? hd[4 * j + 2 * i + 1] + a.b1[hj + 1] : 0.f);
          hp[2 * j + i] = *reinterpret_cast<const uint32_t*>(&v);
        }
      if (it > 0) wg::bar_sync(2, 256);  // warpgroup 1 has read the last tile's hr
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wg::st_shared_v4(a.hx + (q * 128 + lt) * 16,
                         make_uint4(hp[4 * q], hp[4 * q + 1], hp[4 * q + 2], hp[4 * q + 3]));
      __threadfence_block();
      wg::bar_arrive(1, 256);
      store_transposed(a.at, [&](int j, int i, int e) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hp[2 * j + i]);
        return round_to<bf16>(tokbwd::gelu(e ? __high2float(h) : __low2float(h)));
      });
      wg::bar_sync(3, 128);  // a^T is complete
      const uint32_t st = take(g);
      mlptc::mma_tile<N, 1>(acc, a.at, st + kB * kTile);
      release(g);
      ++g;
    } else {
      wg::bar_sync(1, 256);  // hr of this tile has been handed over
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = wg::ld_shared_v4(a.hx + (q * 128 + lt) * 16);
        hp[4 * q] = v.x;
        hp[4 * q + 1] = v.y;
        hp[4 * q + 2] = v.z;
        hp[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hp[2 * j + i]);
          hd[4 * j + 2 * i] = round_to<bf16>(hd[4 * j + 2 * i] * tokbwd::gelu_grad(__low2float(h)));
          hd[4 * j + 2 * i + 1] =
              round_to<bf16>(hd[4 * j + 2 * i + 1] * tokbwd::gelu_grad(__high2float(h)));
        }
      if (it + 1 < a.ntile) wg::bar_arrive(2, 256);  // hr is read
      store_transposed(a.dt, [&](int j, int i, int e) { return hd[4 * j + 2 * i + e]; });
      wg::bar_sync(4, 128);  // dH^T is complete
      const uint32_t st = take(g);
      mlptc::mma_tile<N, 1>(acc, a.dt, st);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // db1, while the product runs
        const uint4 v = wg::ld_shared_v4(a.dt + wg::swz(lt >> 1, (lt & 1) * 4 + q));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
          db += __low2float(h) + __high2float(h);
        }
      }
      release(g);
      ++g;
    }
  }
  wg::fence_regs(acc);
  float* dw1 = a.part;
  float* dw2 = a.part + static_cast<size_t>(a.c) * a.hdim;
  mlptc::for_each_acc<N>(acc, 0, a.c0, [&](int row, int col, float v) {
    const int hj = a.h0 + row;
    if (hj >= a.hdim || col >= a.c) return;
    if constexpr (ROLE == 0) dw2[static_cast<size_t>(hj) * a.c + col] = v;
    else dw1[static_cast<size_t>(col) * a.hdim + hj] = v;
  });
  if constexpr (ROLE == 1) {
    db += __shfl_xor_sync(0xffffffffu, db, 1);
    const int hj = a.h0 + (lt >> 1);
    if (a.cb == 0 && (lt & 1) == 0 && hj < a.hdim)
      a.part[2 * static_cast<size_t>(a.c) * a.hdim + hj] = db;
  }
}

// One CTA: hidden chunk x / nblk, column block x % nblk, token split y;
// writes its [dW1 | dW2 | db1] region of split y's f32 partial. Warpgroups
// 0 and 1 consume; the first thread after them loads.
template <int N>
__global__ void __launch_bounds__(mlptc::threads(2), 1)
ln_mlp_dw_tc_kernel(const __grid_constant__ CUtensorMap m_xn,
                    const __grid_constant__ CUtensorMap m_dy,
                    const __grid_constant__ CUtensorMap m_w1,
                    const __grid_constant__ CUtensorMap m_w2, const float* __restrict__ b1,
                    float* __restrict__ part, int t, int c, int hdim, int nblk, int tps,
                    int tiles) {
  constexpr int kB = (N + 63) / 64, kStage = dw_stage_bytes(N), kStages = dw_stages(N);
  static_assert(kStages >= 2, "the ring holds at least two stages");
  extern __shared__ unsigned char smem_raw[];
  DwArgs a;
  a.base = (wg::smem_addr(smem_raw) + 1023) & ~1023u;
  a.at = a.base + kStages * kStage;
  a.dt = a.at + kTile;
  a.hx = a.dt + kTile;
  a.bars = a.hx + kTile;  // kStages full, then kStages empty
  const int tid = threadIdx.x, wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  a.cb = blockIdx.x % nblk;
  a.h0 = 64 * (blockIdx.x / nblk);
  a.c0 = N * a.cb;
  const int tile0 = blockIdx.y * tps;
  a.ntile = min(tiles, tile0 + tps) - tile0;
  a.nk = (c + 63) / 64;
  a.b1 = b1;
  a.part = part + static_cast<size_t>(blockIdx.y) * (2 * static_cast<size_t>(c) * hdim + hdim);
  a.c = c;
  a.hdim = hdim;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(a.bars + 8 * i, 1);
      wg::mbar_init(a.bars + 8 * (kStages + i), 2);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 2) {  // the producer
    if (tid == 256) {
      const int tpt = a.nk + 1, ntiles = a.ntile * tpt;
      for (int g = 0; g < ntiles; ++g) {
        const int s = g % kStages, row0 = 64 * (tile0 + g / tpt), r = g % tpt;
        const uint32_t st = a.base + s * kStage, full = a.bars + 8 * s;
        wg::mbar_wait(a.bars + 8 * (kStages + s), ((g / kStages) & 1) ^ 1);
        if (r < a.nk) {
          wg::mbar_expect_tx(full, 4 * kTile);
          wg::tma_load(st, &m_xn, 64 * r, row0, full);
          wg::tma_load(st + kTile, &m_w1, a.h0, 64 * r, full);
          wg::tma_load(st + 2 * kTile, &m_dy, 64 * r, row0, full);
          wg::tma_load(st + 3 * kTile, &m_w2, 64 * r, a.h0, full);
        } else {
          wg::mbar_expect_tx(full, 2 * kB * kTile);
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            wg::tma_load(st + kTile * b, &m_xn, a.c0 + 64 * b, row0, full);
            wg::tma_load(st + kTile * (kB + b), &m_dy, a.c0 + 64 * b, row0, full);
          }
        }
      }
    }
    return;
  }
  if (wgi == 0) dw_consumer<N, 0, kStages, kStage>(a);
  else dw_consumer<N, 1, kStages, kStage>(a);
}

template <int N>
int launch_dw_tc_kernel(const DwPlan& p, const CUtensorMap (&maps)[4], const float* b1,
                        float* part, int t, int c, int hdim, cudaStream_t s) {
  constexpr int smem = dw_tc_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_dw_tc_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.chunks * p.nblk, p.splits);
  ln_mlp_dw_tc_kernel<N><<<grid, mlptc::threads(2), smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], b1, part, t, c, hdim, p.nblk, p.tps, p.tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_bf16(const void* x, const float* g, const float* b, const void* w1,
                   const float* b1, const void* w2, const void* dy, float* partial, float* out,
                   void* workspace, int t, int c, int hdim, float eps, cudaStream_t s) {
  const DwPlan p = dw_plan(t, c, hdim);
  const int cp = mlptc::round8(c), hp = mlptc::round8(hdim);
  char* ws = static_cast<char*>(workspace);
  bf16* xn = reinterpret_cast<bf16*>(ws);
  cudaError_t err = mlptc::ln_rows(x, g, b, xn, t, c, cp, eps, 1, s);
  if (err == cudaSuccess && p.staged) {  // zero-padded copies of W1, W2 and dY
    void* w1p = ws + p.xn_bytes;
    void* w2p = static_cast<char*>(w1p) + p.w1_bytes;
    void* dyp = static_cast<char*>(w2p) + p.w2_bytes;
    err = cudaMemsetAsync(w1p, 0, p.w1_bytes + p.w2_bytes + p.dy_bytes, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(w1, w1p, c, hdim, hp, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(w2, w2p, hdim, c, cp, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(dy, dyp, t, c, cp, s);
    w1 = w1p;
    w2 = w2p;
    dy = dyp;
  }
  const int lc = p.staged ? cp : c, lh = p.staged ? hp : hdim;
  CUtensorMap maps[4];
  if (err == cudaSuccess) err = mlptc::make_map(&maps[0], xn, t, c, cp);
  if (err == cudaSuccess) err = mlptc::make_map(&maps[1], dy, t, c, lc);
  if (err == cudaSuccess) err = mlptc::make_map(&maps[2], w1, c, hdim, lh);
  if (err == cudaSuccess) err = mlptc::make_map(&maps[3], w2, hdim, c, lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto args = [&](auto launch) { return launch(p, maps, b1, partial, t, c, hdim, s); };
  int status;
  if (p.n == 64) status = args(launch_dw_tc_kernel<64>);
  else if (p.n == 96) status = args(launch_dw_tc_kernel<96>);
  else if (p.n == 128) status = args(launch_dw_tc_kernel<128>);
  else status = args(launch_dw_tc_kernel<192>);
  if (status != 0) return status;
  const size_t n = 2 * static_cast<size_t>(c) * hdim + hdim;
  return static_cast<int>(sum_partials(partial, out, p.splits, n, s));
}

}  // namespace

// Partials of the dx kernel's dgamma/dbeta sums (its grid's blocks, its
// pass's blocks in bf16, ln_bwd_wide's runs past kMaxC) and token groups of
// the dw grid (bf16: token splits): the wrapper sizes the partials with them
// (groups x 2 x C, and groups x (2 C Hd + Hd), f32).
TT_EXPORT int tt_ln_mlp_bwd_dx_groups(int t, int c, int is_bf16) {
  if (c > kMaxC) return wide_groups(t, c);
  return is_bf16 ? pass_groups(t) : row_groups(t);
}
// tt_ln_mlp_bwd_dw_groups returns the group count, or -1 when the float32
// occupancy query fails (the launch then reports the error).
TT_EXPORT int tt_ln_mlp_bwd_dw_groups(int t, int c, int hdim, int is_bf16) {
  if (is_bf16) return dw_plan(t, c, hdim).splits;
  int groups = 0;
  const int status = c > kMaxC ? dw_wide_groups(t, c, hdim, &groups)
                               : dw_groups<float>(t, c, hdim, &groups);
  return status == 0 ? groups : -1;
}

// Bytes of workspace tt_ln_mlp_bwd_dx needs: in bf16 xn, the f32 dXn
// partials and, for widths that are not multiples of 8, padded copies of
// W1, W2 and dY; past kMaxC also the rows' statistics, and in float32 xn
// and dXn (none up to kMaxC).
TT_EXPORT long long tt_ln_mlp_bwd_dx_workspace(int t, int c, int hdim, int is_bf16) {
  if (is_bf16) return static_cast<long long>(mlptc::make_plan(t, c, hdim, true).total());
  if (c <= kMaxC) return 0;
  return static_cast<long long>(2 * wide_rows_bytes(t, c) + tokbwd::stats_bytes(t));
}

// Bytes of workspace tt_ln_mlp_bwd_dw needs: in bf16 xn and, for widths
// that are not multiples of 8, padded copies of W1, W2 and dY; in float32
// past kMaxC xn (none up to kMaxC).
TT_EXPORT long long tt_ln_mlp_bwd_dw_workspace(int t, int c, int hdim, int is_bf16) {
  if (is_bf16) return static_cast<long long>(dw_plan(t, c, hdim).total());
  return c <= kMaxC ? 0 : static_cast<long long>(wide_rows_bytes(t, c));
}

// dgb receives [dgamma | dbeta] (2 x C f32); residual adds dY to dX. Any C.
TT_EXPORT int tt_ln_mlp_bwd_dx(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* dy,
                               void* dx, void* partial, void* dgb, void* workspace, int t, int c,
                               int hdim, float eps, int residual, int is_bf16, void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* bb1 = static_cast<const float*>(b1);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(dgb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dx_bf16(x, g, b, w1, bb1, w2, dy, dx, part, out, workspace, t, c, hdim, eps,
                          residual, s);
  if (c > kMaxC)
    return launch_dx_f32_wide(x, g, b, w1, bb1, w2, dy, dx, part, out, workspace, t, c, hdim,
                              eps, residual, s);
  return launch_dx_f32(x, g, b, w1, bb1, w2, dy, dx, part, out, t, c, hdim, eps, residual, s);
}

// out receives [dW1 (C x Hd) | dW2 (Hd x C) | db1 (Hd)], f32. Any C.
TT_EXPORT int tt_ln_mlp_bwd_dw(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* dy,
                               void* partial, void* out, void* workspace, int t, int c, int hdim,
                               float eps, int is_bf16, void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* bb1 = static_cast<const float*>(b1);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dw_bf16(x, g, b, w1, bb1, w2, dy, part, o, workspace, t, c, hdim, eps, s);
  if (c > kMaxC)
    return launch_dw_f32_wide(x, g, b, w1, bb1, w2, dy, part, o, workspace, t, c, hdim, eps, s);
  return launch_dw_f32(x, g, b, w1, bb1, w2, dy, part, o, t, c, hdim, eps, s);
}
