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
// by operations).
//
// bf16 (the flagged training step) runs on wgmma in two passes, the "f32
// round trip" design:
// - dXn = dY W^T as a TMA + wgmma GEMM (wgmma.cuh, mlp_tc.cuh's maps and
//   mma_tile): a CTA of 64 NW token rows (NW = 1 or 2 consumer warpgroups,
//   64 rows each) x N dXn columns; one producer thread loads, per 64-deep
//   k-tile of O, the NW dY tiles (the K-major A) and N / 64 blocks of W's
//   rows (W (C, O) row-major is the K-major B of dY W^T: no transposed
//   copy) into a ring of mbarrier-guarded stages; the consumers run wgmma
//   m64nNk16 into an f32 register tile and write it as an f32 partial of
//   dXn. K past O (O = 120: the second k-tile's last 8) and rows of W past
//   C read zeros. N is the width of {256, 192, 128, 96, 64} that computes the
//   fewest columns past C (C = 96: 96; 192, 384: 192; 768: 256); NW = 2
//   where 128-row CTAs fill two waves of the 132 SMs (stage 1 of the
//   flagged step: 784 CTAs), else NW = 1 with two CTAs an SM, and O is
//   split over CTAs where the grid would still not fill two waves, each
//   split writing its own partial (stage 3: 98 x 2 column blocks x 2
//   splits; stage 4: 25 x 3 x 4).
// - token_bwd.cuh's ln_bwd_pass, which kernel 10 shares, adds the partials
//   in split order and applies the LN backward: a warp a row, dX in bf16,
//   deterministic dgamma/dbeta partials added in block order.
// The dXn round trip costs 8*T*C bytes a split more than a fused epilogue
// would (540 MB, 0.16 ms at 3.35 TB/s per flagged step); it keeps
// one LN-backward pass for kernels 9 and 10, and every width takes the same
// GEMM (a fused epilogue would not fit C = 768's 64 x 768 f32 tile in one
// warpgroup's registers; C = 1024 and 1536 take four and six blocks of
// 256); past kMaxC (768) the pass is token_bwd.cuh's ln_bwd_wide. dXn is
// not rounded before the sums over tokens, so summing a k-tile after
// another inside wgmma keeps dgamma/dbeta within f32 noise of the plain
// version. O not a multiple of 8 (TMA's 16-byte row stride) reads W and dY
// from zero-padded copies in the workspace.
//
// float32 (the card-vs-CPU parity step) keeps the scalar kernel below: TF32
// tensor cores keep 10 mantissa bits and would not hold the 1e-4 float32
// checks. A persistent grid of one 256-thread block per SM walks row blocks
// of 32 rows; per row block the block streams O in chunks of 16, dY rows
// and W^T through shared memory, into a 32 x C register tile (2 rows x 48
// columns a thread); the tile goes to shared memory, where one warp per row
// applies the LN backward and one thread per column adds its dgamma/dbeta
// terms, up to C = 768 (kMaxC). Wider rows (swin_base's and swin_large's
// stage 4) take ln_matmul_dxn_wide_kernel: the same register tile over
// column chunks of 768, dXn to an f32 workspace, then ln_bwd_wide.
#include "mlp_tc.cuh"

namespace {

using namespace tokbwd;

constexpr int kBK = 16;  // chunk of the contraction over O

__host__ __device__ inline int ncol_pad(int c) { return (c + 63) / 64 * 64; }

size_t smem_bytes(int c) {
  const int ldw = ncol_pad(c) + 4;
  return sizeof(float) * (static_cast<size_t>(kBK) * ldw + static_cast<size_t>(kBM) * (c + 4) +
                          kBM * (kBK + 1) + 2 * static_cast<size_t>(c) + 2 * kBM);
}

// acc = dY[row0 : row0 + kBM, :] W[c0 : c0 + ncol, :]^T (ncol a multiple of
// 64, at most kMaxC; columns past C read zeros): thread (ty, tx) holds rows
// ty and ty + 16, columns 64 g + 4 tx + e. O streams through shared memory
// in chunks of kBK: Ys (kBM x (kBK + 1)) and Ws (kBK x (ncol + 4)).
template <typename T>
__device__ __forceinline__ void dyw_tile(RowTile& acc, const T* __restrict__ dy,
                                         const T* __restrict__ w, float* Ys, float* Ws,
                                         int row0, int t, int c, int c0, int ncol, int o) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ldw = ncol + 4, ngroups = ncol / 64;
  zero_tile(acc);

  for (int o0 = 0; o0 < o; o0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int row = row0 + r, oo = o0 + kk;
      Ys[r * (kBK + 1) + kk] =
          (row < t && oo < o) ? to_f32(dy[static_cast<size_t>(row) * o + oo]) : 0.f;
    }
    for (int i = tid; i < ncol * kBK; i += kThreads) {
      const int cc = i / kBK, kk = i % kBK, oo = o0 + kk;
      Ws[kk * ldw + cc] =
          (c0 + cc < c && oo < o) ? to_f32(w[static_cast<size_t>(c0 + cc) * o + oo]) : 0.f;
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

    RowTile acc;
    dyw_tile(acc, dy, w, Ys, Ws, row0, t, c, 0, ncol, o);

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

int launch_f32(const void* x, const float* g, const void* w, const void* dy, void* dx,
               float* partial, float* dgb, int t, int c, int o, float eps, cudaStream_t s) {
  const size_t smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_bwd_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = row_groups(t);
  ln_matmul_bwd_kernel<float><<<groups, kThreads, smem, s>>>(
      static_cast<const float*>(x), g, static_cast<const float*>(w),
      static_cast<const float*>(dy), static_cast<float*>(dx), partial, t, c, o, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_partials(partial, dgb, groups, 2 * static_cast<size_t>(c), s));
}

// ---- float32 past kMaxC -------------------------------------------------------
//
// dXn = dY W^T in column chunks of kMaxC, a CTA a (row block, chunk) of the
// same register tile, written to an f32 workspace; token_bwd.cuh's
// ln_bwd_wide then applies the LN backward.

size_t wide_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBK) * (kMaxC + 4) + kBM * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ln_matmul_dxn_wide_kernel(const T* __restrict__ w, const T* __restrict__ dy,
                          float* __restrict__ part, int t, int c, int o) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * kBM, c0 = blockIdx.y * kMaxC;
  const int ncol = ncol_pad(min(kMaxC, c - c0));
  float* Ws = smem;
  float* Ys = Ws + kBK * (ncol + 4);
  RowTile acc;
  dyw_tile(acc, dy, w, Ys, Ws, row0, t, c, c0, ncol, o);
  store_tile(acc, part, row0, t, c, c0, ncol / 64);
}

// The wide float32 workspace: dXn (T x C f32), then the rows' statistics.
size_t wide_part_bytes(int t, int c) {
  return (static_cast<size_t>(t) * c * sizeof(float) + 255) / 256 * 256;
}

int launch_f32_wide(const void* x, const float* g, const void* w, const void* dy, void* dx,
                    float* partial, float* dgb, void* workspace, int t, int c, int o, float eps,
                    cudaStream_t s) {
  float* part = static_cast<float*>(workspace);
  float2* stats = reinterpret_cast<float2*>(static_cast<char*>(workspace) + wide_part_bytes(t, c));
  const size_t smem = wide_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_dxn_wide_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kBM - 1) / kBM, (c + kMaxC - 1) / kMaxC);
  ln_matmul_dxn_wide_kernel<float><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(dy), part, t, c, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      ln_bwd_wide<float>(part, 1, x, g, nullptr, dx, stats, partial, dgb, t, c, eps, 0, s));
}

// ---- bf16: dXn = dY W^T on the tensor cores --------------------------------

using mlptc::bf16;
using mlptc::kTile;

__host__ __device__ constexpr int b_blocks(int n) { return (n + 63) / 64; }
__host__ __device__ constexpr int dxn_stage_bytes(int nw, int n) {
  return (nw + b_blocks(n)) * kTile;
}
// NW = 1 keeps to half the SM's shared memory (and ptxas to half its
// registers), so that two CTAs share an SM
__host__ __device__ constexpr int dxn_min_blocks(int nw) { return nw == 1 ? 2 : 1; }
__host__ __device__ constexpr int dxn_stages(int nw, int n) {
  return (mlptc::kMaxSmem / dxn_min_blocks(nw) - 2048) / dxn_stage_bytes(nw, n) < 8
             ? (mlptc::kMaxSmem / dxn_min_blocks(nw) - 2048) / dxn_stage_bytes(nw, n)
             : 8;
}
__host__ __device__ constexpr int dxn_smem_bytes(int nw, int n) {
  return dxn_stages(nw, n) * dxn_stage_bytes(nw, n) + 2048;
}

// One CTA: rows [64 NW x, +64 NW), dXn columns [N y, +N) (capped at C),
// k-tiles [kps z, +kps) of O; writes its block of split z's f32 partial.
// Warpgroups 0..NW - 1 multiply (warpgroup w: rows +64 w); the first thread
// after them loads.
template <int NW, int N>
__global__ void __launch_bounds__(mlptc::threads(NW), dxn_min_blocks(NW))
ln_matmul_dxn_tc_kernel(const __grid_constant__ CUtensorMap m_dy,
                        const __grid_constant__ CUtensorMap m_w, float* __restrict__ part,
                        int t, int c, int nk, int kps) {
  constexpr int kB = b_blocks(N), kStage = dxn_stage_bytes(NW, N),
                kStages = dxn_stages(NW, N);
  static_assert(kStages >= 2, "the ring holds at least two stages");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (wg::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + kStages * kStage;  // kStages full, then kStages empty
  // the warpgroup index through a shuffle, so that the compiler sees it
  // warp-uniform and keeps the wgmma descriptors in uniform registers
  const int tid = threadIdx.x, wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int row0 = blockIdx.x * 64 * NW, col0 = blockIdx.y * N;
  const int k0 = blockIdx.z * kps, nkt = min(nk, k0 + kps) - k0;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(bars + 8 * i, 1);
      wg::mbar_init(bars + 8 * (kStages + i), NW);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (wgi == NW) {  // the producer: k-tile g is dY[rows, 64 (k0 + g)..] and W[columns, same]
    if (tid == NW * 128) {
      for (int g = 0; g < nkt; ++g) {
        const int s = g % kStages, k = 64 * (k0 + g);
        const uint32_t st = base + s * kStage, full = bars + 8 * s;
        wg::mbar_wait(bars + 8 * (kStages + s), ((g / kStages) & 1) ^ 1);
        wg::mbar_expect_tx(full, kStage);
#pragma unroll
        for (int b = 0; b < NW; ++b) wg::tma_load(st + kTile * b, &m_dy, k, row0 + 64 * b, full);
#pragma unroll
        for (int b = 0; b < kB; ++b)
          wg::tma_load(st + kTile * (NW + b), &m_w, k, col0 + 64 * b, full);
      }
    }
    return;
  }

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int g = 0; g < nkt; ++g) {
    const int s = g % kStages;
    const uint32_t st = base + s * kStage;
    wg::mbar_wait(bars + 8 * s, (g / kStages) & 1);
    mlptc::mma_tile<N, 0>(acc, st + kTile * wgi, st + kTile * NW);
    wg::wait<0>();
    if ((tid & 127) == 0) wg::mbar_arrive(bars + 8 * (kStages + s));
  }
  wg::fence_regs(acc);

  // the fragment's column pairs straight to the partial: 8 bytes a store
  // where C is even, as two floats where it is not
  float* out = part + static_cast<size_t>(blockIdx.z) * t * c;
  const int lt = tid & 127, warp = lt >> 5, lane = lt & 31;
  const int ccap = min(c, col0 + N);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 64 * wgi + warp * 16 + (lane >> 2) + 8 * i;
      const int col = col0 + 8 * j + 2 * (lane & 3);
      if (row >= t || col >= ccap) continue;
      float* dst = out + static_cast<size_t>(row) * c + col;
      if (col + 1 < ccap && (c & 1) == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      } else {
        dst[0] = acc[4 * j + 2 * i];
        if (col + 1 < ccap) dst[1] = acc[4 * j + 2 * i + 1];
      }
    }
}

// The tile shape of a call and its workspace: the f32 dXn partials (splits x
// T x C) and, when O is not a multiple of 8, W and dY zero-padded to
// round8(O) columns.
struct DxnPlan {
  int n, nw, nblk, row_tiles, nk, kps, splits;
  bool staged;
  size_t part_bytes, w_bytes, dy_bytes, stats_bytes;
  size_t total() const { return part_bytes + w_bytes + dy_bytes + stats_bytes; }
};

inline DxnPlan dxn_plan(int t, int c, int o) {
  DxnPlan p;
  const int widths[5] = {256, 192, 128, 96, 64};
  p.n = 256;
  for (int n : widths)  // the fewest columns computed past C; ties keep the wider
    if ((c + n - 1) / n * n < (c + p.n - 1) / p.n * p.n) p.n = n;
  p.nblk = (c + p.n - 1) / p.n;
  p.nk = (o + 63) / 64;
  p.nw = (t + 127) / 128 * p.nblk >= 2 * mlptc::kSMs ? 2 : 1;
  p.row_tiles = (t + 64 * p.nw - 1) / (64 * p.nw);
  const int base = p.row_tiles * p.nblk;
  int s = (2 * mlptc::kSMs + base - 1) / base;
  s = s < 1 ? 1 : (s > p.nk ? p.nk : s);
  p.kps = (p.nk + s - 1) / s;
  p.splits = (p.nk + p.kps - 1) / p.kps;
  p.staged = o % 8 != 0;
  const int op = mlptc::round8(o);
  p.part_bytes = mlptc::round256(static_cast<size_t>(p.splits) * t * c * sizeof(float));
  p.w_bytes = p.staged ? mlptc::round256(static_cast<size_t>(c) * op * sizeof(bf16)) : 0;
  p.dy_bytes = p.staged ? mlptc::round256(static_cast<size_t>(t) * op * sizeof(bf16)) : 0;
  p.stats_bytes = c > kMaxC ? tokbwd::stats_bytes(t) : 0;  // ln_bwd_wide's
  return p;
}

template <int NW, int N>
int launch_dxn_kernel(const DxnPlan& p, const CUtensorMap& m_dy, const CUtensorMap& m_w,
                      float* part, int t, int c, cudaStream_t s) {
  constexpr int smem = dxn_smem_bytes(NW, N);
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_dxn_tc_kernel<NW, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.row_tiles, p.nblk, p.splits);
  ln_matmul_dxn_tc_kernel<NW, N><<<grid, mlptc::threads(NW), smem, s>>>(m_dy, m_w, part, t, c,
                                                                      p.nk, p.kps);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const float* g, const void* w, const void* dy, void* dx,
                float* partial, float* dgb, void* workspace, int t, int c, int o, float eps,
                cudaStream_t s) {
  const DxnPlan p = dxn_plan(t, c, o);
  const int op = mlptc::round8(o);
  char* ws = static_cast<char*>(workspace);
  float* part = reinterpret_cast<float*>(ws);
  cudaError_t err = cudaSuccess;
  const void* dyk = dy;
  if (p.staged) {  // zero-padded copies of W and dY
    void* wp = ws + p.part_bytes;
    void* dyp = static_cast<char*>(wp) + p.w_bytes;
    err = cudaMemsetAsync(wp, 0, p.w_bytes + p.dy_bytes, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(w, wp, c, o, op, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(dy, dyp, t, o, op, s);
    w = wp;
    dyk = dyp;
  }
  const int lo = p.staged ? op : o;
  CUtensorMap m_dy, m_w;
  if (err == cudaSuccess) err = mlptc::make_map(&m_dy, dyk, t, o, lo);
  if (err == cudaSuccess) err = mlptc::make_map(&m_w, w, c, o, lo);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto args = [&](auto launch) { return launch(p, m_dy, m_w, part, t, c, s); };
  int status;
  if (p.nw == 1) {
    if (p.n == 64) status = args(launch_dxn_kernel<1, 64>);
    else if (p.n == 96) status = args(launch_dxn_kernel<1, 96>);
    else if (p.n == 128) status = args(launch_dxn_kernel<1, 128>);
    else if (p.n == 192) status = args(launch_dxn_kernel<1, 192>);
    else status = args(launch_dxn_kernel<1, 256>);
  } else {
    if (p.n == 64) status = args(launch_dxn_kernel<2, 64>);
    else if (p.n == 96) status = args(launch_dxn_kernel<2, 96>);
    else if (p.n == 128) status = args(launch_dxn_kernel<2, 128>);
    else if (p.n == 192) status = args(launch_dxn_kernel<2, 192>);
    else status = args(launch_dxn_kernel<2, 256>);
  }
  if (status != 0) return status;
  if (c > kMaxC) {
    float2* stats = reinterpret_cast<float2*>(ws + p.part_bytes + p.w_bytes + p.dy_bytes);
    return static_cast<int>(
        ln_bwd_wide<bf16>(part, p.splits, x, g, nullptr, dx, stats, partial, dgb, t, c, eps, 0, s));
  }
  return static_cast<int>(
      ln_bwd_pass(part, p.splits, x, g, nullptr, dx, partial, dgb, t, c, eps, 0, s));
}

}  // namespace

// Partials of the LN backward's dgamma/dbeta sums (the grid's blocks, its
// pass's blocks in bf16, ln_bwd_wide's runs past kMaxC): the wrapper sizes
// them (groups x 2 x C f32).
TT_EXPORT int tt_ln_bwd_groups(int t, int c, int is_bf16) {
  if (c > kMaxC) return wide_groups(t, c);
  return is_bf16 ? pass_groups(t) : row_groups(t);
}

// Bytes of workspace tt_ln_matmul_bwd needs: in bf16 the f32 dXn partials
// and, for O not a multiple of 8, padded copies of W and dY; past kMaxC
// also the rows' statistics, and in float32 dXn (none up to kMaxC).
TT_EXPORT long long tt_ln_matmul_bwd_workspace(int t, int c, int o, int is_bf16) {
  if (is_bf16) return static_cast<long long>(dxn_plan(t, c, o).total());
  if (c <= kMaxC) return 0;
  return static_cast<long long>(wide_part_bytes(t, c) + tokbwd::stats_bytes(t));
}

// dgb receives [dgamma | dbeta] (2 x C f32), at any C.
TT_EXPORT int tt_ln_matmul_bwd(const void* x, const void* gamma, const void* w, const void* dy,
                               void* dx, void* partial, void* dgb, void* workspace, int t, int c,
                               int o, float eps, int is_bf16, void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(dgb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_bf16(x, g, w, dy, dx, part, out, workspace, t, c, o, eps, s);
  return c > kMaxC ? launch_f32_wide(x, g, w, dy, dx, part, out, workspace, t, c, o, eps, s)
                   : launch_f32(x, g, w, dy, dx, part, out, t, c, o, eps, s);
}
