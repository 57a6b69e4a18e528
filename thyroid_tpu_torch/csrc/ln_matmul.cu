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
// accumulation, + b in f32 (PatchMerging's reduction has none), and the
// result rounded once to the compute type.
//
// Bound on the H100: 2*C*O operations per row for (C + O) elements moved,
// 2*C*O / (2*(C + O)) operations per byte in bf16. At the QKV projection
// (O = 3C) that is 72 at C = 96 and 144 at C = 192, below the card's ~295:
// stage 1 and 2 are bound by bytes, above all by the T x 3C output (57.8 MB
// per stage-1 call at bucket 32); C = 384 (288) sits at the line and C =
// 768 (576) and the wide merges are bound by operations.
//
// bf16 (the served path) runs on wgmma (mlp_tc.cuh, wgmma.cuh): a pass
// (mlptc::ln_rows, the forward's rounding) writes the normalised rows xn in
// bf16 to the workspace; then a CTA of 64 NW token rows (NW = 1 or 2 consumer
// warpgroups, 64 rows each) x N output columns has one producer thread load,
// per 64-deep k-tile, the NW xn tiles and the N / 64 W blocks by TMA (128-byte
// swizzle; W read as the MN-major B, never transposed) into a ring of stages
// guarded by mbarriers, while the consumers run wgmma m64nNk16 into an f32
// register tile. K past C (C = 96: the second k-tile's last 32) and columns
// past O read zeros. The epilogue adds b in f32, rounds once to bf16, stages
// the tile in the (then idle) ring and writes it out in 16-byte row pieces. N
// is the width of {256, 192, 128, 96, 64} that computes the fewest columns past
// O (O = 288: 3 x 96; 576, 1152: 192; 2304, 768, 1536, 4608: 256; 384, 192:
// 192); NW = 2 (128 rows, W blocks shared by both warpgroups) where the grid
// still fills two waves of the 132 SMs, else 1. Budget at N = 256, the width of
// C = 768's QKV (O = 2304), of C = 1536's (O = 4608) and of the 3072 -> 1536
// merge: 128 f32 accumulator registers a thread; NW = 2, 4 stages of 48 KB =
// 194 KB of shared memory, one CTA of 288 threads an SM, 168 registers (ptxas,
// no spill); NW = 1 (C = 768 at bucket 32: 117 CTAs of 128 rows would not fill
// two waves), 5 stages of 40 KB, 255 registers, no spill. The K loop takes any
// C (24 k-tiles at 1536, 48 at swin_large's 3072-wide merge). N <= 128: stages
// of 16-32 KB within half the SM's shared memory and at most 64 accumulators,
// two CTAs an SM.
// Widths O that are not multiples of 8 (TMA's 16-byte row stride) read W
// from a zero-padded copy in the workspace.
//
// float32 (the card-vs-CPU parity path) stays on the scalar kernel below:
// TF32 tensor cores keep 10 mantissa bits and would not hold the 1e-4
// float32 checks. A 64 x 64 output tile per block of 256 threads, each
// thread a 4 x 4 register tile of f32 FMAs; the block computes the LN
// statistics of its 64 rows, then streams K in chunks of 16, normalising
// the x chunk on its way into shared memory.
#include "mlp_tc.cuh"

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

int launch_f32(const void* x, const float* g, const float* b, const void* w, const float* wb,
               void* y, int t, int c, int o, float eps, cudaStream_t s) {
  const dim3 grid((t + kBM - 1) / kBM, (o + kBN - 1) / kBN);
  ln_matmul_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), g, b,
                                                    static_cast<const float*>(w), wb,
                                                    static_cast<float*>(y), t, c, o, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: the tensor-core kernel ------------------------------------------

using mlptc::bf16;
using mlptc::kTile;

__host__ __device__ constexpr int b_blocks(int n) { return (n + 63) / 64; }
__host__ __device__ constexpr int tc_stage_bytes(int nw, int n) {
  return (nw + b_blocks(n)) * kTile;
}
// N <= 128 keeps to half the SM's shared memory (and ptxas to half its
// registers), so that two CTAs share an SM
__host__ __device__ constexpr int tc_min_blocks(int n) { return n <= 128 ? 2 : 1; }
__host__ __device__ constexpr int tc_stages(int nw, int n) {
  return (mlptc::kMaxSmem / tc_min_blocks(n) - 2048) / tc_stage_bytes(nw, n) < 8
             ? (mlptc::kMaxSmem / tc_min_blocks(n) - 2048) / tc_stage_bytes(nw, n)
             : 8;
}
__host__ __device__ constexpr int tc_smem_bytes(int nw, int n) {
  return tc_stages(nw, n) * tc_stage_bytes(nw, n) + 2048;
}

// One CTA: rows [64 NW y, +64 NW), output columns [N x, +N). Warpgroups
// 0..NW - 1 multiply (warpgroup w: rows +64 w); the first thread after them
// loads.
template <int NW, int N>
__global__ void __launch_bounds__(mlptc::threads(NW), tc_min_blocks(N))
ln_matmul_tc_kernel(const __grid_constant__ CUtensorMap m_xn,
                    const __grid_constant__ CUtensorMap m_w, const float* __restrict__ wb,
                    bf16* __restrict__ y, int t, int c, int o, int vec) {
  constexpr int kB = b_blocks(N), kStage = tc_stage_bytes(NW, N), kStages = tc_stages(NW, N);
  constexpr int kPitch = (N + 8) * 2;  // bytes of a staged output row
  static_assert(kStages >= 2 && kStages * kStage >= NW * 64 * kPitch,
                "the ring holds at least two stages and the staged output tile");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (wg::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + kStages * kStage;  // kStages full, then kStages empty
  // the warpgroup index through a shuffle, so that the compiler sees it
  // warp-uniform and keeps the wgmma descriptors in uniform registers
  const int tid = threadIdx.x, wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int col0 = blockIdx.x * N, row0 = blockIdx.y * 64 * NW;
  const int nk = (c + 63) / 64;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(bars + 8 * i, 1);
      wg::mbar_init(bars + 8 * (kStages + i), NW);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (wgi == NW) {  // the producer: k-tile g is xn[rows, 64 g..] and W[64 g.., columns]
    if (tid == NW * 128) {
      for (int g = 0; g < nk; ++g) {
        const int s = g % kStages;
        const uint32_t st = base + s * kStage, full = bars + 8 * s;
        wg::mbar_wait(bars + 8 * (kStages + s), ((g / kStages) & 1) ^ 1);
        wg::mbar_expect_tx(full, kStage);
#pragma unroll
        for (int b = 0; b < NW; ++b)
          wg::tma_load(st + kTile * b, &m_xn, 64 * g, row0 + 64 * b, full);
#pragma unroll
        for (int b = 0; b < kB; ++b)
          wg::tma_load(st + kTile * (NW + b), &m_w, col0 + 64 * b, 64 * g, full);
      }
    }
    return;
  }

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int g = 0; g < nk; ++g) {
    const int s = g % kStages;
    const uint32_t st = base + s * kStage;
    wg::mbar_wait(bars + 8 * s, (g / kStages) & 1);
    mlptc::mma_tile<N, 1>(acc, st + kTile * wgi, st + kTile * NW);
    wg::wait<0>();
    if ((tid & 127) == 0) wg::mbar_arrive(bars + 8 * (kStages + s));
  }
  wg::fence_regs(acc);

  // every wgmma of the CTA is done and every load has landed: the ring holds
  // the output tile now, 64 rows of kPitch bytes a warpgroup
  wg::bar_sync(1, NW * 128);
  const int lt = tid & 127, warp = lt >> 5, lane = lt & 31;
  const uint32_t out = base + wgi * 64 * kPitch;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + (lane >> 2) + 8 * i, cc = 8 * j + 2 * (lane & 3);
      const int col = col0 + cc;
      const float b0 = wb != nullptr && col < o ? wb[col] : 0.f;
      const float b1 = wb != nullptr && col + 1 < o ? wb[col + 1] : 0.f;
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * i] + b0,
                                                     acc[4 * j + 2 * i + 1] + b1);
      wg::st_shared_b32(out + r * kPitch + cc * 2, *reinterpret_cast<const uint32_t*>(&v));
    }
  wg::bar_sync(2 + wgi, 128);
  constexpr int kChunks = N / 8;  // 16-byte pieces of a row
  for (int idx = lt; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const int row = row0 + 64 * wgi + r, col = col0 + 8 * ch;
    if (row >= t || col >= o) continue;
    const uint4 v = wg::ld_shared_v4(out + r * kPitch + ch * 16);
    bf16* dst = y + static_cast<size_t>(row) * o + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      for (int q = 0; q < 8 && col + q < o; ++q) dst[q] = e[q];
    }
  }
}

// The tile shape of a call and its workspace: xn (T x round8(C) bf16) and,
// when O is not a multiple of 8, W zero-padded to C x round8(O).
struct TcPlan {
  int n, nw, nblk;
  bool staged;
  size_t xn_bytes, w_bytes;
};

inline TcPlan tc_plan(int t, int c, int o) {
  TcPlan p;
  const int widths[5] = {256, 192, 128, 96, 64};
  p.n = 256;
  for (int n : widths)  // the fewest columns computed past O; ties keep the wider
    if ((o + n - 1) / n * n < (o + p.n - 1) / p.n * p.n) p.n = n;
  p.nblk = (o + p.n - 1) / p.n;
  p.nw = (t + 127) / 128 * p.nblk >= 2 * mlptc::kSMs ? 2 : 1;
  p.staged = o % 8 != 0;
  p.xn_bytes = mlptc::round256(static_cast<size_t>(t) * mlptc::round8(c) * sizeof(bf16));
  p.w_bytes = p.staged ? mlptc::round256(static_cast<size_t>(c) * mlptc::round8(o) * sizeof(bf16))
                       : 0;
  return p;
}

template <int NW, int N>
int launch_tc_kernel(const CUtensorMap& m_xn, const CUtensorMap& m_w, const float* wb, void* y,
                     int t, int c, int o, cudaStream_t s) {
  constexpr int smem = tc_smem_bytes(NW, N);
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_tc_kernel<NW, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((o + N - 1) / N, (t + 64 * NW - 1) / (64 * NW));
  const int vec = o % 8 == 0 && mlptc::aligned16(y);
  ln_matmul_tc_kernel<NW, N><<<grid, mlptc::threads(NW), smem, s>>>(
      m_xn, m_w, wb, static_cast<bf16*>(y), t, c, o, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const float* g, const float* b, const void* w, const float* wb,
                void* y, void* workspace, int t, int c, int o, float eps, cudaStream_t s) {
  const TcPlan p = tc_plan(t, c, o);
  const int cp = mlptc::round8(c), op = mlptc::round8(o);
  char* ws = static_cast<char*>(workspace);
  bf16* xn = reinterpret_cast<bf16*>(ws);
  cudaError_t err = mlptc::ln_rows(x, g, b, xn, t, c, cp, eps, 0, s);
  if (err == cudaSuccess && p.staged) {
    void* wp = ws + p.xn_bytes;
    err = cudaMemsetAsync(wp, 0, p.w_bytes, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(w, wp, c, o, op, s);
    w = wp;
  }
  CUtensorMap m_xn, m_w;
  if (err == cudaSuccess) err = mlptc::make_map(&m_xn, xn, t, c, cp);
  if (err == cudaSuccess) err = mlptc::make_map(&m_w, w, c, o, p.staged ? op : o);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto args = [&](auto launch) { return launch(m_xn, m_w, wb, y, t, c, o, s); };
  if (p.nw == 1) {
    if (p.n == 64) return args(launch_tc_kernel<1, 64>);
    if (p.n == 96) return args(launch_tc_kernel<1, 96>);
    if (p.n == 128) return args(launch_tc_kernel<1, 128>);
    if (p.n == 192) return args(launch_tc_kernel<1, 192>);
    return args(launch_tc_kernel<1, 256>);
  }
  if (p.n == 64) return args(launch_tc_kernel<2, 64>);
  if (p.n == 96) return args(launch_tc_kernel<2, 96>);
  if (p.n == 128) return args(launch_tc_kernel<2, 128>);
  if (p.n == 192) return args(launch_tc_kernel<2, 192>);
  return args(launch_tc_kernel<2, 256>);
}

}  // namespace

// Bytes of workspace tt_ln_matmul needs (0 in float32): the normalised rows
// in bf16 and, for O not a multiple of 8, a zero-padded copy of W.
TT_EXPORT long long tt_ln_matmul_workspace(int t, int c, int o, int is_bf16) {
  if (!is_bf16) return 0;
  const TcPlan p = tc_plan(t, c, o);
  return static_cast<long long>(p.xn_bytes + p.w_bytes);
}

// wb may be null (PatchMerging's reduction has no bias).
TT_EXPORT int tt_ln_matmul(const void* x, const void* gamma, const void* beta, const void* w,
                           const void* wb, void* y, void* workspace, int t, int c, int o,
                           float eps, int is_bf16, void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* bias = static_cast<const float*>(wb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(x, g, b, w, bias, y, workspace, t, c, o, eps, s)
                 : launch_f32(x, g, b, w, bias, y, t, c, o, eps, s);
}
