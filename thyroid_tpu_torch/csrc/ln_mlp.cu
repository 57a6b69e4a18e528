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
// y = acc + b2 (+ x with the residual) stored in the compute type, one
// rounding from the full f32 sum.
//
// Bound on the H100: 4*C*Hd operations per row for 2*C elements moved
// (177.6 GFLOP per swin_tiny forward at bucket 32, 0.18 ms of dense bf16),
// so bound by operations: the bf16 path runs on the tensor cores.
//
// bf16 (the served path): mlp_tc.cuh's wgmma core. A pass writes the
// normalised rows xn (bf16) to the workspace; then a CTA of 64 rows x at
// most 512 output columns has one producer thread load 64-deep tiles of
// xn, W1 and W2 by TMA into a ring of stages (mbarriers), while its
// consumer warpgroups compute each hidden chunk (64 units per warpgroup)
// with wgmma m64n64k16 into registers, apply + b1, round, GELU, round
// there and store it (bf16, swizzled) as the A operand of fc2, which
// accumulates with wgmma m64nNk16 (N = 64-256 columns per warpgroup) into
// an f32 register tile. Shapes by width: C <= 256 one consumer warpgroup
// (C = 96: N = 128, a quarter of fc2 on zero columns); C = 384 two of 192
// columns; C = 768 two column blocks of 384 (each recomputes fc1: stage 4
// does 1.5x the operations); C = 1536 three blocks of 512 (two warpgroups
// of 256). Budget at C = 768: 4 stages of 48 KB + the 64 x 128 hidden
// chunk (16 KB) = 209 KB of shared memory, one CTA of 288 threads per SM,
// 96 + 32 f32 accumulator registers a thread (159 in all, no spill); at
// C = 1536: 3 stages of 64 KB (209 KB), 128 + 32 accumulators, and the
// 168 registers a thread that nine warps leave (two consumer warps and
// the producer's on each of the SM's four schedulers) spill 512 bytes.
// One consumer warpgroup (C <= 256) keeps to 106 KB, so that two CTAs
// share an SM. Where the row tiles x column blocks would not fill two
// waves of the 132 SMs (swin_tiny stages 3 and 4: 98 and 50 CTAs), the
// hidden axis is split over CTAs into f32 partials that a second pass
// adds in split order with b2 and the residual.
//
// float32 (the card-vs-CPU parity path) stays on the scalar kernel below
// (scalar f32 FMAs, no tensor core): TF32 tensor cores keep 10 mantissa
// bits and would not hold the 1e-4 float32 checks. A block owns BM rows
// and up to 768 output columns (more columns take more blocks along y,
// each recomputing the hidden layer); the normalised rows stay in shared
// memory; the hidden layer is produced 128 units at a time into shared
// memory and consumed at once into per-thread f32 register accumulators
// (BM / 16 rows x 48 columns a thread). The rows of a block follow from
// C: BM = 32 while its shared memory fits, 4 (32 (C + 4) + 32 x 132 +
// 32 x 128 + 16 x 768) bytes = 214,016 at C = 1024, and BM = 16 above,
// 172,544 bytes at swin_large's C = 1536 (32 rows would take 279,552, more
// than the 232,448 a block may use); 16 rows fit up to C = 2472. Every
// output element is one thread's: the same LN, the same fc1 sum in k
// order and fc2 sum in hidden order whatever BM, so the numbers do not
// depend on it.
#include "mlp_tc.cuh"

namespace {

constexpr int kHC = 128;       // hidden units per chunk
constexpr int kLdH = kHC + 4;  // padded row of the hidden tile
constexpr int kBK1 = 32;       // K chunk of fc1
constexpr int kBK2 = 16;       // K chunk of fc2
constexpr int kGroups = 12;    // 64-column groups a block owns
constexpr int kCols = 64 * kGroups;
constexpr int kThreads = 256;

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const T* __restrict__ w1,
              const float* __restrict__ b1, const T* __restrict__ w2,
              const float* __restrict__ b2, T* __restrict__ y, int t, int c, int hdim,
              float eps, int residual) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int RPT = BM / 16;  // rows a thread: ty + 16 i
  const int row0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * kCols;
  const int ncol = min(kCols, c - c0);
  const int ncol_pad = (ncol + 63) / 64 * 64;
  const int ngroups = ncol_pad / 64;
  const int ldx = c + 4;
  float* Xs = smem;                 // BM x ldx       normalised rows
  float* Hs = Xs + BM * ldx;        // BM x kLdH      hidden chunk
  float* W1s = Hs + BM * kLdH;      // kBK1 x kHC
  float* W2s = W1s + kBK1 * kHC;    // kBK2 x ncol_pad
  const float cf = static_cast<float>(c);

  for (int r = warp; r < BM; r += kThreads / 32) {
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

  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 i
  float acc[RPT][kGroups][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

  for (int h0 = 0; h0 < hdim; h0 += kHC) {
    // fc1 for hidden units [h0, h0 + kHC): RPT rows x 8 units a thread
    float hacc[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
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
        const float4 p = *reinterpret_cast<const float4*>(&W1s[kk * kHC + tx * 4]);
        const float4 q = *reinterpret_cast<const float4*>(&W1s[kk * kHC + 64 + tx * 4]);
        const float bv[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float a = Xs[(ty + 16 * i) * ldx + k0 + kk];
#pragma unroll
          for (int e = 0; e < 8; ++e) hacc[i][e] = fmaf(a, bv[e], hacc[i][e]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int jj = (e < 4 ? tx * 4 + e : 64 + tx * 4 + e - 4);
        const int hj = h0 + jj;
        float v = 0.f;
        if (hj < hdim) v = round_to<T>(tokbwd::gelu(round_to<T>(hacc[i][e] + b1[hj])));
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
        float a[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = Hs[(ty + 16 * i) * kLdH + k0 + kk];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (g < ngroups) {
            const float4 b = *reinterpret_cast<const float4*>(&W2s[kk * ncol_pad + g * 64 + tx * 4]);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              acc[i][g][0] = fmaf(a[i], b.x, acc[i][g][0]);
              acc[i][g][1] = fmaf(a[i], b.y, acc[i][g][1]);
              acc[i][g][2] = fmaf(a[i], b.z, acc[i][g][2]);
              acc[i][g][3] = fmaf(a[i], b.w, acc[i][g][3]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
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

size_t smem_bytes(int bm, int c) {
  const int ncol_pad = (min(kCols, c) + 63) / 64 * 64;
  return sizeof(float) * (static_cast<size_t>(bm) * (c + 4) + bm * kLdH + kBK1 * kHC +
                          static_cast<size_t>(kBK2) * ncol_pad);
}

template <int BM>
int launch_f32_rows(const void* x, const float* g, const float* b, const void* w1,
                    const float* b1, const void* w2, const float* b2, void* y, int t, int c,
                    int hdim, float eps, int residual, cudaStream_t s) {
  const size_t smem = smem_bytes(BM, c);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_kernel<float, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + BM - 1) / BM, (c + kCols - 1) / kCols);
  ln_mlp_kernel<float, BM><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), g, b, static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<float*>(y), t, c, hdim, eps, residual);
  return static_cast<int>(cudaGetLastError());
}

// 32 rows a block where they fit (C <= 1024), else 16.
int launch_f32(const void* x, const float* g, const float* b, const void* w1, const float* b1,
               const void* w2, const float* b2, void* y, int t, int c, int hdim, float eps,
               int residual, cudaStream_t s) {
  return smem_bytes(32, c) <= static_cast<size_t>(mlptc::kMaxSmem)
             ? launch_f32_rows<32>(x, g, b, w1, b1, w2, b2, y, t, c, hdim, eps, residual, s)
             : launch_f32_rows<16>(x, g, b, w1, b1, w2, b2, y, t, c, hdim, eps, residual, s);
}

// ---- bf16: the tensor-core kernel -----------------------------------------

using mlptc::bf16;
using mlptc::kTile;

// One CTA: rows [64 x, +64), output columns [cblock y, +cblock) (capped at
// C), hidden chunks [cps z, +cps) of 64 NW units. Warpgroups 0..NW - 1
// multiply; the first thread after them loads. part ==
// nullptr: the epilogue stores y; otherwise the f32 partial of split z.
template <int NW, int NWC>
__global__ void __launch_bounds__(mlptc::threads(NW), 1)
ln_mlp_tc_kernel(const __grid_constant__ CUtensorMap m_xn,
                 const __grid_constant__ CUtensorMap m_w1,
                 const __grid_constant__ CUtensorMap m_w2, const bf16* __restrict__ x,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 bf16* __restrict__ y, float* __restrict__ part, int t, int c, int hdim,
                 int cblock, int cps, int nchunks, int residual) {
  constexpr int kStage = mlptc::stage_bytes(NW, NWC), kStages = mlptc::stages(NW, NWC);
  constexpr int kFc2Blocks = NW * NWC / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (wg::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t hbuf = base + kStages * kStage;  // the hidden chunk, 64 x 64 NW
  const uint32_t bars = hbuf + kTile * NW;        // kStages full, then kStages empty
  // the warpgroup index through a shuffle, so that the compiler sees it
  // warp-uniform and keeps the wgmma descriptors in uniform registers
  const int tid = threadIdx.x, wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int row0 = blockIdx.x * mlptc::kRows;
  const int c0 = blockIdx.y * cblock, ccap = min(c, c0 + cblock);
  const int ch0 = blockIdx.z * cps, nch = min(nchunks, ch0 + cps) - ch0;
  const int nk1 = (c + 63) / 64, tpc = nk1 + NW, ntiles = nch * tpc;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(bars + 8 * i, 1);
      wg::mbar_init(bars + 8 * (kStages + i), NW);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  // the producer: k-tile g is xn[:, 64 r..] and W1[64 r.., chunk] for
  // r < nk1, else W2[chunk's 64 (r - nk1).., columns]
  if (wgi == NW) {
    if (tid == NW * 128) {
      for (int g = 0; g < ntiles; ++g) {
        const int s = g % kStages, h0 = (ch0 + g / tpc) * 64 * NW, r = g % tpc;
        const uint32_t st = base + s * kStage, full = bars + 8 * s;
        wg::mbar_wait(bars + 8 * (kStages + s), ((g / kStages) & 1) ^ 1);
        if (r < nk1) {
          wg::mbar_expect_tx(full, kTile * (1 + NW));
          wg::tma_load(st, &m_xn, 64 * r, row0, full);
#pragma unroll
          for (int b = 0; b < NW; ++b)
            wg::tma_load(st + kTile * (1 + b), &m_w1, h0 + 64 * b, 64 * r, full);
        } else {
          wg::mbar_expect_tx(full, kTile * kFc2Blocks);
#pragma unroll
          for (int b = 0; b < kFc2Blocks; ++b)
            wg::tma_load(st + kTile * b, &m_w2, c0 + 64 * b, h0 + 64 * (r - nk1), full);
        }
      }
    }
  } else {  // the consumers
    const int cw = wgi;
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
    float acc[NWC / 2], hid[32];
#pragma unroll
    for (int i = 0; i < NWC / 2; ++i) acc[i] = 0.f;
    int g = 0;
    for (int ch = 0; ch < nch; ++ch) {
      for (int k = 0; k < nk1; ++k, ++g) {  // fc1: this warpgroup's 64 units
        const uint32_t st = take(g);
        if (k == 0) mlptc::mma_tile<64, 1, true>(hid, st, st + kTile * (1 + cw));
        else mlptc::mma_tile<64, 1>(hid, st, st + kTile * (1 + cw));
        release(g);
      }
      wg::fence_regs(hid);
      const int h0 = (ch0 + ch) * 64 * NW + 64 * cw;
      wg::bar_sync(1, NW * 128);  // every fc2 of the last chunk is done with hbuf
      mlptc::store_hidden(hid, hbuf + kTile * cw, h0, [&](float v, int hj) {
        return hj < hdim ? round_to<bf16>(tokbwd::gelu(round_to<bf16>(v + b1[hj]))) : 0.f;
      });
      wg::bar_sync(1, NW * 128);
      for (int k = 0; k < NW; ++k, ++g) {  // fc2 over the chunk's 64 NW units
        const uint32_t st = take(g);
        mlptc::mma_tile<NWC, 1>(acc, hbuf + kTile * k, st + kTile * (NWC / 64) * cw);
        release(g);
      }
    }
    wg::fence_regs(acc);

    const size_t split_off = static_cast<size_t>(blockIdx.z) * t * c;
    mlptc::for_each_acc<NWC>(acc, row0, c0 + NWC * cw, [&](int row, int col, float v) {
      if (row < t && col < ccap) {
        const size_t off = static_cast<size_t>(row) * c + col;
        if (part != nullptr) {
          part[split_off + off] = v;
        } else {
          v += b2[col];
          y[off] = __float2bfloat16_rn(residual ? v + to_f32(x[off]) : v);
        }
      }
    });
  }
}

// y = sum over splits, in order, of the partials + b2 (+ x), rounded once.
__global__ void __launch_bounds__(256)
ln_mlp_sum_kernel(const float* __restrict__ part, const bf16* __restrict__ x,
                  const float* __restrict__ b2, bf16* __restrict__ y, int splits, size_t n,
                  int c, int residual) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[static_cast<size_t>(s) * n + i];
  v += b2[i % c];
  y[i] = __float2bfloat16_rn(residual ? v + to_f32(x[i]) : v);
}

template <int NW, int NWC>
int launch_tc_kernel(const mlptc::Plan& p, const CUtensorMap (&maps)[3], const void* x,
                     const float* b1, const float* b2, void* y, float* part, int t, int c,
                     int hdim, int residual, cudaStream_t s) {
  constexpr int smem = mlptc::smem_bytes(NW, NWC);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_tc_kernel<NW, NWC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.row_tiles, p.nblk, p.splits);
  ln_mlp_tc_kernel<NW, NWC><<<grid, mlptc::threads(NW), smem, s>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(x), b1, b2, static_cast<bf16*>(y),
      part, t, c, hdim, p.cblock, p.cps, p.nchunks, residual);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const float* g, const float* b, const void* w1, const float* b1,
                const void* w2, const float* b2, void* y, void* workspace, int t, int c,
                int hdim, float eps, int residual, cudaStream_t s) {
  const mlptc::Plan p = mlptc::make_plan(t, c, hdim, false);
  const int cp = mlptc::round8(c), hp = mlptc::round8(hdim);
  char* ws = static_cast<char*>(workspace);
  bf16* xn = reinterpret_cast<bf16*>(ws);
  float* part = p.part_bytes ? reinterpret_cast<float*>(ws + p.xn_bytes) : nullptr;
  cudaError_t err = mlptc::ln_rows(x, g, b, xn, t, c, cp, eps, 0, s);
  if (err == cudaSuccess && p.staged) {  // zero-padded copies of the weights
    void* w1p = ws + p.xn_bytes + p.part_bytes;
    void* w2p = static_cast<char*>(w1p) + p.w1_bytes;
    err = cudaMemsetAsync(w1p, 0, p.w1_bytes + p.w2_bytes, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(w1, w1p, c, hdim, hp, s);
    if (err == cudaSuccess) err = mlptc::pad_copy(w2, w2p, hdim, c, cp, s);
    w1 = w1p;
    w2 = w2p;
  }
  CUtensorMap maps[3];
  if (err == cudaSuccess) err = mlptc::make_map(&maps[0], xn, t, c, cp);
  if (err == cudaSuccess) err = mlptc::make_map(&maps[1], w1, c, hdim, p.staged ? hp : hdim);
  if (err == cudaSuccess) err = mlptc::make_map(&maps[2], w2, hdim, c, p.staged ? cp : c);
  if (err != cudaSuccess) return static_cast<int>(err);
  int status;
  const auto args = [&](auto launch) {
    return launch(p, maps, x, b1, b2, y, part, t, c, hdim, residual, s);
  };
  if (p.nw == 1 && p.nwc == 64) status = args(launch_tc_kernel<1, 64>);
  else if (p.nw == 1 && p.nwc == 128) status = args(launch_tc_kernel<1, 128>);
  else if (p.nw == 1 && p.nwc == 192) status = args(launch_tc_kernel<1, 192>);
  else if (p.nw == 1 && p.nwc == 256) status = args(launch_tc_kernel<1, 256>);
  else if (p.nw == 2 && p.nwc == 192) status = args(launch_tc_kernel<2, 192>);
  else if (p.nw == 2 && p.nwc == 256) status = args(launch_tc_kernel<2, 256>);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (status != 0 || part == nullptr) return status;
  const size_t n = static_cast<size_t>(t) * c;
  ln_mlp_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      part, static_cast<const bf16*>(x), b2, static_cast<bf16*>(y), p.splits, n, c, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of workspace tt_ln_mlp needs (0 in float32): the normalised rows in
// bf16 and, where the hidden axis is split, the f32 partials.
TT_EXPORT long long tt_ln_mlp_workspace(int t, int c, int hdim, int is_bf16) {
  if (!is_bf16) return 0;
  return static_cast<long long>(mlptc::make_plan(t, c, hdim, false).total());
}

// residual = 1: y = x + MLP(LN(x)) (fused_ln_mlp_residual); 0: y = MLP(LN(x)).
TT_EXPORT int tt_ln_mlp(const void* x, const void* gamma, const void* beta, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* y, void* workspace,
                        int t, int c, int hdim, float eps, int residual, int is_bf16,
                        void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* bb1 = static_cast<const float*>(b1);
  const float* bb2 = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(x, g, b, w1, bb1, w2, bb2, y, workspace, t, c, hdim, eps,
                               residual, s)
                 : launch_f32(x, g, b, w1, bb1, w2, bb2, y, t, c, hdim, eps, residual, s);
}
