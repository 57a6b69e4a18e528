// The tensor-core core of the bf16 LN + MLP kernels: ln_mlp.cu (kernel 3,
// the forward) and ln_mlp_bwd.cu (kernel 10, the backward's dX). float32
// stays on those files' scalar kernels. Its pieces (the LN pass, tensor
// maps, staged copies, mma_tile) also serve the LN + matmul forward
// (ln_matmul.cu, kernel 2) and the LN + MLP weight gradients (kernel 11 in
// ln_mlp_bwd.cu), which lay out their own CTAs.
//
// Both products of a hidden chunk run on wgmma (wgmma.cuh) over a CTA of
// 64 token rows (wgmma's M) and a block of output columns:
// - a pass before (ln_rows_kernel) writes the LayerNorm'd rows xn in bf16,
//   rounded as the scalar kernels round them, to a workspace; the CTA
//   streams its 64-row tiles from there (L2) like the weights;
// - warp specialisation: one producer thread (after the consumers) walks the CTA's
//   k-tiles (64 deep) and loads each with TMA into a ring of stages, each
//   stage guarded by a "full" mbarrier (the TMA bytes) and an "empty" one
//   (one arrival per consumer warpgroup when its wgmma on the stage is
//   done); NW = 1 or 2 consumer warpgroups only wait and multiply. No
//   weight is transposed or converted: W1 (C, Hd) is the MN-major B of fc1
//   and the K-major B of dXn = dH W1^T, W2 (Hd, C) the MN-major B of fc2
//   and the K-major B of dA = dY W2^T;
// - the hidden axis goes in chunks of 64 units per consumer warpgroup (64
//   NW a chunk). Each warpgroup computes its 64 units (64 x 64 f32 in
//   registers), applies the chunk's epilogue there (kernel 3: + b1, round,
//   exact-erf GELU, round; kernel 10: + b1, round, then round(dA *
//   gelu'(hr))) and stores it in bf16 to shared memory, the A operand of
//   the second product, between two named barriers of the consumers;
// - the second product accumulates into an f32 register tile of 64 rows x
//   NWC columns a warpgroup (NWC <= 256, at most 128 registers a thread);
//   a CTA takes NW * NWC >= its column block, at most 512 columns (256 in
//   kernel 10 past C = 768). Wider rows take several column blocks, each
//   of which recomputes the first product(s);
// - when a grid of row tiles x column blocks would not fill the card twice,
//   the hidden axis is split over CTAs; each split writes f32 partials
//   that a second pass adds in split order, so the sum is deterministic.
// TMA needs row strides that are multiples of 16 bytes: widths that are not
// multiples of 8 (never a Swin width) go through zero-padded copies in the
// workspace.
//
// Rounding contract (as the scalar kernels and the plain versions): every
// product accumulates in f32; the hidden layer is rounded to bf16 before
// and after GELU (kernel 10: hr = round(xn W1 + b1), dH = round(dA *
// gelu'(hr))); the output is rounded once from the full f32 sum.
#pragma once

#include "token_bwd.cuh"
#include "wgmma.cuh"

namespace mlptc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                 // token rows of a CTA
constexpr int kTile = kRows * 128;        // one swizzled 64 x 64 bf16 block, 8 KB
constexpr int kMaxBlockCols = 512;        // output columns of a CTA, at most
constexpr int kMaxSmem = 232448;          // shared memory a block can use
constexpr int kSMs = 132;

// Shared memory: a ring of stages, the hidden chunk (NW blocks), the
// mbarriers. One consumer warpgroup keeps to half the SM's shared memory,
// so that two CTAs can share an SM where their registers allow it.
__host__ __device__ constexpr int stage_bytes(int nw, int nwc) {
  return kTile * (1 + nw) > nw * nwc * 128 ? kTile * (1 + nw) : nw * nwc * 128;
}
__host__ __device__ constexpr int stages(int nw, int nwc) {
  return ((nw == 1 ? kMaxSmem / 2 : kMaxSmem) - kTile * nw - 2048) / stage_bytes(nw, nwc) < 8
             ? ((nw == 1 ? kMaxSmem / 2 : kMaxSmem) - kTile * nw - 2048) / stage_bytes(nw, nwc)
             : 8;
}
__host__ __device__ constexpr int smem_bytes(int nw, int nwc) {
  return stages(nw, nwc) * stage_bytes(nw, nwc) + kTile * nw + 2048;
}

// Threads of a CTA: NW consumer warpgroups, then one producer warp.
__host__ __device__ constexpr int threads(int nw) { return nw * 128 + 32; }

inline size_t round256(size_t n) { return (n + 255) / 256 * 256; }
inline int round8(int n) { return (n + 7) / 8 * 8; }

struct Plan {
  int nw, nwc;           // consumer warpgroups; output columns of each
  int cblock, nblk;      // output columns of a CTA; column blocks
  int nchunks, cps;      // hidden chunks (64 nw units); chunks of a split
  int splits, row_tiles;
  bool staged;           // C or Hd not a multiple of 8: padded copies
  // workspace, in this order: xn (T x round8(C) bf16), f32 partials, and
  // when staged the padded W1 (C x round8(Hd)), W2 (Hd x round8(C)) and,
  // for kernel 10, dY (T x round8(C))
  // and, for kernel 10 past tokbwd::kMaxC, the rows' statistics
  size_t xn_bytes, part_bytes, w1_bytes, w2_bytes, dy_bytes, stats_bytes;
  size_t total() const {
    return xn_bytes + part_bytes + w1_bytes + w2_bytes + dy_bytes + stats_bytes;
  }
};

// bwd: kernel 10, which writes its dXn as partials even unsplit. Its rows
// past tokbwd::kMaxC (C = 1024, 1536) take blocks of 256 columns, one
// warpgroup each: two warpgroups of 256 spill 1.3 KB a thread (ptxas) and
// were the slower on the card, though each block recomputes hr
// and dA.
inline Plan make_plan(int t, int c, int hdim, bool bwd) {
  Plan p;
  const int most = bwd && c > tokbwd::kMaxC ? 256 : kMaxBlockCols;
  p.nblk = (c + most - 1) / most;
  p.cblock = ((c + p.nblk - 1) / p.nblk + 63) / 64 * 64;
  p.nw = p.cblock > 256 ? 2 : 1;
  p.nwc = ((p.cblock + p.nw - 1) / p.nw + 63) / 64 * 64;
  p.nchunks = (hdim + 64 * p.nw - 1) / (64 * p.nw);
  p.row_tiles = (t + kRows - 1) / kRows;
  const int base = p.row_tiles * p.nblk;
  int s = (2 * kSMs + base - 1) / base;
  s = s < 1 ? 1 : (s > p.nchunks ? p.nchunks : s);
  p.cps = (p.nchunks + s - 1) / s;
  p.splits = (p.nchunks + p.cps - 1) / p.cps;
  p.staged = c % 8 != 0 || hdim % 8 != 0;
  const int cp = round8(c), hp = round8(hdim);
  p.xn_bytes = round256(static_cast<size_t>(t) * cp * sizeof(bf16));
  p.part_bytes = (bwd || p.splits > 1)
                     ? round256(static_cast<size_t>(p.splits) * t * c * sizeof(float))
                     : 0;
  p.w1_bytes = p.staged ? round256(static_cast<size_t>(c) * hp * sizeof(bf16)) : 0;
  p.w2_bytes = p.staged ? round256(static_cast<size_t>(hdim) * cp * sizeof(bf16)) : 0;
  p.dy_bytes = p.staged && bwd ? round256(static_cast<size_t>(t) * cp * sizeof(bf16)) : 0;
  p.stats_bytes = bwd && c > tokbwd::kMaxC ? tokbwd::stats_bytes(t) : 0;
  return p;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- tensor maps ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map of a rows x cols bf16 matrix with row stride ld elements
// (ld % 8 == 0), read in 64 x 64 boxes into 128-byte-swizzled tiles;
// boxes past the edge read zeros. cuTensorMapEncodeTiled comes through the
// runtime's entry-point query, so nothing links against libcuda.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int cols, int ld) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (!aligned16(base) || ld % 8 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dst (rows x ld_dst) = src (rows x cols, dense): the staged copies.
__global__ void __launch_bounds__(256)
pad_copy_kernel(const bf16* __restrict__ src, bf16* __restrict__ dst, int rows, int cols,
                int ld_dst) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<size_t>(rows) * cols) return;
  dst[(i / cols) * ld_dst + i % cols] = src[i];
}

inline cudaError_t pad_copy(const void* src, void* dst, int rows, int cols, int ld_dst,
                            cudaStream_t s) {
  const size_t n = static_cast<size_t>(rows) * cols;
  pad_copy_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(src), static_cast<bf16*>(dst), rows, cols, ld_dst);
  return cudaGetLastError();
}

// LayerNorm rows into the compute type T (row stride ld), one warp a row:
// the forward's (x - mu) * (rstd * gamma) + beta (bwd_form = 0, as
// ln_mlp.cu's scalar kernel) or the backward's round-by-step x_hat * gamma +
// beta (1, as token_bwd.cuh). Statistics as flax: mean, max(0, E[x^2] -
// mean^2).
template <typename T>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ xn, int t, int c, int ld,
               float eps, int bwd_form) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= t) return;
  const T* xr = x + static_cast<size_t>(row) * c;
  T* out = xn + static_cast<size_t>(row) * ld;
  float mu, rs;
  tokbwd::row_stats(xr, c, eps, mu, rs);
  for (int k = threadIdx.x & 31; k < c; k += 32) {
    const float v = to_f32(xr[k]);
    out[k] = from_f32<T>(bwd_form ? tokbwd::ln_affine(tokbwd::xhat(v, mu, rs), gamma[k], beta[k])
                                  : (v - mu) * (rs * gamma[k]) + beta[k]);
  }
}

template <typename T>
inline cudaError_t ln_rows(const void* x, const float* g, const float* b, T* xn, int t, int c,
                           int ld, float eps, int bwd_form, cudaStream_t s) {
  ln_rows_kernel<T><<<(t + 7) / 8, 256, 0, s>>>(static_cast<const T*>(x), g, b, xn, t, c, ld,
                                                eps, bwd_form);
  return cudaGetLastError();
}

template <int N, int TB>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) wg::mma_m64n64k16<TB>(d, a, b, scale_d);
  else if constexpr (N == 96) wg::mma_m64n96k16<TB>(d, a, b, scale_d);
  else if constexpr (N == 128) wg::mma_m64n128k16<TB>(d, a, b, scale_d);
  else if constexpr (N == 192) wg::mma_m64n192k16<TB>(d, a, b, scale_d);
  else wg::mma_m64n256k16<TB>(d, a, b, scale_d);
}

// Starts one k-tile as a wgmma group: A (64 x 64k) K-major at a, B at b,
// four k16 steps of d += A B (SET: d = A B, d written only by the first
// step, which N = 64 allows); a ragged last tile of C reads zeros past C.
// TB = 1: B MN-major, 64-column blocks kTile apart; TB = 0: B K-major. The
// descriptors are formed before the fence, so that the four wgmmas go
// back to back. The caller waits for the group (wg::wait, then
// wg::fence_regs) before it reads d or lets the tiles be overwritten.
template <int N, int TB, bool SET = false>
__device__ __forceinline__ void mma_tile(float (&d)[N / 2], uint32_t a, uint32_t b) {
  uint64_t da[4], db[4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    da[ks] = wg::desc(a + ks * 32, 16, 1024);
    db[ks] = wg::desc(b + ks * (TB ? 2048 : 32), TB ? kTile : 16, 1024);
  }
  if constexpr (!SET) wg::fence_regs(d);
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (SET) {
      static_assert(N == 64, "the write-only first step is m64n64k16");
      if (ks == 0) {
        wg::mma_m64n64k16_set<TB>(d, da[0], db[0]);
        continue;
      }
    }
    mma<N, TB>(d, da[ks], db[ks], 1);
  }
  wg::commit();
}

// Stores a 64 x 64 fragment (f(value, hidden unit) of each accumulator) as
// bf16 into the swizzled block at shared address blk.
template <typename F>
__device__ __forceinline__ void store_hidden(const float (&d)[32], uint32_t blk, int h_first,
                                             F f) {
  const int lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + (lane >> 2) + 8 * i, cc = 8 * j + 2 * (lane & 3);
      const __nv_bfloat162 v = __floats2bfloat162_rn(f(d[4 * j + 2 * i], h_first + cc),
                                                     f(d[4 * j + 2 * i + 1], h_first + cc + 1));
      wg::st_shared_b32(blk + wg::swz(r, j) + (cc & 7) * 2,
                        *reinterpret_cast<const uint32_t*>(&v));
    }
  wg::fence_proxy();
}

// Calls f(row, column, value) for each accumulator of a 64 x N fragment
// whose first column is col0.
template <int N, typename F>
__device__ __forceinline__ void for_each_acc(const float (&d)[N / 2], int row0, int col0, F f) {
  const int lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        f(row0 + warp * 16 + (lane >> 2) + 8 * i, col0 + 8 * j + 2 * (lane & 3) + e,
          d[4 * j + 2 * i + e]);
}

}  // namespace mlptc
