// Swin window attention: the serving half-block and the training forward.
//
// tt_swin_block_attention replaces the TPU kernel
// thyroid_tpu/ops/attention.py _swin_proj_kernel (pallas_call in
// _fused_swin_fwd_call, public wrapper fused_swin_block_attention).
// tt_swin_attention replaces _swin_kernel (the same pallas_call without
// the projection; public wrapper fused_swin_attention, whose backward is
// swin_attention_bwd.cu).
//
// What they compute, for qkv (B, H, W, 3, C) in the compute type (f32 or
// bf16), in the frame the caller already rolled: for every ws x ws window
// and every head, in f32,
//   S = (q * scale) k^T + bias[head] (+ mask[window]),  P = softmax(S),
//   O = P v.
// The training forward stores O in the compute type at the window's own
// positions of (B, H, W, C). The serving half-block instead rounds O
// (N x C) to the compute type, forms Y = O Wp (f32 accumulation) + bp and
// stores out = residual + Y, with the residual stream (B, H, W, C) in the
// compute type. Window partition and reverse are index arithmetic, never a
// copy through global memory. bias is the relative-position bias already
// gathered to (heads, N, N) f32; mask is the (nW, N, N) f32 shift mask of
// 0 / -100, or null. The loops run over exactly N = ws*ws keys, no padding.
// Cores: in bf16 both kernels run window_tc.cuh's TF32 tensor-core core
// (mma.sync; operands rounded to TF32, unit roundoff 2^-11, f32
// accumulation, as kernel 7's), the serving half-block's projection runs
// on wgmma; in float32 both keep swin_window.cuh's scalar f32 core
// (gather, scores, softmax, P v) and scalar f32 FMAs.
//
// Bound on the H100: per window 4*N^2*C operations for attention (and
// 2*N*C^2 for the projection), on 4*N*C elements moved for the training
// forward (5*N*C with the projection and the C x C weight); at Swin's
// shapes the bytes bound both (swin_tiny's 12 serving blocks at batch 32:
// about 456 MB, 0.14 ms at 3.35 TB/s, against 31 GFLOP).
//
// bf16 serving (swin_block_attention_tc_kernel) runs the attention on TF32
// mma.sync (window_tc.cuh's core, as kernel 7) and the out-projection on
// wgmma. A CTA takes WIN = 1 or 2 windows (one consumer warpgroup each, M
// = 64 rows: the window's n <= 64 tokens and rows past n, which are
// computed and never stored) and one block of NB (128 or 192) output
// columns; one producer thread after the consumers. Per head group (the
// 64 / DH heads whose 64 columns make one k-tile of the projection; two
// at Swin's dh = 32), each warpgroup
// - gathers the group's q, k and v columns of its window's tokens from qkv
//   (B, H, W, 3, C) with cp.async (16-byte pieces) into a bf16 staging
//   area, the next group's copy in flight while this group's last head
//   and its projection run;
// - converts k and v to f32 in shared memory (rows kLdK / kLdV floats
//   apart, zero past n) and keeps q * scale (f32) in registers;
// - runs window_tc.cuh's attend per head (S = q k^T and P v on TF32
//   mma.sync, bias, mask and softmax in f32, e^x as __expf and one
//   reciprocal a row: the exact expf, slow where a shifted block's -100
//   mask makes e^x tiny, and a division per key were most of the
//   softmax's time) and writes O, rounded to bf16, into a
//   128-byte-swizzled 64 x 64 A block in shared memory. The head's bias
//   and the window's mask come from shared memory, where cp.async brings
//   them (4-byte pieces) a head ahead: loaded from global memory inside
//   the softmax, their latency was not hidden;
// - multiplies that block into its 64 x NB f32 register tile with wgmma
//   (m64nNBk16): B is the matching 64 rows of Wp (C, C), row-major (in,
//   out), the MN-major B, never transposed, which the producer loads with
//   TMA into a ring of mbarrier-guarded stages shared by the CTA's windows
//   (two windows read Wp once; rows and columns past C read zeros).
// No O tile stays resident, so any C fits: swin_large's C = 1536 takes
// eight column blocks of 192. Each column block recomputes its windows'
// attention, a small share of the work where C is wide (7.4 MFLOP of
// attention a window at C = 768 against the projection's 75 MFLOP).
// The epilogue adds bp and the residual in f32 and stores bf16 at the
// window's own token rows. Plan (tc_plan): NB = 192 (128 where that needs
// no more column blocks); WIN = 2 wherever two windows fit (a CTA fills
// an SM: 168 registers a thread); then, where the CTAs would not fill
// nine tenths of the card, column blocks of 128. swin_tiny at batch 32:
// stage 1 (2,048 windows, C = 96) 1,024 CTAs of 2 windows x 1 block of
// 128; stage 2 (512, C = 192) 256 x 1 of 192; stage 3 (128, C = 384) 64 x
// 2 of 192; stage 4 (32, C = 768) 16 x 6 of 128 (96 CTAs). Shared memory:
// the ring (2-4 stages of NB / 64 boxes of 8 KB) and per window the A
// block (8 KB), the staging (n x 400 bytes), K and V (35 KB), two heads'
// bias and the mask (9.4 KB each at n = 49). Takes dh a multiple of 8 up
// to 64 and n <= 64; other bf16 shapes are refused. No atomics: two runs
// are bit-equal.
//
// bf16 training forward (swin_attention_tc_kernel<DH>, kernel 5): kernel
// 4's attention without the projection. A CTA is one warpgroup (M = 64
// rows, as above) on one head group (64 / DH heads, two at Swin's DH = 32
// and one above; two below 32, which keeps kernel 6's per-CTA bias and
// dbias sums in shared memory), walking windows x, x + gridDim.x, ...:
// the grid is (train_ctas(windows, head groups), head groups), about 528
// CTAs (window_tc.cuh), so every stage fills the 132 SMs with no column
// split. swin_tiny at batch 32: stage 1 (2,048 windows, heads 3: a pair
// and a single) 264 x 2 CTAs of 7-8 windows; stage 2 (512, 6 heads) 176 x
// 3 of 2-3; stage 3 (128, 12) 88 x 6 of 1-2; stage 4 (32, 24) 32 x 12 of
// one. Per window the group's q | k | v columns of the n token rows come
// by cp.async (16-byte pieces; a head pair is a 128-byte row piece) into
// one of two bf16 staging buffers (rows past n stay zero), with the
// window's mask, while the previous window is computed; the group's bias
// came once. Per head, window_tc.cuh's staged_probs (q * scale in f32,
// S = q k^T on TF32 mma.sync straight from the bf16 staging, bias and
// mask from shared memory, softmax on the fragments with e^x as __expf
// and one reciprocal a row: FAST, chosen for kernels 5 and 6 together)
// and pv give O, stored in bf16 from the fragments at the head's columns
// of the window's token rows. Kernel 6 takes its P from the same
// staged_probs, so it is bit-equal to this one's. Shared memory at n =
// 49, DH = 32: two stagings of 22,400 bytes, the bias 19,216 and, shifted,
// two masks of 9,616: 64,016 or 83,248 bytes, two or three CTAs an SM
// (launch bounds (128, 3)); ptxas gives the DH = 32 instantiation 98
// registers a thread and no spill (87-123 over DH = 8-64, chip_smoke.py
// phase 1). Takes DH a multiple of 8 up to 64 and n <= 64; other bf16
// shapes are refused.
//
// float32 (the card-vs-CPU parity path) keeps the scalar kernels: TF32
// would not hold the 1e-4 float32 checks. The training forward
// (swin_attention_kernel) takes one block of 256 threads per
// window; per head, q/k/v (N x head_dim) are gathered into shared memory
// as f32, scores and softmax (a warp per row, max-shifted) stay in shared
// memory, and P v goes to global memory. The float32 serving half-block
// is two kernels in one call: that same kernel writes O in f32 to a
// workspace (B, H, W, C) that the wrapper sizes, then swin_proj_kernel
// streams 64 token rows of O and 32 x 128 tiles of Wp through shared
// memory into register accumulators of scalar f32 FMAs in k order and adds
// bias and residual in its epilogue (each output a chain of FMAs in k
// order). Not one kernel: an N x C f32 O tile in shared memory would take
// 301 KB at swin_large's C = 1536, against the 227 KB a block may use.
// Shared memory does not grow with C: the attention 29,008 bytes at n =
// 49, DH = 32 (4 (2 n (DH + 1) + n DH + n (n + 1))), the projection
// 24,832, at every C from 96 to 1536.
#include "mlp_tc.cuh"
#include "swin_window.cuh"
#include "window_tc.cuh"

namespace {

using swin::kThreads;
constexpr int kPRows = 64;   // projection row tile (float32)
constexpr int kPCols = 128;  // projection column tile
constexpr int kPBK = 32;     // projection K chunk

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

// Training forward in float32, and the first half of the float32 serving
// half-block: the scalar per-head core, O stored at the window's own
// positions of (B, H, W, C).
__global__ void __launch_bounds__(kThreads)
swin_attention_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                      const float* __restrict__ mask, float* __restrict__ out, int hh, int ww,
                      int c, int heads, int ws, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ws * ws, dh = c / heads;
  const swin::Window w = swin::window_of(blockIdx.x, hh, ww, ws);
  float* Qs = reinterpret_cast<float*>(smem_raw);  // n x (dh + 1)
  float* Ks = Qs + n * (dh + 1);                   // n x (dh + 1)
  float* Vs = Ks + n * (dh + 1);                   // n x dh
  float* Ss = Vs + n * dh;                         // n x (n + 1)
  for (int h = 0; h < heads; ++h) {
    swin::head_probs<float>(qkv, bias, mask, w, c, h, dh, scale, Qs, Ks, Vs, dh, Ss);
    swin::head_pv(Ss, Vs, dh, n, dh,
                  [&](int r, int d, float o) { out[w.token(r) * c + h * dh + d] = o; });
  }
}

int launch_fwd(const void* qkv, const float* bias, const float* mask, void* out, int b,
               int hh, int ww, int c, int heads, int ws, float scale, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(n) * (dh + 1) +
                                       static_cast<size_t>(n) * dh +
                                       static_cast<size_t>(n) * (n + 1));
  cudaError_t err = cudaFuncSetAttribute(swin_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = b * (hh / ws) * (ww / ws);
  swin_attention_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(qkv), bias, mask, static_cast<float*>(out), hh, ww, c, heads,
      ws, scale);
  return static_cast<int>(cudaGetLastError());
}

// The float32 serving half-block's second half: y = residual + (O Wp + bp)
// over 64 token rows x 128 columns a block, O (rows, C) f32 as
// swin_attention_kernel stored it; rows ty + 8 i, columns 4 tx + e
// a thread, each a chain of scalar f32 FMAs in k order.
__global__ void __launch_bounds__(kThreads)
swin_proj_kernel(const float* __restrict__ o, const float* __restrict__ xres,
                 const float* __restrict__ wp, const float* __restrict__ bp,
                 float* __restrict__ y, int rows, int c) {
  __shared__ float As[kPRows][kPBK + 1];
  __shared__ __align__(16) float Wps[kPBK * kPCols];
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int r0 = blockIdx.x * kPRows, n0 = blockIdx.y * kPCols;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int k0 = 0; k0 < c; k0 += kPBK) {
    for (int i = tid; i < kPRows * kPBK; i += kThreads) {
      const int rr = i / kPBK, kk = i % kPBK, row = r0 + rr, k = k0 + kk;
      As[rr][kk] = (row < rows && k < c) ? o[static_cast<size_t>(row) * c + k] : 0.f;
    }
    for (int i = tid; i < kPBK * kPCols; i += kThreads) {
      const int kk = i / kPCols, jj = i % kPCols, k = k0 + kk, col = n0 + jj;
      Wps[i] = (k < c && col < c) ? wp[static_cast<size_t>(k) * c + col] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kPBK, c - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&Wps[kk * kPCols + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[ty + 8 * i][kk];
        acc[i][0] = fmaf(a, bv.x, acc[i][0]);
        acc[i][1] = fmaf(a, bv.y, acc[i][1]);
        acc[i][2] = fmaf(a, bv.z, acc[i][2]);
        acc[i][3] = fmaf(a, bv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty + 8 * i;
    if (row >= rows) continue;
    const size_t base = static_cast<size_t>(row) * c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + tx * 4 + e;
      if (col < c) y[base + col] = xres[base + col] + (acc[i][e] + bp[col]);
    }
  }
}

// The float32 serving half-block: the attention into the workspace (B, H,
// W, C) f32, then the projection.
int launch_f32(const void* qkv, const void* xres, const void* wp, const float* bp,
               const float* bias, const float* mask, void* y, void* workspace, int b, int hh,
               int ww, int c, int heads, int ws, float scale, cudaStream_t s) {
  const int err = launch_fwd(qkv, bias, mask, workspace, b, hh, ww, c, heads, ws, scale, s);
  if (err != 0) return err;
  const int rows = b * hh * ww;
  const dim3 grid((rows + kPRows - 1) / kPRows, (c + kPCols - 1) / kPCols);
  swin_proj_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<const float*>(xres),
      static_cast<const float*>(wp), bp, static_cast<float*>(y), rows, c);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 serving: attention on TF32 mma.sync, projection on wgmma ----------

using mlptc::bf16;
using mlptc::kTile;

constexpr int kMaxWin = 2;    // windows of a CTA
constexpr int kLdS = 200;     // bf16 row stride of the q | k | v staging: 3 x 64 + 8, so
                              // that the q fragment reads of 8 rows miss each other's banks

__host__ __device__ constexpr int tc_threads(int win) { return win * 128 + 32; }

// f32 bytes of one head's bias or one window's mask (n x n), 16-aligned.
__host__ __device__ inline int tc_side_bytes(int n) { return (n * n * 4 + 15) / 16 * 16; }

// Shared memory of one window: the O block, the staging, K and V (rows
// rounded up to 8), two heads' bias and the window's mask (when the block
// is shifted); a multiple of 1024 bytes so that the next window's O block
// keeps the swizzle's alignment.
__host__ __device__ inline int tc_window_bytes(int n, bool has_mask) {
  const int n8 = (n + 7) / 8 * 8;
  const int bytes = kTile + (n * kLdS * 2 + 15) / 16 * 16 +
                    n8 * (wintc::kLdK + wintc::kLdV) * 4 + (has_mask ? 3 : 2) * tc_side_bytes(n);
  return (bytes + 1023) / 1024 * 1024;
}

// One CTA: windows [WIN x, +WIN) (consumer warpgroup w: window WIN x + w),
// output columns [NB y, +NB). The first thread after the consumers loads
// Wp's k-tiles.
template <int DH, int NB>
__global__ void __launch_bounds__(tc_threads(kMaxWin), 1)
swin_block_attention_tc_kernel(const __grid_constant__ CUtensorMap m_wp,
                               const bf16* __restrict__ qkv, const bf16* __restrict__ xres,
                               const float* __restrict__ bp, const float* __restrict__ bias,
                               const float* __restrict__ mask, bf16* __restrict__ y,
                               int windows, int hh, int ww, int c, int heads, int ws, int win,
                               int stages, float scale) {
  constexpr int HPG = 64 / DH;            // heads of a group
  constexpr int G = HPG * DH;             // O columns of a group, the k-tile's live rows
  constexpr int kStage = NB / 64 * kTile; // NB / 64 boxes of 64 x 64
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int n = ws * ws, n8 = (n + 7) / 8 * 8;
  const uint32_t w0 = base + stages * kStage;             // the windows' areas
  const int wbytes = tc_window_bytes(n, mask != nullptr);
  const uint32_t bars = w0 + win * wbytes;                // stages full, then stages empty
  const int tid = threadIdx.x, wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int w_first = blockIdx.x * win, active = min(win, windows - w_first);
  const int groups = (heads + HPG - 1) / HPG;
  const int n0 = blockIdx.y * NB;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      wg::mbar_init(bars + 8 * i, 1);
      wg::mbar_init(bars + 8 * (stages + i), active);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (wgi == win) {  // the producer: tile i is Wp's rows [G i, +64), columns [n0, +NB)
    if (tid == win * 128) {
      for (int i = 0; i < groups; ++i) {
        const int s = i % stages;
        const uint32_t st = base + s * kStage, full = bars + 8 * s;
        wg::mbar_wait(bars + 8 * (stages + s), ((i / stages) & 1) ^ 1);
        wg::mbar_expect_tx(full, kStage);
#pragma unroll
        for (int bx = 0; bx < NB / 64; ++bx) wg::tma_load(st + bx * kTile, &m_wp, n0 + 64 * bx, G * i, full);
      }
    }
    return;
  }
  if (wgi >= active) return;

  const swin::Window wd = swin::window_of(w_first + wgi, hh, ww, ws);
  const uint32_t o_blk = w0 + wgi * wbytes;
  const uint32_t stg = o_blk + kTile;
  const bf16* Sg = reinterpret_cast<const bf16*>(smem_raw + (stg - raw));
  float* Ks = reinterpret_cast<float*>(smem_raw + (stg - raw) + (n * kLdS * 2 + 15) / 16 * 16);
  float* Vs = Ks + n8 * wintc::kLdK;
  const uint32_t bs0 = stg + (n * kLdS * 2 + 15) / 16 * 16 + n8 * (wintc::kLdK + wintc::kLdV) * 4;
  const uint32_t ms = bs0 + 2 * tc_side_bytes(n);  // head h's bias at bs0 + (h & 1) side bytes
  const float* Bs = reinterpret_cast<const float*>(smem_raw + (bs0 - raw));
  const float* Ms = reinterpret_cast<const float*>(smem_raw + (ms - raw));
  const int lt = tid & 127, warp = lt >> 5, lane = lt & 31, g = lane >> 2, t = lane & 3;
  const int bar = 1 + wgi;

  // q | k | v of group gi (the window's n rows, the group's live columns)
  // into the staging, one 16-byte piece a copy
  const auto gather = [&](int gi) {
    const int pieces = min(G, c - G * gi) / 8, per_row = 3 * pieces;
    for (int idx = lt; idx < n * per_row; idx += 128) {
      const int r = idx / per_row, sec = (idx % per_row) / pieces, p = idx % pieces;
      const bf16* src = qkv + wd.token(r) * 3 * c + sec * c + G * gi + 8 * p;
      const uint32_t dst = stg + 2 * (r * kLdS + 64 * sec + 8 * p);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    }
  };

  // n x n f32 from global memory into shared memory, 4 bytes a copy (a
  // head's or window's offset n^2 floats need not be 16-byte aligned)
  const auto copy_side = [&](uint32_t dst, const float* src) {
    for (int i = lt; i < n * n; i += 128)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4 * i), "l"(src + i)
                   : "memory");
  };

  // The O block starts at zero: its columns past a group's heads then meet
  // zero (or past-C) rows of Wp.
  for (int i = lt; i < kTile / 16; i += 128) wg::st_shared_v4(o_blk + 16 * i, make_uint4(0u, 0u, 0u, 0u));
  if (mask != nullptr) copy_side(ms, mask + static_cast<size_t>(wd.wi) * n * n);
  copy_side(bs0, bias);
  gather(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int gi = 0; gi < groups; ++gi) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    wg::bar_sync(bar, 128);  // the staging holds group gi; the last group's reads are done
    const int nh = min(HPG, heads - HPG * gi), live = nh * DH;

    // k and v to f32 (zero past n and past the group's heads)
    for (int idx = lt; idx < n8 * (G / 8); idx += 128) {
      const int r = idx / (G / 8), p = idx % (G / 8);
      float kv[2][8];
#pragma unroll
      for (int sec = 0; sec < 2; ++sec) {
        uint4 raw8 = make_uint4(0u, 0u, 0u, 0u);
        if (r < n && 8 * p < live) raw8 = *reinterpret_cast<const uint4*>(Sg + r * kLdS + 64 * (sec + 1) + 8 * p);
        const bf16* e = reinterpret_cast<const bf16*>(&raw8);
#pragma unroll
        for (int k = 0; k < 8; ++k) kv[sec][k] = __bfloat162float(e[k]);
      }
      float* kd = Ks + r * wintc::kLdK + 8 * p;
      float* vd = Vs + r * wintc::kLdV + 8 * p;
      *reinterpret_cast<float4*>(kd) = make_float4(kv[0][0], kv[0][1], kv[0][2], kv[0][3]);
      *reinterpret_cast<float4*>(kd + 4) = make_float4(kv[0][4], kv[0][5], kv[0][6], kv[0][7]);
      *reinterpret_cast<float4*>(vd) = make_float4(kv[1][0], kv[1][1], kv[1][2], kv[1][3]);
      *reinterpret_cast<float4*>(vd + 4) = make_float4(kv[1][4], kv[1][5], kv[1][6], kv[1][7]);
    }
    // q * scale of the warp's rows, as accumulator fragments (columns 8 kc + 2t + e of a head)
    float q[HPG][DH / 8][4];
#pragma unroll
    for (int j = 0; j < HPG; ++j)
#pragma unroll
      for (int kc = 0; kc < DH / 8; ++kc)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp * 16 + g + 8 * i;
          float2 v = make_float2(0.f, 0.f);
          if (r < n && j < nh)
            v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                Sg + r * kLdS + j * DH + 8 * kc + 2 * t));
          q[j][kc][2 * i] = v.x * scale;
          q[j][kc][2 * i + 1] = v.y * scale;
        }

#pragma unroll
    for (int j = 0; j < HPG; ++j) {
      if (j >= nh) break;
      const int h = HPG * gi + j;
      // head h's bias has landed; K and V are complete; every warp is past
      // head h - 1, whose bias buffer now takes head h + 1's, and past its
      // reads of the staging, which the last head refills
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      wg::bar_sync(bar, 128);
      if (h + 1 < heads) copy_side(bs0 + ((h + 1) & 1) * tc_side_bytes(n), bias + static_cast<size_t>(h + 1) * n * n);
      if (j == nh - 1 && gi + 1 < groups) gather(gi + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      const float* bias_h = Bs + (h & 1) * (tc_side_bytes(n) / 4);
      float o[DH / 8][4];
      wintc::attend<DH, true>(q[j], Ks + j * DH, Vs + j * DH, n, warp * 16,
                        [&](int r, int key) {
                          return bias_h[r * n + key] + (mask != nullptr ? Ms[r * n + key] : 0.f);
                        },
                        o);
      // O rounded to bf16 into the group's k-block (rows past n too: finite, never stored)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
#pragma unroll
        for (int dt = 0; dt < DH / 8; ++dt) {
          const int col = j * DH + 8 * dt + 2 * t;
          const __nv_bfloat162 v = __floats2bfloat162_rn(o[dt][2 * i], o[dt][2 * i + 1]);
          wg::st_shared_b32(o_blk + wg::swz(r, col / 8) + (col & 7) * 2,
                            *reinterpret_cast<const uint32_t*>(&v));
        }
      }
    }
    wg::fence_proxy();
    wg::bar_sync(bar, 128);  // the O block is complete

    const int s = gi % stages;
    wg::mbar_wait(bars + 8 * s, (gi / stages) & 1);
    mlptc::mma_tile<NB, 1>(acc, o_blk, base + s * kStage);
    wg::wait<0>();
    wg::fence_regs(acc);
    if (lt == 0) wg::mbar_arrive(bars + 8 * (stages + s));
  }

  // y = residual + (O Wp + bp), in f32, at the window's own token rows
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= c) continue;
    const float b0 = bp[col], b1 = bp[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      if (r >= n) continue;
      const size_t off = wd.token(r) * c + col;
      const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xres + off));
      *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(
          xr.x + (acc[4 * j + 2 * i] + b0), xr.y + (acc[4 * j + 2 * i + 1] + b1));
    }
  }
}

struct TcPlan {
  int win, nb, nblk, stages, smem;
};

// NB = 192, or 128 where that needs no more column blocks; WIN = 2 where
// two stages fit beside two windows (a CTA of two windows takes about as
// long as one of one, and one CTA fills an SM); column blocks of 128 where
// the CTAs would not fill nine tenths of the card; then the most stages
// (2-4) that fit, keeping a one-window CTA to half an SM where two stages
// allow it.
inline bool tc_plan(int windows, int c, int n, bool has_mask, TcPlan* p) {
  const int blocks192 = (c + 191) / 192, blocks128 = (c + 127) / 128;
  p->nb = blocks128 == blocks192 ? 128 : 192;
  p->nblk = blocks192;
  const int wbytes = tc_window_bytes(n, has_mask);
  const auto smem = [&](int win, int nb, int stages) {
    return 1024 + win * wbytes + stages * (nb / 64 * kTile + 16);
  };
  p->win = windows > 1 && smem(2, p->nb, 2) <= mlptc::kMaxSmem ? 2 : 1;
  const int ctas = (windows + p->win - 1) / p->win;
  if (p->nb == 192 && ctas * p->nblk < mlptc::kSMs * 9 / 10) {
    p->nb = 128;
    p->nblk = blocks128;
  }
  constexpr int kHalf = 233472 / 2 - 1024;  // two CTAs an SM, each with its 1 KB reserve
  p->stages = 0;
  while (p->stages < 4 && smem(p->win, p->nb, p->stages + 1) <= mlptc::kMaxSmem) ++p->stages;
  if (p->win == 1 && smem(1, p->nb, 2) <= kHalf) {
    while (smem(1, p->nb, p->stages) > kHalf) --p->stages;
  }
  p->smem = smem(p->win, p->nb, p->stages);
  return p->stages >= 2;
}

template <int DH, int NB>
int launch_tc_kernel(const TcPlan& p, const CUtensorMap& map, const void* qkv, const void* xres,
                     const float* bp, const float* bias, const float* mask, void* y, int windows,
                     int hh, int ww, int c, int heads, int ws, float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(swin_block_attention_tc_kernel<DH, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((windows + p.win - 1) / p.win, p.nblk);
  swin_block_attention_tc_kernel<DH, NB><<<grid, tc_threads(p.win), p.smem, s>>>(
      map, static_cast<const bf16*>(qkv), static_cast<const bf16*>(xres), bp, bias, mask,
      static_cast<bf16*>(y), windows, hh, ww, c, heads, ws, p.win, p.stages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_tc_dh(const TcPlan& p, const CUtensorMap& map, const void* qkv, const void* xres,
                 const float* bp, const float* bias, const float* mask, void* y, int windows,
                 int hh, int ww, int c, int heads, int ws, float scale, cudaStream_t s) {
  return p.nb == 128 ? launch_tc_kernel<DH, 128>(p, map, qkv, xres, bp, bias, mask, y, windows,
                                                 hh, ww, c, heads, ws, scale, s)
                     : launch_tc_kernel<DH, 192>(p, map, qkv, xres, bp, bias, mask, y, windows,
                                                 hh, ww, c, heads, ws, scale, s);
}

int launch_bf16(const void* qkv, const void* xres, const void* wp, const float* bp,
                const float* bias, const float* mask, void* y, int b, int hh, int ww, int c,
                int heads, int ws, float scale, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  if (n > 64 || dh % 8 != 0 || dh > 64 || !mlptc::aligned16(qkv) ||
      (reinterpret_cast<uintptr_t>(xres) & 3) != 0 || (reinterpret_cast<uintptr_t>(y) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int windows = b * (hh / ws) * (ww / ws);
  TcPlan p;
  if (!tc_plan(windows, c, n, mask != nullptr, &p)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cudaError_t err = mlptc::make_map(&map, wp, c, c, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto args = [&](auto launch) {
    return launch(p, map, qkv, xres, bp, bias, mask, y, windows, hh, ww, c, heads, ws, scale, s);
  };
  switch (dh / 8) {
    case 1: return args(launch_tc_dh<8>);
    case 2: return args(launch_tc_dh<16>);
    case 3: return args(launch_tc_dh<24>);
    case 4: return args(launch_tc_dh<32>);
    case 5: return args(launch_tc_dh<40>);
    case 6: return args(launch_tc_dh<48>);
    case 7: return args(launch_tc_dh<56>);
    default: return args(launch_tc_dh<64>);
  }
}


// ---- bf16 training forward (kernel 5): TF32 mma.sync, a warpgroup an item ---

// Shared memory of a kernel 5 CTA: two staging buffers of n8 rows x (3 G +
// 8) bf16 (q | k | v of the item's heads), the head group's bias (HPG n x n
// f32) and, for a shifted block, two window masks (n x n f32).
inline int train_fwd_smem(int n, int dh, bool has_mask) {
  const int hpg = wintc::train_heads(dh), ld = 3 * hpg * dh + 8, n8 = (n + 7) / 8 * 8;
  return static_cast<int>(2 * align16(static_cast<size_t>(n8) * ld * 2) +
                          align16(static_cast<size_t>(hpg) * n * n * 4) +
                          (has_mask ? 2 * align16(static_cast<size_t>(n) * n * 4) : 0));
}

// One CTA, one warpgroup: head group blockIdx.y (heads HPG y, + HPG), the
// windows blockIdx.x, + gridDim.x, ... in turn, the next window's q | k | v
// and mask copied in while this one is computed.
template <int DH>
__global__ void __launch_bounds__(wintc::kTrainThreads, 3)
swin_attention_tc_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                         const float* __restrict__ mask, bf16* __restrict__ out, int windows,
                         int hh, int ww, int c, int heads, int ws, float scale) {
  constexpr int HPG = wintc::train_heads(DH), G = HPG * DH, LD = 3 * G + 8;
  constexpr int kT = wintc::kTrainThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ws * ws, n8 = (n + 7) / 8 * 8, nn = n * n;
  const int h0 = blockIdx.y * HPG, nh = min(HPG, heads - h0), col0 = h0 * DH;
  const int stg = static_cast<int>(align16(static_cast<size_t>(n8) * LD * 2)) / 2;  // bf16
  bf16* S0 = reinterpret_cast<bf16*>(smem_raw);
  float* Bs = reinterpret_cast<float*>(S0 + 2 * stg);
  float* M0 = Bs + align16(static_cast<size_t>(HPG) * nn * 4) / 4;
  const int mstride = static_cast<int>(align16(static_cast<size_t>(nn) * 4) / 4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // window bw's q | k | v of the group's heads (16-byte pieces) and its
  // mask (4-byte pieces: a window's n^2 floats need not be 16-byte
  // aligned) into buffer buf
  const auto gather = [&](int bw, int buf) {
    const swin::Window w = swin::window_of(bw, hh, ww, ws);
    bf16* S = S0 + buf * stg;
    const int pieces = nh * DH / 8, per_row = 3 * pieces;
    for (int idx = tid; idx < n * per_row; idx += kT) {
      const int r = idx / per_row, sec = (idx % per_row) / pieces, p = idx % pieces;
      wintc::cp_async16(S + r * LD + sec * G + 8 * p,
                        qkv + w.token(r) * 3 * c + sec * c + col0 + 8 * p);
    }
    if (mask != nullptr) {
      const float* src = mask + static_cast<size_t>(w.wi) * nn;
      for (int i = tid; i < nn; i += kT) wintc::cp_async4(M0 + buf * mstride + i, src + i);
    }
  };

  // rows n to n8 of both buffers stay zero: the keys past n meet finite values
  for (int i = tid; i < (n8 - n) * LD; i += kT) {
    S0[n * LD + i] = __float2bfloat16_rn(0.f);
    S0[stg + n * LD + i] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < nh * nn; i += kT)
    wintc::cp_async4(Bs + i, bias + static_cast<size_t>(h0) * nn + i);
  int bw = blockIdx.x;
  gather(bw, 0);
  wintc::cp_async_commit();
  for (int it = 0; bw < windows; bw += gridDim.x, ++it) {
    const int buf = it & 1;
    wintc::cp_async_wait_all();
    __syncthreads();  // buffer buf has landed; every warp is done with buffer buf ^ 1
    if (bw + static_cast<int>(gridDim.x) < windows) gather(bw + gridDim.x, buf ^ 1);
    wintc::cp_async_commit();
    const swin::Window w = swin::window_of(bw, hh, ww, ws);
    const bf16* S = S0 + buf * stg;
    const float* mw = mask != nullptr ? M0 + buf * mstride : nullptr;
#pragma unroll
    for (int j = 0; j < HPG; ++j) {
      if (j >= nh) break;
      float p[8][4], o[DH / 8][4];
      wintc::staged_probs<DH, G>(S, LD, j, n, warp * 16, scale, Bs + j * nn, mw, p);
      wintc::pv<DH>(
          p, [&](int key, int d) { return __bfloat162float(S[key * LD + 2 * G + j * DH + d]); },
          n, o);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
        if (r >= n) continue;
        bf16* dst = out + w.token(r) * c + col0 + j * DH + 2 * t;
#pragma unroll
        for (int dt = 0; dt < DH / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * dt) =
              __floats2bfloat162_rn(o[dt][2 * i], o[dt][2 * i + 1]);
      }
    }
  }
}

template <int DH>
int launch_train_tc(const void* qkv, const float* bias, const float* mask, void* out,
                    int windows, int hh, int ww, int c, int heads, int ws, float scale,
                    cudaStream_t s) {
  constexpr int HPG = wintc::train_heads(DH);
  const int smem = train_fwd_smem(ws * ws, DH, mask != nullptr);
  cudaError_t err = cudaFuncSetAttribute(swin_attention_tc_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hgroups = (heads + HPG - 1) / HPG;
  const dim3 grid(wintc::train_ctas(windows, hgroups), hgroups);
  swin_attention_tc_kernel<DH><<<grid, wintc::kTrainThreads, smem, s>>>(
      static_cast<const bf16*>(qkv), bias, mask, static_cast<bf16*>(out), windows, hh, ww, c,
      heads, ws, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_bf16(const void* qkv, const float* bias, const float* mask, void* out, int b,
                    int hh, int ww, int c, int heads, int ws, float scale, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  if (n > 64 || dh % 8 != 0 || dh > 64 || dh == 0 || !mlptc::aligned16(qkv) ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int windows = b * (hh / ws) * (ww / ws);
  const auto args = [&](auto launch) {
    return launch(qkv, bias, mask, out, windows, hh, ww, c, heads, ws, scale, s);
  };
  switch (dh / 8) {
    case 1: return args(launch_train_tc<8>);
    case 2: return args(launch_train_tc<16>);
    case 3: return args(launch_train_tc<24>);
    case 4: return args(launch_train_tc<32>);
    case 5: return args(launch_train_tc<40>);
    case 6: return args(launch_train_tc<48>);
    case 7: return args(launch_train_tc<56>);
    default: return args(launch_train_tc<64>);
  }
}

}  // namespace

// workspace: (b, hh, ww, c) f32 for float32 (the attention's output before
// the projection), unused (null) in bf16.
TT_EXPORT int tt_swin_block_attention(const void* qkv, const void* xres, const void* wp,
                                      const void* bp, const void* bias, const void* mask,
                                      void* y, void* workspace, int b, int hh, int ww, int c,
                                      int heads, int ws, float scale, int is_bf16,
                                      void* stream) {
  const float* fbp = static_cast<const float*>(bp);
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(qkv, xres, wp, fbp, fbias, fmask, y, b, hh, ww, c, heads, ws,
                               scale, s)
                 : launch_f32(qkv, xres, wp, fbp, fbias, fmask, y, workspace, b, hh, ww, c,
                              heads, ws, scale, s);
}

TT_EXPORT int tt_swin_attention(const void* qkv, const void* bias, const void* mask, void* out,
                                int b, int hh, int ww, int c, int heads, int ws, float scale,
                                int is_bf16, void* stream) {
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd_bf16(qkv, fbias, fmask, out, b, hh, ww, c, heads, ws, scale, s)
                 : launch_fwd(qkv, fbias, fmask, out, b, hh, ww, c, heads, ws, scale, s);
}
