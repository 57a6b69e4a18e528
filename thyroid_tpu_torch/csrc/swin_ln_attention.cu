// LayerNorm + QKV projection + shifted-window attention from the raw stream.
//
// tt_swin_ln_attention replaces the TPU kernel thyroid_tpu/ops/attention.py
// _swin_ln_kernel (pallas_call in fused_swin_ln_attention), the serving
// path of WindowAttention(ln_kernel=True).
//
// What it computes, for x (B, H, W, C) in the compute type (the residual
// stream, already rolled if the block is shifted), for every ws x ws
// window and its tokens t:
//   xn = ((x - mu) * rsqrt(max(0, E[x^2] - mu^2) + eps)) * gamma + beta
//        in f32, rounded to the compute type;
//   q, k, v = xn W (W (C, 3C) in the compute type, f32 accumulation)
//             + the f32 QKV bias; q *= scale in f32;
// then per head, in f32, S = q k^T + bias[head] (+ mask[window]),
// P = softmax(S), O = P v, stored in the compute type at the window's own
// positions of the (B, H, W, C) output (before the out-projection).
// Window partition and reverse are index arithmetic, never a copy.
//
// Bound on the H100: per window 2*N*C*3C operations for the projection and
// 4*N^2*C for attention (about 75 GFLOP over swin_tiny's 12 blocks at batch
// 32, about 0.08 ms at the bf16 tensor-core peak), on 2*N*C elements moved
// plus the weight; the projection's operations (88% of them) bound it.
//
// bf16 (swin_ln_attention_tc_kernel) runs the projection on wgmma and the
// attention core on TF32 mma.sync (window_tc.cuh). A CTA takes WIN = 1 or 2
// windows (one consumer warpgroup each, M = 64 rows: the window's n <= 64
// tokens and zero rows) and a run of head groups:
// - each warpgroup copies its window's token rows with cp.async (every
//   16-byte piece in flight at once) into a 128-byte-swizzled bf16 A tile
//   in shared memory (C / 64 blocks of 8 KB: 96 KB a window at C = 768),
//   zeros past n and past C, and normalises them there in place (a warp a
//   row, f32 statistics, the rounding above);
// - a head group is the heads whose q columns fit one 64-column TMA box
//   (64 / dh heads: two at Swin's dh = 32, which answers dh's 64 bytes being
//   half a 128-byte-swizzled box); one producer thread loads, per 64-deep
//   k-tile, its q, k and v boxes of W (three tensor maps of C x C at column
//   offsets 0, C, 2C, row stride 3C: boxes past C read zeros; W is the
//   MN-major B, never transposed) into a ring of mbarrier-guarded stages
//   shared by the CTA's windows, so that two windows read the weight once;
// - each warpgroup runs wgmma m64n192k16 into a 64 x 192 f32 register tile
//   (q | k | v of the group), adds the bias, scales q, keeps q in registers
//   and writes k and v in f32 to shared memory; then per head of the group
//   each warp takes its 16 rows through window_tc.cuh (S and P v in TF32,
//   bias, mask and softmax in f32) and stores O in bf16.
// WIN = 2 where it fits in shared memory (C <= 384) and the pairs of
// windows still fill the 132 SMs once (swin_tiny at batch 32: stages 1-3,
// 1,024 / 256 / 64 CTAs of 2 windows), else 1 (stage 4); head groups go to
// separate CTAs (as few as possible) until the grid fills two waves: stage 1
// all 2 groups a CTA (1,024 CTAs), stage 2 2 + 1 (512), stage 3 one (384),
// stage 4 one (32 windows x 12 groups). Shared memory: the ring (2-8 stages
// of 24 KB), the A tiles, 35 KB of K and V a window.
// Above C = 1024 (swin_large's stage 4 has C = 1536: 192 KB of A tile a
// window, more than fits beside two stages) A is not resident: a first
// kernel of the same call (ln_windows_kernel) normalises every window's
// rows, with the same arithmetic and rounding as ln_window, into a bf16
// workspace in window order (row w * n + t), and the producer streams
// each window's 64 x 64 A k-tile from there by TMA into the same stage as
// the k-tile's weight boxes (rows past the window's n belong to the next
// window or read zeros past the end; they land only in rows the epilogue
// zeroes or never stores). Takes dh a multiple of 8 up to 64 and C up to
// 1536; other shapes are refused in bf16.
//
// float32 (the card-vs-CPU parity path) keeps the scalar kernel below: TF32
// would not hold the 2e-5 float32 checks. One block of 256 threads per
// window and group of heads (all the heads where the windows fill the card,
// fewer in the late stages; see heads_per_block). A warp per token computes
// the LayerNorm and stores xn (N x C) in shared memory; per head its q, k, v
// columns (3*dh) stream through shared memory in 32 x 128 tiles into
// register accumulators of scalar f32 FMAs; the epilogue adds the bias and
// the scale into the f32 Qs, Ks, Vs of swin_window.cuh's core, whose
// scores, softmax and P v follow. A C above about 900 does not fit in
// shared memory, and the launch is refused.
#include "mlp_tc.cuh"
#include "swin_window.cuh"
#include "window_tc.cuh"

namespace {

using swin::kThreads;
using swin::kWarps;
constexpr int kCols = 128;  // projection column tile (local q|k|v columns of one head)
constexpr int kBK = 32;     // projection K chunk

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

template <typename T>
size_t smem_bytes(int n, int c, int dh) {
  return align16(sizeof(T) * static_cast<size_t>(n) * c) +
         sizeof(float) * (static_cast<size_t>(kBK) * kCols + 2 * static_cast<size_t>(n) * (dh + 1) +
                          static_cast<size_t>(n) * dh + static_cast<size_t>(n) * (n + 1));
}

// Heads per block: all of them where the windows alone give at least two
// blocks per SM; else the most that still do, so that the late stages'
// few windows (32 at swin_tiny's last stage and batch 32) fill the card.
// Each block of a window recomputes its LayerNorm, a small share of the
// projection's work.
int heads_per_block(int windows, int heads) {
  constexpr int kEnough = 2 * 132;
  for (int hpb = heads; hpb > 1; --hpb) {
    if (static_cast<long long>(windows) * ((heads + hpb - 1) / hpb) >= kEnough) return hpb;
  }
  return 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swin_ln_attention_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const T* __restrict__ w,
                         const float* __restrict__ bqkv, const float* __restrict__ bias,
                         const float* __restrict__ mask, T* __restrict__ out, int hh, int ww,
                         int c, int heads, int hpb, int ws, float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ws * ws, dh = c / heads, cols = 3 * dh;
  const swin::Window win = swin::window_of(blockIdx.x, hh, ww, ws);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  T* Xn = reinterpret_cast<T*>(smem_raw);  // n x c, the compute type
  float* Ws = reinterpret_cast<float*>(smem_raw + align16(sizeof(T) * static_cast<size_t>(n) * c));
  float* Qs = Ws + kBK * kCols;    // n x (dh + 1)
  float* Ks = Qs + n * (dh + 1);   // n x (dh + 1)
  float* Vs = Ks + n * (dh + 1);   // n x dh
  float* Ss = Vs + n * dh;         // n x (n + 1)

  // LayerNorm, a warp per token, statistics in f32
  for (int t = warp; t < n; t += kWarps) {
    const T* xr = x + win.token(t) * c;
    float s = 0.f, s2 = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float v = to_f32(xr[j]);
      s += v;
      s2 = fmaf(v, v, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / c;
    const float rs = rsqrtf(fmaxf(0.f, s2 / c - mu * mu) + eps);
    for (int j = lane; j < c; j += 32) {
      Xn[t * c + j] = from_f32<T>((to_f32(xr[j]) - mu) * rs * gamma[j] + beta[j]);
    }
  }
  __syncthreads();

  const int ty = tid / 32, tx = tid % 32;
  const int h_begin = static_cast<int>(blockIdx.y) * hpb;
  const int h_end = min(heads, h_begin + hpb);
  for (int h = h_begin; h < h_end; ++h) {
    // q, k, v of head h: local column lc of 3*dh is global column
    // (lc / dh) * c + h * dh + lc % dh of W
    for (int cb = 0; cb < cols; cb += kCols) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < c; k0 += kBK) {
        for (int i = tid; i < kBK * kCols; i += kThreads) {
          const int kk = i / kCols, lc = cb + i % kCols, k = k0 + kk;
          Ws[i] = (k < c && lc < cols)
                      ? to_f32(w[static_cast<size_t>(k) * 3 * c + (lc / dh) * c + h * dh + lc % dh])
                      : 0.f;
        }
        __syncthreads();
        const int kmax = min(kBK, c - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Ws[kk * kCols + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = ty + 8 * i;
            if (r < n) {
              const float a = to_f32(Xn[r * c + k0 + kk]);
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 8 * i;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lc = cb + tx + 32 * j;
          if (lc >= cols) continue;
          const int part = lc / dh, d = lc % dh;
          const float y = acc[i][j] + (bqkv != nullptr ? bqkv[part * c + h * dh + d] : 0.f);
          if (part == 0) {
            Qs[r * (dh + 1) + d] = y * scale;
          } else if (part == 1) {
            Ks[r * (dh + 1) + d] = y;
          } else {
            Vs[r * dh + d] = y;
          }
        }
      }
    }
    __syncthreads();
    swin::scores_softmax(bias + static_cast<size_t>(h) * n * n,
                         mask != nullptr ? mask + static_cast<size_t>(win.wi) * n * n : nullptr,
                         n, dh, Qs, Ks, Ss);
    swin::head_pv(Ss, Vs, dh, n, dh, [&](int r, int d, float o) {
      out[win.token(r) * c + h * dh + d] = from_f32<T>(o);
    });
  }
}

int launch_f32(const void* x, const float* gamma, const float* beta, const void* w,
               const float* bqkv, const float* bias, const float* mask, void* out, int b, int hh,
               int ww, int c, int heads, int ws, float scale, float eps, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  const size_t smem = smem_bytes<float>(n, c, dh);
  cudaError_t err = cudaFuncSetAttribute(swin_ln_attention_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int windows = b * (hh / ws) * (ww / ws);
  const int hpb = heads_per_block(windows, heads);
  const dim3 grid(windows, (heads + hpb - 1) / hpb);
  swin_ln_attention_kernel<float><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), gamma, beta, static_cast<const float*>(w), bqkv, bias, mask,
      static_cast<float*>(out), hh, ww, c, heads, hpb, ws, scale, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: projection on wgmma, attention on TF32 mma.sync -----------------

using mlptc::bf16;
using mlptc::kTile;

constexpr int kMaxWin = 2;                    // windows of a CTA
constexpr int kStageTc = 3 * kTile;           // one k-tile of a group's q, k, v boxes
constexpr int kKvBytes = 64 * (wintc::kLdK + wintc::kLdV) * 4;  // K and V of a window
constexpr int kMaxChunks = 4;                 // 16-byte pieces of a row a lane: C <= 1024
constexpr int kMaxResidentC = 8 * 32 * kMaxChunks;  // widest C whose A tiles stay resident
constexpr int kMaxC = 1536;                   // widest C: streamed A above kMaxResidentC

__host__ __device__ constexpr int tc_threads(int win) { return win * 128 + 32; }

// Bytes of one ring stage: a k-tile's q, k and v boxes, and with a
// streamed A each window's A k-tile.
inline int tc_stage_bytes(int win, bool stream) { return kStageTc + (stream ? win * kTile : 0); }

// Shared memory: 1024 bytes of alignment slack, the ring, the windows'
// resident A tiles (none when streamed), their K and V, the mbarriers.
inline int tc_smem(int win, int nkb, int stages, bool stream) {
  return 1024 + stages * tc_stage_bytes(win, stream) + win * ((stream ? 0 : nkb * kTile) + kKvBytes) +
         16 * stages;
}

struct TcPlan {
  int win, gpc, groups, nkb, stages, smem;
  bool stream;  // A streamed from the workspace (C > kMaxResidentC)
};

// WIN = 2 where two stages fit beside two windows and the pairs fill the
// card once; then the most head groups a CTA that still give two waves.
inline bool tc_plan(int windows, int heads, int c, int dh, TcPlan* p) {
  p->nkb = (c + 63) / 64;
  p->groups = (heads + 64 / dh - 1) / (64 / dh);
  p->stream = c > kMaxResidentC;
  auto stages_for = [&](int win) {
    int st = 0;
    while (st < 8 && tc_smem(win, p->nkb, st + 1, p->stream) <= mlptc::kMaxSmem) ++st;
    return st;
  };
  p->win = stages_for(2) >= 2 && (windows + 1) / 2 * p->groups >= mlptc::kSMs ? 2 : 1;
  p->stages = stages_for(p->win);
  if (p->stages < 2) return false;
  p->smem = tc_smem(p->win, p->nkb, p->stages, p->stream);
  const int ctas = (windows + p->win - 1) / p->win;
  p->gpc = 1;
  for (int g = p->groups; g >= 1; --g) {
    if (static_cast<long long>(ctas) * ((p->groups + g - 1) / g) >= 2 * mlptc::kSMs) {
      p->gpc = g;
      break;
    }
  }
  return true;
}

// The LayerNorm's two halves on one 16-byte piece (8 bf16 of columns
// 8 ch..): add its values to the row's sums, in column order; normalise
// it, (v - mu) * rs * gamma + beta rounded to bf16.
__device__ __forceinline__ void ln_sums(const uint4& raw, float& s, float& s2) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float v = __bfloat162float(e[q]);
    s += v;
    s2 = fmaf(v, v, s2);
  }
}

__device__ __forceinline__ uint4 ln_piece(const uint4& raw, int ch, float mu, float rs,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  uint32_t packed[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = 8 * ch + 2 * q;
    const __nv_bfloat162 y = __floats2bfloat162_rn(
        (__bfloat162float(e[2 * q]) - mu) * rs * gamma[k] + beta[k],
        (__bfloat162float(e[2 * q + 1]) - mu) * rs * gamma[k + 1] + beta[k + 1]);
    packed[q] = *reinterpret_cast<const uint32_t*>(&y);
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// The LayerNorm of ln_window for C above kMaxResidentC, before the
// tensor-core kernel: a warp a row of the windows' rows (row w * n + t is
// token t of window w), read twice from global memory (statistics, then
// the pieces), into xn (row stride c) in bf16.
__global__ void __launch_bounds__(256)
ln_windows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, bf16* __restrict__ xn, int rows, int hh,
                  int ww, int ws, int c, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int n = ws * ws, chunks = c / 8;
  const uint4* src =
      reinterpret_cast<const uint4*>(x + swin::window_of(row / n, hh, ww, ws).token(row % n) * c);
  uint4* dst = reinterpret_cast<uint4*>(xn + static_cast<size_t>(row) * c);
  float s = 0.f, s2 = 0.f;
  for (int ch = lane; ch < chunks; ch += 32) ln_sums(src[ch], s, s2);
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / c;
  const float rs = rsqrtf(fmaxf(0.f, s2 / c - mu * mu) + eps);
  for (int ch = lane; ch < chunks; ch += 32) dst[ch] = ln_piece(src[ch], ch, mu, rs, gamma, beta);
}

// One consumer warpgroup's window: LayerNorm its tokens into the swizzled A
// tile at a_w (nkb blocks of 64 rows x 64 columns), zeros past n and C.
// The raw rows land first, every 16-byte piece in flight at once (cp.async
// into the piece's own swizzled place); then a warp a row normalises them
// in place from shared memory. Ends with the warpgroup's A tile complete.
__device__ __forceinline__ void ln_window(const swin::Window& wd, const bf16* __restrict__ x,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta, uint32_t a_w, int n,
                                          int c, int nkb, float eps, int bar) {
  const int lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
  const int chunks = c / 8, slots = nkb * 8;
  for (int idx = lt; idx < 64 * slots; idx += 128) {
    const int r = idx / slots, ch = idx % slots;
    const uint32_t dst = a_w + (ch / 8) * kTile + wg::swz(r, ch % 8);
    if (r < n && ch < chunks) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(x + wd.token(r) * c + 8 * ch)
                   : "memory");
    } else {
      wg::st_shared_v4(dst, make_uint4(0u, 0u, 0u, 0u));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  wg::bar_sync(bar, 128);
  for (int r = warp; r < n; r += 4) {
    uint4 raw[kMaxChunks];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int ch = lane + 32 * i;
      if (ch < chunks) {
        raw[i] = wg::ld_shared_v4(a_w + (ch / 8) * kTile + wg::swz(r, ch % 8));
        ln_sums(raw[i], s, s2);
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / c;
    const float rs = rsqrtf(fmaxf(0.f, s2 / c - mu * mu) + eps);
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int ch = lane + 32 * i;
      if (ch >= chunks) continue;
      wg::st_shared_v4(a_w + (ch / 8) * kTile + wg::swz(r, ch % 8),
                       ln_piece(raw[i], ch, mu, rs, gamma, beta));
    }
  }
  wg::fence_proxy();
  wg::bar_sync(bar, 128);
}

// One CTA: windows [WIN x, +WIN) (consumer warpgroup w: window WIN x + w),
// head groups [gpc y, +gpc) of 64 / DH heads. The first thread after the
// consumers loads the weight boxes, and with `stream` (m_a: the
// workspace's normalised rows) the windows' A k-tiles beside them.
template <int DH>
__global__ void __launch_bounds__(tc_threads(kMaxWin), 1)
swin_ln_attention_tc_kernel(const __grid_constant__ CUtensorMap m_q,
                            const __grid_constant__ CUtensorMap m_k,
                            const __grid_constant__ CUtensorMap m_v,
                            const __grid_constant__ CUtensorMap m_a, const bf16* __restrict__ x,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            const float* __restrict__ bqkv, const float* __restrict__ bias,
                            const float* __restrict__ mask, bf16* __restrict__ out, int windows,
                            int hh, int ww, int c, int heads, int ws, int win, int gpc,
                            int stages, int stream, float scale, float eps) {
  constexpr int HPG = 64 / DH;  // heads of a group
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int n = ws * ws, nkb = (c + 63) / 64;
  const int stage_bytes = kStageTc + (stream ? win * kTile : 0);
  const uint32_t a0 = base + stages * stage_bytes;     // WIN resident A tiles of nkb blocks
  const uint32_t kv0 = a0 + (stream ? 0 : win * nkb * kTile);  // WIN times K (64 x kLdK), V (64 x kLdV)
  const uint32_t bars = kv0 + win * kKvBytes;          // stages full, then stages empty
  const int tid = threadIdx.x, wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int w_first = blockIdx.x * win, active = min(win, windows - w_first);
  const int groups = (heads + HPG - 1) / HPG;
  const int g0 = blockIdx.y * gpc, ng = min(groups, g0 + gpc) - g0;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      wg::mbar_init(bars + 8 * i, 1);
      wg::mbar_init(bars + 8 * (stages + i), active);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (wgi == win) {  // the producer: tile i is k-tile i % nkb of group g0 + i / nkb
    if (tid == win * 128) {
      for (int i = 0; i < ng * nkb; ++i) {
        const int s = i % stages, col = (g0 + i / nkb) * HPG * DH, row = 64 * (i % nkb);
        const uint32_t st = base + s * stage_bytes, full = bars + 8 * s;
        wg::mbar_wait(bars + 8 * (stages + s), ((i / stages) & 1) ^ 1);
        wg::mbar_expect_tx(full, kStageTc + (stream ? active * kTile : 0));
        wg::tma_load(st, &m_q, col, row, full);
        wg::tma_load(st + kTile, &m_k, col, row, full);
        wg::tma_load(st + 2 * kTile, &m_v, col, row, full);
        if (stream)
          for (int j = 0; j < active; ++j)
            wg::tma_load(st + kStageTc + j * kTile, &m_a, row, (w_first + j) * n, full);
      }
    }
    return;
  }
  if (wgi >= active) return;

  const swin::Window wd = swin::window_of(w_first + wgi, hh, ww, ws);
  const uint32_t a_w = a0 + wgi * nkb * kTile;
  float* Ks = reinterpret_cast<float*>(smem_raw + (kv0 - raw) + wgi * kKvBytes);
  float* Vs = Ks + 64 * wintc::kLdK;
  const int lt = tid & 127, warp = lt >> 5, lane = lt & 31, g = lane >> 2, t = lane & 3;
  const float* mask_w = mask != nullptr ? mask + static_cast<size_t>(wd.wi) * n * n : nullptr;

  if (!stream) ln_window(wd, x, gamma, beta, a_w, n, c, nkb, eps, 1 + wgi);

  float acc[96];  // q | k | v of the group: 64 rows x 192 columns
  int tile = 0;
  for (int gi = 0; gi < ng; ++gi) {
    const int grp = g0 + gi, col0 = grp * HPG * DH;
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nkb; ++kb, ++tile) {
      const int s = tile % stages;
      const uint32_t st = base + s * stage_bytes;
      wg::mbar_wait(bars + 8 * s, (tile / stages) & 1);
      mlptc::mma_tile<192, 1>(acc, stream ? st + kStageTc + wgi * kTile : a_w + kb * kTile, st);
      wg::wait<0>();
      if (lt == 0) wg::mbar_arrive(bars + 8 * (stages + s));
    }
    wg::fence_regs(acc);

    // + the QKV bias, q * scale; k and v (zero rows past n) to shared memory
    wg::bar_sync(1 + wgi, 128);  // the last group's reads of Ks, Vs are done
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp * 16 + g + 8 * i, lc = 8 * j + 2 * t;
        float y[3][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + lc + e;
          const bool ok = lc + e < HPG * DH && col < c;
#pragma unroll
          for (int sec = 0; sec < 3; ++sec) {
            const float b = ok && bqkv != nullptr ? bqkv[sec * c + col] : 0.f;
            y[sec][e] = ok ? acc[32 * sec + 4 * j + 2 * i + e] + b : 0.f;
          }
          acc[4 * j + 2 * i + e] = y[0][e] * scale;
        }
        const bool live = row < n;
        *reinterpret_cast<float2*>(Ks + row * wintc::kLdK + lc) =
            live ? make_float2(y[1][0], y[1][1]) : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(Vs + row * wintc::kLdV + lc) =
            live ? make_float2(y[2][0], y[2][1]) : make_float2(0.f, 0.f);
      }
    wg::bar_sync(1 + wgi, 128);  // K and V are complete

#pragma unroll
    for (int j = 0; j < HPG; ++j) {
      const int h = grp * HPG + j;
      if (h >= heads) break;
      float q[DH / 8][4], o[DH / 8][4];
#pragma unroll
      for (int kc = 0; kc < DH / 8; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) q[kc][e] = acc[4 * (j * DH / 8 + kc) + e];
      const float* bias_h = bias + static_cast<size_t>(h) * n * n;
      wintc::attend<DH>(q, Ks + j * DH, Vs + j * DH, n, warp * 16,
                        [&](int r, int key) {
                          return bias_h[r * n + key] +
                                 (mask_w != nullptr ? mask_w[r * n + key] : 0.f);
                        },
                        o);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
        if (r >= n) continue;
        bf16* dst = out + wd.token(r) * c + h * DH + 2 * t;
#pragma unroll
        for (int dt = 0; dt < DH / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * dt) =
              __floats2bfloat162_rn(o[dt][2 * i], o[dt][2 * i + 1]);
      }
    }
  }
}

template <int DH>
int launch_tc_kernel(const TcPlan& p, const CUtensorMap (&maps)[4], const void* x,
                     const float* gamma, const float* beta, const float* bqkv, const float* bias,
                     const float* mask, void* out, int windows, int hh, int ww, int c, int heads,
                     int ws, float scale, float eps, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(swin_ln_attention_tc_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((windows + p.win - 1) / p.win, (p.groups + p.gpc - 1) / p.gpc);
  swin_ln_attention_tc_kernel<DH><<<grid, tc_threads(p.win), p.smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(x), gamma, beta, bqkv, bias,
      mask, static_cast<bf16*>(out), windows, hh, ww, c, heads, ws, p.win, p.gpc, p.stages,
      static_cast<int>(p.stream), scale, eps);
  return static_cast<int>(cudaGetLastError());
}

// work: the normalised rows (windows * n x c bf16) where C > kMaxResidentC,
// else unused.
int launch_bf16(const void* x, const float* gamma, const float* beta, const void* w,
                const float* bqkv, const float* bias, const float* mask, void* out, void* work,
                int b, int hh, int ww, int c, int heads, int ws, float scale, float eps,
                cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  if (n > 64 || dh % 8 != 0 || dh > 64 || c > kMaxC || !mlptc::aligned16(x) ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int windows = b * (hh / ws) * (ww / ws);
  TcPlan p;
  if (!tc_plan(windows, heads, c, dh, &p)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  for (int sec = 0; sec < 3; ++sec) {
    const cudaError_t err =
        mlptc::make_map(&maps[sec], static_cast<const bf16*>(w) + sec * c, c, c, 3 * c);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  maps[3] = maps[0];
  if (p.stream) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int rows = windows * n;
    ln_windows_kernel<<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(x), gamma, beta,
                                                     static_cast<bf16*>(work), rows, hh, ww, ws,
                                                     c, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = mlptc::make_map(&maps[3], work, rows, c, c);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto args = [&](auto launch) {
    return launch(p, maps, x, gamma, beta, bqkv, bias, mask, out, windows, hh, ww, c, heads, ws,
                  scale, eps, s);
  };
  switch (dh / 8) {
    case 1: return args(launch_tc_kernel<8>);
    case 2: return args(launch_tc_kernel<16>);
    case 3: return args(launch_tc_kernel<24>);
    case 4: return args(launch_tc_kernel<32>);
    case 5: return args(launch_tc_kernel<40>);
    case 6: return args(launch_tc_kernel<48>);
    case 7: return args(launch_tc_kernel<56>);
    default: return args(launch_tc_kernel<64>);
  }
}

}  // namespace

// x, out: (b, hh, ww, c) in the compute type; gamma, beta (c,) f32; w (c, 3c)
// in the compute type; bqkv (3c,) f32 or null; bias (heads, n, n) f32; mask
// (nW, n, n) f32 or null; work: in bf16 above C = 1024 a workspace of
// b * hh * ww * c bf16 (the normalised rows), else null.
TT_EXPORT int tt_swin_ln_attention(const void* x, const void* gamma, const void* beta,
                                   const void* w, const void* bqkv, const void* bias,
                                   const void* mask, void* out, void* work, int b, int hh, int ww,
                                   int c, int heads, int ws, float scale, float eps, int is_bf16,
                                   void* stream) {
  const float* fg = static_cast<const float*>(gamma);
  const float* fb = static_cast<const float*>(beta);
  const float* fq = static_cast<const float*>(bqkv);
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(x, fg, fb, w, fq, fbias, fmask, out, work, b, hh, ww, c, heads, ws,
                               scale, eps, s)
                 : launch_f32(x, fg, fb, w, fq, fbias, fmask, out, b, hh, ww, c, heads, ws,
                              scale, eps, s);
}
