// Per-window multi-head attention on separate q, k, v.
//
// tt_window_attention replaces the TPU kernel thyroid_tpu/ops/attention.py
// _attention_kernel (pallas_call in fused_window_attention).
//
// What it computes, for q, k, v (BW, heads, N, D) in the compute type (f32
// or bf16), bias (heads, N, N) f32 and mask (nW, N, N) f32 or null, window
// b taking mask[b % nW]: for every window and head, in f32,
//   S = (q * scale) k^T + bias[head] (+ mask),  e = exp(S - max S),
//   P = e / sum(e),  O = P v,
// O stored in the compute type. The TPU kernel pads N to a multiple of 16
// with -1e9 on the pad keys; here keys at or past N get exactly 0.
//
// Bound on the H100: per window and head (an item) 4*N^2*D operations on
// 4*N*D elements moved (q, k, v read, O written) plus the bias and mask;
// at N = 49, D = 32 that is about 50 operations per byte in bf16, so the
// card's bandwidth bounds it (12.5 KB an item; 0.11 ms for the 29,184
// items of a swin_tiny forward at batch 32).
//
// bf16 with D a multiple of 16 up to 64 (Swin's D is 32 in every config),
// window_attention_tc_kernel<D>, on wgmma:
// - Work grouped by side table. Every item of one (head h, window index
//   b % nW) group, or of one head without a mask, adds the same n x n f32
//   table bias[h] (+ mask[b % nW]). Items are ordered group by group and a
//   CTA takes a contiguous run of them, so it loads a table once per group
//   it meets (into registers: each thread its 32 accumulator positions,
//   -inf at keys past n, 0 at rows past n), not once per item; a table in
//   shared memory at a 72-float pitch measured slower (chip_compare.py's
//   k8_table_smem cut). The grid
//   is as many CTAs as the occupancy query lets stay resident (four an
//   SM: at most 128 registers a thread, 49 KB of shared memory), the runs
//   equal to one item: no tail wave, and 24 groups at swin_tiny's stage 4
//   still fill the 132 SMs. A cursor walks the run with 32-bit counters,
//   no division an item.
// - q, k, v streamed an item ahead. One warpgroup (M = 64 >= n rows) a
//   CTA; each item's three n x D blocks (contiguous, 3,136 bytes each at
//   n = 49, D = 32) come by 16-byte cp.async into a ring of kStages = 2
//   stages of three 64-row, 128-byte-swizzled tiles (wgmma.cuh's layout,
//   D / 8 of a row's eight chunks used): the next item's copy runs while
//   this one is computed. A third stage (three CTAs an SM) measured 8%
//   slower, occupancy being what hides the chain of each item.
//   Rows n..63 and the chunks past D were zeroed once and are never
//   written, so every value wgmma reads is finite. (A bulk copy would land
//   the rows unswizzled at a pitch of 2 D bytes, which no wgmma operand
//   layout reads; a TMA tensor copy would need a tensor map a call and a
//   swizzle mode a head width.)
// - bf16 operands straight into the tensor cores. S = Q K^T is D / 16
//   m64n64k16 steps from the Q and K tiles (both K-major), then in f32 on
//   the accumulator: S * scale (not q * scale rounded to bf16), + the
//   table, the softmax over a row's 64 keys (a quad of lanes: two
//   shuffles), e^x as __expf and one reciprocal a row (kernels 4-6's fast
//   form). P rounded to bf16 is the register A operand of O = P V, four
//   m64n64k16 steps over the keys with the V tile as the MN-major B (the
//   columns past D are zeros, their O columns never stored). 6 wgmma an
//   item at D = 32. window_tc.cuh's TF32 mma.sync core (kernel 5's) on the
//   same ring measured about twice as slow (the k8_tf32_core cut).
// - O rounded to bf16 from the accumulators, rows < n only, at the item's
//   own place (a quad of lanes writes a row's 16 contiguous bytes a tile).
// Numbers against the JAX kernel, which keeps P in f32: P is rounded to
// bf16 (relative 2^-8) before P V; held to the bf16 tolerance, and to the
// model of these roundings in tests/test_torch_window_attention_tc.py.
// No atomics: two runs are bit-equal.
//
// float32, and bf16 at other head widths: window_attention_kernel, one
// block of 256 threads per item; q, k, v go into shared memory as f32 (q
// already scaled), the scores, the softmax (a warp per row) and P v are
// swin_window.cuh's scalar core, the bias and mask read from global
// memory.
#include "swin_window.cuh"
#include "wgmma.cuh"

#include <math_constants.h>

namespace {

using swin::kThreads;

size_t smem_bytes(int n, int d) {
  return sizeof(float) * (2 * static_cast<size_t>(n) * (d + 1) + static_cast<size_t>(n) * d +
                          static_cast<size_t>(n) * (n + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ out, int heads, int n,
                        int d, int nw, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // n x (d + 1)
  float* Ks = Qs + n * (d + 1);                    // n x (d + 1)
  float* Vs = Ks + n * (d + 1);                    // n x d
  float* Ss = Vs + n * d;                          // n x (n + 1)
  const int bh = blockIdx.x;                       // window * heads + head
  const int b = bh / heads, h = bh % heads;
  const size_t base = static_cast<size_t>(bh) * n * d;
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    const int t = i / d, j = i % d;
    Qs[t * (d + 1) + j] = to_f32(q[base + i]) * scale;
    Ks[t * (d + 1) + j] = to_f32(k[base + i]);
    Vs[i] = to_f32(v[base + i]);
  }
  __syncthreads();
  swin::scores_softmax(bias + static_cast<size_t>(h) * n * n,
                       mask != nullptr ? mask + static_cast<size_t>(b % nw) * n * n : nullptr,
                       n, d, Qs, Ks, Ss);
  swin::head_pv(Ss, Vs, d, n, d,
                [&](int r, int j, float o) { out[base + r * d + j] = from_f32<T>(o); });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, const float* mask,
           void* out, int bw, int heads, int n, int d, int nw, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(n, d);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_kernel<T><<<bw * heads, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(out), heads, n, d, nw, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 on wgmma -----------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;          // one warpgroup: M = 64 query rows
constexpr int kStages = 2;               // the ring of q | k | v stages
constexpr int kMinCtas = 4;              // CTAs an SM: at most 128 registers a thread
constexpr int kTcTile = 64 * 128;        // a 64-row, 128-byte-swizzled bf16 tile: 8 KB

constexpr int tc_smem_bytes() { return 1024 + kStages * 3 * kTcTile; }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The value of the table of (head h, window index wi) at row r, key c:
// bias (+ mask) in f32 inside the n x n window, -inf at keys past n (P is
// exactly 0 there), 0 at rows past n (computed, never stored).
__device__ __forceinline__ float table_at(const float* bh, const float* mw, int n, int r, int c) {
  if (c >= n) return -CUDART_INF_F;
  if (r >= n) return 0.f;
  return mw != nullptr ? bh[r * n + c] + mw[r * n + c] : bh[r * n + c];
}

// Item L of the group-major order: group L / per_group is head h at
// window index wi (h = group / nw, wi = group % nw), its j-th item (j = L %
// per_group) window wi + j nw. A cursor walks the order without dividing.
struct Cursor {
  int h, wi, j;
  __device__ Cursor(int L, int per_group, int nw)
      : h(L / per_group / nw), wi(L / per_group % nw), j(L % per_group) {}
  __device__ void next(int per_group, int nw) {
    if (++j < per_group) return;
    j = 0;
    if (++wi < nw) return;
    wi = 0;
    ++h;
  }
  __device__ int item(int nw, int heads) const { return (wi + j * nw) * heads + h; }
};

// One CTA, one warpgroup: items [first, last) of the group-major order,
// kStages - 1 items copied ahead.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, kMinCtas)
window_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ mask, bf16* __restrict__ out, int heads,
                           int n, int nw, int per_group, int items, float scale) {
  static_assert(DH % 16 == 0 && DH <= 64, "the wgmma kernel takes D = 16, 32, 48, 64");
  constexpr int kChunks = DH / 8;  // 16-byte pieces of a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;
  const size_t item_elems = static_cast<size_t>(n) * DH;
  const int first = static_cast<int>(static_cast<long long>(items) * blockIdx.x / gridDim.x);
  const int last = static_cast<int>(static_cast<long long>(items) * (blockIdx.x + 1) / gridDim.x);

  // the item at cursor c's q, k, v into stage `stage`: piece i of a block is
  // row i / kChunks, chunk i % kChunks, at its swizzled place
  const auto load = [&](const Cursor& c, int stage) {
    const size_t off = static_cast<size_t>(c.item(nw, heads)) * item_elems;
    const uint32_t st = base + stage * 3 * kTcTile;
    for (int i = tid; i < n * kChunks; i += kTcThreads) {
      const uint32_t dst = st + wg::swz(i / kChunks, i % kChunks);
      cp_async16(dst, q + off + 8 * i);
      cp_async16(dst + kTcTile, k + off + 8 * i);
      cp_async16(dst + 2 * kTcTile, v + off + 8 * i);
    }
  };

  for (int i = tid; i < kStages * 3 * kTcTile / 16; i += kTcThreads)
    wg::st_shared_v4(base + 16 * i, make_uint4(0u, 0u, 0u, 0u));
  __syncthreads();  // the zeros land before any copy into the same tiles
  Cursor ahead(first, per_group, nw);  // the next item to copy
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (first + s < last) {
      load(ahead, s);
      ahead.next(per_group, nw);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  Cursor cur(first, per_group, nw);
  int table_h = -1, table_wi = -1;  // the group whose table is loaded
  float tab[32];  // the table at this thread's accumulator positions
#pragma unroll
  for (int x = 0; x < 32; ++x) tab[x] = 0.f;
  for (int L = first, stage = 0; L < last; ++L, cur.next(per_group, nw)) {
    cp_async_wait<kStages - 2>();
    wg::fence_proxy();  // this thread's copies of item L, seen by wgmma
    __syncthreads();    // every thread's copies of L have landed; every thread is done with L - 1
    if (L + kStages - 1 < last) {
      load(ahead, stage == 0 ? kStages - 1 : stage - 1);
      ahead.next(per_group, nw);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    if (cur.h != table_h || cur.wi != table_wi) {  // the next group's table
      table_h = cur.h;
      table_wi = cur.wi;
      const float* bh = bias + static_cast<size_t>(cur.h) * n * n;
      const float* mw = mask != nullptr ? mask + static_cast<size_t>(cur.wi) * n * n : nullptr;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tab[4 * j + 2 * i + e] = table_at(bh, mw, n, row0 + g + 8 * i, 8 * j + 2 * t + e);
    }
    const uint32_t st = base + stage * 3 * kTcTile;
    bf16* dst = out + static_cast<size_t>(cur.item(nw, heads)) * item_elems;
    stage = stage + 1 == kStages ? 0 : stage + 1;

    // S = Q K^T, D / 16 steps; both tiles K-major
    float s[32];
    wg::fence();
    wg::mma_m64n64k16_set<0>(s, wg::desc(st, 16, 1024), wg::desc(st + kTcTile, 16, 1024));
#pragma unroll
    for (int ks = 1; ks < DH / 16; ++ks)
      wg::mma_m64n64k16<0>(s, wg::desc(st + 32 * ks, 16, 1024),
                           wg::desc(st + kTcTile + 32 * ks, 16, 1024), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);

    // P = softmax(S * scale + table) on the fragments: rows row0 + g + 8 i,
    // keys 8 j + 2 t + e at s[4 j + 2 i + e]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * i;
        s[x] = __fmul_rn(s[x], scale) + tab[x];
        s[x + 1] = __fmul_rn(s[x + 1], scale) + tab[x + 1];
        m = fmaxf(m, fmaxf(s[x], s[x + 1]));
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ev = __expf(s[4 * j + 2 * i + e] - m);
          s[4 * j + 2 * i + e] = ev;
          sum += ev;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = __frcp_rn(sum);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) s[4 * j + 2 * i + e] *= inv;
    }

    // P in bf16 as the A operand of each 16-key step kk: tiles 2 kk and 2 kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        pa[kk][r] = *reinterpret_cast<const uint32_t*>(&pr);
      }

    // O = P V over the 64 keys; V is the MN-major B
    float o[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) o[x] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n64k16_rs<1>(o, pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3],
                              wg::desc(st + 2 * kTcTile + 2048 * kk, kTcTile, 1024), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(o);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + r * DH + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, const float* bias, const float* mask,
              void* out, int bw, int heads, int n, int nw, float scale, cudaStream_t s) {
  const int smem = tc_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(window_attention_tc_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_attention_tc_kernel<DH>,
                                                      kTcThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = bw * heads;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int ctas = items < resident ? items : resident;
  window_attention_tc_kernel<DH><<<ctas, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, mask, static_cast<bf16*>(out), heads, n, nw, bw / nw, items, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// bf16 at a head width d that is a multiple of 16 up to 64, q, k and v
// 16-byte aligned (their rows are copied in 16-byte pieces), runs on wgmma;
// float32 and every other bf16 shape on the scalar kernel.
bool takes_wgmma(int is_bf16, int d, const void* q, const void* k, const void* v) {
  return is_bf16 && d % 16 == 0 && d > 0 && d <= 64 && aligned16(q) && aligned16(k) &&
         aligned16(v);
}

int launch_wgmma(const void* q, const void* k, const void* v, const float* bias,
                 const float* mask, void* out, int bw, int heads, int n, int d, int nw,
                 float scale, cudaStream_t s) {
  switch (d / 16) {
    case 1: return launch_tc<16>(q, k, v, bias, mask, out, bw, heads, n, nw, scale, s);
    case 2: return launch_tc<32>(q, k, v, bias, mask, out, bw, heads, n, nw, scale, s);
    case 3: return launch_tc<48>(q, k, v, bias, mask, out, bw, heads, n, nw, scale, s);
    default: return launch_tc<64>(q, k, v, bias, mask, out, bw, heads, n, nw, scale, s);
  }
}

}  // namespace

// 1 where tt_window_attention runs these q, k, v on the wgmma kernel, 0
// where on the scalar kernel.
TT_EXPORT int tt_window_attention_route(const void* q, const void* k, const void* v, int d,
                                        int is_bf16) {
  return takes_wgmma(is_bf16, d, q, k, v) ? 1 : 0;
}

// q, k, v, out: (bw, heads, n, d) in the compute type, n <= 64; bias
// (heads, n, n) f32; mask (nw, n, n) f32 or null, nw dividing bw.
TT_EXPORT int tt_window_attention(const void* q, const void* k, const void* v, const void* bias,
                                  const void* mask, void* out, int bw, int heads, int n, int d,
                                  int nw, float scale, int is_bf16, void* stream) {
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_wgmma(is_bf16, d, q, k, v))
    return launch_wgmma(q, k, v, fbias, fmask, out, bw, heads, n, d, fmask != nullptr ? nw : 1,
                        scale, s);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, fbias, fmask, out, bw, heads, n, d, nw, scale,
                                         s)
                 : launch<float>(q, k, v, fbias, fmask, out, bw, heads, n, d, nw, scale, s);
}
