// Two per-image bisection kernels of thyroid_tpu_torch/ops/percentile.py,
// built on one multi-way bisection (the device functions below the
// constants).
//
// 1. fused_percentile_normalize: per-image 1st/99th-percentile clip and
// scale. Replaces the TPU kernel thyroid_tpu/ops/percentile.py
// _bisect_normalize_kernel (pallas_call in fused_percentile_normalize).
// What it computes, per image of N pixels: the value-space bisection of
// per_image_quantile_fast for both quantiles (brackets start at the image
// min/max; each of `iters` steps counts x <= mid against
// t = float32(q * (N - 1)) and keeps the half that holds the quantile; the
// answer is the last bracket midpoint), then y = (clip(x, lo, hi) - lo) /
// (hi - lo + eps). The counts are exact integers and the bracket updates
// are IEEE float operations, so the brackets agree bit for bit with the
// plain PyTorch version; the file is built without --use_fast_math, so the
// final division is the correctly rounded one and the output is bit-equal
// to percentile_normalize_plain.
// Bound on the H100: one read and one write of the batch (0.2 MB an image
// at 224x224 in bf16: 6.4 MB at the served bucket of 32, about 2 us at
// 3.35 TB/s, below a launch). The work is latency: the bisection's
// dependent passes. Design (percentile_normalize_kernel):
// - a cluster of 1-8 CTAs of 512 threads an image, chosen from the batch
//   (pn_plan) so that every cluster runs in the first wave (4 at the served
//   bucket of 32 in float32 and bf16, 2 at 128 in bf16, 4 in float32 where
//   two waves cannot be avoided; 64 registers and 29 KB of static shared
//   memory let two CTAs share an SM);
//   each CTA stages its slice in its input type in shared memory by bulk
//   copies (kChunk-byte pieces, an mbarrier each), taking min and max as
//   the pieces land, so device memory is read once (25 KB a CTA at 32 x
//   224x224 float32). A slice above kPnMaxStage, an image of
//   n * sizeof(T) % 16 != 0 and a view off a 16-byte boundary stream every
//   pass from global memory instead, in the same kernel;
// - both brackets settle 8 steps a counting pass (22 = 8 + 8 + 6: three
//   passes). In the first the two brackets are both [min, max], so one
//   histogram serves both targets; a pass where the brackets are still the
//   same bits does the same. Otherwise each element is binned in each
//   bracket's 255 candidates, into per-warp-pair histograms. After the
//   first pass a scan keeps the values inside either bracket (about 1/128
//   of a continuous image) in a list of kPnList in shared memory and counts
//   the others at or below each bracket's lo, and the later passes bin the
//   list alone (pn_compact; a list that overflows leaves them the slice). Counts cross the cluster through distributed shared memory in
//   rank order;
// - the clip and scale read the slice from shared memory and write it with
//   16-byte stores.
//
// 2. fused_stats_quantile: per-image mean, population std, max, min and
// one bisection quantile (the quality pipeline's 99.9th). Replaces the TPU
// kernel thyroid_tpu/ops/percentile.py _stats_quantile_kernel (pallas_call
// in fused_stats_quantile), which kept each image in VMEM and produced the
// five scalars in one HBM pass. Bound on the H100: one read of the batch
// (32 MiB per 32-frame chunk of 512x512 float32, about 10 us at 3.35
// TB/s). One block per image would hold 32 of the 132 SMs at a chunk of
// 32, and one bisection step a scan means 2 + 22 scans of each image
// through L2. Design (stats_quantile_kernel):
// - A cluster of kSqCluster = 16 CTAs per image (cudaLaunchKernelEx with a
//   cluster dimension; a non-portable size). A CTA stages its slice (64 KiB
//   at 512x512) in shared memory by bulk copies, one mbarrier per 8 KiB
//   piece, and takes min, max and the sum as the pieces land: device
//   memory is read once. Slices above kSqMaxStage (frames above about 620x
//   620), images of n % 4 != 0 and views off a 16-byte boundary stream
//   every pass from global memory instead, in the same kernel; an image
//   smaller than the cluster leaves CTAs without pixels.
// - Partials (double sums, extremes, integer counts) go through distributed
//   shared memory: after cluster.sync() each CTA reads all 16 in the same
//   fixed order, so every CTA holds the same totals and two runs give the
//   same bits. Mean and std are double sums (float within a float4), as
//   before: within 1e-5 of the plain version's float32 sums.
//
// The multi-way bisection (both kernels): a pass settles up to kSteps = 8
// steps of a bracket. It builds the 2^s - 1 midpoints of the next s steps
// below (lo, hi), each by the same operations along its path from the
// root, so every candidate is the midpoint the one-step loop would compute
// there; bins each element (the first candidate >= v) from an estimate
// (v - lo) * 2^s / (hi - lo) checked against the bin's two bounds in one
// shared load, bisecting only where it missed (a 16-byte unit's bins
// first, then their shared-memory atomics, so that the loads overlap);
// counts the bins in per-warp histograms; and settles the s steps at once
// where the prefix counts cross the target, float32(count) <= target (the
// interval the one-step walk down the tree ends in). After the first pass,
// elements <= lo or > hi are binned without an estimate. Candidates that are not
// ascending (a NaN, a sum past FLT_MAX) make that pass settle one step.
// The brackets, hence the quantiles, are bit-equal to
// per_image_quantile_fast (tests/test_torch_quantile_multiway.py models
// both kernels' walks on the CPU).
#include "common.cuh"
#include "wgmma.cuh"

#include <cooperative_groups.h>

#include <cfloat>
#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;            // threads of a CTA, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;                // bisection steps one counting pass settles
constexpr int kBins = 1 << kSteps;       // 2^m - 1 candidates cut the line into 2^m bins
constexpr int kChunk = 8192;             // bytes of one bulk copy: 16 bytes a thread
constexpr float kInf = __builtin_huge_valf();
static_assert(kChunk / 16 == kThreads, "a staged piece is one 16-byte unit a thread");

// ---- the multi-way bisection, shared by both kernels ------------------------

// One bracket's state: (lo, hi), the steps settled, and this pass's steps
// s and candidates k = 2^s - 1 (0 once every step is settled).
struct Bracket {
  float lo, hi;
  int done, s, k;
};

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

// Bracket `seg` of a kernel's kSegs (1 or 2) brackets, by value, without
// indexing the register array at run time.
template <int kSegs>
__device__ __forceinline__ Bracket pick(const Bracket (&br)[kSegs], int seg) {
  return kSegs == 1 || seg == 0 ? br[0] : br[kSegs - 1];
}

// Candidate j (in-order index, 0 <= j < 2^s - 1) of the s-step bisection
// tree below bracket (lo, hi): the midpoint the one-step loop computes at
// that node, by the same operations along the path from the root.
__device__ __forceinline__ float tree_candidate(float lo, float hi, int s, int j) {
  int node = (1 << (s - 1)) - 1;
  for (int d = 0; d < s; ++d) {
    const float mid = midpoint(lo, hi);
    if (j == node) return mid;
    const int step = 1 << (s - 2 - d);
    if (j > node) {
      lo = mid;
      node += step;
    } else {
      hi = mid;
      node -= step;
    }
  }
  return 0.0f;  // not reached
}

// A pass's candidates of every bracket (bracket b by threads [256 b, 256 b
// + 256)): s = min(kSteps, steps left) and the 2^s - 1 candidates in
// cand[b], the bins' bounds (cand[e - 1], cand[e]] in bnd[b] (-inf / +inf
// at the ends). The binning needs ascending candidates; where a midpoint
// left its bracket (a sum past FLT_MAX, a NaN) that bracket's pass settles
// one step. Every thread calls; ends synchronised.
template <int kSegs>
__device__ __forceinline__ void set_candidates(Bracket (&br)[kSegs], int iters,
                                               float (*cand)[kBins], float2 (*bnd)[kBins]) {
  const int tid = threadIdx.x, seg = tid >> 8, j = tid & 255;
#pragma unroll
  for (int b = 0; b < kSegs; ++b) {
    br[b].s = min(kSteps, iters - br[b].done);
    br[b].k = (1 << br[b].s) - 1;
  }
  if (seg < kSegs) {
    const Bracket m = pick(br, seg);
    if (j < m.k) cand[seg][j] = tree_candidate(m.lo, m.hi, m.s, j);
  }
  __syncthreads();
  bool fell = false;
#pragma unroll
  for (int b = 0; b < kSegs; ++b) {
    if (!__syncthreads_and(seg != b || j + 1 >= br[b].k || cand[b][j] <= cand[b][j + 1])) {
      br[b].s = 1;
      br[b].k = 1;
      if (tid == 0) cand[b][0] = midpoint(br[b].lo, br[b].hi);
      fell = true;
    }
  }
  if (fell) __syncthreads();
  if (seg < kSegs) {
    const int k = pick(br, seg).k;
    if (j <= k)
      bnd[seg][j] = make_float2(j > 0 ? cand[seg][j - 1] : -kInf, j < k ? cand[seg][j] : kInf);
  }
  __syncthreads();
}

// Whether every candidate of a bracket lies in [lo, hi]: then an element
// <= lo is bin 0 and one > hi bin k.
__device__ __forceinline__ bool inside(const Bracket& b, const float* cand) {
  return b.k > 0 && b.lo <= cand[0] && cand[b.k - 1] <= b.hi;
}

// The estimate's scale (k + 1) / (hi - lo); 0 for a bracket of one value
// (every hint 0, where bin 0 holds all).
__device__ __forceinline__ float bin_scale(const Bracket& b) {
  return b.hi > b.lo ? __fdiv_rn(static_cast<float>(b.k + 1), __fsub_rn(b.hi, b.lo)) : 0.0f;
}

// The bin of v in one bracket's pass (the first candidate >= v, k for
// none): estimated from the value, checked against its two bounds with one
// shared load, and searched for by bisection only where the estimate
// missed (a bracket narrower than the float spacing, a NaN or an infinite
// value). With kCut and cut, an element
// <= lo is bin 0 and one > hi bin k without an estimate.
template <bool kCut>
__device__ __forceinline__ int bin_of(float v, const Bracket& b, float scale, bool cut,
                                      const float* cand, const float2* bnd) {
  if (kCut && cut) {
    if (v <= b.lo) return 0;
    if (v > b.hi) return b.k;
  }
  // round((v - lo) * scale - 1/2) by the float spacing of 1 in [2^23,
  // 2^24), clamped to [0, k]
  int e = __vimin_s32_relu(
      __float_as_int(__fmaf_rn(__fsub_rn(v, b.lo), scale, 8388607.5f)) - 0x4B000000, b.k);
  const float2 bd = bnd[e];
  if (!(v > bd.x && v <= bd.y)) {
    // the first candidate >= v by bisection: v <= cand[j] ascends in j
    // (false for every j at a NaN), and a bracket at +inf, or narrower than
    // the float spacing, holds long runs of equal candidates
    int a = 0, z = b.k;
    while (a < z) {
      const int m = (a + z) >> 1;
      if (v <= cand[m])
        z = m;
      else
        a = m + 1;
    }
    e = a;
  }
  return e;
}

// Counts the kN values v into one bracket's pass histogram: bin 0 into
// `below` (a register), bins 1..k-1 into hist (shared memory), bin k
// nowhere. Every value's bin first, so that their shared loads are in
// flight together, then the tallies.
template <bool kCut, int kN>
__device__ __forceinline__ void count_values(const float (&v)[kN], const Bracket& b, float scale,
                                             bool cut, const float* cand, const float2* bnd,
                                             int* hist, int& below) {
  if (b.k == 0) return;
  int e[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) e[i] = bin_of<kCut>(v[i], b, scale, cut, cand, bnd);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (e[i] == 0)
      ++below;
    else if (e[i] < b.k)
      atomicAdd(hist + e[i], 1);
  }
}

// A warp's bin-0 counts into its histogram.
__device__ __forceinline__ void add_below(int below, const Bracket& b, int* hist) {
  below = warp_sum(below);
  if ((threadIdx.x & 31) == 0 && b.k > 0) atomicAdd(hist, below);
}

// In-place inclusive prefix sums of cnt[b][0..k_b), k_b <= 255, bracket b
// by threads [256 b, 256 b + 256); wscan holds 8 kSegs ints. Every thread
// calls; ends synchronised.
template <int kSegs>
__device__ __forceinline__ void prefix(int (*cnt)[kBins], const Bracket (&br)[kSegs],
                                       int* wscan) {
  const int tid = threadIdx.x, seg = tid >> 8, j = tid & 255, lane = tid & 31, w = j >> 5;
  const int k = seg < kSegs ? pick(br, seg).k : 0;
  int v = 0;
  if (seg < kSegs) {
    v = j < k ? cnt[seg][j] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wscan[8 * seg + w] = v;
  }
  __syncthreads();
  if (j < k) {
    for (int q = 0; q < w; ++q) v += wscan[8 * seg + q];
    cnt[seg][j] = v;
  }
  __syncthreads();
}

// Settles each bracket's pass from its prefix counts (after prefix()).
// The counts ascend, so the one-step walk down the tree ends in the
// interval where float32(count) <= target turns false: with i the number
// of candidates it holds for, (lo, hi) becomes (cand[i - 1], cand[i]) (the
// bracket's own end past the first or last candidate), the very floats the
// walk's midpoints are. Thread j of bracket b's segment tests the pair
// around interval j, so no thread walks the s dependent steps. Every thread
// calls; ends synchronised (flip: kSegs ints of shared memory).
template <int kSegs>
__device__ __forceinline__ void settle(Bracket (&br)[kSegs], int (*cnt)[kBins],
                                       float (*cand)[kBins], const float (&target)[kSegs],
                                       int* flip) {
  const int tid = threadIdx.x, seg = tid >> 8, j = tid & 255;
  if (seg < kSegs) {
    const Bracket m = pick(br, seg);
    const float t = kSegs == 1 || seg == 0 ? target[0] : target[kSegs - 1];
    if (m.s > 0 && j <= m.k) {
      const bool left = j == 0 || static_cast<float>(cnt[seg][j - 1]) <= t;
      const bool right = j < m.k && static_cast<float>(cnt[seg][j]) <= t;
      if (left && !right) flip[seg] = j;
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kSegs; ++b) {
    if (br[b].s > 0) {
      const int i = flip[b];
      if (i > 0) br[b].lo = cand[b][i - 1];
      if (i < br[b].k) br[b].hi = cand[b][i];
    }
    br[b].done += br[b].s;
  }
}

// Stages `units` 16-byte units at src (16-byte aligned) into shared memory
// at stage by bulk copies of kChunk bytes, one mbarrier each (bar0 the
// first's shared address), and calls f(unit) on each unit as its piece
// lands (unit j by thread j % kThreads). Every thread calls.
template <typename F>
__device__ __forceinline__ void stage_slice(uint4* stage, const void* src, int units,
                                            uint32_t bar0, F f) {
  const int tid = threadIdx.x;
  const int bytes = units * 16;
  const int pieces = (bytes + kChunk - 1) / kChunk;
  if (tid == 0) {
    for (int c = 0; c < pieces; ++c) wg::mbar_init(bar0 + 8 * c, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    const uint4* from = static_cast<const uint4*>(src);
    for (int c = 0; c < pieces; ++c) {
      const int sz = min(kChunk, bytes - c * kChunk);
      wg::mbar_expect_tx(bar0 + 8 * c, sz);
      wg::bulk_load(wg::smem_addr(stage) + c * kChunk, from + c * (kChunk / 16), sz, bar0 + 8 * c);
    }
  }
  for (int c = 0; c < pieces; ++c) {
    const int j = c * (kChunk / 16) + tid;
    wg::mbar_wait(bar0 + 8 * c, 0);
    if (j < units) f(stage[j]);
  }
}

// Thread 0 gets the block's min and max, and with kSum its double sum.
template <bool kSum>
__device__ __forceinline__ void block_stats(float& mn, float& mx, double& s, float* red_a,
                                            float* red_b, double* red_d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  mn = warp_min(mn);
  mx = warp_max(mx);
  if (kSum) s = warp_sum(s);
  if (lane == 0) {
    red_a[warp] = mn;
    red_b[warp] = mx;
    if (kSum) red_d[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mn = fminf(mn, red_a[w]);
      mx = fmaxf(mx, red_b[w]);
      if (kSum) s += red_d[w];
    }
  }
}

// ---- kernel 1: fused_percentile_normalize -----------------------------------

constexpr int kPnMaxCluster = 8;          // CTAs an image, at most (a portable size)
constexpr int kPnList = 2048;             // values the passes after the first may keep
constexpr int kPnMaxStage = 224 * 224 * 2;  // staged bytes a CTA: a 224x224 bf16 image fits one
constexpr int kPnBars = kPnMaxStage / kChunk + 1;

// The CTA's shared state; the fields a peer reads are marked.
struct PnShared {
  // per-warp counts of the running pass: a row a warp where the brackets
  // are the same; else warps 2p and 2p + 1 count bracket b in row 2p + b
  int whist[kWarps][kBins];
  int chist[2][2][kBins];  // the CTA's counts by pass parity and bracket (read by peers)
  int cnt[2][kBins];       // the cluster's counts, then their prefix sums
  float cand[2][kBins];
  float2 bnd[2][kBins];
  int wscan[16];
  int flip[2];
  float list[kPnList];  // after the first pass: the values inside either bracket
  int list_n;           // how many there are (more than kPnList: not kept)
  int base[2];          // the other values at or below each bracket's lo
  float red_a[kWarps], red_b[kWarps];
  float mn, mx;  // the CTA's extremes (read by peers)
  float gmn, gmx;
  unsigned long long bar[kPnBars];
};

// The values of a 16-byte unit of T (4 float or 8 bf16), and back.
template <typename T>
constexpr int kPerUnit = 16 / static_cast<int>(sizeof(T));

template <typename T>
__device__ __forceinline__ float unit_value(const uint4& u, int i) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(reinterpret_cast<const uint32_t*>(&u)[i]);
  else
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&u)[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack_unit(const float (&y)[kPerUnit<T>]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(y[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
  return u;
}

// Calls f(v) for the values of the CTA's slice: a 16-byte unit's values at
// once when staged, else one element of global memory.
template <typename T, typename F>
__device__ __forceinline__ void for_slice(const uint4* stage, const T* xi, int first, int count,
                                          bool staged, F f) {
  if (staged) {
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const uint4 u = stage[j];
      float v[kPerUnit<T>];
#pragma unroll
      for (int i = 0; i < kPerUnit<T>; ++i) v[i] = unit_value<T>(u, i);
      f(v);
    }
  } else {
    for (int i = first + threadIdx.x; i < first + count; i += kThreads) {
      const float v[1] = {to_f32(xi[i])};
      f(v);
    }
  }
}

// One counting pass of both brackets over the CTA's slice, or over its
// list of values (list: the pass's bins then lack the values outside the
// list, which base[] adds to bin 0); `same`: one histogram for both.
template <bool kFirst, typename T>
__device__ __forceinline__ void pn_count(PnShared& sh, const uint4* stage, const T* xi, int first,
                                         int count, bool staged, const Bracket (&br)[2],
                                         bool same, bool list) {
  const int warp = threadIdx.x >> 5;
  const float sc0 = bin_scale(br[0]), sc1 = bin_scale(br[1]);
  const bool cut0 = inside(br[0], sh.cand[0]), cut1 = inside(br[1], sh.cand[1]);
  int* h0 = same ? sh.whist[warp] : sh.whist[warp & ~1];
  int* h1 = sh.whist[warp | 1];
  int below0 = 0, below1 = 0;
  auto visit = [&](const auto& v) {
    count_values<!kFirst>(v, br[0], sc0, cut0, sh.cand[0], sh.bnd[0], h0, below0);
    if (!same) count_values<!kFirst>(v, br[1], sc1, cut1, sh.cand[1], sh.bnd[1], h1, below1);
  };
  if (list) {
    for (int i = threadIdx.x; i < sh.list_n; i += kThreads) {
      const float v[1] = {sh.list[i]};
      visit(v);
    }
  } else {
    for_slice<T>(stage, xi, first, count, staged, visit);
  }
  add_below(below0, br[0], h0);
  if (!same) add_below(below1, br[1], h1);
}

// After the first pass, when steps are left: the slice's values inside
// either bracket still settling (lo < v <= hi) go to sh.list (a warp's
// appends take one atomic), and per bracket the others at or below its lo
// are counted into sh.base. A later pass whose candidates all lie in its
// brackets bins the list alone: every value outside it is at or below a
// bracket's lo (bin 0, counted in base) or above its hi (bin k) for every
// candidate to come, as the brackets only narrow. Returns whether the list
// held every such value (a flat region at a quantile, an infinite image:
// then the passes scan the slice).
template <typename T>
__device__ __forceinline__ bool pn_compact(PnShared& sh, const uint4* stage, const T* xi,
                                           int first, int count, bool staged,
                                           const Bracket (&br)[2], int iters) {
  const bool a0 = br[0].done < iters, a1 = br[1].done < iters;
  const int lane = threadIdx.x & 31;
  int below0 = 0, below1 = 0;
  for_slice<T>(stage, xi, first, count, staged, [&](const auto& v) {
    constexpr int kN = sizeof(v) / sizeof(v[0]);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float x = v[i];
      const bool in = (a0 && x > br[0].lo && x <= br[0].hi) || (a1 && x > br[1].lo && x <= br[1].hi);
      if (!in) {
        below0 += x <= br[0].lo;
        below1 += x <= br[1].lo;
      }
      const unsigned active = __activemask();
      const unsigned mask = __ballot_sync(active, in);
      if (mask != 0) {
        const int leader = __ffs(active) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&sh.list_n, __popc(mask));
        at = __shfl_sync(active, at, leader) + __popc(mask & ((1u << lane) - 1u));
        if (in && at < kPnList) sh.list[at] = x;
      }
    }
  });
  below0 = warp_sum(below0);
  below1 = warp_sum(below1);
  if (lane == 0) {
    atomicAdd(&sh.base[0], below0);
    atomicAdd(&sh.base[1], below1);
  }
  __syncthreads();
  return sh.list_n <= kPnList;
}

// y (b, n) = each image of x clipped to its two bisection quantiles and
// scaled. One cluster of CTAs an image; CTA `rank` owns slice `rank`, in
// 16-byte units when staged, else in elements.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
percentile_normalize_kernel(const T* __restrict__ x, T* __restrict__ y, int n, float t_lo,
                            float t_hi, float eps, int iters, int staged_flag) {
  __shared__ PnShared sh;
  extern __shared__ __align__(16) uint4 pn_stage[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const bool staged = staged_flag != 0;
  const T* xi = x + static_cast<size_t>(img) * n;
  T* yi = y + static_cast<size_t>(img) * n;

  const int units = staged ? n / kPerUnit<T> : n;
  const int per = (units + csize - 1) / csize;
  const int first = min(rank * per, units);
  const int count = min(per, units - first);

  for (int i = tid; i < kWarps * kBins; i += kThreads) (&sh.whist[0][0])[i] = 0;
  if (tid == 0) sh.list_n = sh.base[0] = sh.base[1] = 0;

  // stage the slice (or scan it) for min and max
  float mn = FLT_MAX, mx = -FLT_MAX;
  if (staged) {
    stage_slice(pn_stage, xi + static_cast<size_t>(first) * kPerUnit<T>, count,
                wg::smem_addr(&sh.bar[0]), [&](const uint4& u) {
#pragma unroll
                  for (int i = 0; i < kPerUnit<T>; ++i) {
                    const float v = unit_value<T>(u, i);
                    mn = fminf(mn, v);
                    mx = fmaxf(mx, v);
                  }
                });
  } else {
    for (int i = first + tid; i < first + count; i += kThreads) {
      const float v = to_f32(xi[i]);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  }
  double unused = 0.0;
  block_stats<false>(mn, mx, unused, sh.red_a, sh.red_b, nullptr);
  if (tid == 0) {
    sh.mn = mn;
    sh.mx = mx;
  }
  cluster.sync();
  if (tid < 32) {  // the cluster's extremes: lane r reads rank r
    float a = FLT_MAX, c = -FLT_MAX;
    if (tid < csize) {
      const PnShared* p = cluster.map_shared_rank(&sh, tid);
      a = p->mn;
      c = p->mx;
    }
    a = warp_min(a);
    c = warp_max(c);
    if (tid == 0) {
      sh.gmn = a;
      sh.gmx = c;
    }
  }
  __syncthreads();

  Bracket br[2] = {{sh.gmn, sh.gmx, 0, 0, 0}, {sh.gmn, sh.gmx, 0, 0, 0}};
  const float targets[2] = {t_lo, t_hi};
  int parity = 0;
  bool first_pass = true, listed = false;
  while (br[0].done < iters || br[1].done < iters) {
    set_candidates<2>(br, iters, sh.cand, sh.bnd);
    // the same bits, the same candidates: one histogram for both
    const bool same = br[0].s == br[1].s && __float_as_int(br[0].lo) == __float_as_int(br[1].lo) &&
                      __float_as_int(br[0].hi) == __float_as_int(br[1].hi);
    const bool list = listed && (br[0].k == 0 || inside(br[0], sh.cand[0])) &&
                      (br[1].k == 0 || inside(br[1], sh.cand[1]));
    if (first_pass)
      pn_count<true>(sh, pn_stage, xi, first, count, staged, br, same, false);
    else
      pn_count<false>(sh, pn_stage, xi, first, count, staged, br, same, list);
    __syncthreads();
    const int b = tid >> 8, j = tid & 255, k = b == 0 ? br[0].k : br[1].k;
    if (j < k && !(same && b == 1)) {
      int c = list && j == 0 ? sh.base[b] : 0;
      for (int w = same ? 0 : b; w < kWarps; w += same ? 1 : 2) {
        c += sh.whist[w][j];
        sh.whist[w][j] = 0;
      }
      sh.chist[parity][b][j] = c;
    }
    cluster.sync();
    if (j < k) {  // the cluster's counts, ranks in order
      const int src = same ? 0 : b;
      int c = 0;
      for (int r = 0; r < csize; ++r) c += cluster.map_shared_rank(sh.chist[parity][src], r)[j];
      sh.cnt[b][j] = c;
    }
    __syncthreads();
    prefix<2>(sh.cnt, br, sh.wscan);
    settle<2>(br, sh.cnt, sh.cand, targets, sh.flip);
    parity ^= 1;
    if (first_pass && (br[0].done < iters || br[1].done < iters))
      listed = pn_compact(sh, pn_stage, xi, first, count, staged, br, iters);
    first_pass = false;
    __syncthreads();  // cand and cnt are rewritten by the next pass
  }

  // clip and scale the slice
  const float p_lo = midpoint(br[0].lo, br[0].hi);
  const float p_hi = midpoint(br[1].lo, br[1].hi);
  const float den = __fadd_rn(__fsub_rn(p_hi, p_lo), eps);
  auto scaled = [&](float v) { return __fdiv_rn(__fsub_rn(fminf(fmaxf(v, p_lo), p_hi), p_lo), den); };
  if (staged) {
    uint4* out = reinterpret_cast<uint4*>(yi) + first;
    for (int j = tid; j < count; j += kThreads) {
      const uint4 u = pn_stage[j];
      float v[kPerUnit<T>];
#pragma unroll
      for (int i = 0; i < kPerUnit<T>; ++i) v[i] = scaled(unit_value<T>(u, i));
      out[j] = pack_unit<T>(v);
    }
  } else {
    for (int i = first + tid; i < first + count; i += kThreads) yi[i] = from_f32<T>(scaled(to_f32(xi[i])));
  }
  cluster.sync();  // peers may still read this CTA's counts
}

struct PnPlan {
  int cluster, stage_bytes;
  bool staged;
  int at_once;  // clusters the card holds at once
};

// The cluster launch of percentile_normalize_kernel<T> over b images on
// stream s, into cfg (attr: its cluster dimension); the kernel's
// attributes are set on the first call.
template <typename T>
cudaError_t pn_launch_config(const PnPlan& p, int b, cudaStream_t s, cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(percentile_normalize_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kPnMaxStage);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    configured = true;
  }
  *cfg = {};
  cfg->gridDim = dim3(static_cast<unsigned>(b) * p.cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = p.stage_bytes;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Clusters of p->cluster CTAs with p->stage_bytes each that the card holds
// at once, into p->at_once (the occupancy query, once per shape).
template <typename T>
cudaError_t pn_at_once(PnPlan* p) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(p->cluster, p->stage_bytes);
  const auto it = known.find(key);
  if (it != known.end()) {
    p->at_once = it->second;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = pn_launch_config<T>(*p, 1, nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&p->at_once, percentile_normalize_kernel<T>, &cfg);
  if (err != cudaSuccess) return err;
  known[key] = p->at_once;
  return cudaSuccess;
}

// The launch a batch of b images of n elements of T takes, among clusters
// of 8, 4, 2 and 1 CTAs an image. A slice is staged where the image is a
// whole number of 16-byte units, input and output are `aligned` to 16
// bytes, and it fits kPnMaxStage. Staged plans first, then the fewest
// waves of clusters (a cluster that waits for a wave costs a whole
// cluster's time: 32 clusters of 8 at the served bucket, of which 31 fit,
// took twice as long as 32 of 4), then the most CTAs an image.
template <typename T>
cudaError_t pn_plan(bool aligned, int b, int n, PnPlan* best) {
  const long long bytes = static_cast<long long>(n) * sizeof(T);
  const bool whole = bytes % 16 == 0 && aligned;
  bool found = false;
  long long best_waves = 0;
  for (int c = kPnMaxCluster; c >= 1; c /= 2) {
    const long long slice = (bytes / 16 + c - 1) / c * 16;
    PnPlan p{c, 0, whole && slice <= kPnMaxStage, 0};
    p.stage_bytes = p.staged ? static_cast<int>(slice) : 0;
    const cudaError_t err = pn_at_once<T>(&p);
    if (err != cudaSuccess) return err;
    if (p.at_once == 0) continue;
    const long long waves = (b + p.at_once - 1) / p.at_once;
    if (!found || (p.staged && !best->staged) ||
        (p.staged == best->staged && waves < best_waves)) {
      *best = p;
      best_waves = waves;
      found = true;
    }
  }
  return found ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T>
int pn_launch(const void* x, void* y, int b, int n, float t_lo, float t_hi, float eps, int iters,
              cudaStream_t s) {
  PnPlan p;
  cudaError_t err = pn_plan<T>(
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(y)) & 15) == 0, b, n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = pn_launch_config<T>(p, b, s, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, percentile_normalize_kernel<T>, static_cast<const T*>(x),
                           static_cast<T*>(y), n, t_lo, t_hi, eps, iters,
                           static_cast<int>(p.staged));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pn_config(const void* x, int b, int n, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, percentile_normalize_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  PnPlan p;
  err = pn_plan<T>((reinterpret_cast<size_t>(x) & 15) == 0, b, n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.cluster;
  out[1] = kThreads;
  out[2] = static_cast<int>(p.staged);
  out[3] = p.stage_bytes;
  out[4] = static_cast<int>(fa.sharedSizeBytes);
  out[5] = fa.numRegs;
  out[6] = p.at_once;
  return 0;
}

// ---- kernel 12: fused_stats_quantile ------------------------------------------

constexpr int kSqCluster = 16;            // CTAs an image (a non-portable cluster size)
constexpr int kSqMaxStage = 92 * 1024;    // staged bytes a CTA: two CTAs fit an SM
constexpr int kSqBars = kSqMaxStage / kChunk + 1;

// The CTA's shared state; the fields a peer reads are marked.
struct SqShared {
  int whist[kWarps][kBins];      // per-warp bin counts of the running pass
  int chist[2][kBins];           // the CTA's bin counts, by pass parity (read by peers)
  int cnt[1][kBins];             // the cluster's counts, then their prefix sums
  float cand[1][kBins];          // the pass's candidate midpoints, ascending
  float2 bnd[1][kBins];          // bin e's bounds (cand[e - 1], cand[e]], -inf / +inf at the ends
  int wscan[8];
  int flip[1];
  double red_d[kWarps];
  float red_a[kWarps], red_b[kWarps];
  double sum, sq;                // the CTA's partial sums (read by peers)
  float mn, mx;                  // the CTA's extremes (read by peers)
  double total_sum, total_sq;
  float gmn, gmx;
  unsigned long long bar[kSqBars];
};

// Thread 0 gets the block's double sum.
__device__ __forceinline__ double sq_block_sum(double s, SqShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  if (lane == 0) sh.red_d[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) s += sh.red_d[w];
  return s;
}

// One counting pass over the CTA's slice (the staged float4s, or global
// memory) into the warp's histogram. kFirst (the bracket is still [min,
// max]): also the sum of squared deviations from `mean`, in float a float4
// and in double across them; otherwise elements outside the bracket are
// binned at once where every candidate is inside it.
template <bool kFirst>
__device__ __forceinline__ double sq_count(SqShared& sh, const float4* stage, const float* xi,
                                           int first, int count, bool staged, const Bracket& br,
                                           float mean) {
  const int warp = threadIdx.x >> 5;
  const float scale = bin_scale(br);
  const bool cut = inside(br, sh.cand[0]);
  int* wh = sh.whist[warp];
  int below = 0;
  double sq = 0.0;
  if (staged) {
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const float4 u = stage[j];
      if (kFirst) {
        const float a = u.x - mean, b = u.y - mean, c = u.z - mean, d = u.w - mean;
        sq += static_cast<double>((a * a + b * b) + (c * c + d * d));
      }
      const float v[4] = {u.x, u.y, u.z, u.w};
      count_values<!kFirst>(v, br, scale, cut, sh.cand[0], sh.bnd[0], wh, below);
    }
  } else {
    for (int i = first + threadIdx.x; i < first + count; i += kThreads) {
      const float v[1] = {__ldg(xi + i)};
      if (kFirst) {
        const double d = static_cast<double>(v[0]) - mean;
        sq += d * d;
      }
      count_values<!kFirst>(v, br, scale, cut, sh.cand[0], sh.bnd[0], wh, below);
    }
  }
  add_below(below, br, wh);
  return sq;
}

// out (5, B): mean, std, max, min, quantile of each image. One cluster of
// kSqCluster CTAs an image; CTA `rank` owns slice `rank` of it.
__global__ void __launch_bounds__(kThreads, 2)
stats_quantile_kernel(const float* __restrict__ x, float* __restrict__ out, int b, int n,
                      float target, int iters, int staged_flag) {
  __shared__ SqShared sh;
  extern __shared__ __align__(16) float4 stage[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / kSqCluster;
  const int tid = threadIdx.x;
  const bool staged = staged_flag != 0;
  const float* xi = x + static_cast<size_t>(img) * n;

  // the slice, in float4s when staged, else in floats
  const int units = staged ? n >> 2 : n;
  const int per = (units + kSqCluster - 1) / kSqCluster;
  const int first = min(rank * per, units);
  const int count = min(per, units - first);

  for (int i = tid; i < kWarps * kBins; i += kThreads) (&sh.whist[0][0])[i] = 0;

  // pass 1: stage the slice (bulk copies, one mbarrier each) and take
  // min, max and the double sum as each piece lands
  float mn = FLT_MAX, mx = -FLT_MAX;
  double sum = 0.0;
  if (staged) {
    stage_slice(reinterpret_cast<uint4*>(stage), reinterpret_cast<const float4*>(xi) + first,
                count, wg::smem_addr(&sh.bar[0]), [&](const uint4& u) {
                  const float4 v = *reinterpret_cast<const float4*>(&u);
                  mn = fminf(fminf(mn, v.x), fminf(v.y, fminf(v.z, v.w)));
                  mx = fmaxf(fmaxf(mx, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
                  sum += static_cast<double>((v.x + v.y) + (v.z + v.w));
                });
  } else {
    for (int i = first + tid; i < first + count; i += kThreads) {
      const float v = __ldg(xi + i);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      sum += v;
    }
  }
  block_stats<true>(mn, mx, sum, sh.red_a, sh.red_b, sh.red_d);
  if (tid == 0) {
    sh.mn = mn;
    sh.mx = mx;
    sh.sum = sum;
  }
  cluster.sync();
  if (tid < 32) {  // the cluster's totals: lane r reads rank r, a fixed shuffle tree sums
    double s = 0.0;
    float a = FLT_MAX, c = -FLT_MAX;
    if (tid < kSqCluster) {
      const SqShared* p = cluster.map_shared_rank(&sh, tid);
      s = p->sum;
      a = p->mn;
      c = p->mx;
    }
    s = warp_sum(s);
    a = warp_min(a);
    c = warp_max(c);
    if (tid == 0) {
      sh.total_sum = s;
      sh.gmn = a;
      sh.gmx = c;
    }
  }
  __syncthreads();
  const float mean = static_cast<float>(sh.total_sum / n);
  Bracket br[1] = {{sh.gmn, sh.gmx, 0, 0, 0}};
  const float targets[1] = {target};

  // counting passes, each settling up to kSteps bisection steps; the
  // first also sums the squared deviations (one pass even for iters == 0)
  int parity = 0;
  bool first_pass = true;
  do {
    set_candidates<1>(br, iters, sh.cand, sh.bnd);
    const int k = br[0].k;
    if (first_pass) {
      const double sq = sq_count<true>(sh, stage, xi, first, count, staged, br[0], mean);
      const double total = sq_block_sum(sq, sh);
      if (tid == 0) sh.sq = total;
    } else {
      sq_count<false>(sh, stage, xi, first, count, staged, br[0], mean);
    }
    __syncthreads();
    for (int t = tid; t < k; t += kThreads) {
      int c = 0;
      for (int w = 0; w < kWarps; ++w) {
        c += sh.whist[w][t];
        sh.whist[w][t] = 0;
      }
      sh.chist[parity][t] = c;
    }
    cluster.sync();
    if (first_pass && tid < 32 && rank == 0) {
      const double q = warp_sum(tid < kSqCluster ? cluster.map_shared_rank(&sh, tid)->sq : 0.0);
      if (tid == 0) sh.total_sq = q;
    }
    if (tid < k) {
      int c = 0;
      for (int r = 0; r < kSqCluster; ++r) c += cluster.map_shared_rank(sh.chist[parity], r)[tid];
      sh.cnt[0][tid] = c;
    }
    __syncthreads();
    prefix<1>(sh.cnt, br, sh.wscan);
    settle<1>(br, sh.cnt, sh.cand, targets, sh.flip);
    parity ^= 1;
    first_pass = false;
    __syncthreads();  // cand and cnt are rewritten by the next pass
  } while (br[0].done < iters);
  cluster.sync();  // peers may still read this CTA's counts
  if (rank == 0 && tid == 0) {
    out[img] = mean;
    out[b + img] = static_cast<float>(sqrt(sh.total_sq / n));
    out[2 * b + img] = sh.gmx;
    out[3 * b + img] = sh.gmn;
    out[4 * b + img] = midpoint(br[0].lo, br[0].hi);
  }
}

// Whether an image of n floats at x is staged: n a multiple of 4, x 16-byte
// aligned, and a CTA's slice within kSqMaxStage.
bool sq_staged(const void* x, int n) {
  const int per = ((n >> 2) + kSqCluster - 1) / kSqCluster;
  return (n & 3) == 0 && (reinterpret_cast<size_t>(x) & 15) == 0 && per * 16 <= kSqMaxStage;
}

int sq_stage_bytes(const void* x, int n) {
  return sq_staged(x, n) ? ((n >> 2) + kSqCluster - 1) / kSqCluster * 16 : 0;
}

// The cluster launch of stats_quantile_kernel over b images of n floats at
// x on stream s, into cfg (attr: its cluster dimension); the kernel's
// attributes are set on the first call.
cudaError_t sq_launch_config(const void* x, int b, int n, cudaStream_t s, cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(stats_quantile_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(stats_quantile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSqMaxStage);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    configured = true;
  }
  *cfg = {};
  cfg->gridDim = dim3(static_cast<unsigned>(b) * kSqCluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = sq_stage_bytes(x, n);
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kSqCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

TT_EXPORT int tt_stats_quantile(const void* x, void* out, int b, int n, float target, int iters,
                                void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = sq_launch_config(x, b, n, static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, stats_quantile_kernel, static_cast<const float*>(x),
                           static_cast<float*>(out), b, n, target, iters,
                           static_cast<int>(sq_staged(x, n)));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch of tt_stats_quantile for an image of n floats at x: out[0..6]
// = CTAs a cluster, threads a CTA, staged (1) or streamed (0), dynamic
// shared bytes, static shared bytes, registers a thread, clusters the card
// holds at once.
TT_EXPORT int tt_stats_quantile_config(const void* x, int n, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, stats_quantile_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = sq_launch_config(x, 1, n, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, stats_quantile_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kSqCluster;
  out[1] = kThreads;
  out[2] = static_cast<int>(sq_staged(x, n));
  out[3] = sq_stage_bytes(x, n);
  out[4] = static_cast<int>(fa.sharedSizeBytes);
  out[5] = fa.numRegs;
  out[6] = clusters;
  return 0;
}

TT_EXPORT int tt_percentile_normalize(const void* x, void* y, int b, int n, float t_lo,
                                      float t_hi, float eps, int iters, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pn_launch<__nv_bfloat16>(x, y, b, n, t_lo, t_hi, eps, iters, s)
                 : pn_launch<float>(x, y, b, n, t_lo, t_hi, eps, iters, s);
}

// The launch of tt_percentile_normalize for b images of n elements at x:
// out[0..6] as tt_stats_quantile_config's, for this batch.
TT_EXPORT int tt_percentile_normalize_config(const void* x, int b, int n, int is_bf16, int* out) {
  return is_bf16 ? pn_config<__nv_bfloat16>(x, b, n, out) : pn_config<float>(x, b, n, out);
}
