// Two per-image bisection kernels of thyroid_tpu_torch/ops/percentile.py.
//
// 1. fused_percentile_normalize: per-image 1st/99th-percentile clip and
// scale. Replaces the TPU kernel thyroid_tpu/ops/percentile.py
// _bisect_normalize_kernel (pallas_call in fused_percentile_normalize).
//
// What it computes, per image of N pixels: the value-space bisection of
// per_image_quantile_fast for both quantiles at once (brackets start at the
// image min/max; each of `iters` steps counts x <= mid against
// t = float32(q * (N - 1)) and keeps the half that holds the quantile; the
// answer is the last bracket midpoint), then y = (clip(x, lo, hi) - lo) /
// (hi - lo + eps). The counts are exact integers and the bracket updates
// are IEEE float operations, so the brackets agree bit for bit with the
// plain PyTorch version; the file is built without --use_fast_math so the
// final division is the correctly rounded one.
//
// Bound on the H100: the least work is one read and one write of the
// batch, but the algorithm scans each image 2 + iters times. Design: one
// block of 1024 threads per image advances both brackets in the same scan,
// so a step is one pass over the image; the two counts come from a warp
// shuffle plus shared-memory block reduction, and every thread applies the
// same bracket update. The image (200,704 B at 224x224 float32) is re-read
// from global memory on each pass, which the 50 MB L2 serves after the
// first pass at serving batch sizes.
//
// 2. fused_stats_quantile: per-image mean, population std, max, min and
// one bisection quantile (the quality pipeline's 99.9th). Replaces the TPU
// kernel thyroid_tpu/ops/percentile.py _stats_quantile_kernel (pallas_call
// in fused_stats_quantile), which kept each image in VMEM and produced the
// five scalars in one HBM pass. Bound on the H100: one read of the batch
// (32 MiB per 32-frame chunk of 512x512 float32, about 10 us at 3.35
// TB/s). One block per image would hold 32 of the 132 SMs at a chunk of
// 32, and one bisection step a scan means 2 + 22 scans of each image
// through L2. Design:
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
// - Multi-way bisection: a pass settles up to kSqSteps = 8 steps. It builds
//   the 2^s - 1 midpoints of the next s steps below (lo, hi), each by the
//   same operations along its path from the root, so every candidate is
//   the midpoint the one-step loop would compute there; bins each element
//   (the first candidate >= v) from an estimate (v - lo) * 2^s / (hi - lo)
//   checked against the bin's two bounds in one shared load, searching only
//   where it missed; counts the bins in per-warp histograms; and walks the
//   tree with the one-step rule on the prefix counts, float32(count) <=
//   target. 22 steps take 3 passes (8 + 8 + 6); after the first, elements
//   <= lo or > hi are binned without an estimate. Candidates that are not
//   ascending (a NaN, a sum past FLT_MAX) make that pass settle one step.
//   The brackets, hence the quantile, max and min, are bit-equal to
//   per_image_quantile_fast (tests/test_torch_quantile_multiway.py models
//   the walk on the CPU).
#include "common.cuh"
#include "wgmma.cuh"

#include <cooperative_groups.h>

#include <cfloat>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Sum two ints over the block; every thread returns the totals.
__device__ __forceinline__ void block_sum2(int& a, int& b, int* s_a, int* s_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    s_a[warp] = a;
    s_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? s_a[lane] : 0;
    b = lane < kWarps ? s_b[lane] : 0;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      s_a[0] = a;
      s_b[0] = b;
    }
  }
  __syncthreads();
  a = s_a[0];
  b = s_b[0];
  __syncthreads();  // the buffers are reused by the next call
}

__device__ __forceinline__ void block_minmax(float& mn, float& mx, float* s_a, float* s_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  mn = warp_min(mn);
  mx = warp_max(mx);
  if (lane == 0) {
    s_a[warp] = mn;
    s_b[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < kWarps ? s_a[lane] : FLT_MAX;
    mx = lane < kWarps ? s_b[lane] : -FLT_MAX;
    mn = warp_min(mn);
    mx = warp_max(mx);
    if (lane == 0) {
      s_a[0] = mn;
      s_b[0] = mx;
    }
  }
  __syncthreads();
  mn = s_a[0];
  mx = s_b[0];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
percentile_normalize_kernel(const T* __restrict__ x, T* __restrict__ y, int n,
                            float t_lo, float t_hi, float eps, int iters) {
  __shared__ float s_f0[kWarps], s_f1[kWarps];
  __shared__ int s_i0[kWarps], s_i1[kWarps];
  const T* xi = x + static_cast<size_t>(blockIdx.x) * n;
  T* yi = y + static_cast<size_t>(blockIdx.x) * n;

  float mn = FLT_MAX, mx = -FLT_MAX;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = to_f32(xi[i]);
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  block_minmax(mn, mx, s_f0, s_f1);

  float lo1 = mn, hi1 = mx, lo2 = mn, hi2 = mx;
  for (int it = 0; it < iters; ++it) {
    const float mid1 = __fmul_rn(__fadd_rn(lo1, hi1), 0.5f);
    const float mid2 = __fmul_rn(__fadd_rn(lo2, hi2), 0.5f);
    int c1 = 0, c2 = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float v = to_f32(xi[i]);
      c1 += v <= mid1;
      c2 += v <= mid2;
    }
    block_sum2(c1, c2, s_i0, s_i1);
    if (static_cast<float>(c1) <= t_lo) lo1 = mid1; else hi1 = mid1;
    if (static_cast<float>(c2) <= t_hi) lo2 = mid2; else hi2 = mid2;
  }
  const float p_lo = __fmul_rn(__fadd_rn(lo1, hi1), 0.5f);
  const float p_hi = __fmul_rn(__fadd_rn(lo2, hi2), 0.5f);
  const float den = __fadd_rn(__fsub_rn(p_hi, p_lo), eps);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = fminf(fmaxf(to_f32(xi[i]), p_lo), p_hi);
    yi[i] = from_f32<T>(__fdiv_rn(__fsub_rn(v, p_lo), den));
  }
}

// ---- kernel 12: fused_stats_quantile ------------------------------------------

constexpr int kSqThreads = 512;
constexpr int kSqWarps = kSqThreads / 32;
constexpr int kSqCluster = 16;            // CTAs an image (a non-portable cluster size)
constexpr int kSqSteps = 8;               // bisection steps one counting pass settles
constexpr int kSqBins = 1 << kSqSteps;    // 2^m - 1 candidates cut the line into 2^m bins
constexpr int kSqMaxStage = 92 * 1024;    // staged bytes a CTA: two CTAs fit an SM
constexpr int kSqChunk = 8192;            // bytes of one bulk copy: a float4 a thread
constexpr int kSqBars = kSqMaxStage / kSqChunk + 1;
constexpr float kInf = __builtin_huge_valf();

// The CTA's shared state; the fields a peer reads are marked.
struct SqShared {
  int whist[kSqWarps][kSqBins];  // per-warp bin counts of the running pass
  int chist[2][kSqBins];         // the CTA's bin counts, by pass parity (read by peers)
  int cnt[kSqBins];              // the cluster's counts, then their prefix sums
  float cand[kSqBins];           // the pass's candidate midpoints, ascending
  float2 bnd[kSqBins];           // bin e's bounds (cand[e - 1], cand[e]], -inf / +inf at the ends
  int wscan[8];
  double red_d[kSqWarps];
  float red_a[kSqWarps], red_b[kSqWarps];
  double sum, sq;                // the CTA's partial sums (read by peers)
  float mn, mx;                  // the CTA's extremes (read by peers)
  double total_sum, total_sq;
  float gmn, gmx;
  unsigned long long bar[kSqBars];
};

// Thread 0 gets the block's min, max and double sum.
__device__ __forceinline__ void sq_block_stats(float& mn, float& mx, double& s, SqShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  mn = warp_min(mn);
  mx = warp_max(mx);
  s = warp_sum(s);
  if (lane == 0) {
    sh.red_a[warp] = mn;
    sh.red_b[warp] = mx;
    sh.red_d[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSqWarps; ++w) {
      mn = fminf(mn, sh.red_a[w]);
      mx = fmaxf(mx, sh.red_b[w]);
      s += sh.red_d[w];
    }
  }
}

// Thread 0 gets the block's double sum.
__device__ __forceinline__ double sq_block_sum(double s, SqShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  if (lane == 0) sh.red_d[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kSqWarps; ++w) s += sh.red_d[w];
  return s;
}

// Candidate j (in-order index, 0 <= j < 2^s - 1) of the s-step bisection
// tree below bracket (lo, hi): the midpoint the one-step loop computes at
// that node, by the same operations along the path from the root.
__device__ __forceinline__ float tree_candidate(float lo, float hi, int s, int j) {
  int node = (1 << (s - 1)) - 1;
  for (int d = 0; d < s; ++d) {
    const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
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

// In-place inclusive prefix sum of cnt[0..k), k <= 256; every thread calls.
__device__ __forceinline__ void sq_prefix(SqShared& sh, int k) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int v = 0;
  if (tid < 256) {
    v = tid < k ? sh.cnt[tid] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) sh.wscan[warp] = v;
  }
  __syncthreads();
  if (tid < k) {
    for (int w = 0; w < warp; ++w) v += sh.wscan[w];
    sh.cnt[tid] = v;
  }
  __syncthreads();
}

// One counting pass over the CTA's slice (the staged float4s, or global
// memory): bins every element among the k ascending candidates (bin e:
// the first candidate >= v, k for none) into the warp's histogram, bin 0
// through a register. The bin is estimated from the value, checked against
// its two bounds with one shared load, and searched for only where the
// estimate missed (a bracket narrower than the float spacing, a NaN).
// kFirst (the bracket is still [min, max]): also the sum of squared
// deviations from `mean`, in float a float4 and in double across them.
// Otherwise, with `inside` (every candidate in [lo, hi]), an element <= lo
// is bin 0 and one > hi bin k without an estimate: all but about 1/2^m of
// the elements after the first pass.
template <bool kFirst>
__device__ __forceinline__ double sq_count(SqShared& sh, const float4* stage, const float* xi,
                                           int first, int count, bool staged, int k, bool inside,
                                           float lo, float hi, float mean) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // 0 for a bracket of one value (every hint 0, where bin 0 holds all)
  const float scale = hi > lo ? __fdiv_rn(static_cast<float>(k + 1), __fsub_rn(hi, lo)) : 0.0f;
  int* wh = sh.whist[warp];
  int below = 0;
  double sq = 0.0;
  auto visit = [&](float v) {
    if (k == 0) return;
    if (!kFirst && inside) {
      if (v <= lo) {
        ++below;
        return;
      }
      if (v > hi) return;
    }
    // round((v - lo) * scale - 1/2) by the float spacing of 1 in
    // [2^23, 2^24), clamped to [0, k]
    int e = __vimin_s32_relu(
        __float_as_int(__fmaf_rn(__fsub_rn(v, lo), scale, 8388607.5f)) - 0x4B000000, k);
    const float2 bd = sh.bnd[e];
    if (!(v > bd.x && v <= bd.y)) {
      while (e > 0 && v <= sh.cand[e - 1]) --e;
      while (e < k && !(v <= sh.cand[e])) ++e;
    }
    if (e == 0)
      ++below;
    else if (e < k)
      atomicAdd(wh + e, 1);
  };
  if (staged) {
    for (int j = threadIdx.x; j < count; j += kSqThreads) {
      const float4 v = stage[j];
      if (kFirst) {
        const float a = v.x - mean, b = v.y - mean, c = v.z - mean, d = v.w - mean;
        sq += static_cast<double>((a * a + b * b) + (c * c + d * d));
      }
      visit(v.x);
      visit(v.y);
      visit(v.z);
      visit(v.w);
    }
  } else {
    for (int i = first + threadIdx.x; i < first + count; i += kSqThreads) {
      const float v = __ldg(xi + i);
      if (kFirst) {
        const double d = static_cast<double>(v) - mean;
        sq += d * d;
      }
      visit(v);
    }
  }
  below = warp_sum(below);
  if (lane == 0 && k > 0) atomicAdd(wh, below);
  return sq;
}

// out (5, B): mean, std, max, min, quantile of each image. One cluster of
// kSqCluster CTAs an image; CTA `rank` owns slice `rank` of it.
__global__ void __launch_bounds__(kSqThreads, 2)
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

  for (int i = tid; i < kSqWarps * kSqBins; i += kSqThreads) (&sh.whist[0][0])[i] = 0;

  // pass 1: stage the slice (bulk copies, one mbarrier each) and take
  // min, max and the double sum as each piece lands
  float mn = FLT_MAX, mx = -FLT_MAX;
  double sum = 0.0;
  if (staged) {
    const int bytes = count * 16;
    const int pieces = (bytes + kSqChunk - 1) / kSqChunk;
    const uint32_t bar0 = wg::smem_addr(&sh.bar[0]);
    if (tid == 0) {
      for (int c = 0; c < pieces; ++c) wg::mbar_init(bar0 + 8 * c, 1);
      wg::mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      const float4* src = reinterpret_cast<const float4*>(xi) + first;
      for (int c = 0; c < pieces; ++c) {
        const int sz = min(kSqChunk, bytes - c * kSqChunk);
        wg::mbar_expect_tx(bar0 + 8 * c, sz);
        wg::bulk_load(wg::smem_addr(stage) + c * kSqChunk, src + c * (kSqChunk / 16), sz,
                      bar0 + 8 * c);
      }
    }
    for (int c = 0; c < pieces; ++c) {
      const int j = c * (kSqChunk / 16) + tid;  // kSqChunk / 16 == kSqThreads
      wg::mbar_wait(bar0 + 8 * c, 0);
      if (j < count) {
        const float4 v = stage[j];
        mn = fminf(fminf(mn, v.x), fminf(v.y, fminf(v.z, v.w)));
        mx = fmaxf(fmaxf(mx, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
        sum += static_cast<double>((v.x + v.y) + (v.z + v.w));
      }
    }
  } else {
    for (int i = first + tid; i < first + count; i += kSqThreads) {
      const float v = __ldg(xi + i);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      sum += v;
    }
  }
  sq_block_stats(mn, mx, sum, sh);
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
  float lo = sh.gmn, hi = sh.gmx;

  // counting passes, each settling up to kSqSteps bisection steps; the
  // first also sums the squared deviations (one pass even for iters == 0)
  int done = 0, parity = 0;
  bool first_pass = true;
  do {
    int s = min(kSqSteps, iters - done);
    int k = (1 << s) - 1;
    if (tid < k) sh.cand[tid] = tree_candidate(lo, hi, s, tid);
    __syncthreads();
    // the binning needs ascending candidates; where a midpoint left its
    // bracket (a sum past FLT_MAX, a NaN), the pass settles one step
    if (!__syncthreads_and(tid + 1 >= k || sh.cand[tid] <= sh.cand[tid + 1])) {
      s = 1;
      k = 1;
      if (tid == 0) sh.cand[0] = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
      __syncthreads();
    }
    if (tid <= k)
      sh.bnd[tid] = make_float2(tid > 0 ? sh.cand[tid - 1] : -kInf, tid < k ? sh.cand[tid] : kInf);
    __syncthreads();
    const bool inside = k > 0 && lo <= sh.cand[0] && sh.cand[k - 1] <= hi;
    if (first_pass) {
      const double sq =
          sq_count<true>(sh, stage, xi, first, count, staged, k, inside, lo, hi, mean);
      const double total = sq_block_sum(sq, sh);
      if (tid == 0) sh.sq = total;
    } else {
      sq_count<false>(sh, stage, xi, first, count, staged, k, inside, lo, hi, mean);
    }
    __syncthreads();
    for (int t = tid; t < k; t += kSqThreads) {
      int c = 0;
      for (int w = 0; w < kSqWarps; ++w) {
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
      sh.cnt[tid] = c;
    }
    __syncthreads();
    sq_prefix(sh, k);
    // the walk: the one-step rule at each node, every thread alike
    if (s > 0) {
      int node = (1 << (s - 1)) - 1;
      for (int d = 0; d < s; ++d) {
        const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
        const int step = d + 1 < s ? 1 << (s - 2 - d) : 0;
        if (static_cast<float>(sh.cnt[node]) <= target) {
          lo = mid;
          node += step;
        } else {
          hi = mid;
          node -= step;
        }
      }
    }
    done += s;
    parity ^= 1;
    first_pass = false;
    __syncthreads();  // cand and cnt are rewritten by the next pass
  } while (done < iters);
  cluster.sync();  // peers may still read this CTA's counts
  if (rank == 0 && tid == 0) {
    out[img] = mean;
    out[b + img] = static_cast<float>(sqrt(sh.total_sq / n));
    out[2 * b + img] = sh.gmx;
    out[3 * b + img] = sh.gmn;
    out[4 * b + img] = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
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
  cfg->blockDim = dim3(kSqThreads);
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
  out[1] = kSqThreads;
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
  if (is_bf16) {
    percentile_normalize_kernel<__nv_bfloat16><<<b, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, t_lo, t_hi,
        eps, iters);
  } else {
    percentile_normalize_kernel<float><<<b, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, t_lo, t_hi, eps, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
