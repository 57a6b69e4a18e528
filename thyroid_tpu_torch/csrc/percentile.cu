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
// in fused_stats_quantile). Bound on the H100: one read of the batch
// (32 MiB per 32-frame chunk of 512x512 float32, about 10 us at 3.35 TB/s)
// against 2 + iters passes of compares and adds. Design: one block of 1024
// threads per image, as kernel 1: a pass for min, max and the sum, a pass
// for the sum of squared deviations from the mean (both summed in double,
// so mean and std differ from the plain version's float32 sums only in the
// last bits), then `iters` count passes with kernel 1's bracket update;
// the quantile, max and min are bit-equal to the plain version. The 1 MiB
// image is re-read from L2 on every pass (a 32-frame chunk is 32 MiB, in
// the 50 MB L2). Left for a later PR: one block per image occupies 32 of
// the 132 SMs at a chunk of 32; a cluster of blocks per image sharing the
// counts through distributed shared memory would use them all.
#include "common.cuh"

#include <cfloat>

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

// Sum a double over the block; every thread returns the total.
__device__ __forceinline__ double block_sum(double a, double* s_a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  if (lane == 0) s_a[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? s_a[lane] : 0.0;
    a = warp_sum(a);
    if (lane == 0) s_a[0] = a;
  }
  __syncthreads();
  a = s_a[0];
  __syncthreads();
  return a;
}

// f(v) for every element of the image this thread owns; float4 loads
// where the image starts 16 B aligned and n is a multiple of 4.
template <typename F>
__device__ __forceinline__ void for_each(const float* __restrict__ xi, int n, F f) {
  if ((n & 3) == 0 && (reinterpret_cast<size_t>(xi) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xi);
    for (int i = threadIdx.x; i < (n >> 2); i += kThreads) {
      const float4 v = x4[i];
      f(v.x);
      f(v.y);
      f(v.z);
      f(v.w);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) f(xi[i]);
  }
}

// out (5, B): mean, std, max, min, quantile of each image.
__global__ void __launch_bounds__(kThreads)
stats_quantile_kernel(const float* __restrict__ x, float* __restrict__ out, int b, int n,
                      float target, int iters) {
  __shared__ float s_f0[kWarps], s_f1[kWarps];
  __shared__ int s_i0[kWarps], s_i1[kWarps];
  __shared__ double s_d[kWarps];
  const float* xi = x + static_cast<size_t>(blockIdx.x) * n;

  float mn = FLT_MAX, mx = -FLT_MAX;
  double sum = 0.0;
  for_each(xi, n, [&](float v) {
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
    sum += v;
  });
  block_minmax(mn, mx, s_f0, s_f1);
  const float mean = static_cast<float>(block_sum(sum, s_d) / n);

  double sq = 0.0;
  for_each(xi, n, [&](float v) {
    const double d = static_cast<double>(v) - mean;
    sq += d * d;
  });
  const float sd = static_cast<float>(sqrt(block_sum(sq, s_d) / n));

  float lo = mn, hi = mx;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
    int c = 0, unused = 0;
    for_each(xi, n, [&](float v) { c += v <= mid; });
    block_sum2(c, unused, s_i0, s_i1);
    if (static_cast<float>(c) <= target) lo = mid; else hi = mid;
  }
  if (threadIdx.x == 0) {
    out[blockIdx.x] = mean;
    out[b + blockIdx.x] = sd;
    out[2 * b + blockIdx.x] = mx;
    out[3 * b + blockIdx.x] = mn;
    out[4 * b + blockIdx.x] = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
  }
}

}  // namespace

TT_EXPORT int tt_stats_quantile(const void* x, void* out, int b, int n, float target, int iters,
                                void* stream) {
  stats_quantile_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), b, n, target, iters);
  return static_cast<int>(cudaGetLastError());
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
