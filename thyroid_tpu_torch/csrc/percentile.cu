// fused_percentile_normalize: per-image 1st/99th-percentile clip and scale.
//
// Replaces the TPU kernel thyroid_tpu/ops/percentile.py
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

}  // namespace

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
