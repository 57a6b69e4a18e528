// fused_median_bilateral: 3x3 median and the d x d bilateral of the median.
//
// Replaces the TPU kernel thyroid_tpu/ops/stencil.py _median_bilateral_kernel
// (pallas_call in fused_median_bilateral).
//
// What it computes, per 8-bit frame (float32, integer values 0..255): the
// 3x3 median with an edge-replicated border (cv2.medianBlur), by the same
// 19-comparator network as ops/image.py median_filter_3x3, and cv2's
// bilateral filter of that median (circular window of radius R = d / 2,
// reflect-101 border): for each kept tap in row-major order,
//   w = expf(-(tap - c)^2 * inv2sc) * ws    (float32),
//   acc += tap * w,  norm += w              (float64),
// out = float32(acc / norm), every operation a separately rounded one
// (__fmul_rn, __dadd_rn, __ddiv_rn, expf without --use_fast_math), as the
// plain PyTorch bilateral_filter does them. The artifact chain floors the
// bilateral, so a last-bit difference there becomes a whole grey level; the
// float64 sums give a flat region its value exactly, whatever the order.
//
// The two borders differ: the median pads its input by replication, the
// bilateral pads the median by reflect-101. A median position outside the
// frame is therefore first reflected into the frame, and its median is
// then taken over the edge-replicated input around the reflected position.
//
// Bound on the H100: one read of the frame and two writes (med and bil),
// 12 bytes per pixel (96 MiB per 32-frame chunk of 512x512, about 30 us at
// 3.35 TB/s); the arithmetic is about 160 float32 operations per pixel
// (38 for the median network, 9 per bilateral tap, two of them float64),
// a third of that time at 67 TFLOP/s. Design: one block of 256 threads per 32x32 output tile;
// the input window (tile + R + 1 on each side, edge-clamped) goes to shared
// memory, the block computes the median over the tile plus the bilateral's
// halo of R into shared memory, then each output pixel reads its taps from
// there. Left for a later PR: the median of the halo is recomputed by each
// neighbouring tile (27% extra at R = 2), and expf is taken per tap; both
// are small against the memory traffic.
#include "common.cuh"

constexpr int kMaxTaps = 64;

// The spatial weights of the kept taps, in row-major order (passed by value).
struct Taps {
  float sw[kMaxTaps];
};

namespace {

constexpr int kTile = 32;
constexpr int kThreadsX = 32, kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// cv2's BORDER_REFLECT_101 for -n < v < 2n - 1.
__device__ __forceinline__ int reflect101(int v, int n) {
  if (v < 0) v = -v;
  if (v >= n) v = 2 * (n - 1) - v;
  return v;
}

__device__ __forceinline__ void cmpswap(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
median_bilateral_kernel(const float* __restrict__ x, float* __restrict__ med,
                        float* __restrict__ bil, int h, int w, float inv2sc, Taps taps) {
  constexpr int kMed = kTile + 2 * R;  // the median over the tile and the bilateral's halo
  constexpr int kIn = kMed + 2;        // the input the median reads
  __shared__ float s_in[kIn][kIn + 1];
  __shared__ float s_med[kMed][kMed + 1];
  const int oy0 = blockIdx.y * kTile, ox0 = blockIdx.x * kTile;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const float* xi = x + plane;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  // s_in[ly][lx] = x at global (oy0 - R - 1 + ly, ox0 - R - 1 + lx), clamped
  // into the frame: the median's edge replication
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int ly = i / kIn, lx = i % kIn;
    const int gy = clampi(oy0 - R - 1 + ly, 0, h - 1);
    const int gx = clampi(ox0 - R - 1 + lx, 0, w - 1);
    s_in[ly][lx] = xi[static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();

  // s_med[my][mx] = median at the reflect-101 image of global
  // (oy0 - R + my, ox0 - R + mx). For every position an output pixel of the
  // frame reads, the reflected centre lies in [oy0 - R, oy0 + kTile + R - 1]
  // and its 3x3 window inside s_in; the clamp only keeps positions that feed
  // no output pixel (past the frame's last row or column) inside s_in.
  for (int i = tid; i < kMed * kMed; i += kThreads) {
    const int my = i / kMed, mx = i % kMed;
    const int cy = clampi(reflect101(oy0 - R + my, h) - (oy0 - R - 1), 1, kIn - 2);
    const int cx = clampi(reflect101(ox0 - R + mx, w) - (ox0 - R - 1), 1, kIn - 2);
    float p[9];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) p[dy * 3 + dx] = s_in[cy - 1 + dy][cx - 1 + dx];
    cmpswap(p[1], p[2]); cmpswap(p[4], p[5]); cmpswap(p[7], p[8]);
    cmpswap(p[0], p[1]); cmpswap(p[3], p[4]); cmpswap(p[6], p[7]);
    cmpswap(p[1], p[2]); cmpswap(p[4], p[5]); cmpswap(p[7], p[8]);
    cmpswap(p[0], p[3]); cmpswap(p[5], p[8]); cmpswap(p[4], p[7]);
    cmpswap(p[3], p[6]); cmpswap(p[1], p[4]); cmpswap(p[2], p[5]);
    cmpswap(p[4], p[7]); cmpswap(p[4], p[2]); cmpswap(p[6], p[4]);
    cmpswap(p[4], p[2]);
    s_med[my][mx] = p[4];
  }
  __syncthreads();

  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int ly = i / kTile, lx = i % kTile;
    const int gy = oy0 + ly, gx = ox0 + lx;
    if (gy >= h || gx >= w) continue;
    const float c = s_med[ly + R][lx + R];
    double acc = 0.0, norm = 0.0;
    int t = 0;
#pragma unroll
    for (int dy = 0; dy <= 2 * R; ++dy) {
#pragma unroll
      for (int dx = 0; dx <= 2 * R; ++dx) {
        if ((dy - R) * (dy - R) + (dx - R) * (dx - R) > R * R) continue;  // cv2's circle
        const float tap = s_med[ly + dy][lx + dx];
        const float d = __fsub_rn(tap, c);
        const float cw = __fmul_rn(expf(__fmul_rn(-__fmul_rn(d, d), inv2sc)), taps.sw[t++]);
        acc = __dadd_rn(acc, __dmul_rn(tap, cw));
        norm = __dadd_rn(norm, cw);
      }
    }
    const size_t o = plane + static_cast<size_t>(gy) * w + gx;
    med[o] = c;
    bil[o] = __double2float_rn(__ddiv_rn(acc, norm));
  }
}

}  // namespace

// x, med, bil: (b, h, w) float32; r = d / 2 in {1, 2, 3}; h, w > r.
TT_EXPORT int tt_median_bilateral(const void* x, void* med, void* bil, int b, int h, int w,
                                  int r, float inv2sc, Taps taps, void* stream) {
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  const dim3 block(kThreadsX, kThreadsY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* mp = static_cast<float*>(med);
  float* bp = static_cast<float*>(bil);
  switch (r) {
    case 1: median_bilateral_kernel<1><<<grid, block, 0, s>>>(xp, mp, bp, h, w, inv2sc, taps); break;
    case 2: median_bilateral_kernel<2><<<grid, block, 0, s>>>(xp, mp, bp, h, w, inv2sc, taps); break;
    case 3: median_bilateral_kernel<3><<<grid, block, 0, s>>>(xp, mp, bp, h, w, inv2sc, taps); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
