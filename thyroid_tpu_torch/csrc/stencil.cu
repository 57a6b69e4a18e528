// fused_median_bilateral: 3x3 median and the d x d bilateral of the median.
//
// Replaces the TPU kernel thyroid_tpu/ops/stencil.py _median_bilateral_kernel
// (pallas_call in fused_median_bilateral).
//
// What it computes, per 8-bit frame (float32, integer values 0..255): the
// 3x3 median with an edge-replicated border (cv2.medianBlur), the value of
// ops/image.py median_filter_3x3's comparator network, and cv2's bilateral
// filter of that median (circular window of radius R = d / 2, reflect-101
// border): for each kept tap in row-major order,
//   w = expf(-(tap - c)^2 * inv2sc) * ws    (float32),
//   acc += tap * w,  norm += w              (float64),
// out = float32(acc / norm), every operation a separately rounded one
// (__fmul_rn, __ddiv_rn, expf without --use_fast_math), as the plain
// PyTorch bilateral_filter does them. The artifact chain floors the
// bilateral, so a last-bit difference there becomes a whole grey level; the
// float64 sums give a flat region its value exactly, whatever the order.
//
// The two borders differ: the median pads its input by replication, the
// bilateral pads the median by reflect-101. A median position outside the
// frame takes the median at its reflect-101 image inside the frame.
//
// Bound on the H100: one read of the frame and two writes (med and bil),
// 12 bytes per pixel (96 MiB per 32-frame chunk of 512x512, about 30 us at
// 3.35 TB/s); the float64 work (an fma and an add a tap, a division a
// pixel) is about a third of that at 34 TFLOP/s. What a straightforward
// stencil spends instead: an accurate expf a tap (MUFU, 16 a clock an SM),
// two float32 -> float64 conversions a tap (16 a clock), a 19-comparator
// network a median, and about 20 address instructions a loaded value, its
// global latency exposed on every tile.
// Design:
// - Colour weights from a table. On the 8-bit input |d| = |tap - c| is an
//   integer in [0, 255], so tap t's weight takes 256 values. Each block
//   builds ct[|d|] = expf(-(d*d) * inv2sc) once (256 expf, one a thread,
//   the operations of the per-tap form), then W[t][|d|] =
//   double(ct[|d|] * ws[t]) for every tap: one shared-memory load a tap
//   replaces the expf, the float32 multiply and a conversion. A tile whose
//   input holds any value that is not an integer in [0, 255] takes the
//   per-tap expf instead (decided once per tile, __syncthreads_and).
// - acc += tap * w as one fma in float64: tap * w of two floats is exact in
//   float64 (24 + 24 bits), so fma(tap, w, acc) rounds once, as the
//   separate product and sum do; the sums keep their order.
// - The median from sorted columns: each thread takes four medians along x;
//   it sorts the six 3-element columns they share once, and each median is
//   med3(max of the three column minima, med3 of the column medians, min of
//   the column maxima), exact for any nine values.
// - 64x32 output tiles (26.6% recomputed median halo at R = 2) on a persistent
//   grid (as many blocks as the card holds at once: the table is built once
//   a block). Each thread copies its share of a tile's input window into
//   one of two buffers by cp.async, the next tile's copies in flight while
//   this one computes: a 16-byte copy for each four values inside a frame
//   whose width is a multiple of 4 and whose start is 16-byte aligned, 4-byte
//   copies clamped into the frame (the median's edge replication) at its
//   edges and for any other frame. The 8-bit test runs over the values a
//   tile copies (its window and two columns of row padding).
#include <stdint.h>

#include "common.cuh"

constexpr int kMaxTaps = 64;

// The spatial weights of the kept taps, in row-major order (passed by value).
struct Taps {
  float sw[kMaxTaps];
};

namespace {

constexpr int kTileW = 64, kTileH = 32;
constexpr int kThreads = 256;
constexpr int kStrip = 4;     // outputs (and medians) a thread takes along x
constexpr int kLevels = 256;  // W's entries a tap: |d| = 0..255
// Columns: a tile's input window starts at ox0 - kOx - 1, a multiple of 4
// (its rows copy in 16-byte pieces), and its medians at ox0 - kOx, so
// output column lx is median column lx + kOx; kOx >= R for every radius
// taken.
constexpr int kOx = 3;

__host__ __device__ constexpr int taps_of(int r) {
  int n = 0;
  for (int dy = -r; dy <= r; ++dy)
    for (int dx = -r; dx <= r; ++dx) n += dy * dy + dx * dx <= r * r;
  return n;
}

__host__ __device__ constexpr int isqrt(int v) {
  int s = 0;
  while ((s + 1) * (s + 1) <= v) ++s;
  return s;
}

// The circle's taps before row dy, in row-major order.
__host__ __device__ constexpr int first_tap(int r, int dy) {
  int n = 0;
  for (int y = -r; y < dy; ++y) n += 2 * isqrt(r * r - y * y) + 1;
  return n;
}

template <int R>
struct Geo {
  static constexpr int kTaps = taps_of(R);
  static constexpr int kMedH = kTileH + 2 * R;  // medians: the tile and the bilateral's halo
  static constexpr int kMedW = (kOx + kTileW + R + kStrip - 1) / kStrip * kStrip;
  static constexpr int kInH = kMedH + 2;        // the input the medians read:
  static constexpr int kInCols = kMedW + 2;     // kInH x kInCols in rows of kInW
  static constexpr int kInW = kMedW + 4;        // (16-byte rows; all kInW are copied)
  static constexpr int kRowF4 = (kStrip + kOx + R + 3) / 4;  // float4s of a tap row
  static constexpr int kTableBytes = kTaps * kLevels * 8;   // a multiple of 2048
  static constexpr int kInBytes = kInH * kInW * 4;
  static constexpr int kMedBytes = kMedH * kMedW * 4;
  // the table, two input buffers and the medians
  static constexpr int kSmem = kTableBytes + 2 * kInBytes + kMedBytes;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool is_8bit(float v) {
  return v >= 0.0f && v <= 255.0f && v == truncf(v);
}

// cv2's BORDER_REFLECT_101 for -n < v < 2n - 1.
__device__ __forceinline__ int reflect101(int v, int n) {
  if (v < 0) v = -v;
  if (v >= n) v = 2 * (n - 1) - v;
  return v;
}

__device__ __forceinline__ void sort3(float& a, float& b, float& c) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = fminf(lo, c);
  const float m = fmaxf(lo, c);
  b = fminf(hi, m);
  c = fmaxf(hi, m);
}

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// Four medians along x at median row my, columns mx0..mx0+3, from the
// input rows my..my+2, columns mx0..mx0+5.
template <int kInW>
__device__ __forceinline__ float4 median_strip(const float* in, int my, int mx0) {
  float lo[kStrip + 2], md[kStrip + 2], hi[kStrip + 2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* src = in + (my + r) * kInW + mx0;
    const float4 q = *reinterpret_cast<const float4*>(src);
    const float2 p = *reinterpret_cast<const float2*>(src + 4);
    float* dst = r == 0 ? lo : r == 1 ? md : hi;
    dst[0] = q.x;
    dst[1] = q.y;
    dst[2] = q.z;
    dst[3] = q.w;
    dst[4] = p.x;
    dst[5] = p.y;
  }
#pragma unroll
  for (int j = 0; j < kStrip + 2; ++j) sort3(lo[j], md[j], hi[j]);
  float m[kStrip];
#pragma unroll
  for (int o = 0; o < kStrip; ++o)
    m[o] = med3(fmaxf(fmaxf(lo[o], lo[o + 1]), lo[o + 2]), med3(md[o], md[o + 1], md[o + 2]),
                fminf(fminf(hi[o], hi[o + 1]), hi[o + 2]));
  return make_float4(m[0], m[1], m[2], m[3]);
}

// Row DY of the circle (taps dx = -w..w) added into the four outputs' sums
// in row-major order, then the rows below it.
template <int R, bool kTable, int DY>
__device__ __forceinline__ void bilateral_rows(const float* s_med, const double* W,
                                               const int (&ci)[kStrip], int ly, int lx0,
                                               float inv2sc, const Taps& taps,
                                               const float (&c)[kStrip], double (&acc)[kStrip],
                                               double (&norm)[kStrip]) {
  using G = Geo<R>;
  constexpr int kHalf = isqrt(R * R - DY * DY);
  constexpr int kFirst = first_tap(R, DY);
  constexpr int kCols = G::kRowF4 * 4;
  // v[i]: the median at tile column lx0 + i - kOx, row ly + DY; the row
  // needs i in [kOx - kHalf, kOx + kStrip - 1 + kHalf], float4s kF0..kF1
  constexpr int kF0 = (kOx - kHalf) / 4, kF1 = (kOx + kStrip - 1 + kHalf) / 4;
  float v[kCols];
  const float4* row = reinterpret_cast<const float4*>(s_med + (ly + R + DY) * G::kMedW + lx0);
#pragma unroll
  for (int f = kF0; f <= kF1; ++f) {
    const float4 q = row[f];
    v[4 * f] = q.x;
    v[4 * f + 1] = q.y;
    v[4 * f + 2] = q.z;
    v[4 * f + 3] = q.w;
  }
  // each value's float64 (and, on the table path, its integer) once, from
  // the bits on the table path (2^23 + v, 2^52 + v): not through the
  // conversion pipe, 16 a clock an SM
  int vi[kCols];
  double vd[kCols];
#pragma unroll
  for (int i = kOx - kHalf; i < kStrip + kOx + kHalf; ++i) {
    if (kTable) {
      vi[i] = __float_as_int(__fadd_rn(v[i], 8388608.0f)) - 0x4B000000;
      vd[i] = __dsub_rn(__hiloint2double(0x43300000, vi[i]), 4503599627370496.0);
    } else {
      vd[i] = static_cast<double>(v[i]);
    }
  }
#pragma unroll
  for (int o = 0; o < kStrip; ++o) {
#pragma unroll
    for (int dx = -kHalf; dx <= kHalf; ++dx) {
      const int i = o + kOx + dx, t = kFirst + dx + kHalf;
      double cw;
      if (kTable) {
        cw = W[t * kLevels + abs(vi[i] - ci[o])];
      } else {
        const float d = __fsub_rn(v[i], c[o]);
        cw = static_cast<double>(
            __fmul_rn(expf(__fmul_rn(-__fmul_rn(d, d), inv2sc)), taps.sw[t]));
      }
      acc[o] = __fma_rn(vd[i], cw, acc[o]);
      norm[o] = __dadd_rn(norm[o], cw);
    }
  }
  if constexpr (DY < R)
    bilateral_rows<R, kTable, DY + 1>(s_med, W, ci, ly, lx0, inv2sc, taps, c, acc, norm);
}

// The bilateral of four medians along x at tile row ly, columns lx0..lx0+3
// (c: the medians, res: their bilateral). kTable: colour weights from W
// (the tile's input is 8-bit integral); else the per-tap expf.
template <int R, bool kTable>
__device__ __forceinline__ void bilateral_strip(const float* s_med, const double* W, int ly,
                                                int lx0, float inv2sc, const Taps& taps,
                                                float (&c)[kStrip], float (&res)[kStrip]) {
  double acc[kStrip], norm[kStrip];
  int ci[kStrip];
#pragma unroll
  for (int o = 0; o < kStrip; ++o) {
    acc[o] = 0.0;
    norm[o] = 0.0;
    c[o] = s_med[(ly + R) * Geo<R>::kMedW + lx0 + o + kOx];
    ci[o] = kTable ? __float_as_int(__fadd_rn(c[o], 8388608.0f)) - 0x4B000000 : 0;
  }
  bilateral_rows<R, kTable, -R>(s_med, W, ci, ly, lx0, inv2sc, taps, c, acc, norm);
#pragma unroll
  for (int o = 0; o < kStrip; ++o) res[o] = __double2float_rn(__ddiv_rn(acc[o], norm[o]));
}

// x, med, bil: (b, h, w) float32.
template <int R>
__global__ void __launch_bounds__(kThreads)
median_bilateral_kernel(const float* __restrict__ x, float* __restrict__ med,
                        float* __restrict__ bil, int b, int h, int w, float inv2sc, Taps taps) {
  using G = Geo<R>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* W = reinterpret_cast<double*>(smem);
  float* s_in0 = reinterpret_cast<float*>(smem + G::kTableBytes);
  float* s_med = reinterpret_cast<float*>(smem + G::kTableBytes + 2 * G::kInBytes);
  const int tid = threadIdx.x;
  const int tiles_x = (w + kTileW - 1) / kTileW, tiles_y = (h + kTileH - 1) / kTileH;
  const int tiles = tiles_x * tiles_y * b;
  constexpr int kInQ = G::kInW / 4;  // 16-byte pieces of a window row

  // the output tile (oy0, ox0) of image img; its input window starts at
  // (oy0 - R - 1, ox0 - kOx - 1)
  auto origin = [&](int tile, int& img, int& oy0, int& ox0) {
    img = tile / (tiles_x * tiles_y);
    const int rest = tile - img * tiles_x * tiles_y;
    oy0 = rest / tiles_x * kTileH;
    ox0 = rest % tiles_x * kTileW;
  };
  // this thread's share of a tile's window into buffer buf, in flight until
  // the thread's next cp.async.wait_all: the window's rows in 16-byte
  // pieces, each one 16-byte copy where its four values lie inside an
  // aligned frame, else four 4-byte copies clamped into the frame
  const bool vec = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto load_window = [&](int tile, int buf) {
    int img, oy0, ox0;
    origin(tile, img, oy0, ox0);
    const int iy0 = oy0 - R - 1, ix0 = ox0 - kOx - 1;
    const float* xi = x + static_cast<size_t>(img) * h * w;
    const uint32_t in = smem_u32(s_in0) + buf * G::kInBytes;
    for (int i = tid; i < G::kInH * kInQ; i += kThreads) {
      const int iy = i / kInQ, ix = (i - iy * kInQ) * 4;
      const float* row = xi + static_cast<size_t>(clampi(iy0 + iy, 0, h - 1)) * w;
      const int gx = ix0 + ix;
      const uint32_t dst = in + 4 * (iy * G::kInW + ix);
      if (vec && gx >= 0 && gx + 4 <= w) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(row + gx)
                     : "memory");
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4 * k),
                       "l"(row + clampi(gx + k, 0, w - 1))
                       : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (static_cast<int>(blockIdx.x) < tiles) load_window(blockIdx.x, 0);

  // the colour table, once a block, while the first window is in flight:
  // ct (in s_med's room) then W
  float* ct = s_med;
  if (tid < 256) {
    const float d = static_cast<float>(tid);
    ct[tid] = expf(__fmul_rn(-__fmul_rn(d, d), inv2sc));
  }
  __syncthreads();
  for (int i = tid; i < G::kTaps * kLevels; i += kThreads) {
    const int t = i / kLevels, e = i - t * kLevels;
    W[i] = static_cast<double>(__fmul_rn(ct[e], taps.sw[t]));
  }
  // (the first tile's barriers order W and ct before their readers)

  int n = 0;  // tiles this block has taken: tile n's window is in buffer n & 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    int img, oy0, ox0;
    origin(tile, img, oy0, ox0);
    const float* in = s_in0 + (n & 1) * (G::kInBytes / 4);
    // this thread's copies have landed; it checks the values it copied
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    bool eight_bit = true;
    for (int i = tid; i < G::kInH * kInQ; i += kThreads) {
      const float4 q = reinterpret_cast<const float4*>(in)[i];
      eight_bit &= is_8bit(q.x) && is_8bit(q.y) && is_8bit(q.z) && is_8bit(q.w);
    }
    // (and after this barrier every thread's copies are visible)
    const bool table = __syncthreads_and(eight_bit);
    // the next tile's window into the other buffer, which the last tile's
    // median pass read before the barrier that followed it
    if (tile + static_cast<int>(gridDim.x) < tiles) load_window(tile + gridDim.x, (n + 1) & 1);

    // medians at (oy0 - R + my, ox0 - kOx + mx), four along x a thread
    for (int i = tid; i < G::kMedH * (G::kMedW / kStrip); i += kThreads) {
      const int my = i / (G::kMedW / kStrip), mx0 = (i - my * (G::kMedW / kStrip)) * kStrip;
      *reinterpret_cast<float4*>(s_med + my * G::kMedW + mx0) =
          median_strip<G::kInW>(in, my, mx0);
    }
    __syncthreads();

    // positions outside the frame take the median at their reflect-101
    // image; those that feed no output keep any value inside the tile
    if (oy0 - R < 0 || ox0 - kOx < 0 || oy0 + kTileH + R > h || ox0 - kOx + G::kMedW > w) {
      for (int i = tid; i < G::kMedH * G::kMedW; i += kThreads) {
        const int my = i / G::kMedW, mx = i - my * G::kMedW;
        const int gy = oy0 - R + my, gx = ox0 - kOx + mx;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) continue;
        const int ry = clampi(reflect101(clampi(gy, 1 - h, 2 * h - 2), h) - (oy0 - R), 0,
                              G::kMedH - 1);
        const int rx = clampi(reflect101(clampi(gx, 1 - w, 2 * w - 2), w) - (ox0 - kOx), 0,
                              G::kMedW - 1);
        s_med[i] = s_med[ry * G::kMedW + rx];
      }
      __syncthreads();
    }

    // the bilateral, four outputs along x a thread
    const size_t plane = static_cast<size_t>(img) * h * w;
    for (int i = tid; i < kTileH * (kTileW / kStrip); i += kThreads) {
      const int ly = i / (kTileW / kStrip), lx0 = (i - ly * (kTileW / kStrip)) * kStrip;
      const int gy = oy0 + ly, gx = ox0 + lx0;
      if (gy >= h || gx >= w) continue;
      float c[kStrip], res[kStrip];
      if (table)
        bilateral_strip<R, true>(s_med, W, ly, lx0, inv2sc, taps, c, res);
      else
        bilateral_strip<R, false>(s_med, W, ly, lx0, inv2sc, taps, c, res);
      const size_t o = plane + static_cast<size_t>(gy) * w + gx;
      if ((w & 3) == 0) {
        *reinterpret_cast<float4*>(med + o) = make_float4(c[0], c[1], c[2], c[3]);
        *reinterpret_cast<float4*>(bil + o) = make_float4(res[0], res[1], res[2], res[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kStrip; ++k) {
          if (gx + k < w) {
            med[o + k] = c[k];
            bil[o + k] = res[k];
          }
        }
      }
    }
    // no barrier: the next tile's first barrier follows every read of s_med
    // here, and this tile's input buffer is not read past the median pass
  }
}

// The persistent grid: blocks the card holds at once, once per radius.
template <int R>
cudaError_t grid_blocks(int* blocks) {
  static int cached = 0;
  if (cached == 0) {
    cudaError_t err = cudaFuncSetAttribute(median_bilateral_kernel<R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Geo<R>::kSmem);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, median_bilateral_kernel<R>,
                                                        kThreads, Geo<R>::kSmem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    cached = sms * per_sm;
  }
  *blocks = cached;
  return cudaSuccess;
}

template <int R>
int launch(const float* x, float* med, float* bil, int b, int h, int w, float inv2sc,
           const Taps& taps, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = grid_blocks<R>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((w + kTileW - 1) / kTileW) *
                          ((h + kTileH - 1) / kTileH) * b;
  const int grid = static_cast<int>(tiles < blocks ? tiles : blocks);
  median_bilateral_kernel<R><<<grid, kThreads, Geo<R>::kSmem, s>>>(x, med, bil, b, h, w, inv2sc,
                                                                   taps);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int config(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, median_bilateral_kernel<R>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = grid_blocks<R>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  out[0] = kTileW;
  out[1] = kTileH;
  out[2] = kThreads;
  out[3] = Geo<R>::kSmem;
  out[4] = fa.numRegs;
  out[5] = blocks / sms;
  out[6] = blocks;
  return 0;
}

}  // namespace

// x, med, bil: (b, h, w) float32; r = d / 2 in {1, 2, 3}; h, w > r.
TT_EXPORT int tt_median_bilateral(const void* x, void* med, void* bil, int b, int h, int w,
                                  int r, float inv2sc, Taps taps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* mp = static_cast<float*>(med);
  float* bp = static_cast<float*>(bil);
  switch (r) {
    case 1: return launch<1>(xp, mp, bp, b, h, w, inv2sc, taps, s);
    case 2: return launch<2>(xp, mp, bp, b, h, w, inv2sc, taps, s);
    case 3: return launch<3>(xp, mp, bp, b, h, w, inv2sc, taps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch of tt_median_bilateral at radius r: out[0..6] = output tile
// width and height, threads a block, dynamic shared bytes a block,
// registers a thread, blocks an SM, blocks of the persistent grid.
TT_EXPORT int tt_median_bilateral_config(int r, int* out) {
  switch (r) {
    case 1: return config<1>(out);
    case 2: return config<2>(out);
    case 3: return config<3>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
