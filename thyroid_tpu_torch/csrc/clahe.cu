// CLAHE LUT apply: each pixel blends the LUTs of its four neighbouring tiles.
//
// Two entries sharing one device function:
// - tt_apply_luts replaces the TPU kernel thyroid_tpu/ops/clahe.py
//   _quadrant_apply_kernel (pallas_call in _interp_luts_pallas): one grid;
// - tt_apply_luts_dual replaces _quadrant_apply_dual_kernel (pallas_call in
//   _interp_luts_pallas_dual): each image takes the coarse or the fine
//   grid's LUTs, as its use_coarse flag says.
//
// What it computes, per pixel (y, x) of image b with v = clip(x8, 0, 255):
// cv2's tile coordinate f = p / t - 0.5 along each axis (float32 division),
// weight f - floor(f), neighbour tiles clamp(floor(f)) and
// clamp(floor(f) + 1) into the grid; then
//   top = f00 * (1 - wx) + f01 * wx,  bot = f10 * (1 - wx) + f11 * wx,
//   out = top * (1 - wy) + bot * wy,
// with fij = lut[b, yi, xj, v], each operation a separately rounded float32
// one, exactly as ops/clahe.py _interp_luts (the plain version) computes it:
// the quality pipeline rounds the blend to 8 bit and scales it by about
// 257, so a last-bit difference at .5 would move a pixel by a grey level.
// Tiles need not have even sides.
//
// Bound on the H100: one read of x8 and one write of the output (8 bytes
// per pixel, 64 MiB per 32-frame chunk of 512x512) plus one read of the
// LUTs each image uses (1 MiB per image at grid 32x32, 0.25 MiB at 16x16,
// float32); about 20 us at 3.35 TB/s. Design: one block of 256 threads per
// band of 16 rows of one image. The block loads the LUT rows of the tiles
// its rows blend (at most (15 / th) + 3 tile rows) into shared memory as
// bytes (the LUT entries are integers 0..255; 24 KB at grid 32x32), then
// each thread takes pixels of the band in row-major order: four shared
// memory lookups and the blend. This replaces the TPU kernel's per-lane
// bit-select tree and expansion matmul, which existed only because the
// TPU's vector unit has no gather. Left for a later PR: each band reloads
// its LUT rows from L2 (about twice the LUT bytes over the whole chunk),
// and the float32 LUTs are converted to bytes in every block.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 16;  // output rows per block

struct Grid {
  const float* luts;  // (B, gh, gw, 256) float32, integer values 0..255
  int gh, gw, th, tw;
};

// cv2's tile coordinate of pixel p along an axis with tiles of t and g tiles.
__device__ __forceinline__ void tile_coord(int p, int t, int g, float& wgt, int& i0, int& i1) {
  const float f = __fsub_rn(__fdiv_rn(static_cast<float>(p), static_cast<float>(t)), 0.5f);
  const float fl = floorf(f);
  wgt = __fsub_rn(f, fl);
  const int k = static_cast<int>(fl);
  i0 = min(max(k, 0), g - 1);
  i1 = min(max(k + 1, 0), g - 1);
}

__device__ __forceinline__ float blend(float a, float b, float wgt) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, wgt)), __fmul_rn(b, wgt));
}

// Rows [y_begin, y_begin + kBand) of image b, with grid g's LUTs.
__device__ void apply_band(const float* __restrict__ x8, float* __restrict__ out, const Grid& g,
                           int b, int y_begin, int h, int w, unsigned char* s_lut) {
  const int y_end = min(y_begin + kBand, h);
  float wgt;
  int ya, yb, unused;
  tile_coord(y_begin, g.th, g.gh, wgt, ya, unused);
  tile_coord(y_end - 1, g.th, g.gh, wgt, unused, yb);
  const int row = g.gw * 256;
  const float* lut = g.luts + (static_cast<size_t>(b) * g.gh + ya) * row;
  for (int i = threadIdx.x; i < (yb - ya + 1) * row; i += kThreads) {
    s_lut[i] = static_cast<unsigned char>(lut[i]);
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(b) * h * w;
  for (int i = threadIdx.x; i < (y_end - y_begin) * w; i += kThreads) {
    const int y = y_begin + i / w, x = i % w;
    float wy, wx;
    int y0, y1, x0, x1;
    tile_coord(y, g.th, g.gh, wy, y0, y1);
    tile_coord(x, g.tw, g.gw, wx, x0, x1);
    const size_t p = base + static_cast<size_t>(y) * w + x;
    const int v = static_cast<int>(fminf(fmaxf(x8[p], 0.f), 255.f));
    const unsigned char* r0 = s_lut + (y0 - ya) * row + v;
    const unsigned char* r1 = s_lut + (y1 - ya) * row + v;
    const float top = blend(r0[x0 * 256], r0[x1 * 256], wx);
    const float bot = blend(r1[x0 * 256], r1[x1 * 256], wx);
    out[p] = blend(top, bot, wy);
  }
}

__global__ void __launch_bounds__(kThreads)
apply_luts_kernel(const float* __restrict__ x8, float* __restrict__ out, int h, int w, Grid g) {
  extern __shared__ unsigned char s_lut[];
  apply_band(x8, out, g, blockIdx.y, blockIdx.x * kBand, h, w, s_lut);
}

__global__ void __launch_bounds__(kThreads)
apply_luts_dual_kernel(const float* __restrict__ x8, const int* __restrict__ use_coarse,
                       float* __restrict__ out, int h, int w, Grid coarse, Grid fine) {
  extern __shared__ unsigned char s_lut[];
  const int b = blockIdx.y;
  apply_band(x8, out, use_coarse[b] ? coarse : fine, b, blockIdx.x * kBand, h, w, s_lut);
}

// Shared memory of the most tile rows a band of one grid can blend.
size_t lut_bytes(const Grid& g) {
  return static_cast<size_t>(std::min(g.gh, (kBand - 1) / g.th + 3)) * g.gw * 256;
}

}  // namespace

// x8, out: (b, h, w) float32; luts: (b, gh, gw, 256) float32; tiles th x tw.
TT_EXPORT int tt_apply_luts(const void* x8, void* out, int b, int h, int w, const void* luts,
                            int gh, int gw, int th, int tw, void* stream) {
  const Grid g{static_cast<const float*>(luts), gh, gw, th, tw};
  const size_t smem = lut_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(apply_luts_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + kBand - 1) / kBand, b);
  apply_luts_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x8), static_cast<float*>(out), h, w, g);
  return static_cast<int>(cudaGetLastError());
}

// As tt_apply_luts, image i taking the coarse grid where use_coarse[i] != 0
// (int32), else the fine grid.
TT_EXPORT int tt_apply_luts_dual(const void* x8, const void* use_coarse, void* out, int b, int h,
                                 int w, const void* luts_c, int gch, int gcw, int tch, int tcw,
                                 const void* luts_f, int gfh, int gfw, int tfh, int tfw,
                                 void* stream) {
  const Grid c{static_cast<const float*>(luts_c), gch, gcw, tch, tcw};
  const Grid f{static_cast<const float*>(luts_f), gfh, gfw, tfh, tfw};
  const size_t smem = std::max(lut_bytes(c), lut_bytes(f));
  cudaError_t err = cudaFuncSetAttribute(apply_luts_dual_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + kBand - 1) / kBand, b);
  apply_luts_dual_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x8), static_cast<const int*>(use_coarse),
      static_cast<float*>(out), h, w, c, f);
  return static_cast<int>(cudaGetLastError());
}
