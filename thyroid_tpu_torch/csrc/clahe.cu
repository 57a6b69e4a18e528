// CLAHE LUT apply: each pixel blends the LUTs of its four neighbouring tiles.
//
// Three entries sharing one kernel (apply_kernel<kMode>):
// - tt_apply_luts replaces the TPU kernel thyroid_tpu/ops/clahe.py
//   _quadrant_apply_kernel (pallas_call in _interp_luts_pallas): one grid;
// - tt_apply_luts_dual replaces _quadrant_apply_dual_kernel (pallas_call in
//   _interp_luts_pallas_dual): each image takes the coarse or the fine
//   grid's LUTs, as its use_coarse flag says;
// - tt_apply_luts_dual_fused replaces _quadrant_apply_dual_fused_kernel
//   (pallas_call in _interp_luts_pallas_dual_fused): the dual apply with
//   the uint16 round trip's way back and the per-image branch select as
//   its epilogue (see its entry below).
//
// What it computes, per pixel (y, x) of image b with v = clip(x8, 0, 255):
// cv2's tile coordinate f = p / t - 0.5 along each axis, weight
// f - floor(f), neighbour tiles clamp(floor(f)) and clamp(floor(f) + 1)
// into the grid; then
//   top = f00 * (1 - wx) + f01 * wx,  bot = f10 * (1 - wx) + f11 * wx,
//   out = top * (1 - wy) + bot * wy,
// with fij = lut[b, yi, xj, v]. Every step is rounded as the JAX package's
// compiled program rounds it, and as ops/clahe.py _interp_luts (the plain
// version) repeats it: f = fma(p, float32(1/t), -0.5) (XLA's reciprocal
// product, fused with the -0.5), and each blend a * (1 - w) + b * w as
// fma(a, 1 - w, round(b * w)); the quality pipeline rounds the blend to
// 8 bit and scales it by about 257, so a last-bit difference at .5 would
// move a pixel by a grey level. The LUT entries are read as the float32
// values they are, so the output is bit-equal to _interp_luts.
// Tiles need not have even sides.
//
// Bound on the H100: one read of x8 and one write of the output (8 bytes
// per pixel, 64 MiB per 32-frame chunk of 512x512) plus one read of the
// LUTs each image uses (1 MiB per image at grid 32x32, 0.25 MiB at 16x16,
// float32); about 27 us at 3.35 TB/s for the quality chunk. Design:
// - bands on cv2's half tiles: a band is the rows whose tile coordinate
//   has the same floor (rows [t/2 + m t, t/2 + (m + 1) t) inside the
//   frame), so it blends exactly two LUT rows (one at the top and bottom
//   edges), not the three a band of 16 rows off the half tile needs;
// - persistent blocks of 512 threads, as many as fit the 132 SMs (two an
//   SM at grid 32x32 on 512-wide frames), each over a contiguous run of
//   the batch's rows, band after band; consecutive bands share a LUT row,
//   so a block holds three LUT rows of float32 in shared memory (96 KB at
//   grid 32x32) and copies each new row once by 16-byte cp.async, a band
//   ahead: the next band's row lands while the current band blends;
// - each column's weight and tile pair are computed once per block into
//   shared memory, with tile_coord's operations; each row's weight once
//   per 4 pixels, its tile pair once per band;
// - pixels move as 16-byte loads and stores (a frame of width a multiple
//   of 4 on 16-byte boundaries; 4-byte ones otherwise); two blocks of 512
//   threads an SM keep enough of them in flight (two 16-byte loads a
//   thread in flight were measured no faster);
// - the fused entry reads the frame itself too (12 bytes per pixel, 96 MiB
//   per chunk, about 30 us); a band of a frame that takes no equalisation
//   copies its rows and loads no LUT row.
#include "common.cuh"

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kSlots = 3;       // LUT rows a block holds: a band's two and the next one
constexpr int kSMs = 132;
constexpr size_t kMaxSmem = 232448;

enum Mode { kSingle = 0, kDual = 1, kDualFused = 2 };

struct Grid {
  const float* luts;  // (B, gh, gw, 256) float32, integer values 0..255
  int gh, gw, th, tw;
};

struct Args {
  const float* x8;         // (b, h, w) the 8-bit bins
  const float* orig;       // kDualFused: (b, h, w) the frames on the uint16 scale
  const int* use_coarse;   // kDual, kDualFused: (b,) grid[0] (coarse) where != 0, else grid[1]
  const int* apply;        // kDualFused: (b,)
  const float* lo;         // kDualFused: (b,)
  const float* span;       // kDualFused: (b,)
  float* out;              // (b, h, w)
  int b, h, w;
  Grid grid[2];
  int rows_per_block;      // of the batch's b * h rows
  int slot_floats;         // floats of a LUT slot: the widest grid's gw * 256
  int wp;                  // w rounded up to 4: the column tables' stride
  int vec;                 // 16-byte pixel loads and stores
};

// cv2's tile coordinate of pixel p along an axis with tiles of t and g tiles.
__device__ __forceinline__ void tile_coord(int p, int t, int g, float& wgt, int& i0, int& i1) {
  const float f = __fmaf_rn(static_cast<float>(p), __frcp_rn(static_cast<float>(t)), -0.5f);
  const float fl = floorf(f);
  wgt = __fsub_rn(f, fl);
  const int k = static_cast<int>(fl);
  i0 = min(max(k, 0), g - 1);
  i1 = min(max(k + 1, 0), g - 1);
}

__device__ __forceinline__ float blend(float a, float b, float wgt) {
  return __fmaf_rn(a, __fsub_rn(1.f, wgt), __fmul_rn(b, wgt));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// A band: rows [y, y_end) of image img whose tile rows are (r0, r1) of
// grid gi, held in LUT slots s0, s1; or, with pass, rows of a frame the
// fused apply passes through.
struct Band {
  int img, y, y_end, gi, r0, r1, s0, s1;
  bool pass;
};

template <int kMode>
__device__ __forceinline__ Band band_at(const Args& a, int row, int row_end) {
  Band bd;
  bd.img = row / a.h;
  bd.y = row - bd.img * a.h;
  bd.s0 = bd.s1 = -1;
  const int last = min(a.h, row_end - bd.img * a.h);
  bd.pass = kMode == kDualFused && (a.apply[bd.img] == 0 || !(a.span[bd.img] > 0.f));
  bd.gi = kMode == kSingle || bd.pass ? 0 : (a.use_coarse[bd.img] != 0 ? 0 : 1);
  if (bd.pass) {
    bd.y_end = last;
    bd.r0 = bd.r1 = -1;
    return bd;
  }
  const Grid g = bd.gi == 0 ? a.grid[0] : a.grid[1];
  const float rcp = __frcp_rn(static_cast<float>(g.th));
  const float fl = floorf(__fmaf_rn(static_cast<float>(bd.y), rcp, -0.5f));
  int e = bd.y + 1;
  while (e < last && floorf(__fmaf_rn(static_cast<float>(e), rcp, -0.5f)) == fl) ++e;
  bd.y_end = e;
  const int k = static_cast<int>(fl);
  bd.r0 = min(max(k, 0), g.gh - 1);
  bd.r1 = min(max(k + 1, 0), g.gh - 1);
  return bd;
}

// The slot of LUT row `key` (img * h + row) among the tags, or -1.
__device__ __forceinline__ int find_slot(const int (&tag)[kSlots], int key) {
  int s = -1;
#pragma unroll
  for (int i = 0; i < kSlots; ++i)
    if (tag[i] == key) s = i;
  return s;
}

// A slot other than a, b and c.
__device__ __forceinline__ int free_slot(int a, int b, int c) {
  int s = -1;
#pragma unroll
  for (int i = kSlots - 1; i >= 0; --i)
    if (i != a && i != b && i != c) s = i;
  return s;
}

// Gives band bd its LUT slots: a row already held keeps its slot, a new
// row takes a slot that neither this band nor the band being blended
// (slots keep0, keep1) uses and is copied there by cp.async (not waited
// for). Consecutive bands share a row, so three slots always suffice.
__device__ __forceinline__ void fetch(const Args& a, Band& bd, int (&tag)[kSlots], int keep0,
                                      int keep1, float* slots) {
  if (bd.pass) return;
  const Grid g = bd.gi == 0 ? a.grid[0] : a.grid[1];
  const int key0 = bd.img * a.h + bd.r0, key1 = bd.img * a.h + bd.r1;
  bd.s0 = find_slot(tag, key0);
  bd.s1 = find_slot(tag, key1);
  const int n16 = g.gw * 64;  // 16-byte pieces of a LUT row
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    int& sl = q == 0 ? bd.s0 : bd.s1;
    if (sl >= 0) continue;
    if (q == 1 && key1 == key0) {
      sl = bd.s0;
      continue;
    }
    sl = free_slot(keep0, keep1, q == 0 ? bd.s1 : bd.s0);
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      if (i == sl) tag[i] = q == 0 ? key0 : key1;
    const float* src = g.luts + (static_cast<size_t>(bd.img) * g.gh + (q == 0 ? bd.r0 : bd.r1)) *
                                    g.gw * 256;
    float* dst = slots + sl * a.slot_floats;
    for (int i = threadIdx.x; i < n16; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
  }
}

// One pixel: the blend of LUT rows s0 (upper tile row) and s1 (lower) at
// column offsets o0, o1 (x0 * 256, x1 * 256) with weights wx, wy, and the
// fused entry's way back with the image's scale and lo.
template <int kMode>
__device__ __forceinline__ float pixel(float xv, const float* s0, const float* s1, int o0, int o1,
                                       float wx, float wy, float scale, float lo) {
  const int v = static_cast<int>(fminf(fmaxf(xv, 0.f), 255.f));
  const float top = blend(s0[o0 + v], s0[o1 + v], wx);
  const float bot = blend(s1[o0 + v], s1[o1 + v], wx);
  const float r = blend(top, bot, wy);
  if constexpr (kMode == kDualFused) {
    const float o = __fmaf_rn(rintf(r), scale, lo);
    return floorf(fminf(fmaxf(o, 0.f), 65535.f));
  }
  return r;
}

// Blends (or passes through) the band's pixels: a contiguous run of
// (y_end - y) * w floats.
template <int kMode>
__device__ __forceinline__ void process(const Args& a, const Band& bd, const float* slots,
                                        const float* tables) {
  const size_t base = (static_cast<size_t>(bd.img) * a.h + bd.y) * a.w;
  const int count = (bd.y_end - bd.y) * a.w;
  if (kMode == kDualFused && bd.pass) {
    const bool flat = a.apply[bd.img] != 0;
    auto keep = [&](float v) { return flat ? floorf(v) : v; };
    if (a.vec) {
      const float4* src = reinterpret_cast<const float4*>(a.orig + base);
      float4* dst = reinterpret_cast<float4*>(a.out + base);
      for (int i = threadIdx.x; i < count / 4; i += kThreads) {
        const float4 v = src[i];
        dst[i] = make_float4(keep(v.x), keep(v.y), keep(v.z), keep(v.w));
      }
    } else {
      for (int i = threadIdx.x; i < count; i += kThreads) a.out[base + i] = keep(a.orig[base + i]);
    }
    return;
  }
  const Grid g = bd.gi == 0 ? a.grid[0] : a.grid[1];
  const float rcp = __frcp_rn(static_cast<float>(g.th));
  const float* s0 = slots + bd.s0 * a.slot_floats;
  const float* s1 = slots + bd.s1 * a.slot_floats;
  const float* cwx = tables + bd.gi * 3 * a.wp;
  const int* co0 = reinterpret_cast<const int*>(cwx + a.wp);
  const int* co1 = reinterpret_cast<const int*>(cwx + 2 * a.wp);
  float scale = 0.f, lo = 0.f;
  if constexpr (kMode == kDualFused) {
    scale = __fmul_rn(a.span[bd.img], 1.0f / 255.0f);
    lo = a.lo[bd.img];
  }
  auto row_weight = [&](int p) {  // p: the pixel's offset in the band
    const float f = __fmaf_rn(static_cast<float>(bd.y + p / a.w), rcp, -0.5f);
    return __fsub_rn(f, floorf(f));
  };
  if (a.vec) {
    const float4* src = reinterpret_cast<const float4*>(a.x8 + base);
    float4* dst = reinterpret_cast<float4*>(a.out + base);
    for (int i = threadIdx.x; i < count / 4; i += kThreads) {
      const float4 v = src[i];
      const int p = 4 * i, x = p % a.w;
      const float wy = row_weight(p);
      const float4 wx = *reinterpret_cast<const float4*>(cwx + x);
      const int4 o0 = *reinterpret_cast<const int4*>(co0 + x);
      const int4 o1 = *reinterpret_cast<const int4*>(co1 + x);
      dst[i] = make_float4(pixel<kMode>(v.x, s0, s1, o0.x, o1.x, wx.x, wy, scale, lo),
                           pixel<kMode>(v.y, s0, s1, o0.y, o1.y, wx.y, wy, scale, lo),
                           pixel<kMode>(v.z, s0, s1, o0.z, o1.z, wx.z, wy, scale, lo),
                           pixel<kMode>(v.w, s0, s1, o0.w, o1.w, wx.w, wy, scale, lo));
    }
  } else {
    for (int p = threadIdx.x; p < count; p += kThreads) {
      const int x = p % a.w;
      a.out[base + p] = pixel<kMode>(a.x8[base + p], s0, s1, co0[x], co1[x], cwx[x],
                                     row_weight(p), scale, lo);
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2) apply_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* slots = smem;                             // kSlots LUT rows
  float* tables = smem + kSlots * a.slot_floats;   // per grid: wx, x0 * 256, x1 * 256 by column
  constexpr int kGrids = kMode == kSingle ? 1 : 2;
#pragma unroll
  for (int gi = 0; gi < kGrids; ++gi) {
    const Grid& g = a.grid[gi];
    float* cwx = tables + gi * 3 * a.wp;
    int* co0 = reinterpret_cast<int*>(cwx + a.wp);
    int* co1 = reinterpret_cast<int*>(cwx + 2 * a.wp);
    for (int x = threadIdx.x; x < a.w; x += kThreads) {
      int x0, x1;
      tile_coord(x, g.tw, g.gw, cwx[x], x0, x1);
      co0[x] = x0 * 256;
      co1[x] = x1 * 256;
    }
  }
  const int total = a.b * a.h;
  const int row0 = blockIdx.x * a.rows_per_block;
  const int row_end = min(total, row0 + a.rows_per_block);
  if (row0 >= row_end) return;
  int tag[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) tag[i] = -1;
  Band cur = band_at<kMode>(a, row0, row_end);
  fetch(a, cur, tag, -1, -1, slots);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  while (true) {
    const int next_row = cur.img * a.h + cur.y_end;
    const bool more = next_row < row_end;
    Band nxt;
    if (more) {
      nxt = band_at<kMode>(a, next_row, row_end);
      fetch(a, nxt, tag, cur.s0, cur.s1, slots);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // the current band's rows
    __syncthreads();
    process<kMode>(a, cur, slots, tables);
    if (!more) break;
    __syncthreads();  // the next fetch may take a slot this band read
    cur = nxt;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int kMode>
int launch(Args a, cudaStream_t s) {
  if (a.b == 0 || a.h == 0 || a.w == 0) return 0;
  const int grids = kMode == kSingle ? 1 : 2;
  a.wp = (a.w + 3) / 4 * 4;
  a.slot_floats = 0;
  for (int gi = 0; gi < grids; ++gi) a.slot_floats = std::max(a.slot_floats, a.grid[gi].gw * 256);
  const size_t smem = (static_cast<size_t>(kSlots) * a.slot_floats +
                       static_cast<size_t>(grids) * 3 * a.wp) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(apply_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, apply_kernel<kMode>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.b) * a.h;
  const long long blocks = std::min<long long>(rows, static_cast<long long>(std::max(per_sm, 1)) * kSMs);
  a.rows_per_block = static_cast<int>((rows + blocks - 1) / blocks);
  const unsigned grid = static_cast<unsigned>((rows + a.rows_per_block - 1) / a.rows_per_block);
  const auto aligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; };
  a.vec = a.w % 4 == 0 && aligned(a.x8) && aligned(a.out) &&
          (kMode != kDualFused || aligned(a.orig));
  apply_kernel<kMode><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args args(const void* x8, void* out, int b, int h, int w) {
  Args a{};
  a.x8 = static_cast<const float*>(x8);
  a.out = static_cast<float*>(out);
  a.b = b;
  a.h = h;
  a.w = w;
  return a;
}

}  // namespace

// x8, out: (b, h, w) float32; luts: (b, gh, gw, 256) float32; tiles th x tw.
TT_EXPORT int tt_apply_luts(const void* x8, void* out, int b, int h, int w, const void* luts,
                            int gh, int gw, int th, int tw, void* stream) {
  Args a = args(x8, out, b, h, w);
  a.grid[0] = Grid{static_cast<const float*>(luts), gh, gw, th, tw};
  return launch<kSingle>(a, static_cast<cudaStream_t>(stream));
}

// As tt_apply_luts, image i taking the coarse grid where use_coarse[i] != 0
// (int32), else the fine grid.
TT_EXPORT int tt_apply_luts_dual(const void* x8, const void* use_coarse, void* out, int b, int h,
                                 int w, const void* luts_c, int gch, int gcw, int tch, int tcw,
                                 const void* luts_f, int gfh, int gfw, int tfh, int tfw,
                                 void* stream) {
  Args a = args(x8, out, b, h, w);
  a.use_coarse = static_cast<const int*>(use_coarse);
  a.grid[0] = Grid{static_cast<const float*>(luts_c), gch, gcw, tch, tcw};
  a.grid[1] = Grid{static_cast<const float*>(luts_f), gfh, gfw, tfh, tfw};
  return launch<kDual>(a, static_cast<cudaStream_t>(stream));
}

// The dual apply with the round trip's way back and the branch select, per
// image b with lo = min and span = max - min of its frame:
//   apply[b] and span > 0: eq = rint(blend) (half to even),
//     o = fma(eq, float32(span * float32(1/255)), lo) (XLA's reassociated
//     eq * (span / 255) and the fused + lo, as ops/clahe.py _from_8bit
//     computes it), out = floor(clamp(o, 0, 65535));
//   apply[b] and span <= 0 (a flat frame): out = floor(orig);
//   otherwise (an untouched frame): out = orig.
// x8, orig, out: (b, h, w) float32 (x8 the 8-bit bins, orig the frame on
// the uint16 scale); use_coarse, apply: (b,) int32; lo, span: (b,) float32;
// the grids as tt_apply_luts_dual takes them.
TT_EXPORT int tt_apply_luts_dual_fused(const void* x8, const void* orig, const void* use_coarse,
                                       const void* apply, const void* lo, const void* span,
                                       void* out, int b, int h, int w, const void* luts_c,
                                       int gch, int gcw, int tch, int tcw, const void* luts_f,
                                       int gfh, int gfw, int tfh, int tfw, void* stream) {
  Args a = args(x8, out, b, h, w);
  a.orig = static_cast<const float*>(orig);
  a.use_coarse = static_cast<const int*>(use_coarse);
  a.apply = static_cast<const int*>(apply);
  a.lo = static_cast<const float*>(lo);
  a.span = static_cast<const float*>(span);
  a.grid[0] = Grid{static_cast<const float*>(luts_c), gch, gcw, tch, tcw};
  a.grid[1] = Grid{static_cast<const float*>(luts_f), gfh, gfw, tfh, tfw};
  return launch<kDualFused>(a, static_cast<cudaStream_t>(stream));
}
