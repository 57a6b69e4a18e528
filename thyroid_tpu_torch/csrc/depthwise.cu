// depthwise_conv2d_pallas: stride-1 k x k depthwise convolution, zero padding k / 2.
//
// Replaces the TPU kernel thyroid_tpu/ops/depthwise_pallas.py _dw_kernel
// (pallas_call in _dw_forward, reached through depthwise_conv2d_pallas).
//
// What it computes: x (B, H, W, C) in float32 or bfloat16, w (C, 1, k, k) in
// the same type, k in {3, 5, 7};
//   y[b, oy, ox, c] = sum over (iy, ix) in row-major tap order of
//                     x[b, oy + iy - k/2, ox + ix - k/2, c] * w[c, 0, iy, ix],
// taps outside the image reading zero, every product and sum a separately
// rounded float32 operation (__fmul_rn, __fadd_rn, never contracted into an
// FMA) with the first tap's product as the sum's start, as the TPU kernel's
// `acc = acc + term` and the plain PyTorch version do them, so the kernel is
// bit-equal to the plain version; y in x's type. Unlike the TPU kernel, the
// host neither pads the input nor tiles the weights into packed lanes.
//
// Bound on the H100: one read of x and one write of y (efficientnet_b0's 12
// stride-1 convs at batch 32 in bf16: about 232 MB, 0.07 ms at 3.35 TB/s);
// 2 k^2 float32 operations per output (about 1.8 GFLOP, 0.03 ms at
// 67 TFLOP/s, but 0.06 ms at one operation a lane and clock, since no
// multiply and add may fuse). A stencil: no tensor cores.
//
// Design. A CTA computes one TH x TW output tile of one image for one group
// of channels: CBW 4-byte words of a pixel, 2 bf16 channels or 1 float32
// channel a word, CBW <= 32 and a multiple of 4 (the groups split the
// pixel's words evenly: C = 144 in bf16 is 3 groups of 24 words).
// - The input tile and its halo, (TH + k - 1) x (TW + k - 1) pixels of
//   CBW words, come in as the tensor's own type through cp.async, every
//   piece in flight at once; a piece outside the image has src-size 0,
//   which fills zeros, so no element is tested against the image's edge.
//   Pieces are 16 bytes where C's row of bytes is a multiple of 16 (every
//   EfficientNet width), else 8 or 4 (C = 20, 36: the tests' ragged
//   widths); a bf16 C that is odd (a row of bytes not a multiple of 4)
//   takes 2-byte loads and stores, the one place without cp.async. The
//   choice is made from the shape on the host (piece_bytes).
// - Thread (word, y) keeps its word's channels' k^2 weights in registers
//   and walks strips of 7 output rows at one column (strip y, y + NY,
//   ...): each input row it reads (one 4-byte word per tap column from
//   shared memory) feeds up to k outputs of the strip, in tap order.
// - A CTA takes one tile, so there is nothing to double-buffer: several
//   CTAs share an SM (tiles keep to 48 KB of shared memory) and one's
//   copies overlap another's arithmetic.
// Tiles (plan): TH, TW in {7, 14, 28}, the least padding past the map,
// then the largest tile within 48 KB whose grid still fills two waves of
// 132 SMs (if none does, the largest grid), then the smaller halo, then
// the wider tile. At batch
// 32 in bf16 (efficientnet_b0's stride-1 shapes): 112^2 x 32 (k 3) 14 x 28
// tiles of 16 words, 1,024 CTAs; 56^2 x 144 (k 3) 14 x 28 of 24 words,
// 768; 28^2 x 240 (k 5) 14 x 14 of 32 words, 512; 14^2 x 480 (k 3, 5)
// 7 x 14 of 32 words, 512; 14^2 x 672 (k 5) 14 x 14, 352; 7^2 x 1152 (k 3,
// 5) 7 x 7, 576. NY = the strips spread evenly over at most 256 / CBW rows
// of threads (7 at 32 words: 224 threads).
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kStrip = 7;                 // output rows of a thread's strip
constexpr int kMaxThreads = 256;
constexpr int kMaxTileBytes = 48 * 1024;  // shared memory of a tile and its halo
constexpr int kSMs = 132;

struct Plan {
  int cbw, groups, th, tw, tiles_w, tiles, ny, pb, smem;
};

// Bytes of a copy piece: the largest of 16, 8, 4 that divides a pixel's
// row of bytes (a group starts at a multiple of 16 bytes), else 2.
int piece_bytes(int row_bytes) {
  for (int pb = 16; pb >= 4; pb /= 2)
    if (row_bytes % pb == 0) return pb;
  return 2;
}

Plan make_plan(int b, int h, int w, int c, int k, int es) {
  Plan p;
  const int words = (c * es + 3) / 4;
  p.groups = (words + 31) / 32;
  p.cbw = 4 * ((words + 4 * p.groups - 1) / (4 * p.groups));
  p.groups = (words + p.cbw - 1) / p.cbw;
  p.pb = piece_bytes(c * es);
  static const int kSides[3] = {28, 14, 7};
  long long best_pad = -1, best_ctas = 0;
  int best_area = 0, best_smem = 0;
  bool best_fills = false;
  p.th = p.tw = kStrip;
  for (int th : kSides)
    for (int tw : kSides) {
      const int smem = (th + k - 1) * (tw + k - 1) * p.cbw * 4;
      if (smem > kMaxTileBytes) continue;
      const long long tiles = static_cast<long long>((h + th - 1) / th) * ((w + tw - 1) / tw);
      const long long pad = tiles * th * tw, ctas = tiles * b * p.groups;
      const bool fills = ctas >= 2 * kSMs;
      const int area = th * tw;
      bool better;
      if (best_pad < 0 || pad != best_pad) {
        better = best_pad < 0 || pad < best_pad;
      } else if (fills != best_fills) {
        better = fills;
      } else if (!fills && ctas != best_ctas) {
        better = ctas > best_ctas;
      } else if (area != best_area) {
        better = area > best_area;
      } else if (smem != best_smem) {
        better = smem < best_smem;
      } else {
        better = tw > p.tw;
      }
      if (better) {
        best_pad = pad;
        best_ctas = ctas;
        best_area = area;
        best_smem = smem;
        best_fills = fills;
        p.th = th;
        p.tw = tw;
      }
    }
  p.tiles_w = (w + p.tw - 1) / p.tw;
  p.tiles = p.tiles_w * ((h + p.th - 1) / p.th);
  const int strips = p.tw * (p.th / kStrip);
  const int ny_max = kMaxThreads / p.cbw;
  const int rounds = (strips + ny_max - 1) / ny_max;
  p.ny = (strips + rounds - 1) / rounds;
  p.smem = (p.th + k - 1) * (p.tw + k - 1) * p.cbw * 4;
  return p;
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int pb, int bytes) {
  if (pb == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
                 : "memory");
  } else if (pb == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
                 : "memory");
  }
}

// The channels of a 4-byte word of shared memory, in float32.
template <typename T>
__device__ __forceinline__ void unpack(uint32_t word, float (&v)[4 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(word);
  } else {
    v[0] = __uint_as_float(word << 16);
    v[1] = __uint_as_float(word & 0xffff0000u);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int h,
                 int wd, int c, int cbw, int th, int tw, int tiles_w, int pb) {
  constexpr int P = K / 2, CH = 4 / sizeof(T);
  extern __shared__ __align__(16) unsigned char s_in[];
  const int iw = tw + K - 1, ih = th + K - 1, row_bytes = cbw * 4;
  const int oy0 = (blockIdx.x / tiles_w) * th, ox0 = (blockIdx.x % tiles_w) * tw;
  const int c0 = blockIdx.y * cbw * CH;  // the group's first channel
  const size_t image = static_cast<size_t>(blockIdx.z) * h * wd;
  const int tid = threadIdx.y * cbw + threadIdx.x, nthreads = cbw * blockDim.y;

  // the input tile and its halo: pixel (ly, lx) of the tile at
  // (ly * iw + lx) * row_bytes; zeros outside the image and past C
  const int live = min(row_bytes, (c - c0) * static_cast<int>(sizeof(T)));
  const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(s_in));
  if (pb >= 4) {
    const int per_pixel = row_bytes / pb;
    for (int i = tid; i < ih * iw * per_pixel; i += nthreads) {
      const int pix = i / per_pixel, off = (i % per_pixel) * pb;
      const int gy = oy0 - P + pix / iw, gx = ox0 - P + pix % iw;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd && off < live;
      const unsigned char* src =
          inside ? reinterpret_cast<const unsigned char*>(
                       x + (image + static_cast<size_t>(gy) * wd + gx) * c + c0) + off
                 : reinterpret_cast<const unsigned char*>(x);
      cp_async(s_base + pix * row_bytes + off, src, pb, inside ? pb : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {  // bf16, odd C: one channel a load
    T* s_el = reinterpret_cast<T*>(s_in);
    const int per_pixel = row_bytes / static_cast<int>(sizeof(T));
    for (int i = tid; i < ih * iw * per_pixel; i += nthreads) {
      const int pix = i / per_pixel, j = i % per_pixel;
      const int gy = oy0 - P + pix / iw, gx = ox0 - P + pix % iw;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd && c0 + j < c;
      s_el[i] = inside ? x[(image + static_cast<size_t>(gy) * wd + gx) * c + c0 + j]
                       : from_f32<T>(0.0f);
    }
  }

  // this word's channels' weights, while the copies land
  const int word = threadIdx.x;
  float wr[CH][K * K];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    const int ch = c0 + word * CH + e;
#pragma unroll
    for (int t = 0; t < K * K; ++t)
      wr[e][t] = ch < c ? to_f32(w[static_cast<size_t>(ch) * K * K + t]) : 0.0f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int strips = tw * (th / kStrip);
  for (int s = threadIdx.y; s < strips; s += blockDim.y) {
    const int lx = s % tw, ly0 = (s / tw) * kStrip;
    const int gx = ox0 + lx;
    if (gx >= wd || oy0 + ly0 >= h) continue;
    float acc[kStrip][CH];
    // input row ly0 + r feeds output row oy of the strip through tap row
    // iy = r - oy; r rises, so each output takes its taps in (iy, ix) order
#pragma unroll
    for (int r = 0; r < kStrip + K - 1; ++r) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          s_in + ((ly0 + r) * iw + lx) * row_bytes) + word;
      float v[K][CH];
#pragma unroll
      for (int ix = 0; ix < K; ++ix) unpack<T>(row[ix * cbw], v[ix]);
#pragma unroll
      for (int oy = 0; oy < kStrip; ++oy) {
        const int iy = r - oy;
        if (iy < 0 || iy >= K) continue;
#pragma unroll
        for (int ix = 0; ix < K; ++ix)
#pragma unroll
          for (int e = 0; e < CH; ++e) {
            const float term = __fmul_rn(v[ix][e], wr[e][iy * K + ix]);
            acc[oy][e] = (iy == 0 && ix == 0) ? term : __fadd_rn(acc[oy][e], term);
          }
      }
    }
    const int ch = c0 + word * CH;
#pragma unroll
    for (int oy = 0; oy < kStrip; ++oy) {
      const int gy = oy0 + ly0 + oy;
      if (gy >= h) break;
      T* dst = y + (image + static_cast<size_t>(gy) * wd + gx) * c + ch;
      if constexpr (CH == 2) {
        if (pb >= 4 && ch + 1 < c) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[oy][0], acc[oy][1]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < CH; ++e)
        if (ch + e < c) dst[e] = from_f32<T>(acc[oy][e]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int b, int h, int wd, int c, int k,
           cudaStream_t s) {
  const Plan p = make_plan(b, h, wd, c, k, static_cast<int>(sizeof(T)));
  const dim3 grid(p.tiles, p.groups, b), block(p.cbw, p.ny);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  switch (k) {
    case 3:
      depthwise_kernel<T, 3><<<grid, block, p.smem, s>>>(xp, wp, yp, h, wd, c, p.cbw, p.th, p.tw,
                                                          p.tiles_w, p.pb);
      break;
    case 5:
      depthwise_kernel<T, 5><<<grid, block, p.smem, s>>>(xp, wp, yp, h, wd, c, p.cbw, p.th, p.tw,
                                                          p.tiles_w, p.pb);
      break;
    case 7:
      depthwise_kernel<T, 7><<<grid, block, p.smem, s>>>(xp, wp, yp, h, wd, c, p.cbw, p.th, p.tw,
                                                          p.tiles_w, p.pb);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (b, h, w, c) contiguous; wt: (c, 1, k, k) contiguous, of x's type
// (bfloat16 when is_bf16, else float32); b <= 65535; x 16-byte aligned
// (PyTorch's allocations are), y 4-byte aligned.
TT_EXPORT int tt_depthwise_conv(const void* x, const void* wt, void* y, int b, int h, int w,
                                int c, int k, int is_bf16, void* stream) {
  if (b > 65535 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(y) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, wt, y, b, h, w, c, k, s)
                 : launch<float>(x, wt, y, b, h, w, c, k, s);
}
