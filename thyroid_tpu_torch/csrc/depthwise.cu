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
// rounded float32 operation (__fmul_rn, __fadd_rn) as the TPU kernel's
// `acc = acc + term` and the plain PyTorch version do them, so the kernel is
// bit-equal to the plain version; y in x's type. Unlike the TPU kernel, the
// host neither pads the input nor tiles the weights into packed lanes.
//
// Bound on the H100: one read of x and one write of y (efficientnet_b0's 12
// stride-1 convs at batch 32 in bf16: about 232 MB, 0.07 ms at 3.35 TB/s);
// 2 k^2 float32 operations per output (about 1.8 GFLOP, 0.03 ms at
// 67 TFLOP/s). Design: one block of 32 x 8 threads per (image, 8 x 16 output
// tile, 32 channels); channels are innermost in memory and in threadIdx.x, so
// the loads of the input tile and its halo into shared memory, and the stores,
// are coalesced; each thread keeps its channel's k^2 weights in registers and
// computes two output columns of 8 rows, sliding down the tile's input rows so
// that each value read from shared memory feeds up to k outputs.
// Left for a later PR: 16-byte loads of bf16 channel quads, and a finer grid
// for the 7 x 7 maps (a tile covers 49 of its 128 outputs there).
#include "common.cuh"

namespace {

constexpr int kTileC = 32;                           // channels per block (threadIdx.x)
constexpr int kThreadsY = 8;                         // threadIdx.y
constexpr int kThreads = kTileC * kThreadsY;
constexpr int kTileH = 8;                            // output rows per block
constexpr int kColsPerThread = 2;
constexpr int kTileW = kThreadsY * kColsPerThread;   // output columns per block

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                 int h, int wd, int c, int tiles_w) {
  constexpr int P = K / 2;
  constexpr int kInH = kTileH + K - 1, kInW = kTileW + K - 1;
  __shared__ float s_in[kInH * kInW][kTileC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.y * kTileC + tx;
  const bool live = ch < c;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  const size_t image = static_cast<size_t>(blockIdx.z) * h * wd;

  // s_in[ly * kInW + lx][tx] = x at (oy0 - P + ly, ox0 - P + lx, ch), zero outside
  for (int i = ty; i < kInH * kInW; i += kThreadsY) {
    const int gy = oy0 - P + i / kInW, gx = ox0 - P + i % kInW;
    float v = 0.0f;
    if (live && gy >= 0 && gy < h && gx >= 0 && gx < wd)
      v = to_f32(x[(image + static_cast<size_t>(gy) * wd + gx) * c + ch]);
    s_in[i][tx] = v;
  }
  float wr[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wr[t] = live ? to_f32(w[static_cast<size_t>(ch) * K * K + t]) : 0.0f;
  __syncthreads();
  if (!live) return;

#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int lx = ty + j * kThreadsY;               // output column in the tile
    if (ox0 + lx >= wd) continue;
    float acc[kTileH];
#pragma unroll
    for (int oy = 0; oy < kTileH; ++oy) acc[oy] = 0.0f;
    // input row r of the tile feeds output row oy through tap row iy = r - oy;
    // r rises, so each output takes its taps in (iy, ix) order
#pragma unroll
    for (int r = 0; r < kInH; ++r) {
      float v[K];
#pragma unroll
      for (int ix = 0; ix < K; ++ix) v[ix] = s_in[r * kInW + lx + ix][tx];
#pragma unroll
      for (int oy = 0; oy < kTileH; ++oy) {
        const int iy = r - oy;
        if (iy < 0 || iy >= K) continue;
#pragma unroll
        for (int ix = 0; ix < K; ++ix) {
          const float term = __fmul_rn(v[ix], wr[iy * K + ix]);
          acc[oy] = (iy == 0 && ix == 0) ? term : __fadd_rn(acc[oy], term);
        }
      }
    }
#pragma unroll
    for (int oy = 0; oy < kTileH; ++oy) {
      const int gy = oy0 + oy;
      if (gy < h)
        y[(image + static_cast<size_t>(gy) * wd + ox0 + lx) * c + ch] = from_f32<T>(acc[oy]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int b, int h, int wd, int c, int k,
           cudaStream_t s) {
  const int tiles_w = (wd + kTileW - 1) / kTileW;
  const dim3 grid(tiles_w * ((h + kTileH - 1) / kTileH), (c + kTileC - 1) / kTileC, b);
  const dim3 block(kTileC, kThreadsY);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  switch (k) {
    case 3: depthwise_kernel<T, 3><<<grid, block, 0, s>>>(xp, wp, yp, h, wd, c, tiles_w); break;
    case 5: depthwise_kernel<T, 5><<<grid, block, 0, s>>>(xp, wp, yp, h, wd, c, tiles_w); break;
    case 7: depthwise_kernel<T, 7><<<grid, block, 0, s>>>(xp, wp, yp, h, wd, c, tiles_w); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (b, h, w, c) contiguous; wt: (c, 1, k, k) contiguous, of x's type
// (bfloat16 when is_bf16, else float32); b <= 65535.
TT_EXPORT int tt_depthwise_conv(const void* x, const void* wt, void* y, int b, int h, int w,
                                int c, int k, int is_bf16, void* stream) {
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, wt, y, b, h, w, c, k, s)
                 : launch<float>(x, wt, y, b, h, w, c, k, s);
}
