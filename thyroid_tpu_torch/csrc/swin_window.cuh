// Window-attention core shared by the Swin attention kernels' float32
// paths, all scalar f32 FMAs on shared memory (no tensor core):
// swin_attention.cu's training forward (kernel 5) and the first half of
// its serving half-block (kernel 4), swin_attention_bwd.cu's backward
// (kernel 6), which recomputes the softmax with exactly these
// instructions, so its P is bit-equal to the forward's, and
// window_attention.cu (kernel 8 in float32, and in bf16 at head widths
// that are not multiples of 16 or exceed 64) and swin_ln_attention.cu
// (kernel 7's float32 path), which fill Qs/Ks/Vs their own way and share
// scores_softmax and head_pv. The bf16 paths of kernels 4, 5, 6 and 7 run
// window_tc.cuh's TF32 tensor-core core instead, kernel 8's bf16 path at
// head widths 16-64 its own wgmma core (window_attention.cu).
//
// A block works on one ws x ws window of one image at a time. Window
// partition and reverse are index arithmetic: token t of the window lies at
// row `token(t)` of the (B*H*W) spatial grid the caller already rolled.
#pragma once

#include "common.cuh"

#include <cfloat>

namespace swin {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Window {
  int b, wi;      // image, window index inside the image (the mask's index)
  int wr, wc;     // window row and column
  int hh, ww, ws;

  __device__ __forceinline__ size_t token(int t) const {
    return (static_cast<size_t>(b) * hh + wr * ws + t / ws) * ww + wc * ws + t % ws;
  }
};

// Window `bw` of the flattened (B * nW) window list.
__device__ __forceinline__ Window window_of(int bw, int hh, int ww, int ws) {
  const int nww = ww / ws, nw = (hh / ws) * nww;
  Window w;
  w.b = bw / nw;
  w.wi = bw % nw;
  w.wr = w.wi / nww;
  w.wc = w.wi % nww;
  w.hh = hh;
  w.ww = ww;
  w.ws = ws;
  return w;
}

// S = Qs Ks^T + bias_h (+ mask_w) and P = softmax(S) row by row (a warp
// per row, max-shifted, exactly n <= 64 keys) into Ss (n x (n+1)), from
// Qs, Ks (n x (dh+1), q already scaled) that the block has filled and
// synchronised. bias_h is the head's (n, n) bias, mask_w the window's
// (n, n) mask or null. Ends with the block synchronised.
__device__ __forceinline__ void scores_softmax(const float* __restrict__ bias_h,
                                               const float* __restrict__ mask_w, int n,
                                               int dh, const float* Qs, const float* Ks,
                                               float* Ss) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n * n; i += kThreads) {
    const int r = i / n, j = i % n;
    float s = 0.f;
    for (int d = 0; d < dh; ++d) s = fmaf(Qs[r * (dh + 1) + d], Ks[j * (dh + 1) + d], s);
    s += bias_h[i];
    if (mask_w != nullptr) s += mask_w[i];
    Ss[r * (n + 1) + j] = s;
  }
  __syncthreads();

  for (int r = warp; r < n; r += kWarps) {
    float* sr = Ss + r * (n + 1);
    const bool has0 = lane < n, has1 = lane + 32 < n;
    const float v0 = has0 ? sr[lane] : -FLT_MAX;
    const float v1 = has1 ? sr[lane + 32] : -FLT_MAX;
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = has0 ? expf(v0 - m) : 0.f;
    const float e1 = has1 ? expf(v1 - m) : 0.f;
    const float sum = warp_sum(e0 + e1);
    if (has0) sr[lane] = e0 / sum;
    if (has1) sr[lane + 32] = e1 / sum;
  }
  __syncthreads();
}

// Head h of window w: gather q*scale and k into Qs, Ks (n x (dh+1)) and v
// into Vs (row stride vstride) as f32, then scores_softmax into Ss. qkv is
// (B, H, W, 3, C). Begins and ends with the block synchronised: the caller
// may overwrite Qs/Ks/Vs/Ss again only after its own __syncthreads().
template <typename T>
__device__ __forceinline__ void head_probs(const T* __restrict__ qkv,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ mask, const Window& w,
                                           int c, int h, int dh, float scale, float* Qs,
                                           float* Ks, float* Vs, int vstride, float* Ss) {
  const int n = w.ws * w.ws;
  for (int i = threadIdx.x; i < n * dh; i += kThreads) {
    const int t = i / dh, d = i % dh;
    const T* src = qkv + w.token(t) * 3 * c + h * dh + d;
    Qs[t * (dh + 1) + d] = to_f32(src[0]) * scale;
    Ks[t * (dh + 1) + d] = to_f32(src[c]);
    Vs[t * vstride + d] = to_f32(src[2 * c]);
  }
  __syncthreads();
  scores_softmax(bias + static_cast<size_t>(h) * n * n,
                 mask != nullptr ? mask + static_cast<size_t>(w.wi) * n * n : nullptr, n, dh,
                 Qs, Ks, Ss);
}

// O = P V for the head just computed by head_probs: store(r, d, o) for
// every row r < n and column d < dh. Ends with the block synchronised.
template <typename Store>
__device__ __forceinline__ void head_pv(const float* Ss, const float* Vs, int vstride, int n,
                                        int dh, Store store) {
  for (int i = threadIdx.x; i < n * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(Ss[r * (n + 1) + j], Vs[j * vstride + d], o);
    store(r, d, o);
  }
  __syncthreads();
}

}  // namespace swin
