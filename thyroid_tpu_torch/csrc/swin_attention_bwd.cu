// fused_swin_attention backward: Swin window attention's gradients.
//
// Replaces the TPU kernel thyroid_tpu/ops/attention.py _swin_bwd_kernel
// (pallas_call in _swin_bwd_call, paired with the forward _swin_kernel by
// the custom_vjp of fused_swin_attention).
//
// What it computes, for qkv (B, H, W, 3, C) and the output gradient dO
// (B, H, W, C), both in the compute type (f32 or bf16), bias (heads, N, N)
// f32 and the (nW, N, N) f32 shift mask or null: for every window and head,
// in f32, with q_s = q * scale,
//   S = q_s k^T + bias (+ mask), P = softmax(S)    (recomputed, bit-equal
//                                                    to the forward: the
//                                                    core of swin_window.cuh)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dP * P)),
//   dQ = scale * dS K,  dK = dS^T q_s,
// dqkv = [dQ | dK | dV] stored in the compute type into (B, H, W, 3C) at the
// window's own positions and the head's columns of each third, and
// dbias[head] = sum over batch and windows of dS, in f32.
//
// dbias: the TPU kernel accumulated it across a sequential grid. A GPU grid
// is not sequential, so each block keeps its own N x N sum in shared memory
// over a fixed, strided set of windows of one head and writes it as a
// partial; a second kernel of this file sums the partials of each head in
// a fixed order. The result is deterministic (no atomics), and differs from
// a plain sum only by the order of the f32 additions.
//
// Bound on the H100: per window 10*N^2*C operations on 7*N*C elements
// moved (read qkv and dO, write dqkv), so bound by operations at every
// Swin stage. Design (simple first): 256 threads per block; the grid is
// (groups, heads) with about four blocks per SM in all, and block (g, h)
// walks windows g, g + groups, ... of head h. Per window, q_s, k, v and dO
// (N x head_dim each, row stride head_dim + 1) sit in shared memory as f32
// beside P and dP/dS (N x (N + 1)) and the dbias sum (N x N): 55 KB at
// N = 49 and head_dim 32. Scalar f32 FMAs; tensor-core tiles are later
// work.
#include "swin_window.cuh"

namespace {

using swin::kThreads;
using swin::kWarps;
constexpr int kTargetBlocks = 4 * 132;  // about four blocks on each of the H100's SMs

// Blocks along the window axis of the grid.
inline int bwd_groups(int windows, int heads) {
  const int want = (kTargetBlocks + heads - 1) / heads;
  return windows < want ? (windows > 0 ? windows : 1) : want;
}

__host__ __device__ inline size_t bwd_smem_floats(int n, int dh) {
  return 4 * static_cast<size_t>(n) * (dh + 1) + 2 * static_cast<size_t>(n) * (n + 1) +
         static_cast<size_t>(n) * n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swin_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                          const float* __restrict__ bias, const float* __restrict__ mask,
                          T* __restrict__ dqkv, float* __restrict__ partial, int windows,
                          int groups, int hh, int ww, int c, int ws, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ws * ws, h = blockIdx.y, g = blockIdx.x;
  const int dh = c / gridDim.y;
  const int ld = dh + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Qs = reinterpret_cast<float*>(smem_raw);  // n x ld, q * scale
  float* Ks = Qs + n * ld;                         // n x ld
  float* Vs = Ks + n * ld;                         // n x ld
  float* dOs = Vs + n * ld;                        // n x ld
  float* Ps = dOs + n * ld;                        // n x (n + 1)
  float* dSs = Ps + n * (n + 1);                   // n x (n + 1): dP, then dS
  float* acc = dSs + n * (n + 1);                  // n x n, this block's dbias sum

  for (int i = tid; i < n * n; i += kThreads) acc[i] = 0.f;

  for (int bw = g; bw < windows; bw += groups) {
    const swin::Window w = swin::window_of(bw, hh, ww, ws);
    for (int i = tid; i < n * dh; i += kThreads) {
      const int t = i / dh, d = i % dh;
      dOs[t * ld + d] = to_f32(dout[w.token(t) * c + h * dh + d]);
    }
    // gathers q_s, k, v and leaves P in Ps; its first barrier covers dOs
    swin::head_probs<T>(qkv, bias, mask, w, c, h, dh, scale, Qs, Ks, Vs, ld, Ps);

    for (int i = tid; i < n * n; i += kThreads) {  // dP = dO V^T
      const int r = i / n, j = i % n;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(dOs[r * ld + d], Vs[j * ld + d], s);
      dSs[r * (n + 1) + j] = s;
    }
    __syncthreads();

    for (int r = warp; r < n; r += kWarps) {  // dS = P (dP - rowsum(dP P)); dbias
      float* pr = Ps + r * (n + 1);
      float* sr = dSs + r * (n + 1);
      const bool has0 = lane < n, has1 = lane + 32 < n;
      const float p0 = has0 ? pr[lane] : 0.f, p1 = has1 ? pr[lane + 32] : 0.f;
      const float d0 = has0 ? sr[lane] : 0.f, d1 = has1 ? sr[lane + 32] : 0.f;
      const float rs = warp_sum(fmaf(d0, p0, d1 * p1));
      if (has0) {
        const float ds = p0 * (d0 - rs);
        sr[lane] = ds;
        acc[r * n + lane] += ds;
      }
      if (has1) {
        const float ds = p1 * (d1 - rs);
        sr[lane + 32] = ds;
        acc[r * n + lane + 32] += ds;
      }
    }
    __syncthreads();

    for (int i = tid; i < n * dh; i += kThreads) {
      const int t = i / dh, d = i % dh;
      float dq = 0.f, dk = 0.f, dv = 0.f;
      for (int j = 0; j < n; ++j) {
        dq = fmaf(dSs[t * (n + 1) + j], Ks[j * ld + d], dq);  // dS K
        dk = fmaf(dSs[j * (n + 1) + t], Qs[j * ld + d], dk);  // dS^T q_s
        dv = fmaf(Ps[j * (n + 1) + t], dOs[j * ld + d], dv);  // P^T dO
      }
      T* dst = dqkv + w.token(t) * 3 * c + h * dh + d;
      dst[0] = from_f32<T>(dq * scale);
      dst[c] = from_f32<T>(dk);
      dst[2 * c] = from_f32<T>(dv);
    }
    __syncthreads();
  }

  float* out = partial + (static_cast<size_t>(h) * groups + g) * n * n;
  for (int i = tid; i < n * n; i += kThreads) out[i] = acc[i];
}

// dbias[h, e] = sum over g < groups, in order, of partial[h, g, e].
__global__ void __launch_bounds__(kThreads)
dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dbias, int heads,
                    int groups, int nn) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= heads * nn) return;
  const int h = i / nn, e = i % nn;
  const float* src = partial + static_cast<size_t>(h) * groups * nn + e;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += src[static_cast<size_t>(g) * nn];
  dbias[i] = s;
}

template <typename T>
int launch(const void* qkv, const void* dout, const float* bias, const float* mask,
           void* dqkv, float* dbias, float* partial, int b, int hh, int ww, int c, int heads,
           int ws, float scale, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  const int windows = b * (hh / ws) * (ww / ws);
  const int groups = bwd_groups(windows, heads);
  const size_t smem = sizeof(float) * bwd_smem_floats(n, dh);
  cudaError_t err = cudaFuncSetAttribute(swin_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_attention_bwd_kernel<T><<<dim3(groups, heads), kThreads, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), bias, mask,
      static_cast<T*>(dqkv), partial, windows, groups, hh, ww, c, ws, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = heads * n * n;
  dbias_reduce_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, dbias, heads, groups, n * n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks along the window axis of the grid: the wrapper sizes the dbias
// partials (heads x groups x N x N f32) with it.
TT_EXPORT int tt_swin_bwd_groups(int windows, int heads) { return bwd_groups(windows, heads); }

TT_EXPORT int tt_swin_attention_bwd(const void* qkv, const void* dout, const void* bias,
                                    const void* mask, void* dqkv, void* dbias, void* partial,
                                    int b, int hh, int ww, int c, int heads, int ws,
                                    float scale, int is_bf16, void* stream) {
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  float* fdbias = static_cast<float*>(dbias);
  float* fpart = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(qkv, dout, fbias, fmask, dqkv, fdbias, fpart, b, hh,
                                         ww, c, heads, ws, scale, s)
                 : launch<float>(qkv, dout, fbias, fmask, dqkv, fdbias, fpart, b, hh, ww, c,
                                 heads, ws, scale, s);
}
