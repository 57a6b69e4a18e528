// Per-window multi-head attention on separate q, k, v.
//
// tt_window_attention replaces the TPU kernel thyroid_tpu/ops/attention.py
// _attention_kernel (pallas_call in fused_window_attention).
//
// What it computes, for q, k, v (BW, heads, N, D) in the compute type (f32
// or bf16), bias (heads, N, N) f32 and mask (nW, N, N) f32 or null, window
// b taking mask[b % nW]: for every window and head, in f32,
//   S = (q * scale) k^T + bias[head] (+ mask),  e = exp(S - max S),
//   P = e / sum(e),  O = P v,
// O stored in the compute type. The TPU kernel pads N to a multiple of 16
// with -1e9 on the pad keys; here every loop runs over exactly N keys, so
// no pad is needed.
//
// Bound on the H100: per window and head 4*N^2*D operations on 4*N*D
// elements moved (q, k, v read, O written) plus the bias and mask; at
// N = 49, D = 32 that is about 50 operations per byte in bf16, so the
// card's bandwidth bounds it. Design (simple first): one block of 256
// threads per (window, head). q, k, v (N x D) go into shared memory as f32
// (q already scaled); the scores, the softmax (a warp per row) and P v are
// swin_window.cuh's core, as in the Swin kernels. Scalar f32 FMAs;
// tensor-core tiles are later work.
#include "swin_window.cuh"

namespace {

using swin::kThreads;

size_t smem_bytes(int n, int d) {
  return sizeof(float) * (2 * static_cast<size_t>(n) * (d + 1) + static_cast<size_t>(n) * d +
                          static_cast<size_t>(n) * (n + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ out, int heads, int n,
                        int d, int nw, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // n x (d + 1)
  float* Ks = Qs + n * (d + 1);                    // n x (d + 1)
  float* Vs = Ks + n * (d + 1);                    // n x d
  float* Ss = Vs + n * d;                          // n x (n + 1)
  const int bh = blockIdx.x;                       // window * heads + head
  const int b = bh / heads, h = bh % heads;
  const size_t base = static_cast<size_t>(bh) * n * d;
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    const int t = i / d, j = i % d;
    Qs[t * (d + 1) + j] = to_f32(q[base + i]) * scale;
    Ks[t * (d + 1) + j] = to_f32(k[base + i]);
    Vs[i] = to_f32(v[base + i]);
  }
  __syncthreads();
  swin::scores_softmax(bias + static_cast<size_t>(h) * n * n,
                       mask != nullptr ? mask + static_cast<size_t>(b % nw) * n * n : nullptr,
                       n, d, Qs, Ks, Ss);
  swin::head_pv(Ss, Vs, d, n, d,
                [&](int r, int j, float o) { out[base + r * d + j] = from_f32<T>(o); });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, const float* mask,
           void* out, int bw, int heads, int n, int d, int nw, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(n, d);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_kernel<T><<<bw * heads, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(out), heads, n, d, nw, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (bw, heads, n, d) in the compute type; bias (heads, n, n)
// f32; mask (nw, n, n) f32 or null.
TT_EXPORT int tt_window_attention(const void* q, const void* k, const void* v, const void* bias,
                                  const void* mask, void* out, int bw, int heads, int n, int d,
                                  int nw, float scale, int is_bf16, void* stream) {
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, fbias, fmask, out, bw, heads, n, d, nw, scale,
                                         s)
                 : launch<float>(q, k, v, fbias, fmask, out, bw, heads, n, d, nw, scale, s);
}
