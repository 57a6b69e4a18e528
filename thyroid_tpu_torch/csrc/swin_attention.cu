// Swin window attention: the serving half-block and the training forward.
//
// tt_swin_block_attention replaces the TPU kernel
// thyroid_tpu/ops/attention.py _swin_proj_kernel (pallas_call in
// _fused_swin_fwd_call, public wrapper fused_swin_block_attention).
// tt_swin_attention replaces _swin_kernel (the same pallas_call without
// the projection; public wrapper fused_swin_attention, whose backward is
// swin_attention_bwd.cu).
//
// What they compute, for qkv (B, H, W, 3, C) in the compute type (f32 or
// bf16), in the frame the caller already rolled: for every ws x ws window
// and every head, in f32,
//   S = (q * scale) k^T + bias[head] (+ mask[window]),  P = softmax(S),
//   O = P v.
// The training forward stores O in the compute type at the window's own
// positions of (B, H, W, C). The serving half-block instead rounds O
// (N x C) to the compute type, forms Y = O Wp (f32 accumulation) + bp and
// stores out = residual + Y, with the residual stream (B, H, W, C) in the
// compute type. Window partition and reverse are index arithmetic, never a
// copy through global memory. bias is the relative-position bias already
// gathered to (heads, N, N) f32; mask is the (nW, N, N) f32 shift mask of
// 0 / -100, or null. The loops run over exactly N = ws*ws keys, no padding.
// The per-head core (gather, scores, softmax, P v) is swin_window.cuh.
//
// Bound on the H100: per window 4*N^2*C operations for attention (and
// 2*N*C^2 for the projection), on 4*N*C elements moved for the training
// forward (5*N*C with the projection). Design (simple first): one block of
// 256 threads per window. Per head, q/k/v (N x head_dim) are gathered into
// shared memory as f32, scores and softmax (a warp per row, max-shifted)
// stay in shared memory, and P v goes either straight to global memory
// (training forward) or into an N x C tile of the compute type in shared
// memory (75 KB at C = 768 in bf16, 150 KB in f32). The projection then
// streams Wp through shared memory in 32 x 128 tiles into register
// accumulators and adds bias and residual in its epilogue. Scalar f32
// FMAs; tensor-core tiles are later work.
#include "swin_window.cuh"

namespace {

using swin::kThreads;
constexpr int kPCols = 128; // projection column tile
constexpr int kPBK = 32;    // projection K chunk

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline size_t attn_work_bytes(int n, int dh) {
  const size_t attn = sizeof(float) * (2 * static_cast<size_t>(n) * (dh + 1) +
                                       static_cast<size_t>(n) * dh + static_cast<size_t>(n) * (n + 1));
  const size_t proj = sizeof(float) * kPBK * kPCols;
  return attn > proj ? attn : proj;
}

template <typename T>
size_t smem_bytes(int n, int c, int dh) {
  return align16(sizeof(T) * static_cast<size_t>(n) * c) + attn_work_bytes(n, dh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swin_block_attention_kernel(const T* __restrict__ qkv, const T* __restrict__ xres,
                            const T* __restrict__ wp, const float* __restrict__ bp,
                            const float* __restrict__ bias, const float* __restrict__ mask,
                            T* __restrict__ y, int hh, int ww, int c, int heads, int ws,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ws * ws, dh = c / heads;
  const swin::Window w = swin::window_of(blockIdx.x, hh, ww, ws);
  const int tid = threadIdx.x;

  T* Os = reinterpret_cast<T*>(smem_raw);
  float* work = reinterpret_cast<float*>(smem_raw + align16(sizeof(T) * static_cast<size_t>(n) * c));
  float* Qs = work;                 // n x (dh + 1)
  float* Ks = Qs + n * (dh + 1);    // n x (dh + 1)
  float* Vs = Ks + n * (dh + 1);    // n x dh
  float* Ss = Vs + n * dh;          // n x (n + 1)
  float* Wps = work;                // kPBK x kPCols, after the attention

  for (int h = 0; h < heads; ++h) {
    swin::head_probs<T>(qkv, bias, mask, w, c, h, dh, scale, Qs, Ks, Vs, dh, Ss);
    swin::head_pv(Ss, Vs, dh, n, dh,
                  [&](int r, int d, float o) { Os[r * c + h * dh + d] = from_f32<T>(o); });
  }

  // out-projection + bias + residual; rows ty + 8*i (n <= 64), columns 4*tx + e
  const int ty = tid / 32, tx = tid % 32;
  for (int n0 = 0; n0 < c; n0 += kPCols) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int k0 = 0; k0 < c; k0 += kPBK) {
      for (int i = tid; i < kPBK * kPCols; i += kThreads) {
        const int kk = i / kPCols, jj = i % kPCols;
        const int k = k0 + kk, col = n0 + jj;
        Wps[i] = (k < c && col < c) ? to_f32(wp[static_cast<size_t>(k) * c + col]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(kPBK, c - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(&Wps[kk * kPCols + tx * 4]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty + 8 * i;
          if (r < n) {
            const float a = to_f32(Os[r * c + k0 + kk]);
            acc[i][0] = fmaf(a, bv.x, acc[i][0]);
            acc[i][1] = fmaf(a, bv.y, acc[i][1]);
            acc[i][2] = fmaf(a, bv.z, acc[i][2]);
            acc[i][3] = fmaf(a, bv.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      if (r >= n) continue;
      const size_t base = w.token(r) * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + tx * 4 + e;
        if (col < c) y[base + col] = from_f32<T>(to_f32(xres[base + col]) + (acc[i][e] + bp[col]));
      }
    }
  }
}

template <typename T>
int launch(const void* qkv, const void* xres, const void* wp, const float* bp,
           const float* bias, const float* mask, void* y, int b, int hh, int ww, int c,
           int heads, int ws, float scale, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  const size_t smem = smem_bytes<T>(n, c, dh);
  cudaError_t err = cudaFuncSetAttribute(swin_block_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = b * (hh / ws) * (ww / ws);
  swin_block_attention_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(xres), static_cast<const T*>(wp), bp,
      bias, mask, static_cast<T*>(y), hh, ww, c, heads, ws, scale);
  return static_cast<int>(cudaGetLastError());
}

// Training forward: the same per-head core, O stored straight into
// (B, H, W, C) at the window's own positions.
template <typename T>
__global__ void __launch_bounds__(kThreads)
swin_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                      const float* __restrict__ mask, T* __restrict__ out, int hh, int ww,
                      int c, int heads, int ws, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ws * ws, dh = c / heads;
  const swin::Window w = swin::window_of(blockIdx.x, hh, ww, ws);
  float* Qs = reinterpret_cast<float*>(smem_raw);  // n x (dh + 1)
  float* Ks = Qs + n * (dh + 1);                   // n x (dh + 1)
  float* Vs = Ks + n * (dh + 1);                   // n x dh
  float* Ss = Vs + n * dh;                         // n x (n + 1)
  for (int h = 0; h < heads; ++h) {
    swin::head_probs<T>(qkv, bias, mask, w, c, h, dh, scale, Qs, Ks, Vs, dh, Ss);
    swin::head_pv(Ss, Vs, dh, n, dh, [&](int r, int d, float o) {
      out[w.token(r) * c + h * dh + d] = from_f32<T>(o);
    });
  }
}

template <typename T>
int launch_fwd(const void* qkv, const float* bias, const float* mask, void* out, int b,
               int hh, int ww, int c, int heads, int ws, float scale, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(n) * (dh + 1) +
                                       static_cast<size_t>(n) * dh +
                                       static_cast<size_t>(n) * (n + 1));
  cudaError_t err = cudaFuncSetAttribute(swin_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = b * (hh / ws) * (ww / ws);
  swin_attention_kernel<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(qkv), bias, mask, static_cast<T*>(out), hh, ww, c, heads, ws,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

TT_EXPORT int tt_swin_block_attention(const void* qkv, const void* xres, const void* wp,
                                      const void* bp, const void* bias, const void* mask,
                                      void* y, int b, int hh, int ww, int c, int heads, int ws,
                                      float scale, int is_bf16, void* stream) {
  const float* fbp = static_cast<const float*>(bp);
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(qkv, xres, wp, fbp, fbias, fmask, y, b, hh, ww, c,
                                         heads, ws, scale, s)
                 : launch<float>(qkv, xres, wp, fbp, fbias, fmask, y, b, hh, ww, c, heads, ws,
                                 scale, s);
}

TT_EXPORT int tt_swin_attention(const void* qkv, const void* bias, const void* mask, void* out,
                                int b, int hh, int ww, int c, int heads, int ws, float scale,
                                int is_bf16, void* stream) {
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(qkv, fbias, fmask, out, b, hh, ww, c, heads, ws,
                                             scale, s)
                 : launch_fwd<float>(qkv, fbias, fmask, out, b, hh, ww, c, heads, ws, scale, s);
}
