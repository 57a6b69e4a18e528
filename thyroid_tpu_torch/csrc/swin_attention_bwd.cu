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
//                                                    to the forward's)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dP * P)),
//   dQ = scale * dS K,  dK = dS^T q_s,
// dqkv = [dQ | dK | dV] stored once, rounded to the compute type, into
// (B, H, W, 3C) at the window's own token rows (Window::token, index
// arithmetic) and the head's columns of each third, and
// dbias[head] = sum over batch and windows of dS, in f32.
//
// dbias: the TPU kernel accumulated it across a sequential grid. A GPU grid
// is not sequential, so each block keeps its own N x N sum per head in
// shared memory over a fixed, strided set of windows and writes it as a
// partial; dbias_reduce_kernel sums the partials of each head in a fixed
// order. No atomics: two runs are bit-equal, and the sum differs from a
// plain one only by the order of the f32 additions.
//
// Bound on the H100: per window 10*N^2*C operations on 7*N*C elements
// moved (read qkv and dO, write dqkv), so bound by operations at every
// Swin stage.
//
// bf16 (swin_attention_bwd_tc_kernel<DH>, the training path): TF32
// mma.sync (window_tc.cuh), f32 accumulation. A CTA is one warpgroup (M =
// 64 rows: the window's n <= 64 tokens and rows past n, computed and never
// stored) on one head group (64 / DH heads, two at Swin's DH = 32; two
// below DH = 32), walking windows x, x + gridDim.x, ... (grid
// (train_ctas, head groups), about 528 CTAs: swin_tiny at batch 32 stage 1
// 264 x 2 groups (a pair and a single), stage 2 176 x 3, stage 3 88 x 6,
// stage 4 32 x 12). Per window it copies the group's q | k | v | dO
// columns of the n token rows by cp.async (16-byte pieces) into a bf16
// staging of n8 = 8 ceil(n / 8) rows (rows past n stay zero) and the
// window's mask; the group's bias came in once. Per head:
// - S and P by window_tc.cuh's staged_probs, the very instructions of the
//   forward (kernel 5), so P is bit-equal to the forward's: q * scale in
//   f32, TF32 products, the bias and mask from shared memory, e^x as
//   __expf and one reciprocal a row (FAST, chosen for kernels 5 and 6
//   together: the exact expf and a division per key were most of kernel
//   4's softmax time where a shifted block's -100 mask makes e^x tiny);
// - dP = dO V^T with scores (dO in q's place, V in K's);
// - dS = P (dP - rowsum(dP P)) on the fragments (a row in one lane quad:
//   two shuffles), added into the head's dbias sum in shared memory by the
//   lane that owns each element;
// - dQ = scale dS K with pv (K in V's place), stored from the fragments;
// - P and dS to shared memory (n8 x 72 f32, rows past n zero); after a
//   barrier each warp takes 16 key rows: dV = P^T dO and dK = dS^T q_s with
//   tpv, P^T and dS^T the A operand read from there, dO and q_s the B.
// Shared memory at n = 49, DH = 32: staging 29,568 bytes, P and dS 32,256,
// bias 19,216, mask 9,616, dbias sums 19,216: 109,872, so two CTAs share
// an SM (launch bounds (128, 2)); ptxas gives the DH = 32 instantiation
// 159 registers a thread and no spill (118-159 over DH = 8-64, chip_smoke.py
// phase 1). Takes DH a multiple of 8 up to 64 and n <= 64; other bf16
// shapes are refused, never sent to the scalar kernel.
//
// float32 (the card-vs-CPU parity path) keeps the scalar kernel
// (swin_attention_bwd_kernel, swin_window.cuh's core, scalar f32
// FMAs): TF32 would not hold the float32 step's 1e-4 / 1e-3 checks. 256
// threads per block; the grid is (groups, heads) with about four blocks per
// SM in all, and block (g, h) walks windows g, g + groups, ... of head h.
// Per window, q_s, k, v and dO (N x head_dim each, row stride head_dim + 1)
// sit in shared memory as f32 beside P and dP/dS (N x (N + 1)) and the
// dbias sum (N x N): 55 KB at N = 49 and head_dim 32.
#include "swin_window.cuh"
#include "window_tc.cuh"

namespace {

using swin::kThreads;
using swin::kWarps;
constexpr int kTargetBlocks = 4 * 132;  // about four blocks on each of the H100's SMs

// Blocks along the window axis of the float32 grid.
inline int bwd_groups(int windows, int heads) {
  const int want = (kTargetBlocks + heads - 1) / heads;
  return windows < want ? (windows > 0 ? windows : 1) : want;
}

// Blocks along the window axis of either grid, for a head width dh.
inline int groups_of(int windows, int heads, int dh, bool bf16) {
  if (!bf16) return bwd_groups(windows, heads);
  const int hpg = dh > 0 && dh <= 64 ? wintc::train_heads(dh) : 1;
  const int ctas = wintc::train_ctas(windows, (heads + hpg - 1) / hpg);
  return ctas > 0 ? ctas : 1;
}

__host__ __device__ inline size_t bwd_smem_floats(int n, int dh) {
  return 4 * static_cast<size_t>(n) * (dh + 1) + 2 * static_cast<size_t>(n) * (n + 1) +
         static_cast<size_t>(n) * n;
}

__global__ void __launch_bounds__(kThreads)
swin_attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                          const float* __restrict__ bias, const float* __restrict__ mask,
                          float* __restrict__ dqkv, float* __restrict__ partial, int windows,
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
      dOs[t * ld + d] = dout[w.token(t) * c + h * dh + d];
    }
    // gathers q_s, k, v and leaves P in Ps; its first barrier covers dOs
    swin::head_probs<float>(qkv, bias, mask, w, c, h, dh, scale, Qs, Ks, Vs, ld, Ps);

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
      float* dst = dqkv + w.token(t) * 3 * c + h * dh + d;
      dst[0] = dq * scale;
      dst[c] = dk;
      dst[2 * c] = dv;
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

int reduce_dbias(const float* partial, float* dbias, int heads, int groups, int nn,
                 cudaStream_t s) {
  const int total = heads * nn;
  dbias_reduce_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, dbias, heads, groups, nn);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* qkv, const void* dout, const float* bias, const float* mask,
               void* dqkv, float* dbias, float* partial, int b, int hh, int ww, int c, int heads,
               int ws, float scale, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  const int windows = b * (hh / ws) * (ww / ws);
  const int groups = bwd_groups(windows, heads);
  const size_t smem = sizeof(float) * bwd_smem_floats(n, dh);
  cudaError_t err = cudaFuncSetAttribute(swin_attention_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_attention_bwd_kernel<<<dim3(groups, heads), kThreads, smem, s>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout), bias, mask,
      static_cast<float*>(dqkv), partial, windows, groups, hh, ww, c, ws, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce_dbias(partial, dbias, heads, groups, n * n, s);
}

// ---- bf16: TF32 mma.sync, a warpgroup per (window, head group) -------------

using bf16 = __nv_bfloat16;
constexpr int kLdP = 72;  // f32 row stride of P and dS in shared memory (72 % 32 == 8)

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) / 16 * 16; }

// Shared memory of a CTA, in bytes, by part: the staging (n8 rows of 4 G +
// 8 bf16: q | k | v | dO), P and dS (n8 x kLdP f32 each), the group's bias
// (HPG n x n f32), the window's mask (n x n f32), the dbias sums (HPG n x n
// f32).
struct TcSmem {
  size_t stage, pds, bias, mask, total;
  __host__ __device__ TcSmem(int n, int dh) {
    const int hpg = wintc::train_heads(dh), n8 = (n + 7) / 8 * 8;
    const size_t nn = static_cast<size_t>(n) * n;
    stage = align16(static_cast<size_t>(n8) * (4 * hpg * dh + 8) * 2);
    pds = 2 * static_cast<size_t>(n8) * kLdP * 4;
    bias = align16(hpg * nn * 4);
    mask = align16(nn * 4);
    total = stage + pds + 2 * bias + mask;
  }
};

template <int DH>
__global__ void __launch_bounds__(wintc::kTrainThreads, 2)
swin_attention_bwd_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                             const float* __restrict__ bias, const float* __restrict__ mask,
                             bf16* __restrict__ dqkv, float* __restrict__ partial, int windows,
                             int hh, int ww, int c, int heads, int ws, float scale) {
  constexpr int HPG = wintc::train_heads(DH), G = HPG * DH, LD = 4 * G + 8;
  constexpr int kT = wintc::kTrainThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ws * ws, n8 = (n + 7) / 8 * 8, nn = n * n;
  const int h0 = blockIdx.y * HPG, nh = min(HPG, heads - h0), col0 = h0 * DH;
  const TcSmem sm(n, DH);
  bf16* S = reinterpret_cast<bf16*>(smem_raw);
  float* Ps = reinterpret_cast<float*>(smem_raw + sm.stage);  // P, rows past n zero
  float* Ds = Ps + n8 * kLdP;                                 // dS, rows past n zero
  float* Bs = reinterpret_cast<float*>(smem_raw + sm.stage + sm.pds);
  float* Ms = Bs + sm.bias / 4;
  float* acc = Ms + sm.mask / 4;  // head j's dbias sum at acc + j nn
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;

  for (int i = tid; i < HPG * nn; i += kT) acc[i] = 0.f;
  for (int i = tid; i < (n8 - n) * LD; i += kT) S[n * LD + i] = __float2bfloat16_rn(0.f);
  for (int i = tid; i < nh * nn; i += kT)
    wintc::cp_async4(Bs + i, bias + static_cast<size_t>(h0) * nn + i);

  for (int bw = blockIdx.x; bw < windows; bw += gridDim.x) {
    const swin::Window w = swin::window_of(bw, hh, ww, ws);
    const int pieces = nh * DH / 8, per_row = 4 * pieces;
    for (int idx = tid; idx < n * per_row; idx += kT) {
      const int r = idx / per_row, sec = (idx % per_row) / pieces, p = idx % pieces;
      const bf16* src = sec < 3 ? qkv + w.token(r) * 3 * c + sec * c + col0 + 8 * p
                                : dout + w.token(r) * c + col0 + 8 * p;
      wintc::cp_async16(S + r * LD + sec * G + 8 * p, src);
    }
    if (mask != nullptr) {
      const float* src = mask + static_cast<size_t>(w.wi) * nn;
      for (int i = tid; i < nn; i += kT) wintc::cp_async4(Ms + i, src + i);
    }
    wintc::cp_async_commit();
    wintc::cp_async_wait_all();
    __syncthreads();  // the window's staging and mask have landed

#pragma unroll
    for (int j = 0; j < HPG; ++j) {
      if (j >= nh) break;
      const int qc = j * DH, kc0 = G + j * DH, vc = 2 * G + j * DH, oc = 3 * G + j * DH;
      float p[8][4], ds[8][4];
      wintc::staged_probs<DH, G>(S, LD, j, n, row0, scale, Bs + j * nn,
                                 mask != nullptr ? Ms : nullptr, p);
      {  // dP = dO V^T
        float dof[DH / 8][4];
#pragma unroll
        for (int kc = 0; kc < DH / 8; ++kc)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = row0 + g + 8 * i;
            float2 v = make_float2(0.f, 0.f);
            if (r < n) v = wintc::bf2_at(S + r * LD + oc + 8 * kc + 2 * t);
            dof[kc][2 * i] = v.x;
            dof[kc][2 * i + 1] = v.y;
          }
        wintc::scores<DH>(dof, [&](int key, int d) { return wintc::bf2_at(S + key * LD + vc + d); },
                          n, ds);
      }
      // dS = P (dP - rowsum(dP P)) in place; the dbias sum; P and dS to
      // shared memory for the transposed products
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + g + 8 * i;
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) rs = fmaf(ds[nt][2 * i + e], p[nt][2 * i + e], rs);
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 8 * nt + 2 * t + e;
            const float d = p[nt][2 * i + e] * (ds[nt][2 * i + e] - rs);
            ds[nt][2 * i + e] = d;
            if (r < n && key < n) acc[j * nn + r * n + key] += d;
          }
          if (r < n8) {
            const bool live = r < n;
            *reinterpret_cast<float2*>(Ps + r * kLdP + 8 * nt + 2 * t) =
                live ? make_float2(p[nt][2 * i], p[nt][2 * i + 1]) : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(Ds + r * kLdP + 8 * nt + 2 * t) =
                live ? make_float2(ds[nt][2 * i], ds[nt][2 * i + 1]) : make_float2(0.f, 0.f);
          }
        }
      }
      {  // dQ = scale dS K, at the query rows
        float dq[DH / 8][4];
        wintc::pv<DH>(ds, [&](int key, int d) { return __bfloat162float(S[key * LD + kc0 + d]); },
                      n, dq);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row0 + g + 8 * i;
          if (r >= n) continue;
          bf16* dst = dqkv + w.token(r) * 3 * c + col0 + qc + 2 * t;
#pragma unroll
          for (int dt = 0; dt < DH / 8; ++dt)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * dt) =
                __floats2bfloat162_rn(dq[dt][2 * i] * scale, dq[dt][2 * i + 1] * scale);
        }
      }
      __syncthreads();  // P and dS are complete
      {  // dV = P^T dO and dK = dS^T q_s, at the warp's 16 key rows
        float dv[DH / 8][4], dk[DH / 8][4];
        wintc::tpv<DH>(Ps, kLdP, row0,
                       [&](int i, int d) { return __bfloat162float(S[i * LD + oc + d]); }, n, dv);
        wintc::tpv<DH>(Ds, kLdP, row0,
                       [&](int i, int d) { return __bfloat162float(S[i * LD + qc + d]) * scale; },
                       n, dk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row0 + g + 8 * i;
          if (r >= n) continue;
          bf16* dst = dqkv + w.token(r) * 3 * c + col0 + qc + 2 * t;
#pragma unroll
          for (int dt = 0; dt < DH / 8; ++dt) {
            *reinterpret_cast<__nv_bfloat162*>(dst + c + 8 * dt) =
                __floats2bfloat162_rn(dk[dt][2 * i], dk[dt][2 * i + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dst + 2 * c + 8 * dt) =
                __floats2bfloat162_rn(dv[dt][2 * i], dv[dt][2 * i + 1]);
          }
        }
      }
      __syncthreads();  // every warp is done with P, dS (and, after the last head, the staging)
    }
  }

  // each sum was written by the lane that owns the element; the last
  // barrier of the loop orders those writes before these reads
  for (int i = tid; i < nh * nn; i += kT)
    partial[(static_cast<size_t>(h0 + i / nn) * gridDim.x + blockIdx.x) * nn + i % nn] = acc[i];
}

template <int DH>
int launch_tc(const void* qkv, const void* dout, const float* bias, const float* mask,
              void* dqkv, float* dbias, float* partial, int windows, int hh, int ww, int c,
              int heads, int ws, float scale, cudaStream_t s) {
  constexpr int HPG = wintc::train_heads(DH);
  const int n = ws * ws;
  const int smem = static_cast<int>(TcSmem(n, DH).total);
  cudaError_t err = cudaFuncSetAttribute(swin_attention_bwd_tc_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hgroups = (heads + HPG - 1) / HPG;
  const int groups = wintc::train_ctas(windows, hgroups);
  swin_attention_bwd_tc_kernel<DH><<<dim3(groups, hgroups), wintc::kTrainThreads, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), bias, mask,
      static_cast<bf16*>(dqkv), partial, windows, hh, ww, c, heads, ws, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce_dbias(partial, dbias, heads, groups, n * n, s);
}

int launch_bf16(const void* qkv, const void* dout, const float* bias, const float* mask,
                void* dqkv, float* dbias, float* partial, int b, int hh, int ww, int c,
                int heads, int ws, float scale, cudaStream_t s) {
  const int n = ws * ws, dh = c / heads;
  const auto misaligned = [](const void* p, uintptr_t m) {
    return (reinterpret_cast<uintptr_t>(p) & m) != 0;
  };
  if (n > 64 || dh % 8 != 0 || dh > 64 || dh == 0 || misaligned(qkv, 15) ||
      misaligned(dout, 15) || misaligned(dqkv, 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int windows = b * (hh / ws) * (ww / ws);
  const auto args = [&](auto launch) {
    return launch(qkv, dout, bias, mask, dqkv, dbias, partial, windows, hh, ww, c, heads, ws,
                  scale, s);
  };
  switch (dh / 8) {
    case 1: return args(launch_tc<8>);
    case 2: return args(launch_tc<16>);
    case 3: return args(launch_tc<24>);
    case 4: return args(launch_tc<32>);
    case 5: return args(launch_tc<40>);
    case 6: return args(launch_tc<48>);
    case 7: return args(launch_tc<56>);
    default: return args(launch_tc<64>);
  }
}

}  // namespace

// Blocks along the window axis of the grid for head width dh and the
// compute type: the wrapper sizes the dbias partials (heads x groups x N x
// N f32) with it.
TT_EXPORT int tt_swin_bwd_groups(int windows, int heads, int dh, int is_bf16) {
  return groups_of(windows, heads, dh, is_bf16 != 0);
}

TT_EXPORT int tt_swin_attention_bwd(const void* qkv, const void* dout, const void* bias,
                                    const void* mask, void* dqkv, void* dbias, void* partial,
                                    int b, int hh, int ww, int c, int heads, int ws,
                                    float scale, int is_bf16, void* stream) {
  const float* fbias = static_cast<const float*>(bias);
  const float* fmask = static_cast<const float*>(mask);
  float* fdbias = static_cast<float*>(dbias);
  float* fpart = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(qkv, dout, fbias, fmask, dqkv, fdbias, fpart, b, hh, ww, c,
                               heads, ws, scale, s)
                 : launch_f32(qkv, dout, fbias, fmask, dqkv, fdbias, fpart, b, hh, ww, c, heads,
                              ws, scale, s);
}
