// Window-attention core on the tensor cores (TF32 mma.sync), for a warp's
// 16 query rows of one head and one window of n <= 64 keys. Its users, all
// in bf16: swin_ln_attention.cu (kernel 7) and swin_attention.cu's serving
// half-block (kernel 4) call attend; swin_attention.cu's training forward
// (kernel 5) and swin_attention_bwd.cu (kernel 6) call staged_probs, pv,
// scores and tpv on the bf16 staging of a work item. swin_window.cuh keeps
// the scalar core of the float32 paths of kernels 4, 5 and 6 and of kernel
// 8.
//
// Numbers: q (already scaled), k, v, the scores, the softmax and O stay in
// f32 as the JAX kernel and the plain version keep them; the products take
// their operands rounded to TF32 (cvt.rna, unit roundoff 2^-11; a bf16
// operand is exact in TF32) and accumulate in f32 (mma.sync.m16n8k8
// .tf32). The bias and mask add and the softmax (max-shifted, e / sum e)
// run in f32 on the accumulator fragments: a row's 64 keys lie in one quad
// of lanes, 16 a lane, so the max and the sum take two shuffles. Keys at
// or past n take -inf before the max; rows at or past n are computed and
// never stored. attend is probs (scores, then the softmax) followed by pv.
//
// Fragments (PTX m16n8k8, g = lane / 4, t = lane % 4): the accumulator of an
// 8-column tile holds (row g, columns 2t, 2t + 1) and (row g + 8, the same
// columns), which is also wgmma's accumulator layout for a warp's 16 rows.
// An A operand of k8 wants (row g, k = t) and (row g, k = t + 4): a product
// sums over k in any order, so k = t is taken as column 2t and k = t + 4 as
// column 2t + 1 of the tile, and the accumulators serve as A operands as
// they lie (a0 = d0, a1 = d2, a2 = d1, a3 = d3), for q in S = q k^T and for
// P in O = P v. The B operands follow the same order: K's row (key) g at
// columns 2t, 2t + 1 (one 8-byte load), V's rows 2t, 2t + 1 at column g.
// K and V rows are kLdK = 72 and kLdV = 68 floats apart, which keeps both
// loads free of shared-memory bank conflicts. tpv, the products that sum
// over query rows (dV = P^T dO, dK = dS^T q_s), reads its A operand as
// PTX lays it out, (row g or g + 8, k = t or t + 4), from a matrix in
// shared memory whose rows are the query rows.
#pragma once

#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace wintc {

constexpr int kLdK = 72;  // f32 row stride of K in shared memory
constexpr int kLdV = 68;  // f32 row stride of V in shared memory

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += A B for one m16n8k8 tile, A (16 x 8) and B (8 x 8) in TF32.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// S = A B^T for the warp's 16 rows: a[kc] the A rows' accumulator
// fragments (columns 8 kc + 2t + e), brow(j, d) the float2 of B's row j at
// columns d, d + 1 (d even, j < 8 * ceil(n / 8), finite); s[nt] for the
// 8-key tiles below n, zero past them. S = q k^T with B = K, and kernel
// 6's dP = dO V^T with A = dO and B = V.
template <int DH, typename BRow>
__device__ __forceinline__ void scores(const float (&a)[DH / 8][4], BRow brow, int n,
                                       float (&s)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DH / 8; ++kc) {
    const uint32_t a0 = tf32(a[kc][0]), a1 = tf32(a[kc][2]), a2 = tf32(a[kc][1]),
                   a3 = tf32(a[kc][3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (8 * nt >= n) break;
      const float2 kv = brow(8 * nt + g, 8 * kc + 2 * t);
      mma(s[nt], a0, a1, a2, a3, tf32(kv.x), tf32(kv.y));
    }
  }
}

// P = softmax(S + side) in place on scores' fragments s of the rows row0 +
// g, row0 + g + 8: side(r, j) the bias (+ mask) of row r and key j for r, j
// < n; keys at or past n end at 0. FAST takes e^x as __expf (ex2.approx)
// and a row's 1 / sum once, in place of expf and a division per key
// (kernels 4, 5 and 6; kernel 7 keeps the exact forms).
template <bool FAST, typename Side>
__device__ __forceinline__ void softmax(float (&s)[8][4], int n, int row0, Side side) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * nt + 2 * t + e;
        float v = s[nt][2 * i + e];
        if (j >= n) v = -CUDART_INF_F;
        else if (r < n) v += side(r, j);
        s[nt][2 * i + e] = v;
        m = fmaxf(m, v);
      }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ev = FAST ? __expf(s[nt][2 * i + e] - m) : expf(s[nt][2 * i + e] - m);
        s[nt][2 * i + e] = ev;
        sum += ev;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = FAST ? __frcp_rn(sum) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (FAST) s[nt][2 * i + e] *= inv;
        else s[nt][2 * i + e] /= sum;
      }
  }
}

// P (fragments p) of the warp's query rows row0 + g, row0 + g + 8 for one
// head: q[kc] the scaled q's accumulator fragments, krow(j, d) K's row j
// at columns d, d + 1 as in scores.
template <int DH, bool FAST, typename KRow, typename Side>
__device__ __forceinline__ void probs(const float (&q)[DH / 8][4], KRow krow, int n, int row0,
                                      Side side, float (&p)[8][4]) {
  scores<DH>(q, krow, n, p);
  softmax<FAST>(p, n, row0, side);
}

// O = P V (fragments o[dt], columns 8 dt + 2t + e) from probs' fragments
// p: vat(j, d) V's value at row (key) j, column d, for j < 8 * ceil(n / 8)
// (finite). Kernel 6's dQ = dS K with dS in p's place and K in V's.
template <int DH, typename VAt>
__device__ __forceinline__ void pv(const float (&p)[8][4], VAt vat, int n,
                                   float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    if (8 * kc >= n) break;
    const uint32_t a0 = tf32(p[kc][0]), a1 = tf32(p[kc][2]), a2 = tf32(p[kc][1]),
                   a3 = tf32(p[kc][3]);
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
      mma(o[dt], a0, a1, a2, a3, tf32(vat(8 * kc + 2 * t, 8 * dt + g)),
          tf32(vat(8 * kc + 2 * t + 1, 8 * dt + g)));
  }
}

// O (16 x DH, fragments o[dt]) of the warp's query rows row0 + g, row0 + g
// + 8 for one head: q[kc] the scaled q's accumulator fragments (columns 8 kc
// + 2t + e of the head), Ks / Vs the head's first column of K and V in
// shared memory (rows = keys, every row below 8 * ceil(n / 8) finite),
// side(r, j) the bias (+ mask) of row r and key j for r, j < n; FAST as in
// softmax (kernel 4; kernel 7 keeps the exact forms).
template <int DH, bool FAST = false, typename Side>
__device__ __forceinline__ void attend(const float (&q)[DH / 8][4], const float* Ks,
                                       const float* Vs, int n, int row0, Side side,
                                       float (&o)[DH / 8][4]) {
  float s[8][4];
  probs<DH, FAST>(
      q, [&](int j, int d) { return *reinterpret_cast<const float2*>(Ks + j * kLdK + d); }, n,
      row0, side, s);
  pv<DH>(s, [&](int j, int d) { return Vs[j * kLdV + d]; }, n, o);
}

// D = M^T B for the warp's 16 columns col0 + g, col0 + g + 8 of M (fragments
// d[dt], rows = those columns, columns 8 dt + 2t + e of B): M in shared
// memory with rows = the n query rows, pitch ld floats (ld % 32 == 8 keeps
// the loads free of bank conflicts), every row below 8 * ceil(n / 8) finite
// and zero at or past n; bat(i, d) B's value at query row i, column d.
// Kernel 6's dV = P^T dO and dK = dS^T q_s.
template <int DH, typename BAt>
__device__ __forceinline__ void tpv(const float* M, int ld, int col0, BAt bat, int n,
                                    float (&d)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[dt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    if (8 * kc >= n) break;
    const float* m0 = M + (8 * kc + t) * ld + col0 + g;
    const uint32_t a0 = tf32(m0[0]), a1 = tf32(m0[8]), a2 = tf32(m0[4 * ld]),
                   a3 = tf32(m0[4 * ld + 8]);
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
      mma(d[dt], a0, a1, a2, a3, tf32(bat(8 * kc + t, 8 * dt + g)),
          tf32(bat(8 * kc + t + 4, 8 * dt + g)));
  }
}

// ---- the training kernels' work items (kernels 5 and 6, bf16) ----------------

// Heads of a work item: 64 / DH (a 128-byte row piece of q, k, v and dO at
// Swin's DH = 32, one head at DH > 32), two below DH = 32, which keeps the
// per-CTA bias and dbias sums in shared memory at n = 64.
__host__ __device__ constexpr int train_heads(int dh) { return dh >= 32 ? 64 / dh : 2; }

constexpr int kTrainThreads = 128;     // a CTA: one warpgroup, M = 64 rows
constexpr int kTrainTarget = 4 * 132;  // CTAs of a launch: about four for each SM

// CTAs along the window axis of a (windows, head groups) training launch:
// CTA x walks windows x, x + ctas, ...
inline int train_ctas(int windows, int hgroups) {
  const int want = (kTrainTarget + hgroups - 1) / hgroups;
  return windows < want ? windows : want;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float2 bf2_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// P of head j of a staged work item for the warp's rows row0 + g, row0 + g
// + 8: S holds the item's n token rows (ld bf16 apart, rows n to 8 *
// ceil(n / 8) zero), q in columns [0, G) and k in [G, 2G), head j at j DH;
// q * scale in f32; bias_j and mask_w (or null) the head's and the window's
// n x n f32 in shared memory. Kernels 5 and 6 both take their P from here,
// with the same instructions, so the backward's P is the forward's bit for
// bit.
template <int DH, int G>
__device__ __forceinline__ void staged_probs(const __nv_bfloat16* S, int ld, int j, int n,
                                             int row0, float scale, const float* bias_j,
                                             const float* mask_w, float (&p)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float q[DH / 8][4];
#pragma unroll
  for (int kc = 0; kc < DH / 8; ++kc)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      float2 v = make_float2(0.f, 0.f);
      if (r < n) v = bf2_at(S + r * ld + j * DH + 8 * kc + 2 * t);
      q[kc][2 * i] = v.x * scale;
      q[kc][2 * i + 1] = v.y * scale;
    }
  probs<DH, true>(
      q, [&](int key, int d) { return bf2_at(S + key * ld + G + j * DH + d); }, n, row0,
      [&](int r, int key) {
        return bias_j[r * n + key] + (mask_w != nullptr ? mask_w[r * n + key] : 0.f);
      },
      p);
}

}  // namespace wintc
