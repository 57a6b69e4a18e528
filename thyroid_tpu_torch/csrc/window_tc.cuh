// Window-attention core on the tensor cores (TF32 mma.sync), for a warp's
// 16 query rows of one head and one window of n <= 64 keys: the bf16
// kernels of swin_ln_attention.cu (kernel 7) and swin_attention.cu (kernel
// 4, the serving half-block) use it; swin_window.cuh keeps the scalar core
// that kernel 4's float32 path and kernels 5, 6 and 8 share.
//
// Numbers: q (already scaled), k, v, the scores, the softmax and O stay in
// f32 as the JAX kernel and the plain version keep them; the two products
// S = q k^T and O = P v take their operands rounded to TF32 (cvt.rna, unit
// roundoff 2^-11) and accumulate in f32 (mma.sync.m16n8k8 .tf32). The bias
// and mask add and the softmax (max-shifted, e / sum e) run in f32 on the
// accumulator fragments: a row's 64 keys lie in one quad of lanes, 16 a
// lane, so the max and the sum take two shuffles. Keys at or past n take
// -inf before the max; rows at or past n are computed and never stored.
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
// loads free of shared-memory bank conflicts.
#pragma once

#include <math_constants.h>

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

// O (16 x DH, fragments o[dt]) of the warp's query rows row0 + g, row0 + g
// + 8 for one head: q[kc] the scaled q's accumulator fragments (columns 8 kc
// + 2t + e of the head), Ks / Vs the head's first column of K and V in
// shared memory (rows = keys, every row below 8 * ceil(n / 8) finite),
// side(r, j) the bias (+ mask) of row r and key j for r, j < n. FAST takes
// e^x as __expf (ex2.approx) and a row's 1 / sum once, in place of expf and
// a division per key (kernel 4; kernel 7 keeps the exact forms).
template <int DH, bool FAST = false, typename Side>
__device__ __forceinline__ void attend(const float (&q)[DH / 8][4], const float* Ks,
                                       const float* Vs, int n, int row0, Side side,
                                       float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DH / 8; ++kc) {
    const uint32_t a0 = tf32(q[kc][0]), a1 = tf32(q[kc][2]), a2 = tf32(q[kc][1]),
                   a3 = tf32(q[kc][3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (8 * nt >= n) break;
      const float2 kv = *reinterpret_cast<const float2*>(Ks + (8 * nt + g) * kLdK + 8 * kc + 2 * t);
      mma(s[nt], a0, a1, a2, a3, tf32(kv.x), tf32(kv.y));
    }
  }

  // bias (+ mask), -inf past n; the softmax of rows g (i = 0) and g + 8 (1)
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

#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    if (8 * kc >= n) break;
    const uint32_t a0 = tf32(s[kc][0]), a1 = tf32(s[kc][2]), a2 = tf32(s[kc][1]),
                   a3 = tf32(s[kc][3]);
    const float* v0 = Vs + (8 * kc + 2 * t) * kLdV + g;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
      mma(o[dt], a0, a1, a2, a3, tf32(v0[8 * dt]), tf32(v0[kLdV + 8 * dt]));
  }
}

}  // namespace wintc
