// The s8 tensor-core products on split-halves packed int4 bytes that the
// int4 decode MoE (moe_stream_q4.cu) and the fused int4 RF sampler
// (rf_sampler_q4.cu) share, the same step on int8 bytes (the fused int8 RF
// sampler, rf_sampler_q8.cu, and the int8 decode MoE, moe_stream_q8.cu), the
// exact step on the bf16 tensor cores from the same packed int4 words (the int4
// decode MoE's exact mode), the exact s8 step on both nibble planes of those
// words converted to s8 weights (the per-step stack's exact int4 body on the
// int8 sampler's digit dots), and the steps of their activations' s8 (pair)
// quantization (ops/kernels/intdot.py quant_rows_s8_pair, quant_rows_s8),
// each rounded as the plain versions round it.
//
// A k32 step of one warp: the weights are A (16 output columns a m16 tile,
// two tiles a warp: 32 columns), the activation rows B (8 a n-tile). sm_90 has
// no 8-bit ldmatrix .trans and the tables are column-contiguous, so each lane
// forms its A fragments in registers: it reads one word (4 columns) from each
// of 4 contraction rows per 16-row half of the step and byte-transposes them
// into a register per column, holding 4 contraction-consecutive bytes of one
// column. Which physical rows a lane's words come from is the caller's choice
// (its stage layout), as long as B holds the activations in the same order.
#pragma once

#include "common.cuh"

// d (16x8 s32) += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp's two integer dots of one k32 step. Lane (g = lane / 4, t = lane %
// 4): w[hf][r] is the word of its 4 columns 4g .. 4g + 3 at the step's
// contraction row 16 hf + 4t + r; b1 / b2 the B fragments of the s8 pair a1
// (x_lo - x_hi / 16) and a2 (x_hi) for those rows. The low nibble b & 15 meets
// a1, b ^ 0x80 read as s8 meets a2. m16 tile p takes columns 4g + 2p (its row
// g) and 4g + 2p + 1 (row g + 8): accumulator element i of d[p][nt] is column
// 4g + 2p + i / 2, activation row nt * 8 + 2t + i % 2.
template <int NT>
__device__ __forceinline__ void q4_k32(const uint32_t (&w)[2][4], const uint32_t (&b1)[NT][2],
                                       const uint32_t (&b2)[NT][2], int (&d1)[2][NT][4], int (&d2)[2][NT][4]) {
  uint32_t cols[2][4];  // [contraction half][column 4g + c]
  transpose4x4(w[0], cols[0]);
  transpose4x4(w[1], cols[1]);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t lo[4] = {(uint32_t)nib_lo(cols[0][2 * p]), (uint32_t)nib_lo(cols[0][2 * p + 1]),
                            (uint32_t)nib_lo(cols[1][2 * p]), (uint32_t)nib_lo(cols[1][2 * p + 1])};
    const uint32_t hi[4] = {(uint32_t)nib_x80(cols[0][2 * p]), (uint32_t)nib_x80(cols[0][2 * p + 1]),
                            (uint32_t)nib_x80(cols[1][2 * p]), (uint32_t)nib_x80(cols[1][2 * p + 1])};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_s8(d1[p][nt], lo, b1[nt]);
      mma_s8(d2[p][nt], hi, b2[nt]);
    }
  }
}

// The warp's integer dot of one k32 step on int8 weight bytes, laid out as for
// q4_k32: the transposed bytes themselves are A; b holds the B fragments of NT
// n-tiles of s8 activations for the lane's contraction rows; d[p][nt] as
// q4_k32's d1.
template <int NT>
__device__ __forceinline__ void s8_k32(const uint32_t (&w)[2][4], const uint32_t (&b)[NT][2], int (&d)[2][NT][4]) {
  uint32_t cols[2][4];  // [contraction half][column 4g + c]
  transpose4x4(w[0], cols[0]);
  transpose4x4(w[1], cols[1]);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t a[4] = {cols[0][2 * p], cols[0][2 * p + 1], cols[1][2 * p], cols[1][2 * p + 1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_s8(d[p][nt], a, b[nt]);
  }
}

// The nibbles at bits 0..3 of each byte of v (0..15, offset-binary) as the s8 bytes of their weights n - 8: bit 7
// set first, so that subtracting 8 borrows from no neighbour, then flipped back.
__device__ __forceinline__ uint32_t plane_s8(uint32_t v) {
  return (((v & 0x0F0F0F0Fu) | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// The warp's exact integer dot of one k32 step on split-halves packed int4 bytes, laid out as for s8_k32: each
// byte's low nibble as the s8 weight (b & 15) - 8 of the low plane meets blo, its high nibble (b >> 4) - 8 of the
// high plane meets bhi, both into the same sums d[p][nt] (one exact sum over both planes).
template <int NT>
__device__ __forceinline__ void q4x_k32(const uint32_t (&w)[2][4], const uint32_t (&blo)[NT][2],
                                        const uint32_t (&bhi)[NT][2], int (&d)[2][NT][4]) {
  uint32_t cols[2][4];  // [contraction half][column 4g + c]
  transpose4x4(w[0], cols[0]);
  transpose4x4(w[1], cols[1]);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t c[4] = {cols[0][2 * p], cols[0][2 * p + 1], cols[1][2 * p], cols[1][2 * p + 1]};
    const uint32_t lo[4] = {plane_s8(c[0]), plane_s8(c[1]), plane_s8(c[2]), plane_s8(c[3])};
    const uint32_t hi[4] = {plane_s8(c[0] >> 4), plane_s8(c[1] >> 4), plane_s8(c[2] >> 4), plane_s8(c[3] >> 4)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_s8(d[p][nt], lo, blo[nt]);
      mma_s8(d[p][nt], hi, bhi[nt]);
    }
  }
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16_f32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two nibbles of v (bits shift .. shift + 3 of its bytes 0 and 2, 0..15 offset-binary) as the bf16 pair of their
// weights -8..7, exactly: 0x4300 | n is the bf16 128 + n, and 128 + n - 136 is exact.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v, int shift) {
  const uint32_t n = ((v >> shift) & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(n), "r"(0x3F803F80u), "r"(0xC308C308u));  // n * 1 - 136
  return r;
}

// The warp's exact dots of one 32-packed-row step on split-halves packed int4 bytes, on the bf16 tensor cores
// (mma.sync m16n8k16, fp32 sums). Lane (g, t): w[hf][r] as for q4_k32 (the word of its 4 columns 4g .. 4g + 3 at
// the step's packed row 16 hf + 4t + r). Each byte's low nibble is the weight at that contraction row of the low
// plane, its high nibble the high plane's; k16 step (hf, plane) pairs the lane's rows 16 hf + 4t + (0, 1) as
// k = 2t, 2t + 1 and (2, 3) as k = 2t + 8, 2t + 9, so b[nt][hf][q] is the B fragment of n-tile nt: the rows'
// four bf16 values at those contraction rows of plane q (8 contiguous bytes of a bf16 row). d[q][p][nt]: plane
// q's sums, element i column 4g + 2p + i / 2, row nt * 8 + 2t + i % 2 (as q4_k32).
template <int NT>
__device__ __forceinline__ void q4_bf16_k32(const uint32_t (&w)[2][4], const uint2 (&b)[NT][2][2],
                                            float (&d)[2][2][NT][4]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      // bytes 0 and 2 of v: column 4g + 2p (s0) or 4g + 2p + 1 (s1) at rows (0, 1), then (2, 3)
      const unsigned s0 = p ? 0x6622u : 0x4400u, s1 = p ? 0x7733u : 0x5511u;
      const uint32_t v[4] = {__byte_perm(w[hf][0], w[hf][1], s0), __byte_perm(w[hf][0], w[hf][1], s1),
                             __byte_perm(w[hf][2], w[hf][3], s0), __byte_perm(w[hf][2], w[hf][3], s1)};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t a[4] = {nibbles_bf16x2(v[0], 4 * q), nibbles_bf16x2(v[1], 4 * q), nibbles_bf16x2(v[2], 4 * q),
                               nibbles_bf16x2(v[3], 4 * q)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16_f32(d[q][p][nt], a, b[nt][hf][q].x, b[nt][hf][q].y);
      }
    }
}

// The steps of intdot.quant_rows_s8_pair (and of quant_rows_s8: pair_scale, pair_q), each rounded as the plain version rounds it.
__device__ __forceinline__ float pair_c1(float lo, float hi) { return __fsub_rn(lo, __fmul_rn(hi, 0.0625f)); }
__device__ __forceinline__ float pair_scale(float mx) { return __fadd_rn(__fdiv_rn(mx, 127.0f), 1e-12f); }
__device__ __forceinline__ int pair_q(float v, float sc) { return (int)rintf(__fdiv_rn(v, sc)); }
// pair_q of N values from rc = __frcp_rn(sc) as well, for |v / sc| <= 127 (v from the row whose maximum set sc):
// v * rc lies within 2.3e-5 of the rounded quotient, so the two round to one integer wherever v * rc is 1e-4 or
// more from a half; nearer one (rarely), the division decides. The products are formed without a branch, so the
// N chains run side by side, and rounded to integers by adding 1.5 * 2^23 (round half to even, exact for |t| <
// 2^22) on the full-rate adders instead of the conversion unit.
template <int N>
__device__ __forceinline__ void pair_q_rc(const float (&v)[N], float sc, float rc, int (&q)[N]) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23: its bits are 0x4B400000
  bool near = false;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float t = __fmul_rn(v[e], rc), m = __fadd_rn(t, kMagic), f = __fsub_rn(m, kMagic);
    q[e] = __float_as_int(m) - 0x4B400000;
    near |= fabsf(fabsf(__fsub_rn(t, f)) - 0.5f) < 1e-4f;
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < N; ++e) q[e] = pair_q(v[e], sc);
  }
}
__device__ __forceinline__ float pair_corr(int s1, int s2, float sa1, float sa2) {
  return __fmul_rn(8.0f, __fadd_rn(__fmul_rn((float)s1, sa1), __fmul_rn((float)s2, __fmul_rn(sa2, 0.0625f))));
}
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xFF) | (uint32_t)(b & 0xFF) << 8 | (uint32_t)(c & 0xFF) << 16 | (uint32_t)(d & 0xFF) << 24;
}
