// Shared helpers for the hand-written Hopper kernels of mingunivision_tpu_torch.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() so that a
// refused launch (too many threads, too much shared memory) is reported to the
// Python wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ float silu_f32(float v) { return v / (1.0f + __expf(-v)); }

// silu with each step rounded as written and exp taken in double, then
// rounded to fp32: what the plain versions compute as
// g / (1 + float(exp(double(-g)))), to the bit (fp32 exp implementations
// differ in the last place; an exp in double rounded to fp32 is the correctly
// rounded fp32 value but in vanishingly rare ties).
__device__ __forceinline__ float silu_exact(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, (float)exp(-(double)v)));
}

__host__ __device__ __forceinline__ size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
static inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Sum of fp32 gate-weighted per-slot rows: out[n, c] = sum over the unique
// slots, in ascending order, of gates[slot, n] * ybuf[slot, n, c] (the decode
// MoE kernels' deterministic combine). grid (n_rows, ceil(h / 256)), 256 threads.
static __global__ void __launch_bounds__(256) moe_slot_combine_kernel(
    const float* __restrict__ ybuf, const float* __restrict__ gates, const int* __restrict__ n_unique,
    bf16* __restrict__ out, int n_rows, int h) {
  const int n = blockIdx.x;
  const int c = blockIdx.y * 256 + threadIdx.x;
  if (c >= h) return;
  const int slots = n_unique[0];
  float s = 0.0f;
  for (int slot = 0; slot < slots; ++slot) s = fmaf(gates[slot * n_rows + n], ybuf[((size_t)slot * n_rows + n) * h + c], s);
  out[(size_t)n * h + c] = __float2bfloat16(s);
}

// ---------------------------------------------------------------------------
// int4 weights x s8 activations (the arithmetic of ops/kernels/intdot.py)
// ---------------------------------------------------------------------------

// Transpose a 4x4 block of bytes: w[r] holds row r's bytes of columns 0..3
// (byte c = column c); t[c] gets column c's bytes of rows 0..3, so that one
// __dp4a takes four consecutive contraction rows of one column.
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The two s8 operands of packed int4 bytes (four at a time): the low nibble
// b & 15, and b ^ 0x80 read as s8 (== b - 128).
__device__ __forceinline__ int nib_lo(uint32_t t) { return (int)(t & 0x0F0F0F0Fu); }
__device__ __forceinline__ int nib_x80(uint32_t t) { return (int)(t ^ 0x80808080u); }

// fp32 epilogue of the two integer dots: d1 * sa1 + d2 * (sa2 / 16) - corr,
// rounded step by step as the plain version (no fused multiply-add).
__device__ __forceinline__ float mm4_epilogue(int d1, int d2, const float* st) {
  return __fsub_rn(__fadd_rn(__fmul_rn((float)d1, st[0]), __fmul_rn((float)d2, __fmul_rn(st[1], 0.0625f))), st[2]);
}

template <typename T>
struct MaxOp {
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
template <typename T>
struct SumOp {
  __device__ T operator()(T a, T b) const { return a + b; }
};

// All-reduce K values per thread over the block (blockDim a multiple of 32, at
// most 32 warps); every thread gets the K results. `scratch` holds 32 * K values.
template <int K, typename T, typename Op>
__device__ __forceinline__ void block_allreduce(T (&v)[K], T* scratch, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] = op(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = scratch[k];
    for (int w = 1; w < nwarps; ++w) v[k] = op(v[k], scratch[w * K + k]);
  }
  __syncthreads();
}

// Per-row s8 quantization of the split-halves operand pair (intdot.
// quant_rows_s8_pair) of R rows of length n, block-wide: lo = row[0, n/2),
// hi = row[n/2, n); a1 = round((lo - hi/16) / sa1), a2 = round(hi / sa2) into
// shared a1/a2 [R][n/2]; st[4 r + 0..2] = sa1, sa2, corr. Rows >= nr are zero.
// `row(r, i)` gives element i of row r (it is called twice per element and
// must give the same value both times). fscratch / iscratch hold 32 * 2R values.
template <int R, typename Row>
__device__ void quant_pair_rows(Row row, int nr, int n, int8_t* a1, int8_t* a2, float* st, float* fscratch,
                                int* iscratch) {
  const int half = n / 2;
  float mx[2 * R];
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) mx[k] = 0.0f;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        const float hi = row(r, half + i);
        const float c1 = row(r, i) - hi * 0.0625f;
        mx[2 * r] = fmaxf(mx[2 * r], fabsf(c1));
        mx[2 * r + 1] = fmaxf(mx[2 * r + 1], fabsf(hi));
      }
    }
  }
  block_allreduce<2 * R>(mx, fscratch, MaxOp<float>());
  float sc[2 * R];
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) sc[k] = __fadd_rn(__fdiv_rn(mx[k], 127.0f), 1e-12f);
  int sums[2 * R];
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) sums[k] = 0;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int q1 = 0, q2 = 0;
      if (r < nr) {
        const float hi = row(r, half + i);
        const float c1 = row(r, i) - hi * 0.0625f;
        q1 = (int)rintf(__fdiv_rn(c1, sc[2 * r]));
        q2 = (int)rintf(__fdiv_rn(hi, sc[2 * r + 1]));
      }
      a1[r * half + i] = (int8_t)q1;
      a2[r * half + i] = (int8_t)q2;
      sums[2 * r] += q1;
      sums[2 * r + 1] += q2;
    }
  }
  block_allreduce<2 * R>(sums, iscratch, SumOp<int>());
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sa1 = sc[2 * r], sa2 = sc[2 * r + 1];
      st[4 * r] = sa1;
      st[4 * r + 1] = sa2;
      st[4 * r + 2] = __fmul_rn(8.0f, __fadd_rn(__fmul_rn((float)sums[2 * r], sa1),
                                               __fmul_rn((float)sums[2 * r + 1], __fmul_rn(sa2, 0.0625f))));
    }
  }
  __syncthreads();
}
