// Prefill MoE over int8 tables: grouped SwiGLU over expert-sorted rows,
// ys[r] = (silu(x[tok[r]] @ Q1[e] * s1) * (x[tok[r]] @ Q3[e] * s3)) @ Q2[e] * s2
// for the rows r of expert e, Q the int8 weights (exact dequant).
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py
// (swiglu_gmm_quant -> _swiglu_gmm_q8 -> _kernel_q8_chunked, exact dequant:
// bf16 operands, fp32 sums; the JAX package keeps its s8 variant off,
// INT_DOT_PREFILL_INT8 = False). At the slice's prompt (128 tokens x top-6 =
// 768 rows over 64 experts) the op reads a layer's int8 tables once,
// 64 x 8.65 MB = 554 MB (165 us at 3.35 TB/s), and does 13 GFLOP (the
// understanding prompt's 1,152 tokens: the same bytes, 120 GFLOP).
//
// Design: the bf16 kernel's (moe_swiglu_gmm.cu) group schedule and two
// launches (the expert-sorted and the capacity dispatch both build it), with
// the int8 bytes converted in the load path: each tile step loads BK rows x BN
// columns as 32-bit words (4 columns each) and converts them to fp32 in
// shared memory (int8 values are exact in fp32). Activations enter as their
// bf16 values, sums are fp32; g * s1 and u * s3 after the dots,
// a = silu(g) * u rounded to bf16 before the down dot, the down sums unscaled
// and s2 applied once at the store. The tables are read through the layer
// view's pointer, never copied. Simple smem-tiled FMA; tensor cores come later.
#include "common.cuh"

namespace {

constexpr int TM = 32;  // rows per tile (the schedule's tile, mu_swiglu_gmm_tile_rows)
constexpr int BN = 64;  // output columns per block
constexpr int BK = 32;  // contraction rows per step
constexpr int kThreads = 256;  // 16 x 16: each thread owns 2 rows x 4 columns

// Convert a BK x BN tile of int8 weights (rows k0.., columns n0.. of a table
// with `ld` columns) to fp32.
__device__ __forceinline__ void load_int8_tile(const int8_t* __restrict__ q, size_t ld, int k0, int n0,
                                               float (*w)[BN]) {
  for (int idx = threadIdx.x; idx < BK * BN / 4; idx += kThreads) {
    const int kk = idx / (BN / 4);
    const int c = 4 * (idx % (BN / 4));
    const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(k0 + kk) * ld + n0 + c));
#pragma unroll
    for (int b = 0; b < 4; ++b) w[kk][c + b] = (float)(int8_t)(v >> (8 * b));
  }
}

__device__ __forceinline__ void fma_2x4(float a0, float a1, const float* b, float (&acc)[2][4]) {
  const float4 v = *reinterpret_cast<const float4*>(b);
  acc[0][0] = fmaf(a0, v.x, acc[0][0]); acc[0][1] = fmaf(a0, v.y, acc[0][1]);
  acc[0][2] = fmaf(a0, v.z, acc[0][2]); acc[0][3] = fmaf(a0, v.w, acc[0][3]);
  acc[1][0] = fmaf(a1, v.x, acc[1][0]); acc[1][1] = fmaf(a1, v.y, acc[1][1]);
  acc[1][2] = fmaf(a1, v.z, acc[1][2]); acc[1][3] = fmaf(a1, v.w, acc[1][3]);
}

__global__ void __launch_bounds__(kThreads) gmm_q8_up_kernel(
    const bf16* __restrict__ x, const int* __restrict__ row_token, const int8_t* __restrict__ q1,
    const float* __restrict__ s1, const int8_t* __restrict__ q3, const float* __restrict__ s3,
    const int* __restrict__ sched, bf16* __restrict__ hbuf, int h, int m) {
  const int tile = blockIdx.y;
  const int e = sched[3 * tile];
  const int r0 = sched[3 * tile + 1];
  const int r1 = sched[3 * tile + 2];
  if (r0 >= r1) return;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  __shared__ float xs[BK][TM + 1];
  __shared__ __align__(16) float w1s[BK][BN], w3s[BK][BN];
  __shared__ int tok[TM];
  if (tid < TM) tok[tid] = (r0 + tid < r1) ? row_token[r0 + tid] : -1;
  __syncthreads();

  const int8_t* Q1 = q1 + (size_t)e * h * m;
  const int8_t* Q3 = q3 + (size_t)e * h * m;
  float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < h; k0 += BK) {
    for (int idx = tid; idx < TM * BK; idx += kThreads) {
      const int r = idx / BK;
      const int kk = idx % BK;
      const int t = tok[r];
      xs[kk][r] = t >= 0 ? __bfloat162float(x[(size_t)t * h + k0 + kk]) : 0.0f;
    }
    load_int8_tile(Q1, m, k0, n0, w1s);
    load_int8_tile(Q3, m, k0, n0, w3s);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = xs[kk][2 * ty], a1 = xs[kk][2 * ty + 1];
      fma_2x4(a0, a1, &w1s[kk][4 * tx], g);
      fma_2x4(a0, a1, &w3s[kk][4 * tx], u);
    }
    __syncthreads();
  }

  const float* S1 = s1 + (size_t)e * m + n0 + 4 * tx;
  const float* S3 = s3 + (size_t)e * m + n0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 2 * ty + i;
    if (r < r1) {
      float a[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = silu_f32(g[i][c] * S1[c]) * (u[i][c] * S3[c]);
      bf16* dst = hbuf + (size_t)r * m + n0 + 4 * tx;
      *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(a[0], a[1]);
      *reinterpret_cast<bf162*>(dst + 2) = __floats2bfloat162_rn(a[2], a[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) gmm_q8_down_kernel(
    const bf16* __restrict__ hbuf, const int8_t* __restrict__ q2, const float* __restrict__ s2,
    const int* __restrict__ sched, bf16* __restrict__ ys, int h, int m) {
  const int tile = blockIdx.y;
  const int e = sched[3 * tile];
  const int r0 = sched[3 * tile + 1];
  const int r1 = sched[3 * tile + 2];
  if (r0 >= r1) return;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  __shared__ float as[BK][TM + 1];
  __shared__ __align__(16) float ws[BK][BN];

  const int8_t* Q2 = q2 + (size_t)e * m * h;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < m; k0 += BK) {
    for (int idx = tid; idx < TM * BK; idx += kThreads) {
      const int r = idx / BK;
      const int kk = idx % BK;
      as[kk][r] = (r0 + r < r1) ? __bfloat162float(hbuf[(size_t)(r0 + r) * m + k0 + kk]) : 0.0f;
    }
    load_int8_tile(Q2, h, k0, n0, ws);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) fma_2x4(as[kk][2 * ty], as[kk][2 * ty + 1], &ws[kk][4 * tx], acc);
    __syncthreads();
  }

  const float* S2 = s2 + (size_t)e * h + n0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 2 * ty + i;
    if (r < r1) {
      bf16* dst = ys + (size_t)r * h + n0 + 4 * tx;
      *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(acc[i][0] * S2[0], acc[i][1] * S2[1]);
      *reinterpret_cast<bf162*>(dst + 2) = __floats2bfloat162_rn(acc[i][2] * S2[2], acc[i][3] * S2[3]);
    }
  }
}

}  // namespace

// x (N, h) bf16 token rows; row_token (A,) int32 token of each scheduled row;
// q1/q3 (E, h, m) and q2 (E, m, h) int8 for ONE layer with fp32 scales s1/s3
// (E, 1, m) and s2 (E, 1, h); sched (n_tiles, 3) int32 (expert, first row,
// end row), empty entries have first == end; scratch hbuf (A, m) bf16; out ys
// (A, h) bf16 in scheduled row order. h and m must be multiples of 64 (the
// wrapper checks); the tile rows are mu_swiglu_gmm_tile_rows().
extern "C" int mu_swiglu_gmm_q8(const void* x, const void* row_token, const void* q1, const void* s1, const void* q3,
                                const void* s3, const void* q2, const void* s2, const void* sched, void* hbuf,
                                void* ys, int n_tiles, int h, int m, void* stream) {
  static_assert(TM == 32, "the schedule is built for the bf16 kernel's 32-row tiles");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gmm_q8_up_kernel<<<dim3(m / BN, n_tiles), kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(row_token), static_cast<const int8_t*>(q1),
      static_cast<const float*>(s1), static_cast<const int8_t*>(q3), static_cast<const float*>(s3),
      static_cast<const int*>(sched), static_cast<bf16*>(hbuf), h, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gmm_q8_down_kernel<<<dim3(h / BN, n_tiles), kThreads, 0, st>>>(
      static_cast<const bf16*>(hbuf), static_cast<const int8_t*>(q2), static_cast<const float*>(s2),
      static_cast<const int*>(sched), static_cast<bf16*>(ys), h, m);
  return (int)cudaGetLastError();
}
