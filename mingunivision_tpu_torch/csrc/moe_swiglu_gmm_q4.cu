// Prefill MoE over linear int4 tables: grouped SwiGLU over expert-sorted rows,
// ys[r] = (silu(x[tok[r]] @ W1[e] * s1) * (x[tok[r]] @ W3[e] * s3)) @ W2[e] * s2
// for the rows r of expert e, W = the split-halves packed nibbles - 8 (exact).
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py
// (swiglu_gmm_quant -> _swiglu_gmm_q4_chunked -> _kernel_q4_chunked, exact
// dequant, bf16 operands, fp32 sums). At the slice's prompt (128 tokens x top-6
// = 768 rows over 64 experts) the op reads a layer's packed tables once,
// 64 x 4.33 MB = 277 MB (83 us at 3.35 TB/s), and does 13 GFLOP.
//
// Design: the bf16 kernel's (moe_swiglu_gmm.cu) group schedule and two
// launches, with the nibbles unpacked in the load path. A packed row k of a
// gate/up table holds contraction row k (low nibble) and row k + h/2 (high
// nibble), so each tile step loads BK packed rows once and multiplies both
// planes: x[:, k] with the low nibbles and x[:, k + h/2] with the high ones.
// The down table likewise: its logical row j is the low nibble of packed row
// j for j < m/2, else the high nibble of packed row j - m/2. Nibble values
// (-8..7) are exact in fp32, activations enter as their bf16 values, sums are
// fp32; g * s1 and u * s3 after the dots, a = silu(g) * u rounded to bf16
// before the down dot, s2 once at the store. Simple smem-tiled FMA; tensor
// cores come later.
#include "common.cuh"

namespace {

constexpr int TM = 32;  // rows per tile (the schedule's tile, mu_swiglu_gmm_tile_rows)
constexpr int BN = 64;  // output columns per block
constexpr int BK = 32;  // packed contraction rows per step (2 * BK logical rows)
constexpr int kThreads = 256;  // 16 x 16: each thread owns 2 rows x 4 columns

// Unpack a BK x BN tile of packed bytes (rows k0.., columns n0.. of a table
// with `ld` columns) into its low- and high-nibble weights.
__device__ __forceinline__ void load_nibble_tile(const uint8_t* __restrict__ q, size_t ld, int k0, int n0,
                                                 float (*lo)[BN], float (*hi)[BN]) {
  for (int idx = threadIdx.x; idx < BK * BN / 4; idx += kThreads) {
    const int kk = idx / (BN / 4);
    const int c = 4 * (idx % (BN / 4));
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(k0 + kk) * ld + n0 + c));
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int byte = (w >> (8 * b)) & 0xFF;
      lo[kk][c + b] = (float)((byte & 15) - 8);
      hi[kk][c + b] = (float)((byte >> 4) - 8);
    }
  }
}

__device__ __forceinline__ void fma_2x4(float a0, float a1, const float* b, float (&acc)[2][4]) {
  const float4 v = *reinterpret_cast<const float4*>(b);
  acc[0][0] = fmaf(a0, v.x, acc[0][0]); acc[0][1] = fmaf(a0, v.y, acc[0][1]);
  acc[0][2] = fmaf(a0, v.z, acc[0][2]); acc[0][3] = fmaf(a0, v.w, acc[0][3]);
  acc[1][0] = fmaf(a1, v.x, acc[1][0]); acc[1][1] = fmaf(a1, v.y, acc[1][1]);
  acc[1][2] = fmaf(a1, v.z, acc[1][2]); acc[1][3] = fmaf(a1, v.w, acc[1][3]);
}

__global__ void __launch_bounds__(kThreads) gmm_q4_up_kernel(
    const bf16* __restrict__ x, const int* __restrict__ row_token, const uint8_t* __restrict__ q1,
    const float* __restrict__ s1, const uint8_t* __restrict__ q3, const float* __restrict__ s3,
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
  const int hh = h / 2;

  __shared__ float xlo[BK][TM + 1], xhi[BK][TM + 1];
  __shared__ __align__(16) float w1lo[BK][BN], w1hi[BK][BN], w3lo[BK][BN], w3hi[BK][BN];
  __shared__ int tok[TM];
  if (tid < TM) tok[tid] = (r0 + tid < r1) ? row_token[r0 + tid] : -1;
  __syncthreads();

  const uint8_t* Q1 = q1 + (size_t)e * hh * m;
  const uint8_t* Q3 = q3 + (size_t)e * hh * m;
  float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < hh; k0 += BK) {
    for (int idx = tid; idx < TM * BK; idx += kThreads) {
      const int r = idx / BK;
      const int kk = idx % BK;
      const int t = tok[r];
      xlo[kk][r] = t >= 0 ? __bfloat162float(x[(size_t)t * h + k0 + kk]) : 0.0f;
      xhi[kk][r] = t >= 0 ? __bfloat162float(x[(size_t)t * h + hh + k0 + kk]) : 0.0f;
    }
    load_nibble_tile(Q1, m, k0, n0, w1lo, w1hi);
    load_nibble_tile(Q3, m, k0, n0, w3lo, w3hi);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float l0 = xlo[kk][2 * ty], l1 = xlo[kk][2 * ty + 1];
      const float h0 = xhi[kk][2 * ty], h1 = xhi[kk][2 * ty + 1];
      fma_2x4(l0, l1, &w1lo[kk][4 * tx], g);
      fma_2x4(h0, h1, &w1hi[kk][4 * tx], g);
      fma_2x4(l0, l1, &w3lo[kk][4 * tx], u);
      fma_2x4(h0, h1, &w3hi[kk][4 * tx], u);
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

__global__ void __launch_bounds__(kThreads) gmm_q4_down_kernel(
    const bf16* __restrict__ hbuf, const uint8_t* __restrict__ q2, const float* __restrict__ s2,
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
  const int mh = m / 2;

  __shared__ float alo[BK][TM + 1], ahi[BK][TM + 1];
  __shared__ __align__(16) float wlo[BK][BN], whi[BK][BN];

  const uint8_t* Q2 = q2 + (size_t)e * mh * h;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < mh; k0 += BK) {
    for (int idx = tid; idx < TM * BK; idx += kThreads) {
      const int r = idx / BK;
      const int kk = idx % BK;
      const bool ok = r0 + r < r1;
      const bf16* row = hbuf + (size_t)(r0 + r) * m;
      alo[kk][r] = ok ? __bfloat162float(row[k0 + kk]) : 0.0f;
      ahi[kk][r] = ok ? __bfloat162float(row[mh + k0 + kk]) : 0.0f;
    }
    load_nibble_tile(Q2, h, k0, n0, wlo, whi);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      fma_2x4(alo[kk][2 * ty], alo[kk][2 * ty + 1], &wlo[kk][4 * tx], acc);
      fma_2x4(ahi[kk][2 * ty], ahi[kk][2 * ty + 1], &whi[kk][4 * tx], acc);
    }
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

// x (N, h) bf16 token rows; row_token (A,) int32 token of each expert-sorted
// row; q1/q3 (E, h/2, m) and q2 (E, m/2, h) uint8 split-halves packed int4 for
// ONE layer with fp32 scales s1/s3 (E, 1, m) and s2 (E, 1, h); sched
// (n_tiles, 3) int32 (expert, first row, end row), empty entries have
// first == end; scratch hbuf (A, m) bf16; out ys (A, h) bf16 in sorted row
// order. h and m must be multiples of 64 (the wrapper checks); the tile rows
// are mu_swiglu_gmm_tile_rows().
extern "C" int mu_swiglu_gmm_q4(const void* x, const void* row_token, const void* q1, const void* s1, const void* q3,
                                const void* s3, const void* q2, const void* s2, const void* sched, void* hbuf,
                                void* ys, int n_tiles, int h, int m, void* stream) {
  static_assert(TM == 32, "the schedule is built for the bf16 kernel's 32-row tiles");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gmm_q4_up_kernel<<<dim3(m / BN, n_tiles), kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(row_token), static_cast<const uint8_t*>(q1),
      static_cast<const float*>(s1), static_cast<const uint8_t*>(q3), static_cast<const float*>(s3),
      static_cast<const int*>(sched), static_cast<bf16*>(hbuf), h, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gmm_q4_down_kernel<<<dim3(h / BN, n_tiles), kThreads, 0, st>>>(
      static_cast<const bf16*>(hbuf), static_cast<const uint8_t*>(q2), static_cast<const float*>(s2),
      static_cast<const int*>(sched), static_cast<bf16*>(ys), h, m);
  return (int)cudaGetLastError();
}
