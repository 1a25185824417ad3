// Prefill MoE over int8 tables: grouped SwiGLU over expert-sorted rows,
// ys[r] = (silu(x[tok[r]] @ Q1[e] * s1) * (x[tok[r]] @ Q3[e] * s3)) @ Q2[e] * s2
// for the rows r of expert e, Q the int8 weights, in two dot modes:
//   exact   Q converted to fp32 (exact), x's bf16 values, fp32 sums, a =
//           silu(g) * u rounded to bf16 before the down dot;
//   S8      x quantized per row to s8 (ops/kernels/intdot.py quant_rows_s8),
//           gate/up as s8 x s8 -> s32 dots times the row and column scales,
//           a = silu(g) * u in fp32 re-quantized per row over each m-chunk of
//           `chunk` columns (the JAX package's _pick_chunk: 128 at m = 1408),
//           each chunk's down dot descaled and added in chunk order, s2 once
//           at the store.
//
// Replaces the TPU kernels mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py
// (swiglu_gmm_quant -> _swiglu_gmm_q8 -> _kernel_q8_chunked, exact, and
// _kernel_q8_chunked_s8, which the JAX package switches on with
// INT_DOT_PREFILL_INT8 or s8=True; the port with
// RuntimeConfig.moe_prefill_int_dots). At the slice's prompt (128 tokens x
// top-6 = 768 rows over 64 experts) the op reads a layer's int8 tables once,
// 64 x 8.65 MB = 554 MB (165 us at 3.35 TB/s), and does 13 G operations (the
// understanding prompt's 1,152 tokens: the same bytes, 120 G operations).
//
// Design: the bf16 kernel's (moe_swiglu_gmm.cu) group schedule at tiles of 32
// rows, its own (the expert-sorted and the capacity dispatch both build it;
// a kernel handed a longer tile traps), reading the stacked
// tables' layer views, never copies. Exact: two launches, the int8 bytes
// converted to fp32 in shared memory in the load path. S8: four launches,
//   quantize  x per token row to s8 (one block per token);
//   up        per (64-column tile, row tile) the s8 rows and the int8 tile
//             (its 32-bit words byte-transposed so that each holds four
//             contraction rows of one column) into shared memory, __dp4a,
//             a = silu(g) * u to device memory in fp32;
//   chunks    per (m-chunk, row tile) each row's chunk quantized to s8 (one
//             warp per row);
//   down      per (64-column tile, row tile) the integer dots chunk by chunk,
//             each descaled by its row's chunk scale and added in fp32.
// The integer sums are exact and every fp32 step is rounded as the plain
// version writes it (no fused multiply-add), so the S8 mode agrees with its
// plain version to the bit. Simple smem-tiled CUDA-core dots; tensor cores
// come later.
#include "common.cuh"

namespace {

constexpr int TM = 32;  // rows per tile (the schedule's tile, mu_swiglu_gmm_q8_tile_rows)
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
  if (r1 - r0 > TM) __trap();  // a schedule built for longer tiles than the kernel's: refused
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
  if (r1 - r0 > TM) __trap();  // a schedule built for longer tiles than the kernel's: refused
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


// ---------------------------------------------------------------------------
// S8 mode
// ---------------------------------------------------------------------------

// x (N, h) bf16 -> xq (N, h) s8 and sx (N,) fp32, one block per token row.
__global__ void __launch_bounds__(kThreads) quant_x_s8_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                                                              float* __restrict__ sx, int h) {
  __shared__ float scratch[32];
  const bf16* row = x + (size_t)blockIdx.x * h;
  float mx[1] = {0.0f};
  for (int i = threadIdx.x; i < h; i += kThreads) mx[0] = fmaxf(mx[0], fabsf(__bfloat162float(row[i])));
  block_allreduce<1>(mx, scratch, MaxOp<float>());
  const float sc = __fadd_rn(__fdiv_rn(mx[0], 127.0f), 1e-12f);
  for (int i = threadIdx.x; i < h; i += kThreads)
    xq[(size_t)blockIdx.x * h + i] = (int8_t)(int)rintf(__fdiv_rn(__bfloat162float(row[i]), sc));
  if (threadIdx.x == 0) sx[blockIdx.x] = sc;
}

// A BK x BN tile of an int8 table (rows k0.., columns n0.., `ld` columns) into
// wt [BK / 4][BN] words, word (g, c) holding rows 4g..4g+3 of column c.
__device__ __forceinline__ void load_s8_tile_t(const int8_t* __restrict__ q, size_t ld, int k0, int n0,
                                               uint32_t (*wt)[BN], int task) {
  if (task >= (BK / 4) * (BN / 4)) return;
  const int g = task / (BN / 4), cq = task % (BN / 4);
  uint32_t w[4], t[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
    w[rr] = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(k0 + 4 * g + rr) * ld + n0 + 4 * cq));
  transpose4x4(w, t);
#pragma unroll
  for (int c = 0; c < 4; ++c) wt[g][4 * cq + c] = t[c];
}

// The s8 rows of a tile (rows of `src` with `ld` bytes, picked by row(r), -1
// for none) at columns k0..k0+BK into xw [TM][BK / 4 + 1] words.
template <typename RowOf>
__device__ __forceinline__ void load_s8_rows(const int8_t* __restrict__ src, size_t ld, int k0, RowOf row_of,
                                             int (*xw)[BK / 4 + 1]) {
  for (int idx = threadIdx.x; idx < TM * (BK / 4); idx += kThreads) {
    const int r = idx / (BK / 4), g = idx % (BK / 4);
    const long row = row_of(r);
    xw[r][g] = row >= 0 ? __ldg(reinterpret_cast<const int*>(src + (size_t)row * ld + k0 + 4 * g)) : 0;
  }
}

__device__ __forceinline__ void dp4a_2x4(int x0, int x1, const uint32_t* w, int (&acc)[2][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    acc[0][c] = __dp4a(x0, (int)w[c], acc[0][c]);
    acc[1][c] = __dp4a(x1, (int)w[c], acc[1][c]);
  }
}

__global__ void __launch_bounds__(kThreads) gmm_q8s8_up_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const int* __restrict__ row_token,
    const int8_t* __restrict__ q1, const float* __restrict__ s1, const int8_t* __restrict__ q3,
    const float* __restrict__ s3, const int* __restrict__ sched, float* __restrict__ hbuf, int h, int m) {
  const int tile = blockIdx.y;
  const int e = sched[3 * tile];
  const int r0 = sched[3 * tile + 1];
  const int r1 = sched[3 * tile + 2];
  if (r0 >= r1) return;
  if (r1 - r0 > TM) __trap();  // a schedule built for longer tiles than the kernel's: refused
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  __shared__ int xw[TM][BK / 4 + 1];
  __shared__ __align__(16) uint32_t w1t[BK / 4][BN], w3t[BK / 4][BN];
  __shared__ int tok[TM];
  if (tid < TM) tok[tid] = (r0 + tid < r1) ? row_token[r0 + tid] : -1;
  __syncthreads();

  const int8_t* Q1 = q1 + (size_t)e * h * m;
  const int8_t* Q3 = q3 + (size_t)e * h * m;
  int g[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  int u[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  const int half = (BK / 4) * (BN / 4);
  for (int k0 = 0; k0 < h; k0 += BK) {
    load_s8_rows(xq, (size_t)h, k0, [&](int r) { return (long)tok[r]; }, xw);
    if (tid < half) load_s8_tile_t(Q1, m, k0, n0, w1t, tid);
    else load_s8_tile_t(Q3, m, k0, n0, w3t, tid - half);
    __syncthreads();
#pragma unroll
    for (int kg = 0; kg < BK / 4; ++kg) {
      const int x0 = xw[2 * ty][kg], x1 = xw[2 * ty + 1][kg];
      dp4a_2x4(x0, x1, &w1t[kg][4 * tx], g);
      dp4a_2x4(x0, x1, &w3t[kg][4 * tx], u);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 2 * ty + i;
    if (r < r1) {
      const float sr = sx[tok[2 * ty + i]];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + 4 * tx + c;
        const float gv = __fmul_rn(__fmul_rn((float)g[i][c], sr), s1[(size_t)e * m + col]);
        const float uv = __fmul_rn(__fmul_rn((float)u[i][c], sr), s3[(size_t)e * m + col]);
        hbuf[(size_t)r * m + col] = __fmul_rn(silu_exact(gv), uv);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) gmm_q8s8_down_kernel(
    const int8_t* __restrict__ aq, const float* __restrict__ sa, const int8_t* __restrict__ q2,
    const float* __restrict__ s2, const int* __restrict__ sched, bf16* __restrict__ ys, int h, int m, int chunk) {
  const int tile = blockIdx.y;
  const int e = sched[3 * tile];
  const int r0 = sched[3 * tile + 1];
  const int r1 = sched[3 * tile + 2];
  if (r0 >= r1) return;
  if (r1 - r0 > TM) __trap();  // a schedule built for longer tiles than the kernel's: refused
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int n_chunks = m / chunk;

  __shared__ int xw[TM][BK / 4 + 1];
  __shared__ __align__(16) uint32_t wt[BK / 4][BN];

  const int8_t* Q2 = q2 + (size_t)e * m * h;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int c = 0; c < n_chunks; ++c) {
    int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    for (int k0 = c * chunk; k0 < (c + 1) * chunk; k0 += BK) {
      load_s8_rows(aq, (size_t)m, k0, [&](int r) { return r0 + r < r1 ? (long)(r0 + r) : -1L; }, xw);
      load_s8_tile_t(Q2, h, k0, n0, wt, tid);
      __syncthreads();
#pragma unroll
      for (int kg = 0; kg < BK / 4; ++kg) dp4a_2x4(xw[2 * ty][kg], xw[2 * ty + 1][kg], &wt[kg][4 * tx], d);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 2 * ty + i;
      const float sr = r < r1 ? sa[(size_t)r * n_chunks + c] : 0.0f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[i][cc] = __fadd_rn(acc[i][cc], __fmul_rn((float)d[i][cc], sr));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 2 * ty + i;
    if (r < r1) {
      const float* S2 = s2 + (size_t)e * h + n0 + 4 * tx;
      bf16* dst = ys + (size_t)r * h + n0 + 4 * tx;
      *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(__fmul_rn(acc[i][0], S2[0]), __fmul_rn(acc[i][1], S2[1]));
      *reinterpret_cast<bf162*>(dst + 2) =
          __floats2bfloat162_rn(__fmul_rn(acc[i][2], S2[2]), __fmul_rn(acc[i][3], S2[3]));
    }
  }
}

}  // namespace

// x (n_tokens, h) bf16 token rows; row_token (A,) int32 token of each
// scheduled row; q1/q3 (E, h, m) and q2 (E, m, h) int8 for ONE layer with fp32
// scales s1/s3 (E, 1, m) and s2 (E, 1, h); sched (n_tiles, 3) int32 (expert,
// first row, end row), empty entries have first == end; out ys (A, h) bf16 in
// scheduled row order. Exact (s8 = 0): scratch hbuf (A, m) bf16; xq, sx, aq,
// sa unused. S8 (s8 = 1): scratch hbuf (A, m) fp32, xq (n_tokens, h) s8, sx
// (n_tokens,) fp32, aq (A, m) s8, sa (A, m / chunk) fp32; chunk a multiple of
// 32 dividing m. h and m must be multiples of 64 (the wrapper checks); the tile
// rows are mu_swiglu_gmm_q8_tile_rows() (a longer tile traps).
extern "C" int mu_swiglu_gmm_q8(const void* x, const void* row_token, const void* q1, const void* s1, const void* q3,
                                const void* s3, const void* q2, const void* s2, const void* sched, void* hbuf,
                                void* ys, void* xq, void* sx, void* aq, void* sa, int n_tiles, int h, int m,
                                int n_tokens, int s8, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rt = static_cast<const int*>(row_token);
  const int* sc = static_cast<const int*>(sched);
  const int8_t *Q1 = static_cast<const int8_t*>(q1), *Q3 = static_cast<const int8_t*>(q3),
               *Q2 = static_cast<const int8_t*>(q2);
  const float *S1 = static_cast<const float*>(s1), *S3 = static_cast<const float*>(s3),
              *S2 = static_cast<const float*>(s2);
  if (!s8) {
    gmm_q8_up_kernel<<<dim3(m / BN, n_tiles), kThreads, 0, st>>>(static_cast<const bf16*>(x), rt, Q1, S1, Q3, S3, sc,
                                                                 static_cast<bf16*>(hbuf), h, m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gmm_q8_down_kernel<<<dim3(h / BN, n_tiles), kThreads, 0, st>>>(static_cast<const bf16*>(hbuf), Q2, S2, sc,
                                                                   static_cast<bf16*>(ys), h, m);
    return (int)cudaGetLastError();
  }
  if (chunk % BK || m % chunk) return (int)cudaErrorInvalidValue;
  int8_t *XQ = static_cast<int8_t*>(xq), *AQ = static_cast<int8_t*>(aq);
  float *SX = static_cast<float*>(sx), *SA = static_cast<float*>(sa), *HB = static_cast<float*>(hbuf);
  quant_x_s8_kernel<<<n_tokens, kThreads, 0, st>>>(static_cast<const bf16*>(x), XQ, SX, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gmm_q8s8_up_kernel<<<dim3(m / BN, n_tiles), kThreads, 0, st>>>(XQ, SX, rt, Q1, S1, Q3, S3, sc, HB, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_chunks_s8_kernel<<<dim3(m / chunk, n_tiles), 256, 0, st>>>(HB, sc, AQ, SA, nullptr, m, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gmm_q8s8_down_kernel<<<dim3(h / BN, n_tiles), kThreads, 0, st>>>(AQ, SA, Q2, S2, sc, static_cast<bf16*>(ys), h, m,
                                                                   chunk);
  return (int)cudaGetLastError();
}

// Rows per schedule tile of both modes' kernels; the wrapper builds their schedules with it.
extern "C" int mu_swiglu_gmm_q8_tile_rows(void) { return TM; }
