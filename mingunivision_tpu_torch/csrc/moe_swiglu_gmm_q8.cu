// Prefill MoE over int8 tables: grouped SwiGLU over expert-sorted rows,
// ys[r] = (silu(x[tok[r]] @ Q1[e] * s1) * (x[tok[r]] @ Q3[e] * s3)) @ Q2[e] * s2
// for the rows r of expert e, Q the int8 weights, in two dot modes:
//   exact   Q converted to bf16 (exact), x's bf16 values, fp32 sums, a =
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
// Design. Exact: the bf16 kernel's (moe_swiglu_gmm.cu) body, swiglu_wgmma.cuh,
// over int8 tables (`swiglu_ra_kernel`): 128-row schedule tiles
// (mu_swiglu_gmm_q8_tile_rows(0)), two launches of wgmma bf16 products with
// fp32 sums of the transposed product y^T = W^T x^T: TMA streams the table's
// bytes (64 rows x 256 columns a stage, 64-byte swizzle) beside x's rows
// (gathered by cp.async), and the consumers convert their bytes in registers
// into wgmma's A (a byte b beside 0x43 as a bf16, its sign bit cleared, minus
// the same word masked to 0xFF80: b exactly), so no bf16 copy of the table is
// written; g * s1 and u * s3 after the dots, a = silu(g) * u rounded to bf16
// before the down dot, s2 once at the store. S8: 32-row tiles
// (mu_swiglu_gmm_q8_tile_rows(1)), four launches,
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
// plain version to the bit. Simple smem-tiled CUDA-core dots; its kernels
// trap on a tile longer than their 32 rows. Both modes read the stacked
// tables' layer views, never copies.
#include "swiglu_wgmma.cuh"

namespace {

constexpr int TM = 32;  // rows per tile of the s8 kernels (their schedules' tile rows)
constexpr int BN = 64;  // output columns per block
constexpr int BK = 32;  // contraction rows per step
constexpr int kThreads = 256;  // 16 x 16: each thread owns 2 rows x 4 columns

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
// first row, end row), empty entries have first == end, tiles of at most
// mu_swiglu_gmm_q8_tile_rows(s8) rows (a longer tile traps); out ys (A, h) bf16
// in scheduled row order. Exact (s8 = 0): scratch hbuf (A, m) bf16; xq, sx, aq,
// sa and chunk unused; every operand 16-byte aligned (the scales 8-byte), R
// the rows of hbuf and ys, E the tables' experts. S8 (s8 = 1): scratch hbuf
// (A, m) fp32, xq (n_tokens, h) s8, sx (n_tokens,) fp32, aq (A, m) s8, sa (A,
// m / chunk) fp32; chunk a multiple of 32 dividing m. h and m must be
// multiples of 64 (the wrapper checks).
extern "C" int mu_swiglu_gmm_q8(const void* x, const void* row_token, const void* q1, const void* s1, const void* q3,
                                const void* s3, const void* q2, const void* s2, const void* sched, void* hbuf,
                                void* ys, void* xq, void* sx, void* aq, void* sa, int n_tiles, int R, int E, int h,
                                int m, int n_tokens, int s8, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!s8)
    return swg::launch_swiglu<swg::Tab::kInt8>(x, row_token, q1, s1, q3, s3, q2, s2, sched, hbuf, ys, n_tiles, R, E,
                                               h, m, st);
  const int* rt = static_cast<const int*>(row_token);
  const int* sc = static_cast<const int*>(sched);
  const int8_t *Q1 = static_cast<const int8_t*>(q1), *Q3 = static_cast<const int8_t*>(q3),
               *Q2 = static_cast<const int8_t*>(q2);
  const float *S1 = static_cast<const float*>(s1), *S3 = static_cast<const float*>(s3),
              *S2 = static_cast<const float*>(s2);
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

// Rows per schedule tile of each mode's kernels: exact (s8 = 0) the wgmma
// body's 128, s8 dots 32; the wrapper builds each mode's schedule with it.
extern "C" int mu_swiglu_gmm_q8_tile_rows(int s8) { return s8 ? TM : swg::BM; }
