// Prefill MoE: grouped SwiGLU over expert-sorted rows,
// ys[r] = (silu(x[tok[r]] @ w1[e]) * (x[tok[r]] @ w3[e])) @ w2[e] for the rows r of expert e.
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py
// (swiglu_gmm -> _kernel, scheduled by megablox make_group_metadata and
// _get_store_mask). At the slice's prompt (128 tokens x top-6 = 768 rows over
// 64 experts) the op reads the whole 1.1 GB of a layer's expert tables once
// (330 us at 3.35 TB/s) and does 13 GFLOP, so it is bound by bytes first.
//
// Design. The wrapper builds the schedule on the device: tiles of at most
// TM rows that start at each expert's first sorted row, so no tile straddles a
// group boundary and the store mask reduces to "row < group end". Each tile
// entry is (expert, first row, end row); a static upper bound of tiles is
// launched and empty entries exit at once (no host sync).
//   launch 1  grid (64-column tile of m, tile): g/u over the tile's rows with
//             the silu*mul epilogue fused, h stored bf16 (A, m);
//   launch 2  grid (64-column tile of h, tile): ys = h @ w2[e], stored bf16
//             at the sorted row (masked by the row bound).
// A full (TM, h) fp32 accumulator for a fused single pass would not fit a
// block's shared memory at h = 2048, hence two launches. Each block reads its
// expert's weight tile once per row tile; x rows are gathered by token index
// inside the kernel, so the sorted activations are never materialised.
// Simple smem-tiled FMA with fp32 accumulation; tensor cores come later.
#include "common.cuh"

namespace {

constexpr int TM = 32;  // rows per tile (the wrapper reads it through mu_swiglu_gmm_tile_rows)
constexpr int BN = 64;  // output columns per block
constexpr int BK = 32;  // contraction chunk
constexpr int kThreads = 256;  // 16 x 16: each thread owns 2 rows x 4 columns

__global__ void __launch_bounds__(kThreads) gmm_up_kernel(
    const bf16* __restrict__ x, const int* __restrict__ row_token, const bf16* __restrict__ w1,
    const bf16* __restrict__ w3, const int* __restrict__ sched, bf16* __restrict__ hbuf, int h, int m) {
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
  __shared__ __align__(16) float w1s[BK][BN];
  __shared__ __align__(16) float w3s[BK][BN];
  __shared__ int tok[TM];
  if (tid < TM) tok[tid] = (r0 + tid < r1) ? row_token[r0 + tid] : -1;
  __syncthreads();

  const bf16* W1 = w1 + (size_t)e * h * m;
  const bf16* W3 = w3 + (size_t)e * h * m;
  float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < h; k0 += BK) {
    for (int idx = tid; idx < TM * BK; idx += kThreads) {
      const int r = idx / BK;
      const int kk = idx % BK;
      const int t = tok[r];
      xs[kk][r] = t >= 0 ? __bfloat162float(x[(size_t)t * h + k0 + kk]) : 0.0f;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN;
      const int c = idx % BN;
      const size_t off = (size_t)(k0 + kk) * m + n0 + c;
      w1s[kk][c] = __bfloat162float(W1[off]);
      w3s[kk][c] = __bfloat162float(W3[off]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = xs[kk][2 * ty];
      const float a1 = xs[kk][2 * ty + 1];
      const float4 b1 = *reinterpret_cast<const float4*>(&w1s[kk][4 * tx]);
      const float4 b3 = *reinterpret_cast<const float4*>(&w3s[kk][4 * tx]);
      g[0][0] = fmaf(a0, b1.x, g[0][0]); g[0][1] = fmaf(a0, b1.y, g[0][1]);
      g[0][2] = fmaf(a0, b1.z, g[0][2]); g[0][3] = fmaf(a0, b1.w, g[0][3]);
      g[1][0] = fmaf(a1, b1.x, g[1][0]); g[1][1] = fmaf(a1, b1.y, g[1][1]);
      g[1][2] = fmaf(a1, b1.z, g[1][2]); g[1][3] = fmaf(a1, b1.w, g[1][3]);
      u[0][0] = fmaf(a0, b3.x, u[0][0]); u[0][1] = fmaf(a0, b3.y, u[0][1]);
      u[0][2] = fmaf(a0, b3.z, u[0][2]); u[0][3] = fmaf(a0, b3.w, u[0][3]);
      u[1][0] = fmaf(a1, b3.x, u[1][0]); u[1][1] = fmaf(a1, b3.y, u[1][1]);
      u[1][2] = fmaf(a1, b3.z, u[1][2]); u[1][3] = fmaf(a1, b3.w, u[1][3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 2 * ty + i;
    if (r < r1) {
      bf16* dst = hbuf + (size_t)r * m + n0 + 4 * tx;
      *reinterpret_cast<bf162*>(dst) =
          __floats2bfloat162_rn(silu_f32(g[i][0]) * u[i][0], silu_f32(g[i][1]) * u[i][1]);
      *reinterpret_cast<bf162*>(dst + 2) =
          __floats2bfloat162_rn(silu_f32(g[i][2]) * u[i][2], silu_f32(g[i][3]) * u[i][3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) gmm_down_kernel(
    const bf16* __restrict__ hbuf, const bf16* __restrict__ w2, const int* __restrict__ sched,
    bf16* __restrict__ ys, int h, int m) {
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

  const bf16* W2 = w2 + (size_t)e * m * h;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < m; k0 += BK) {
    for (int idx = tid; idx < TM * BK; idx += kThreads) {
      const int r = idx / BK;
      const int kk = idx % BK;
      as[kk][r] = (r0 + r < r1) ? __bfloat162float(hbuf[(size_t)(r0 + r) * m + k0 + kk]) : 0.0f;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN;
      const int c = idx % BN;
      ws[kk][c] = __bfloat162float(W2[(size_t)(k0 + kk) * h + n0 + c]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = as[kk][2 * ty];
      const float a1 = as[kk][2 * ty + 1];
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      acc[0][0] = fmaf(a0, b.x, acc[0][0]); acc[0][1] = fmaf(a0, b.y, acc[0][1]);
      acc[0][2] = fmaf(a0, b.z, acc[0][2]); acc[0][3] = fmaf(a0, b.w, acc[0][3]);
      acc[1][0] = fmaf(a1, b.x, acc[1][0]); acc[1][1] = fmaf(a1, b.y, acc[1][1]);
      acc[1][2] = fmaf(a1, b.z, acc[1][2]); acc[1][3] = fmaf(a1, b.w, acc[1][3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 2 * ty + i;
    if (r < r1) {
      bf16* dst = ys + (size_t)r * h + n0 + 4 * tx;
      *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      *reinterpret_cast<bf162*>(dst + 2) = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
    }
  }
}

}  // namespace

// x (N, h) bf16 token rows; row_token (A,) int32 token of each expert-sorted
// row; w1/w3 (E, h, m) and w2 (E, m, h) bf16 for ONE layer; sched (n_tiles, 3)
// int32 (expert, first row, end row), empty entries have first == end;
// scratch hbuf (A, m) bf16; out ys (A, h) bf16 in sorted row order.
// h and m must be multiples of 64 (the wrapper checks).
extern "C" int mu_swiglu_gmm_bf16(const void* x, const void* row_token, const void* w1, const void* w3,
                                  const void* w2, const void* sched, void* hbuf, void* ys, int n_tiles, int h,
                                  int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 up_grid(m / BN, n_tiles);
  gmm_up_kernel<<<up_grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(row_token), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w3), static_cast<const int*>(sched), static_cast<bf16*>(hbuf), h, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 down_grid(h / BN, n_tiles);
  gmm_down_kernel<<<down_grid, kThreads, 0, st>>>(static_cast<const bf16*>(hbuf), static_cast<const bf16*>(w2),
                                                  static_cast<const int*>(sched), static_cast<bf16*>(ys), h, m);
  return (int)cudaGetLastError();
}

// Rows per tile the kernels were compiled for; the wrapper builds its schedule with it.
extern "C" int mu_swiglu_gmm_tile_rows(void) { return TM; }
