// Gathered-expert matmul: out[a] = x[a] (h) @ W[ids[a]] (h, N) for every
// assignment a, bf16 operands, fp32 sums, one rounding to bf16 at the store.
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/expert_matmul.py
// (gathered_expert_matmul -> _kernel), a drop-in for the XLA decode dispatch
// that gathers each assignment's expert slab. On the H100 it is bound by the
// bytes of the expert slabs: each distinct (expert, table) slab read once,
// 5.8 MB per slab at the 16B-A3B width (2048 x 1408 bf16). Like the TPU
// kernel, this one reads a slab once per ASSIGNMENT, so when CFG rows route to
// the same experts it reads up to k times the bound's bytes (the decode-MoE
// kernel, csrc/moe_stream.cu, reads each routed expert once).
//
// The TPU kernel takes a whole (h, N) slab per grid step because VMEM holds
// it. Here one block per (assignment, 256-column tile): the block loads its
// own expert id (there is no scalar prefetch), stages x[a] in shared memory as
// fp32, and its 8 warps split the h rows k = warp, warp + 8, ... so that the
// block's reads of neighbouring rows are in flight together. Each lane owns 8
// neighbouring columns and reads them as one 16-byte load, so a warp reads
// 512 contiguous bytes of a row. The 8 warps' partial sums meet in shared
// memory and add in warp order; each column is rounded once. Columns past N
// (a ragged last tile) are masked. An id outside [0, E) gives NaN rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;               // columns per lane: one 16-byte load of bf16
constexpr int kTileN = 32 * kCols;     // columns per block
constexpr int kUnroll = 4;             // rows per lane in flight

__global__ void __launch_bounds__(kThreads) gathered_expert_matmul_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const int* __restrict__ ids, bf16* __restrict__ out,
    int E, int h, int N) {
  extern __shared__ float smem[];
  float* xs = smem;                        // (h,) x[a] in fp32
  float* red = smem + align16(h * 4) / 4;  // (kWarps, kTileN) partial sums
  const int a = blockIdx.x;
  const int n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int e = ids[a];
  const bool valid = e >= 0 && e < E;

  for (int i = tid; i < h; i += kThreads) xs[i] = __bfloat162float(x[(size_t)a * h + i]);
  __syncthreads();

  const int col = n0 + lane * kCols;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  if (valid && col < N) {
    const bf16* wb = w + (size_t)e * h * N + col;
    int k = warp;
    for (; k + (kUnroll - 1) * kWarps < h; k += kUnroll * kWarps) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = *reinterpret_cast<const uint4*>(wb + (size_t)(k + u * kWarps) * N);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float xv = xs[k + u * kWarps];
        const bf162* p = reinterpret_cast<const bf162*>(&v[u]);
#pragma unroll
        for (int c = 0; c < kCols / 2; ++c) {
          const float2 f = __bfloat1622float2(p[c]);
          acc[2 * c] = fmaf(xv, f.x, acc[2 * c]);
          acc[2 * c + 1] = fmaf(xv, f.y, acc[2 * c + 1]);
        }
      }
    }
    for (; k < h; k += kWarps) {
      const uint4 v = *reinterpret_cast<const uint4*>(wb + (size_t)k * N);
      const float xv = xs[k];
      const bf162* p = reinterpret_cast<const bf162*>(&v);
#pragma unroll
      for (int c = 0; c < kCols / 2; ++c) {
        const float2 f = __bfloat1622float2(p[c]);
        acc[2 * c] = fmaf(xv, f.x, acc[2 * c]);
        acc[2 * c + 1] = fmaf(xv, f.y, acc[2 * c + 1]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) red[warp * kTileN + lane * kCols + c] = acc[c];
  __syncthreads();

  const int n = n0 + tid;  // one column per thread: kThreads == kTileN
  if (n < N) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) s += red[j * kTileN + tid];
    out[(size_t)a * N + n] = __float2bfloat16(valid ? s : __int_as_float(0x7fc00000));
  }
}

static_assert(kThreads == kTileN, "the store gives each thread one column of the tile");

}  // namespace

// x (A, h) bf16; w (E, h, N) bf16, N a multiple of 8 (16-byte rows of 8
// columns); ids (A,) int32; out (A, N) bf16. All contiguous on one device
// (the wrapper checks).
extern "C" int mu_gathered_expert_matmul(const void* x, const void* w, const void* ids, void* out, int A, int E,
                                         int h, int N, void* stream) {
  if (A == 0) return (int)cudaSuccess;
  const size_t smem = align16((size_t)h * 4) + (size_t)kWarps * kTileN * 4;
  cudaError_t err = allow_dynamic_smem(gathered_expert_matmul_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(A, (N + kTileN - 1) / kTileN);
  gathered_expert_matmul_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(ids),
      static_cast<bf16*>(out), E, h, N);
  return (int)cudaGetLastError();
}
