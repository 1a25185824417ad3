// Decode-shape MoE: sum over routed experts of gate * (silu(x@w1[e]) * (x@w3[e])) @ w2[e].
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/moe_stream.py
// (moe_experts_stream -> _kernel). On the H100 this op is bound by the bytes
// of expert weights it reads: at the bf16 16B-A3B shape one expert is
// 3 x 2048 x 1408 x 2 B = 17.3 MB, and a 2-row CFG decode step routes up to
// 12 experts per layer (about 208 MB per layer, 62 us at 3.35 TB/s); the
// activations are a few KB. At a 16-slot serving step some 50 experts are
// routed and every weight byte meets 16 rows: 16 FLOP per byte, past what the
// CUDA cores' fp32 FMAs keep up with at 3.35 TB/s, so the products run on the
// tensor cores.
//
// Design: two launches, each a stream of weight tiles through the tensor cores.
//
//   The expert list is built in each block: it reads topk_idx (and, in the
//   down launch, topk_w) of the N <= 64 rows into shared memory, marks the
//   routed experts in a bit set, and ranks them: slot s is the s-th routed
//   expert in ascending id (duplicates across rows are one slot). Blocks of
//   slots past the number routed exit at once, so the wrapper runs no
//   PyTorch op and the grid is sized by min(N * k, E) alone. The column tile
//   is the grid's fastest index, so the blocks of the routed slots come first
//   and fill the SMs evenly; the blocks past them exit together at the end.
//   up    grid (64-column tile of m, slot): h = silu(x@w1) * (x@w3) for the
//         rows, rounded to bf16 like the TPU kernel's h, into a workspace
//         (slot, m, rows padded to 8) that the down launch reads;
//   down  grid (128-column tile of h, slot): y = h @ w2 in fp32, written per
//         slot to the workspace; each block then takes a ticket from its
//         column tile's counter, and the last of the tile's blocks sums, for
//         each row, gate * y over the row's routed slots in ascending slot
//         order (gates of duplicate assignments summed), writes the bf16
//         output and lowers the counter to 0 for the next launch: the result
//         does not depend on which block came last, and no output value is
//         summed by atomics.
//
// Each block streams its tile of the (E, h, m) / (E, m, h) tables (row-major,
// contraction on rows: a tile is 64 contraction rows x the block's columns)
// through a ring of kStages shared-memory stages filled by 16-byte cp.async
// (rows padded by 16 bytes, so ldmatrix reads hit distinct banks; what lies
// past the table's edge is zero-filled), several stages in flight while the
// block multiplies the oldest: mma.sync.m16n8k16 bf16 with fp32 accumulators,
// the weight tile as A through ldmatrix .trans (the output columns as M), the
// rows as B (N: 8 per n-tile, NT n-tiles). Every routed expert is read once
// whatever N, each block a disjoint column tile of it. The routing, the
// cp.async copies and the ticket merge are moe_decode.cuh's, shared with the
// int4 kernel's s8 mode (moe_stream_q4.cu).
#include "moe_decode.cuh"

namespace {

using namespace moe_decode;

constexpr int kThreads = 128;  // 4 warps
constexpr int kTileK = 64;     // contraction rows per stage
constexpr int kUpCols = 64;    // up: columns of m per block (of w1 and of w3), 16 per warp
constexpr int kDownCols = 128;  // down: columns of h per block, 32 per warp: one per thread in the merge
constexpr int kLdUp = kUpCols + 8;      // bf16 elements per staged row
constexpr int kLdDown = kDownCols + 8;
static_assert(kDownCols == kThreads, "the merge gives each thread one column");

// ring depth by n-tiles: two blocks on an SM where the stages allow it
template <int NT>
struct Ring {
  static constexpr int kStages = NT <= 2 ? 5 : NT == 4 ? 4 : 3;
  static constexpr int kRowsPad = NT * 8;
  static constexpr int kLdH = kRowsPad + (NT > 1 ? 8 : 0);  // staged h row: ldmatrix .trans rows on distinct banks
  static constexpr size_t kUpStage = (2 * kTileK * kLdUp + kRowsPad * kLdUp) * sizeof(bf16);
  static constexpr size_t kDownStage = (kTileK * kLdDown + kTileK * kLdH) * sizeof(bf16);
};

// Four 8x8 bf16 matrices from shared memory, each transposed (lanes 8j..8j+7
// give the row addresses of matrix j).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of W^T (16 output columns x 16 contraction rows) from a staged
// [k][col] tile with ld elements a row: matrices (cols 0-7, k 0-7), (cols 8-15,
// k 0-7), (cols 0-7, k 8-15), (cols 8-15, k 8-15).
__device__ __forceinline__ void frag_w(uint32_t (&a)[4], const bf16* s, int ld, int k0, int col0, int lane) {
  ldmatrix_x4_trans(a, s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + col0 + ((lane >> 3) & 1) * 8);
}

// up: hbuf (n_slots, m, NT * 8) bf16 <- silu(x @ w1[e]) * (x @ w3[e]) of slot blockIdx.y,
// columns [64 * blockIdx.x, + 64); rows past N are zeros.
template <int NT>
__global__ void __launch_bounds__(kThreads) moe_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                                                          const bf16* __restrict__ w3, const void* topk_idx,
                                                          int idx64, bf16* __restrict__ hbuf, int N, int K, int E,
                                                          int h, int m) {
  using Rg = Ring<NT>;
  constexpr int S = Rg::kStages;
  __shared__ Routing R;
  const int slot = blockIdx.y;
  build_routing(R, topk_idx, idx64, nullptr, 0, false, N, K, E, slot);
  if (slot >= R.n_unique) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t table = (size_t)R.expert * h * m;
  const bf16* W1 = w1 + table;
  const bf16* W3 = w3 + table;
  const int col0 = blockIdx.x * kUpCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto stage_w1 = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + s * Rg::kUpStage); };
  auto stage_w3 = [&](int s) { return stage_w1(s) + kTileK * kLdUp; };
  auto stage_x = [&](int s) { return stage_w1(s) + 2 * kTileK * kLdUp; };

  auto load = [&](int s, int kt) {
    const int k0 = kt * kTileK;
    bf16* d1 = stage_w1(s);
    bf16* d3 = stage_w3(s);
    for (int i = tid; i < kTileK * (kUpCols / 8); i += kThreads) {
      const int r = i / (kUpCols / 8), c = (i % (kUpCols / 8)) * 8;
      const bool ok = k0 + r < h && col0 + c < m;
      const size_t src = ok ? (size_t)(k0 + r) * m + col0 + c : 0;
      cp_async16_zfill(d1 + r * kLdUp + c, W1 + src, ok);
      cp_async16_zfill(d3 + r * kLdUp + c, W3 + src, ok);
    }
    bf16* dx = stage_x(s);
    for (int i = tid; i < Rg::kRowsPad * (kTileK / 8); i += kThreads) {
      const int n = i / (kTileK / 8), c = (i % (kTileK / 8)) * 8;
      const bool ok = n < N && k0 + c < h;
      cp_async16_zfill(dx + n * kLdUp + c, x + (ok ? (size_t)n * h + k0 + c : 0), ok);
    }
  };

  float g[NT][4], u[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) g[nt][i] = u[nt][i] = 0.0f;

  const int KT = (h + kTileK - 1) / kTileK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  const int gr = lane >> 2, t = lane & 3;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage kt arrived for every thread; every warp is done with the stage overwritten next
    if (kt + S - 1 < KT) load((kt + S - 1) % S, kt + S - 1);
    cp_async_commit();
    const int s = kt % S;
    const bf16* s1 = stage_w1(s);
    const bf16* s3 = stage_w3(s);
    const bf16* sx = stage_x(s);
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      uint32_t a1[4], a3[4];
      frag_w(a1, s1, kLdUp, kk, warp * 16, lane);
      frag_w(a3, s3, kLdUp, kk, warp * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* xr = sx + (nt * 8 + gr) * kLdUp + kk + 2 * t;  // rows as B: [n][k] gives the pairs directly
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(xr), *reinterpret_cast<const uint32_t*>(xr + 8)};
        mma_bf16(g[nt], a1, b);
        mma_bf16(u[nt], a3, b);
      }
    }
  }
  cp_async_wait<0>();

  // c0, c1: column gr, rows 2t, 2t + 1 of the n-tile; c2, c3: column gr + 8
  bf16* hs = hbuf + (size_t)slot * m * Rg::kRowsPad;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = col0 + warp * 16 + gr + half * 8;
    if (col >= m) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float h0 = silu_f32(g[nt][2 * half]) * u[nt][2 * half];
      const float h1 = silu_f32(g[nt][2 * half + 1]) * u[nt][2 * half + 1];
      *reinterpret_cast<bf162*>(hs + (size_t)col * Rg::kRowsPad + nt * 8 + 2 * t) = __floats2bfloat162_rn(h0, h1);
    }
  }
}

// down: ypart (n_slots, N, h) fp32 <- hbuf[slot] @ w2[e] for columns [128 * blockIdx.x, + 128);
// then the tile's last block writes out (N, h) bf16 for those columns.
template <int NT>
__global__ void __launch_bounds__(kThreads) moe_down_kernel(
    const bf16* __restrict__ hbuf, const bf16* __restrict__ w2, const void* topk_idx, int idx64, const void* topk_w,
    int w_f32, float* __restrict__ ypart, int* __restrict__ tickets, bf16* __restrict__ out, int N, int K, int E,
    int h, int m) {
  using Rg = Ring<NT>;
  constexpr int S = Rg::kStages;
  __shared__ Routing R;
  __shared__ MergeLists M;
  const int slot = blockIdx.y;
  build_routing(R, topk_idx, idx64, topk_w, w_f32, true, N, K, E, slot);
  const int U = R.n_unique;
  if (slot >= U) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* W2 = w2 + (size_t)R.expert * m * h;
  const bf16* H = hbuf + (size_t)slot * m * Rg::kRowsPad;
  const int col0 = blockIdx.x * kDownCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto stage_w = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + s * Rg::kDownStage); };
  auto stage_h = [&](int s) { return stage_w(s) + kTileK * kLdDown; };

  auto load = [&](int s, int kt) {
    const int k0 = kt * kTileK;
    bf16* dw = stage_w(s);
    for (int i = tid; i < kTileK * (kDownCols / 8); i += kThreads) {
      const int r = i / (kDownCols / 8), c = (i % (kDownCols / 8)) * 8;
      const bool ok = k0 + r < m && col0 + c < h;
      cp_async16_zfill(dw + r * kLdDown + c, W2 + (ok ? (size_t)(k0 + r) * h + col0 + c : 0), ok);
    }
    bf16* dh = stage_h(s);
    for (int i = tid; i < kTileK * NT; i += kThreads) {
      const int r = i / NT, c = (i % NT) * 8;
      const bool ok = k0 + r < m;
      cp_async16_zfill(dh + r * Rg::kLdH + c, H + (ok ? (size_t)(k0 + r) * Rg::kRowsPad + c : 0), ok);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  const int KT = (m + kTileK - 1) / kTileK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < KT) load((kt + S - 1) % S, kt + S - 1);
    cp_async_commit();
    const int s = kt % S;
    const bf16* sw = stage_w(s);
    const bf16* sh = stage_h(s);
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      uint32_t a[2][4];
      frag_w(a[0], sw, kLdDown, kk, warp * 32, lane);
      frag_w(a[1], sw, kLdDown, kk, warp * 32 + 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];  // h^T as B from the staged [k][row] tile: matrices (k 0-7), (k 8-15) of rows nt*8..+8
        ldmatrix_x2_trans(b, sh + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * Rg::kLdH + nt * 8);
        mma_bf16(acc[0][nt], a[0], b);
        mma_bf16(acc[1][nt], a[1], b);
      }
    }
  }
  cp_async_wait<0>();

  const int gr = lane >> 2, t = lane & 3;
  float* yp = ypart + (size_t)slot * N * h;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = col0 + warp * 32 + mt * 16 + gr + half * 8;
      if (col >= h) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = nt * 8 + 2 * t + j;
          if (n < N) yp[(size_t)n * h + col] = acc[mt][nt][2 * half + j];
        }
    }

  merge_tile<true>(R, M, ypart, tickets, out, N, K, h, col0, U);
}

template <int NT>
int launch(const bf16* x, const bf16* w1, const bf16* w3, const bf16* w2, const void* topk_idx, const void* topk_w,
           bf16* hbuf, float* ypart, int* tickets, bf16* out, int N, int K, int E, int h, int m, int idx64,
           int w_f32, cudaStream_t st) {
  using Rg = Ring<NT>;
  const size_t up_smem = Rg::kStages * Rg::kUpStage, down_smem = Rg::kStages * Rg::kDownStage;
  cudaError_t err = allow_dynamic_smem(moe_up_kernel<NT>, up_smem);
  if (err == cudaSuccess) err = allow_dynamic_smem(moe_down_kernel<NT>, down_smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slots = min(N * K, E);
  moe_up_kernel<NT><<<dim3((m + kUpCols - 1) / kUpCols, n_slots), kThreads, up_smem, st>>>(
      x, w1, w3, topk_idx, idx64, hbuf, N, K, E, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_down_kernel<NT><<<dim3((h + kDownCols - 1) / kDownCols, n_slots), kThreads, down_smem, st>>>(
      hbuf, w2, topk_idx, idx64, topk_w, w_f32, ypart, tickets, out, N, K, E, h, m);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, h) bf16; w1/w3 (E, h, m) and w2 (E, m, h) bf16 for ONE layer, 16-byte
// aligned; topk_idx (N, K) int32 (int64 with idx64) and topk_w (N, K) bf16
// (fp32 with w_f32); workspace, with S = min(N K, E) slots (the wrapper's
// workspace_sizes): hbuf S x m x mu_moe_stream_rows_pad(N) bf16, ypart S x N x
// h fp32, tickets ceil(h / 128) int32, zero before the first launch (every
// launch leaves them zero); out (N, h) bf16. 1 <= N <= 64, 1 <= K <= 8, E <=
// 1024, h a multiple of 32 and m of 8 (the wrapper checks).
extern "C" int mu_moe_stream_bf16(const void* x, const void* w1, const void* w3, const void* w2, const void* topk_idx,
                                  const void* topk_w, void* hbuf, void* ypart, void* tickets, void* out, int N, int K,
                                  int E, int h, int m, int idx64, int w_f32, void* stream) {
  if (N < 1 || N > kMaxRows || K < 1 || K > kMaxK || E < 1 || E > kMaxE || h % 32 || m % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *xb = static_cast<const bf16*>(x), *w1b = static_cast<const bf16*>(w1);
  const bf16 *w3b = static_cast<const bf16*>(w3), *w2b = static_cast<const bf16*>(w2);
  bf16* hb = static_cast<bf16*>(hbuf);
  float* yb = static_cast<float*>(ypart);
  int* tk = static_cast<int*>(tickets);
  bf16* ob = static_cast<bf16*>(out);
  const int pad = rows_pad(N);
#define MU_MOE_LAUNCH(NT) launch<NT>(xb, w1b, w3b, w2b, topk_idx, topk_w, hb, yb, tk, ob, N, K, E, h, m, idx64, w_f32, st)
  if (pad == 8) return MU_MOE_LAUNCH(1);
  if (pad == 16) return MU_MOE_LAUNCH(2);
  if (pad == 32) return MU_MOE_LAUNCH(4);
  return MU_MOE_LAUNCH(8);
#undef MU_MOE_LAUNCH
}

// The rows of N the kernel pads the h workspace to (8 per n-tile, 1, 2, 4 or 8 n-tiles).
extern "C" int mu_moe_stream_rows_pad(int N) { return rows_pad(N); }
