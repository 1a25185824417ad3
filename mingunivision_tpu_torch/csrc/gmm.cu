// Grouped matrix products of MoE training: the forward and lhs-gradient
// product `gmm` (each expert-sorted row against its group's matrix) and the
// table-gradient product `tgmm` (per group, lhs^T . grad over the group's rows).
//
// Replaces the library Pallas kernels the JAX package reaches through
// mingunivision_tpu/ops/kernels/moe_gmm.py:moe_experts_gmm (megablox
// gmm.py:gmm and, in its custom VJP ops.py:_gmm_bwd, gmm with the rhs
// transposed and gmm.py:tgmm). At the training shape (2 x 1024 tokens x top-6
// = 12,288 rows, 64 experts of 2048 x 1408) each call moves one bf16 expert
// table (369 MB) and the rows once: bound by bytes at about 0.14 ms, with
// 70.9 GFLOP of products (0.072 ms at the bf16 tensor-core rate) beside it.
// What the kernels must do about that is keep the products on the tensor
// cores and read each table tile once per row tile.
//
// Design. One block of 8 warps computes a 128 x 128 output tile with
// mma.sync.m16n8k16 bf16 products into fp32 accumulators (each warp 64 x 32).
// Operands are staged through shared memory in 32-deep k-chunks, each in its
// memory order: [row][k] where k is contiguous (the rows of gmm, the
// transposed table), [k][row] where rows are (the forward table, both tgmm
// operands), rows padded by 16 bytes so fragment reads hit distinct banks;
// [k][row] tiles reach the tensor cores through ldmatrix .trans. Zeros fill
// the tiles outside the valid rows, columns and k-range. An fp32
// operand (the fp32 cotangent of the VJP) is split into hi = bf16(v) and
// lo = bf16(v - hi) and enters two products, so it keeps 16 bits of its
// mantissa (the JAX package multiplies such mixed operands in fp32).
//   gmm    grid (column tiles, schedule tiles): the wrapper's schedule of
//          (group, first row, end row) tiles of at most 128 rows that start at
//          each group's first row (moe_swiglu_gmm.tile_schedule, built on the
//          device: no host sync); empty entries exit at once; rows past the
//          tile's end are computed as zeros and not stored.
//   tgmm   grid (column tiles, row tiles of K, groups): each block walks its
//          group's rows 32 at a time; a group with no rows stores zeros.
// Loads are 16-byte copies (element copies where a row's width or the
// operand's alignment does not allow them) followed by a barrier: cp.async /
// TMA pipelining, wgmma and a persistent schedule are later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 128;   // output rows per block (schedule tile rows for gmm)
constexpr int BN = 128;   // output columns per block
constexpr int BK = 32;    // contraction chunk staged per step
constexpr int LDS = BK + 8;  // [row][k] tile row stride (bf16): 80 bytes
constexpr int LDT = BM + 8;  // [k][row] tile row stride (bf16): 272 bytes
constexpr int TILE = BM * LDS > BK * LDT ? BM * LDS : BK * LDT;  // elements of one staged tile
constexpr int kThreads = 256;
static_assert(BM == BN, "one tile shape for both operands");

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// Where element (r, kk) of a staged tile lies: KC tiles are [row][k] (the
// operand's k is contiguous in memory), the others [k][row] (its rows are),
// so every staged vector lands in consecutive shared memory.
template <bool KC>
__device__ __forceinline__ int at(int r, int kk) { return KC ? r * LDS + kk : kk * LDT + r; }

// Stage the 128 x BK tile of element (r, kk) = src[r * rs + kk * ks] into hi
// (and, for fp32 sources, the remainder v - hi into lo), zeros where r >= rows
// or kk >= kvalid. KC: kk is the contiguous index in memory (ks 1), else r is
// (rs 1). With `vec` (16-byte aligned rows and source), threads move 16 bytes
// at a time along the contiguous index; a vector that crosses the valid edge
// is read element by element.
template <typename T, bool KC>
__device__ __forceinline__ void stage(bf16* hi, bf16* lo, const T* __restrict__ src, long rs, long ks, int rows,
                                      int kvalid, bool vec) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (vec) {
    constexpr int V = 16 / sizeof(T);  // elements per vector
    for (int v = threadIdx.x; v < BM * BK / V; v += kThreads) {
      const int r = KC ? v / (BK / V) : (v % (BM / V)) * V;
      const int kk = KC ? (v % (BK / V)) * V : v / (BM / V);
      const T* p = src + (long)r * rs + (long)kk * ks;  // the vector's V elements are p[0 .. V-1]
      alignas(16) T e[V];
      if (KC ? (r < rows && kk + V <= kvalid) : (kk < kvalid && r + V <= rows)) {
        *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const bool ok = KC ? (r < rows && kk + i < kvalid) : (kk < kvalid && r + i < rows);
          e[i] = ok ? p[i] : from_f32<T>(0.0f);
        }
      }
      if constexpr (F32) {
        alignas(8) bf16 h[V], l[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          h[i] = __float2bfloat16(e[i]);
          l[i] = __float2bfloat16(e[i] - __bfloat162float(h[i]));
        }
        *reinterpret_cast<uint2*>(hi + at<KC>(r, kk)) = *reinterpret_cast<const uint2*>(h);
        *reinterpret_cast<uint2*>(lo + at<KC>(r, kk)) = *reinterpret_cast<const uint2*>(l);
      } else {
        *reinterpret_cast<uint4*>(hi + at<KC>(r, kk)) = *reinterpret_cast<const uint4*>(e);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < BM * BK; idx += kThreads) {
    const int r = KC ? idx / BK : idx % BM;
    const int kk = KC ? idx % BK : idx / BM;
    const float v = (r < rows && kk < kvalid) ? to_f32(src[(long)r * rs + (long)kk * ks]) : 0.0f;
    const bf16 h = __float2bfloat16(v);
    hi[at<KC>(r, kk)] = h;
    if constexpr (F32) lo[at<KC>(r, kk)] = __float2bfloat16(v - __bfloat162float(h));
  }
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Four 8x8 bf16 matrices from shared memory, each transposed (lanes 8j..8j+7
// give the row addresses of matrix j).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The warp's A fragments (4 m16 tiles from row0) at k offset ks. A [row][k]
// tile gives each register's pair directly; a [k][row] one through ldmatrix
// .trans, matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15).
template <bool KC>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4][4], const bf16* s, int row0, int ks, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int r = row0 + mi * 16;
    if constexpr (KC) {
      a[mi][0] = ld32(s + at<true>(r + g, ks + 2 * t));
      a[mi][1] = ld32(s + at<true>(r + g + 8, ks + 2 * t));
      a[mi][2] = ld32(s + at<true>(r + g, ks + 2 * t + 8));
      a[mi][3] = ld32(s + at<true>(r + g + 8, ks + 2 * t + 8));
    } else {
      ldmatrix_x4_trans(a[mi], s + at<false>(r + ((lane >> 3) & 1) * 8, ks + (lane & 7) + ((lane >> 4) & 1) * 8));
    }
  }
}

// The warp's B fragments (4 n8 tiles from col0) at k offset ks. A [col][k]
// tile gives them directly; a [k][col] one through ldmatrix .trans, two n8
// tiles per call: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
// (k 8-15, n 8-15).
template <bool KC>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4][2], const bf16* s, int col0, int ks, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (KC) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      b[ni][0] = ld32(s + at<true>(col0 + ni * 8 + g, ks + 2 * t));
      b[ni][1] = ld32(s + at<true>(col0 + ni * 8 + g, ks + 2 * t + 8));
    }
  } else {
#pragma unroll
    for (int ni = 0; ni < 4; ni += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, s + at<false>(col0 + ni * 8 + (lane >> 4) * 8, ks + (lane & 7) + ((lane >> 3) & 1) * 8));
      b[ni][0] = r[0];
      b[ni][1] = r[1];
      b[ni + 1][0] = r[2];
      b[ni + 1][1] = r[3];
    }
  }
}

__device__ __forceinline__ void mma_tile(float (&acc)[4][4][4], const uint32_t (&a)[4][4], const uint32_t (&b)[4][2]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
}

// acc += A . B^T over one staged BK chunk (A_KC / B_KC: the tiles' layouts);
// A_SPLIT / B_SPLIT: that operand also has a lo tile (an fp32 source), which
// adds its own product.
template <bool A_KC, bool B_KC, bool A_SPLIT, bool B_SPLIT>
__device__ __forceinline__ void chunk_products(float (&acc)[4][4][4], const bf16* ah, const bf16* al,
                                               const bf16* bh, const bf16* bl) {
  static_assert(!(A_SPLIT && B_SPLIT), "at most one fp32 operand");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp / 4) * 64, col0 = (warp % 4) * 32;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[4][4], b[4][2];
    frag_a<A_KC>(a, ah, row0, ks, lane);
    frag_b<B_KC>(b, bh, col0, ks, lane);
    mma_tile(acc, a, b);
    if constexpr (A_SPLIT) {
      frag_a<A_KC>(a, al, row0, ks, lane);
      mma_tile(acc, a, b);
    }
    if constexpr (B_SPLIT) {
      frag_b<B_KC>(b, bl, col0, ks, lane);
      mma_tile(acc, a, b);
    }
  }
}

// Store the block's accumulators at out[(r) * ld + c] for r < rows, c < cols
// (row and column offsets already applied to out).
template <typename TO>
__device__ __forceinline__ void store_tile(const float (&acc)[4][4][4], TO* __restrict__ out, long ld, int rows,
                                           int cols) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / 4) * 64, col0 = (warp % 4) * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + mi * 16 + g + half * 8;
        const int c = col0 + ni * 8 + 2 * t;
        if (r >= rows) continue;
        if (c < cols) out[(long)r * ld + c] = from_f32<TO>(acc[mi][ni][2 * half]);
        if (c + 1 < cols) out[(long)r * ld + c + 1] = from_f32<TO>(acc[mi][ni][2 * half + 1]);
      }
}

// out (R, N) = lhs (R, K) . rhs[group] with rhs (E, K, N), or rhs (E, N, K)
// read transposed (TRANS), over the schedule's (group, first row, end row) tiles.
template <typename TL, bool TRANS, typename TO>
__global__ void __launch_bounds__(kThreads) gmm_kernel(const TL* __restrict__ lhs, const bf16* __restrict__ rhs,
                                                       const int* __restrict__ sched, TO* __restrict__ out, int K,
                                                       int N, bool vec) {
  const int tile = blockIdx.y;
  const int e = sched[3 * tile];
  const int r0 = sched[3 * tile + 1];
  const int r1 = sched[3 * tile + 2];
  if (r0 >= r1) return;
  const int n0 = blockIdx.x * BN;
  __shared__ __align__(16) bf16 ah[TILE];
  __shared__ __align__(16) bf16 al[TILE];
  __shared__ __align__(16) bf16 bh[TILE];

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;

  const TL* A = lhs + (long)r0 * K;
  const bf16* W = rhs + (long)e * K * N;
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<TL, true>(ah, al, A + k0, K, 1, r1 - r0, K - k0, vec);
    if constexpr (TRANS)
      stage<bf16, true>(bh, nullptr, W + (long)n0 * K + k0, K, 1, N - n0, K - k0, vec);
    else
      stage<bf16, false>(bh, nullptr, W + (long)k0 * N + n0, 1, N, N - n0, K - k0, vec);
    __syncthreads();
    chunk_products<true, TRANS, std::is_same<TL, float>::value, false>(acc, ah, al, bh, nullptr);
    __syncthreads();
  }
  store_tile(acc, out + (long)r0 * N + n0, N, r1 - r0, N - n0);
}

// out (E, K, N): out[e] = lhs[rows of e]^T . grad[rows of e], lhs (R, K) bf16,
// grad (R, N); offsets (E + 1,) int32 are the groups' first rows.
template <typename TG, typename TO>
__global__ void __launch_bounds__(kThreads) tgmm_kernel(const bf16* __restrict__ lhs, const TG* __restrict__ grad,
                                                        const int* __restrict__ offsets, TO* __restrict__ out, int K,
                                                        int N, bool vec) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int s = offsets[e], end = offsets[e + 1];
  __shared__ __align__(16) bf16 ah[TILE];
  __shared__ __align__(16) bf16 bh[TILE];
  __shared__ __align__(16) bf16 bl[TILE];

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;

  for (int k0 = s; k0 < end; k0 += BK) {
    stage<bf16, false>(ah, nullptr, lhs + (long)k0 * K + m0, 1, K, K - m0, end - k0, vec);
    stage<TG, false>(bh, bl, grad + (long)k0 * N + n0, 1, N, N - n0, end - k0, vec);
    __syncthreads();
    chunk_products<false, false, false, std::is_same<TG, float>::value>(acc, ah, nullptr, bh, bl);
    __syncthreads();
  }
  store_tile(acc, out + ((long)e * K + m0) * N + n0, N, K - m0, N - n0);
}

// 16-byte vectors along every staged row: aligned operands and widths that
// are multiples of 8 elements (so every row of either dtype starts aligned).
bool vectors_fit(const void* a, const void* b, int K, int N) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 && K % 8 == 0 &&
         N % 8 == 0;
}

template <typename TL, bool TRANS, typename TO>
int launch_gmm(const void* lhs, const void* rhs, const void* sched, void* out, int n_tiles, int K, int N,
               cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, n_tiles);
  gmm_kernel<TL, TRANS, TO><<<grid, kThreads, 0, st>>>(static_cast<const TL*>(lhs), static_cast<const bf16*>(rhs),
                                                       static_cast<const int*>(sched), static_cast<TO*>(out), K, N,
                                                       vectors_fit(lhs, rhs, K, N));
  return (int)cudaGetLastError();
}

template <typename TG, typename TO>
int launch_tgmm(const void* lhs, const void* grad, const void* offsets, void* out, int E, int K, int N,
                cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  tgmm_kernel<TG, TO><<<grid, kThreads, 0, st>>>(static_cast<const bf16*>(lhs), static_cast<const TG*>(grad),
                                                 static_cast<const int*>(offsets), static_cast<TO*>(out), K, N,
                                                 vectors_fit(lhs, grad, K, N));
  return (int)cudaGetLastError();
}

}  // namespace

// out (R, N) = lhs (R, K) . rhs[group of each row]: rhs (E, K, N) bf16, or
// (E, N, K) read transposed with `transpose`; lhs bf16 or fp32 (lhs_f32); out
// fp32 or bf16 (out_f32); sched (n_tiles, 3) int32 (group, first row, end
// row), tiles of at most mu_gmm_tile_rows() rows, empty entries first == end.
extern "C" int mu_gmm(const void* lhs, const void* rhs, const void* sched, void* out, int n_tiles, int K, int N,
                      int lhs_f32, int transpose, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mode = (lhs_f32 ? 4 : 0) | (transpose ? 2 : 0) | (out_f32 ? 1 : 0);
  switch (mode) {
    case 0: return launch_gmm<bf16, false, bf16>(lhs, rhs, sched, out, n_tiles, K, N, st);
    case 1: return launch_gmm<bf16, false, float>(lhs, rhs, sched, out, n_tiles, K, N, st);
    case 2: return launch_gmm<bf16, true, bf16>(lhs, rhs, sched, out, n_tiles, K, N, st);
    case 3: return launch_gmm<bf16, true, float>(lhs, rhs, sched, out, n_tiles, K, N, st);
    case 4: return launch_gmm<float, false, bf16>(lhs, rhs, sched, out, n_tiles, K, N, st);
    case 5: return launch_gmm<float, false, float>(lhs, rhs, sched, out, n_tiles, K, N, st);
    case 6: return launch_gmm<float, true, bf16>(lhs, rhs, sched, out, n_tiles, K, N, st);
    default: return launch_gmm<float, true, float>(lhs, rhs, sched, out, n_tiles, K, N, st);
  }
}

// out (E, K, N) = per group e, lhs[offsets[e]:offsets[e+1]]^T . grad[...]:
// lhs (R, K) bf16, grad (R, N) bf16 or fp32 (grad_f32), out bf16 or fp32
// (out_f32), fp32 accumulation rounded once; a group without rows gets zeros.
extern "C" int mu_tgmm(const void* lhs, const void* grad, const void* offsets, void* out, int E, int K, int N,
                       int grad_f32, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grad_f32)
    return out_f32 ? launch_tgmm<float, float>(lhs, grad, offsets, out, E, K, N, st)
                   : launch_tgmm<float, bf16>(lhs, grad, offsets, out, E, K, N, st);
  return out_f32 ? launch_tgmm<bf16, float>(lhs, grad, offsets, out, E, K, N, st)
                 : launch_tgmm<bf16, bf16>(lhs, grad, offsets, out, E, K, N, st);
}

// Rows per schedule tile the gmm kernel was compiled for.
extern "C" int mu_gmm_tile_rows(void) { return BM; }
