// Grouped matrix products of MoE training: the forward and lhs-gradient
// product `gmm` (each expert-sorted row against its group's matrix) and the
// table-gradient product `tgmm` (per group, lhs^T . grad over the group's rows).
//
// Replaces the library Pallas kernels the JAX package reaches through
// mingunivision_tpu/ops/kernels/moe_gmm.py:moe_experts_gmm (megablox
// gmm.py:gmm and, in its custom VJP ops.py:_gmm_bwd, gmm with the rhs
// transposed and gmm.py:tgmm). At the training shape (2 x 1024 tokens x top-6
// = 12,288 rows, 64 experts of 2048 x 1408) each call moves one bf16 expert
// table (369 MB), the rows and the output once: bound by bytes at about
// 0.15 ms, with 70.9 GFLOP of products (0.072 ms at the bf16 tensor-core
// rate; 141.7 GFLOP, 0.143 ms, where an fp32 operand enters as two bf16
// parts) beside it. What the kernels must do about that is keep the products
// on the tensor cores, keep the table's loads in flight while they run, and
// read each table tile once per row tile.
//
// gmm, the wgmma route (shapes TMA can describe: 16-byte aligned operands,
// K and N multiples of 8; the training shapes). One block per (256-column
// tile, schedule tile) of 384 threads: two consumer warpgroups, each
// computing 64 rows x 256 columns with wgmma.m64n256k16 bf16 products into
// fp32 registers, and a producer warpgroup whose one thread keeps a ring of
// 3-4 stages of TMA copies in flight (full / empty mbarriers; setmaxnreg moves
// the producer's registers to the consumers). A stage holds the tile's 128
// rows and the table's 256 columns over 64 of K, both 128-byte swizzled: the
// transposed table (E, N, K) is K-major, as wgmma reads B by default; the
// forward table (E, K, N) is N-major, read through the descriptor's MN-major
// layout (leading byte offset: the stride between 64-column chunks, stride
// byte offset: between 8-row groups of K) and wgmma's transpose-B bit. bf16
// rows enter wgmma from shared memory. fp32 rows (the VJP's cotangent) are
// copied as fp32 and split in registers into hi = bf16(v) and lo = bf16(v -
// hi), which enter two register-A wgmma products against the same B
// descriptor: 16 bits of the cotangent's mantissa, as the JAX package's fp32
// product keeps. The rows are read again for every column tile, twice the
// bytes when they are fp32: 256 columns rather than 128 halve that (N = 1408
// takes 5.5 tiles, the last half zero-filled, and was measured no slower).
// TMA fills rows past R, columns past N and K past its end with zeros; rows
// past the tile's end are computed and never stored (the epilogue stores from
// registers under a row mask); a tile of 64 rows or fewer leaves the second
// warpgroup without products (it still keeps the ring's barriers).
//
// tgmm, the wgmma route (the same TMA rule, at most 1,024 groups). The
// products run transposed, out[e]^T (N x K) = grad[rows]^T . lhs[rows], so the
// fp32 operand is A and splits in registers as above: A is read from the
// staged grad tile (TMA, 128-byte swizzled, rows of N) transposed, two
// neighbouring rows per register; B is the lhs tile, N-major as the forward
// table. An item is (group, 128 grad columns, 256 lhs columns); a stage holds
// 64 of the group's rows (2 stages). A group's rows start anywhere, and TMA
// fills zeros only past R: in a group's last stage the rows of what follows
// are zeroed in A's split and in B's shared tile (generic stores, then
// fence.proxy.async before the products), so neither a next group's value nor
// its NaN or Inf reaches this group. The epilogue stages each consumer
// warpgroup's 64 x 256 tile transposed (stmatrix .trans) in its own
// 128-byte-swizzled shared tile and stores it with TMA (clipped at K and N:
// K = 1408 takes 5.5 column tiles); the next item's loads and products do not
// wait for it. At the train shape a uniform item holds only about 192 rows,
// so each block is persistent, one per multiprocessor, walking items from the
// largest group down (a skewed routing's heavy groups start first; each block
// sums and ranks the groups' sizes in shared memory), its producer filling
// the next item's stages while the consumers finish one (on an H100 1.3-1.5x
// faster than a block per item). Empty groups' items store zeros. Each SM's
// shared memory is the likely limit: per stage the lhs tile is read twice by
// the products (hi and lo), the grad tile by the split, and TMA writes both.
// gmm, the mma.sync route (widths TMA cannot take), and tgmm's: one block of 8
// warps computes a 128 x 128 output tile with mma.sync.m16n8k16 bf16
// products into fp32 accumulators (each warp 64 x 32). Operands are staged
// through shared memory in 32-deep k-chunks, each in its memory order:
// [row][k] where k is contiguous (the rows of gmm, the transposed table),
// [k][row] where rows are (the forward table, both tgmm operands), rows
// padded by 16 bytes so fragment reads hit distinct banks; [k][row] tiles
// reach the tensor cores through ldmatrix .trans. Zeros fill the tiles
// outside the valid rows, columns and k-range. An fp32 operand is split into
// hi and lo when it is staged, and enters two products. Loads are 16-byte
// copies (element copies where a row's width or the operand's alignment does
// not allow them) followed by a barrier, without pipelining.
//   gmm    grid (column tiles, schedule tiles), either route: the wrapper's
//          schedule of (group, first row, end row) tiles of at most 128 rows
//          that start at each group's first row (moe_gmm.gmm_schedule, built
//          on the device: no host sync), then tiles of group -1 over the rows
//          of no group, which the kernels fill with zeros (the output is not
//          zero-filled beforehand); empty entries exit at once.
//   tgmm   mma.sync route: grid (column tiles, row tiles of K, groups): each
//          block walks its group's rows 32 at a time; a group with no rows
//          stores zeros.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128;   // output rows per block: the schedule's tile rows (moe_gmm.TILE_ROWS), both routes
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

// Zeros in rows r0 .. r1 - 1 of out (R, N), columns n0 .. n0 + width - 1
// within N: a schedule tile of group -1, rows that belong to no group.
template <typename TO>
__device__ __forceinline__ void zero_rows(TO* __restrict__ out, int N, int r0, int r1, int n0, int width) {
  const int cols = min(width, N - n0);
  for (int i = threadIdx.x; i < (r1 - r0) * cols; i += blockDim.x)
    out[(long)(r0 + i / cols) * N + n0 + i % cols] = from_f32<TO>(0.0f);
}

// out (R, N) = lhs (R, K) . rhs[group] with rhs (E, K, N), or rhs (E, N, K)
// read transposed (TRANS), over the schedule's (group, first row, end row)
// tiles; tiles of group -1 get zeros.
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
  if (e < 0) {
    zero_rows(out, N, r0, r1, n0, BN);
    return;
  }
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

// Group e's rows, s .. end - 1: after the first e groups' sizes, cut at R.
__device__ __forceinline__ void group_rows(const int* __restrict__ sizes, int e, int R, int& s, int& end) {
  long long c = 0;
  for (int f = 0; f < e; ++f) c += sizes[f];
  s = c < R ? (int)c : R;
  c += sizes[e];
  end = c < R ? (int)c : R;
}

// out (E, K, N): out[e] = lhs[rows of e]^T . grad[rows of e], lhs (R, K) bf16,
// grad (R, N); sizes (E,) int32, the groups' rows in order.
template <typename TG, typename TO>
__global__ void __launch_bounds__(kThreads) tgmm_kernel(const bf16* __restrict__ lhs, const TG* __restrict__ grad,
                                                        const int* __restrict__ sizes, TO* __restrict__ out, int R,
                                                        int K, int N, bool vec) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  int s, end;
  group_rows(sizes, e, R, s, end);
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
int launch_tgmm(const void* lhs, const void* grad, const void* sizes, void* out, int R, int E, int K, int N,
                cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  tgmm_kernel<TG, TO><<<grid, kThreads, 0, st>>>(static_cast<const bf16*>(lhs), static_cast<const TG*>(grad),
                                                 static_cast<const int*>(sizes), static_cast<TO*>(out), R, K, N,
                                                 vectors_fit(lhs, grad, K, N));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gmm, the wgmma route: a TMA-fed stage ring, two consumer warpgroups and a
// producer warpgroup per block
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BK = 64;                             // K per stage: one 128-byte swizzle row of bf16
constexpr int TN = 256;                            // output columns per block
constexpr int kConsumers = 2;                      // warpgroups of 64 output rows each
constexpr int kThreads = 128 * (kConsumers + 1);   // + the producer warpgroup
constexpr uint32_t kGroupBytes = 1024;             // 8 swizzled rows of 128 bytes: the stride of 8-row groups
constexpr uint32_t kChunkBBytes = 64 * BK * 2;    // one 64-column chunk of an N-major table tile
static_assert(BM == kConsumers * 64, "a consumer warpgroup per 64 rows");

// The ring of one lhs type: a stage holds A (128 rows x 64 of K in the lhs
// type; fp32 as two 32-column boxes, 128 bytes wide each) and B (256 columns
// x 64 of K, bf16): 48 KB and 4 stages for bf16 rows, 64 KB and 3 for fp32.
template <typename TL>
struct Ring {
  static constexpr bool F32 = std::is_same<TL, float>::value;
  static constexpr uint32_t kABytes = BM * BK * sizeof(TL);
  static constexpr uint32_t kBBytes = TN * BK * 2;
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = 200 * 1024 / kStageBytes;
  static constexpr size_t kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, + alignment
};

// The table tile's descriptor at k16 step ks. K-major (the transposed table,
// rows of 64 K): the step moves 32 bytes along each swizzled row; the leading
// offset is unused. N-major (the forward table: 64 rows of K, each 64 columns
// of N, per chunk): the step moves 16 rows; the leading offset is the stride
// between the 64-column chunks, the stride offset between 8-row groups.
template <bool TRANS>
__device__ __forceinline__ uint64_t b_desc(uint32_t b, int ks) {
  return TRANS ? smem_desc(b + ks * 32, 16, kGroupBytes) : smem_desc(b + ks * 16 * 128, kChunkBBytes, kGroupBytes);
}

// The warpgroup's 128 accumulator registers, as wgmma's operand list and as asm outputs.
#define WG_ACC \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define WG_OUTS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 256 fp32, the warpgroup's accumulators) += A (64 x 16) . B (16 x 256):
// ss with A from shared memory, rs with A from registers (each thread's 4
// registers of bf16 pairs); MN_B: B is N-major (wgmma's transpose-B bit).
template <int MN_B>
struct Wgmma {
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_ACC ", %128, %129, p, 1, 1, 0, %131;\n}\n"
        : WG_OUTS(d)
        : "l"(da), "l"(db), "r"(1), "n"(MN_B));
  }
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_ACC
        ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : WG_OUTS(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(MN_B));
  }
};

#undef WG_ACC
#undef WG_OUTS

// The thread's A registers of k16 step ks from a staged fp32 tile (two boxes
// of 32 K, 128 rows of 128 bytes each, 16-byte chunk c of row r at c ^ (r % 8)),
// each value split into hi = bf16(v) and lo = bf16(v - hi): registers (row g,
// k 2t, 2t + 1), (g + 8, the same), (g, k + 8), (g + 8, k + 8) of the warp's
// 16 rows from `row` (a multiple of 16, so r % 8 == g).
__device__ __forceinline__ void split_frags(const uint8_t* tile, int row, int ks, int lane, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* box = tile + (ks >> 1) * (BM * 128);
  const int c = 4 * (ks & 1) + (t >> 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row + g + 8 * (i & 1), cc = c + 2 * (i >> 1);
    const float2 v = *reinterpret_cast<const float2*>(box + r * 128 + ((cc ^ g) << 4) + (t & 1) * 8);
    const bf162 h = __floats2bfloat162_rn(v.x, v.y);
    const float2 hf = __bfloat1622float2(h);
    const bf162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// Store the warp's accumulators (rows `row` .. row + 15 of the tile) at
// out[(r0 + r) * N + c] for r < rows, c < N: thread (g, t) holds rows g and
// g + 8, columns 8 j + 2 t and + 1 (N is a multiple of 8 on this route).
template <typename TO>
__device__ __forceinline__ void store_acc(const float (&acc)[TN / 2], TO* __restrict__ out, int N, int r0, int rows,
                                          int row, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + g + 8 * h, c = n0 + 8 * j + 2 * t;
      if (r >= rows || c >= N) continue;
      TO* p = out + (long)(r0 + r) * N + c;
      if constexpr (std::is_same<TO, float>::value)
        *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      else
        *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

// out (R, N) = lhs (R, K) . rhs[group], 128 rows x 256 columns per block:
// rhs (E, K, N) (N-major B), or (E, N, K) read transposed (TRANS: K-major B);
// lhs_map over lhs (K, R innermost first, boxes of 64 | 32 K x 128 rows),
// rhs_map over rhs (boxes of 64 K x 256 N, or 64 N x 64 K). Tiles of group -1
// get zeros.
template <typename TL, bool TRANS, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap lhs_map, const __grid_constant__ CUtensorMap rhs_map,
                     const int* __restrict__ sched, TO* __restrict__ out, int K, int N) {
  using Cfg = Ring<TL>;
  using Mma = Wgmma<TRANS ? 0 : 1>;
  const int tile = blockIdx.y;
  const int e = sched[3 * tile], r0 = sched[3 * tile + 1], r1 = sched[3 * tile + 2];
  if (r0 >= r1) return;
  const int n0 = blockIdx.x * TN;
  if (e < 0) {
    zero_rows(out, N, r0, r1, n0, TN);
    return;
  }
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms start on 1024-byte boundaries
  const uint8_t* tiles = smem_raw + (base - raw);
  const uint32_t full0 = base + Cfg::kStages * Cfg::kStageBytes, empty0 = full0 + 8 * Cfg::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int k_tiles = (K + BK - 1) / BK;
  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {  // the producer: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % Cfg::kStages, k0 = kt * BK;
        const uint32_t full = full0 + 8 * s, a = base + s * Cfg::kStageBytes, b = a + Cfg::kABytes;
        mbar_wait(empty0 + 8 * s, ((kt / Cfg::kStages) & 1) ^ 1);
        mbar_expect_tx(full, Cfg::kStageBytes);
        tma_load_2d(a, &lhs_map, full, k0, r0);
        if constexpr (Cfg::F32) tma_load_2d(a + Cfg::kABytes / 2, &lhs_map, full, k0 + BK / 2, r0);
        if constexpr (TRANS) {
          tma_load_3d(b, &rhs_map, full, k0, n0, e);
        } else {
#pragma unroll
          for (int c = 0; c < TN / 64; ++c) tma_load_3d(b + c * kChunkBBytes, &rhs_map, full, n0 + 64 * c, k0, e);
        }
      }
    }
  } else {  // a consumer: rows 64 wgi .. 64 wgi + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
    const int lane = threadIdx.x % 32, row = wgi * 64 + (threadIdx.x % 128) / 32 * 16;
    const bool active = wgi * 64 < r1 - r0;  // else the tile's rows end in the first warpgroup's half
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % Cfg::kStages;
      const uint32_t a = base + s * Cfg::kStageBytes, b = a + Cfg::kABytes;
      mbar_wait(full0 + 8 * s, (kt / Cfg::kStages) & 1);
      if (active) {
        if constexpr (Cfg::F32) {
          uint32_t hi[4][4], lo[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) split_frags(tiles + s * Cfg::kStageBytes, row, ks, lane, hi[ks], lo[ks]);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            Mma::rs(acc, hi[ks], b_desc<TRANS>(b, ks));
            Mma::rs(acc, lo[ks], b_desc<TRANS>(b, ks));
          }
        } else {
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            Mma::ss(acc, smem_desc(a + wgi * 64 * 128 + ks * 32, 16, kGroupBytes), b_desc<TRANS>(b, ks));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free once both warpgroups are done
    }
    if (active) store_acc(acc, out, N, r0, r1 - r0, row, n0, lane);
  }
}

// ---------------------------------------------------------------------------
// tgmm, the wgmma route: out[e]^T (N x K) = grad[rows of e]^T . lhs[rows of e],
// persistent blocks over (group, 128 grad columns, 256 lhs columns) items
// ---------------------------------------------------------------------------

constexpr int TS = 64;                         // rows (the contraction) per tgmm stage
constexpr int TM = 128;                        // grad columns per item: the products' M, 64 per consumer warpgroup
constexpr uint32_t kTBoxBytes = TS * 128;      // one 128-byte-wide TMA box of a stage
constexpr uint32_t kEpiBytes = 32 * 1024;      // a consumer warpgroup's staged output tile
constexpr int kMaxGroups = 1024;               // groups ordered in shared memory

// The ring of one grad type: a stage holds A (TS rows x 128 grad columns:
// fp32 as four 32-column boxes, bf16 as two 64-column ones) and B (TS rows x
// 256 lhs columns, four 64-column boxes); each consumer warpgroup has its own
// epilogue tile; the groups' offsets and their order by size follow.
template <typename TG>
struct TRing {
  static constexpr bool F32 = std::is_same<TG, float>::value;
  static constexpr uint32_t kABytes = TS * TM * sizeof(TG);
  static constexpr uint32_t kBBytes = TS * TN * 2;
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = (200 * 1024 - kConsumers * kEpiBytes) / kStageBytes;  // 2 for either grad
  static constexpr size_t kSmem =
      kStages * kStageBytes + kConsumers * kEpiBytes + 2 * kStages * 8 + (2 * kMaxGroups + 2) * 4 + 1024;
};

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
// Four 8 x 8 bf16 blocks of the warp's registers into shared memory, each
// transposed (lanes 8i .. 8i + 7 give the row addresses of block i).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]),
               "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// One work item: group e, grad columns n0 .. n0 + 127, lhs columns k0 .. k0 +
// 255, the group's rows r0 .. r1 - 1. Items run through the groups from the
// largest (order), each group's items with the grad columns fastest.
struct TItem {
  int e, n0, k0, r0, r1;
};

__device__ __forceinline__ TItem t_item(int i, const int* offs, const int* order, int m_tiles, int per_group) {
  const int e = order[i / per_group], t = i % per_group;
  return {e, (t % m_tiles) * TM, (t / m_tiles) * TN, offs[e], offs[e + 1]};
}

// The thread's A registers of k16 step ks, A[m][k] = grad[row k][column m]
// from a staged grad tile (rows of 128 bytes, 16-byte chunk c of row k at
// c ^ (k % 8)): registers (m = mrow + g, k 2t, 2t + 1), (m + 8, the same),
// (m, k + 8), (m + 8, k + 8); rows at or past `valid` (the group's end) read
// as zeros. fp32 values are split into hi = bf16(v) and lo = bf16(v - hi).
template <typename TG>
__device__ __forceinline__ void t_frags(const uint8_t* tile, int mrow, int ks, int lane, int valid, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mrow + g + 8 * (i & 1), k = 16 * ks + 2 * t + 8 * (i >> 1);
    if constexpr (std::is_same<TG, float>::value) {
      const uint8_t* col = tile + (m >> 5) * kTBoxBytes + (m & 3) * 4;
      float v[2];
#pragma unroll
      for (int p = 0; p < 2; ++p)
        v[p] = k + p < valid ? *reinterpret_cast<const float*>(col + (k + p) * 128 + ((((m & 31) >> 2) ^ (2 * t + p)) << 4))
                             : 0.0f;
      const bf162 h = __floats2bfloat162_rn(v[0], v[1]);
      const float2 hf = __bfloat1622float2(h);
      const bf162 l = __floats2bfloat162_rn(v[0] - hf.x, v[1] - hf.y);
      hi[i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[i] = *reinterpret_cast<const uint32_t*>(&l);
    } else {
      const uint8_t* col = tile + (m >> 6) * kTBoxBytes + (m & 7) * 2;
      bf16 v[2];
#pragma unroll
      for (int p = 0; p < 2; ++p)
        v[p] = k + p < valid ? *reinterpret_cast<const bf16*>(col + (k + p) * 128 + ((((m & 63) >> 3) ^ (2 * t + p)) << 4))
                             : __float2bfloat16(0.0f);
      const bf162 h = __halves2bfloat162(v[0], v[1]);
      hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
}

// The consumer warpgroup's tile (64 grad columns x 256 lhs columns, thread
// (warp, g, t) holding columns 16 warp + g (+ 8) at lhs columns 8 j + 2 t (+ 1))
// into out[e] (K, N) at rows k0.., columns nw..: staged transposed in the
// warpgroup's 128-byte-swizzled tile (rows of lhs columns, grad columns
// contiguous), then TMA stores that clip at K and N. bf16: stmatrix .trans
// writes each 8 x 8 block of the accumulators transposed; the 256 rows in one
// store. fp32: two passes of 128 rows, each two 32-column boxes.
template <typename TO>
__device__ __forceinline__ void t_store(const float (&acc)[TN / 2], uint8_t* buf, uint32_t buf_s,
                                        const CUtensorMap* out_map, int e, int nw, int k0, int N, int K, int wgi,
                                        int tid) {
  constexpr bool F32 = std::is_same<TO, float>::value;
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int q = 0; q < (F32 ? 2 : 1); ++q) {
    if (tid == 0) bulk_wait_read();  // the previous store has read the tile
    named_bar(2 + wgi, 128);
    if constexpr (F32) {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int r = 8 * jj + 2 * t + p, m = 16 * warp + 8 * h + g;
            *reinterpret_cast<float*>(buf + (m >> 5) * (kEpiBytes / 2) + r * 128 + ((((m & 31) >> 2) ^ (r & 7)) << 4) +
                                      (m & 3) * 4) = acc[4 * (16 * q + jj) + 2 * h + p];
          }
    } else {
      // the 8 x 8 blocks (grad columns 16 warp + 8 h.., lhs columns 8 j..), four per stmatrix .trans: lane l
      // names row l % 8 (lhs column 8 j + l % 8) of block l / 8 (j = 2 p + (l / 8) / 2, h = (l / 8) % 2)
      const uint32_t row = (uint32_t)(lane & 7), q = (uint32_t)(lane >> 3);
#pragma unroll
      for (int p = 0; p < TN / 16; ++p) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bf162 pair = __floats2bfloat162_rn(acc[4 * (2 * p + (i >> 1)) + 2 * (i & 1)],
                                                   acc[4 * (2 * p + (i >> 1)) + 2 * (i & 1) + 1]);
          v[i] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        const uint32_t c = 16 * p + 8 * (q >> 1) + row, chunk = 2 * warp + (q & 1);
        stmatrix_x4_trans(buf_s + c * 128 + ((chunk ^ row) << 4), v);
      }
    }
    fence_async_smem();
    named_bar(2 + wgi, 128);
    if (tid == 0) {
      const int kq = k0 + 128 * q;
      if (kq < K) {
        if constexpr (F32) {
          if (nw < N) tma_store_3d(out_map, buf_s, nw, kq, e);
          if (nw + 32 < N) tma_store_3d(out_map, buf_s + kEpiBytes / 2, nw + 32, kq, e);
        } else if (nw < N) {
          tma_store_3d(out_map, buf_s, nw, kq, e);
        }
      }
      bulk_commit();
    }
  }
}

// One stage of a consumer warpgroup's item (the ring's ctr-th): wait for its
// copies; where the group ends inside it (the group's last rows r .. r1 - 1),
// zero B's rows past the end (both warpgroups, then fence.proxy.async and
// their barrier); then per k16 step split A into its own registers and issue
// its products, so each step's split runs beside the previous step's
// products; wait for them and free the slot.
template <typename TG>
__device__ __forceinline__ void t_stage(float (&acc)[TN / 2], uint8_t* tiles, uint32_t base, uint32_t full0,
                                        uint32_t empty0, int ctr, int r, int r1, int mrow, int lane, int tid) {
  using Cfg = TRing<TG>;
  const int s = ctr % Cfg::kStages, valid = min(TS, r1 - r);
  const uint32_t b = base + s * Cfg::kStageBytes + Cfg::kABytes;
  mbar_wait(full0 + 8 * s, (ctr / Cfg::kStages) & 1);
  if (valid < TS) {  // the group ends in this stage: zero B's rows of what follows it
    uint8_t* bp = tiles + (b - base);
    const int per_box = (TS - valid) * 8;  // 16-byte vectors
    for (int v = threadIdx.x; v < per_box * (TN / 64); v += kConsumers * 128)
      *reinterpret_cast<uint4*>(bp + (v / per_box) * kTBoxBytes + valid * 128 + (v % per_box) * 16) =
          make_uint4(0, 0, 0, 0);
    fence_async_smem();
    named_bar(1, kConsumers * 128);
  }
  uint32_t hi[TS / 16][4], lo[TS / 16][4];
  fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < TS / 16; ++ks) {
    t_frags<TG>(tiles + s * Cfg::kStageBytes, mrow, ks, lane, valid, hi[ks], lo[ks]);
    wgmma_fence();
    const uint64_t db = smem_desc(b + ks * 16 * 128, kTBoxBytes, kGroupBytes);
    Wgmma<1>::rs(acc, hi[ks], db);
    if constexpr (Cfg::F32) Wgmma<1>::rs(acc, lo[ks], db);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if (tid == 0) mbar_arrive(empty0 + 8 * s);
}

// out (E, K, N) bf16 or fp32: out[e] = lhs[rows of e]^T . grad[rows of e], as
// out[e]^T = grad^T . lhs: A = the grad tile read transposed from shared
// memory into registers (fp32 split into two products), B = the lhs tile,
// N-major (the MN-major descriptor, transpose-B bit). grad_map over grad
// (N, R innermost first; boxes of 128 bytes x TS rows), lhs_map over lhs (K,
// R; boxes of 64 x TS), out_map over out (N, K, E; boxes of 64 x 256 x 1 bf16,
// 32 x 128 x 1 fp32). sizes (E,) int32: the groups' rows in order (their
// bounds are summed in shared memory, cut at R). Rows of other groups in a
// group's last stage are zeroed in both operands (A in the split, B in shared
// memory before the products), so nothing of them leaks, not even a NaN; an
// empty group's items store zeros.
template <typename TG, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap grad_map, const __grid_constant__ CUtensorMap lhs_map,
                      const __grid_constant__ CUtensorMap out_map, const int* __restrict__ sizes, int R, int E,
                      int K, int N) {
  using Cfg = TRing<TG>;
  constexpr int kAB = 128 / sizeof(TG);  // grad columns per 128-byte box
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const uint32_t epi0 = base + Cfg::kStages * Cfg::kStageBytes;
  const uint32_t full0 = epi0 + kConsumers * kEpiBytes, empty0 = full0 + 8 * Cfg::kStages;
  int* offs = reinterpret_cast<int*>(tiles + (empty0 + 8 * Cfg::kStages - base));
  int* order = offs + E + 1;
  for (int i = threadIdx.x; i < E; i += blockDim.x) order[i] = sizes[i];  // the sizes, until the ranking below
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int e = threadIdx.x; e <= E; e += blockDim.x) {  // the groups' bounds: offs[e] is group e's first row
    long long c = 0;
    for (int f = 0; f < e; ++f) c += order[f];
    offs[e] = c < R ? (int)c : R;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {  // rank the groups by size, largest first, ties by index
    const int size = offs[e + 1] - offs[e];
    int rank = 0;
    for (int f = 0; f < E; ++f) {
      const int sf = offs[f + 1] - offs[f];
      rank += sf > size || (sf == size && f < e);
    }
    order[rank] = e;
  }
  __syncthreads();
  const int m_tiles = (N + TM - 1) / TM, per_group = m_tiles * ((K + TN - 1) / TN), n_items = E * per_group;
  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {  // the producer: one thread starts every copy, running ahead into the next items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int ctr = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const TItem it = t_item(i, offs, order, m_tiles, per_group);
        for (int r = it.r0; r < it.r1; r += TS, ++ctr) {
          const int s = ctr % Cfg::kStages;
          const uint32_t full = full0 + 8 * s, a = base + s * Cfg::kStageBytes, b = a + Cfg::kABytes;
          mbar_wait(empty0 + 8 * s, ((ctr / Cfg::kStages) & 1) ^ 1);
          mbar_expect_tx(full, Cfg::kStageBytes);
#pragma unroll
          for (int c = 0; c < TM / kAB; ++c) tma_load_2d(a + c * kTBoxBytes, &grad_map, full, it.n0 + kAB * c, r);
#pragma unroll
          for (int c = 0; c < TN / 64; ++c) tma_load_2d(b + c * kTBoxBytes, &lhs_map, full, it.k0 + 64 * c, r);
        }
      }
    }
  } else {  // a consumer: grad columns 64 wgi .. 64 wgi + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32, mrow = wgi * 64 + tid / 32 * 16;
    uint8_t* buf = tiles + (epi0 - base) + wgi * kEpiBytes;
    float acc[TN / 2];
    int ctr = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const TItem it = t_item(i, offs, order, m_tiles, per_group);
#pragma unroll
      for (int j = 0; j < TN / 2; ++j) acc[j] = 0.0f;
      for (int r = it.r0; r < it.r1; r += TS, ++ctr)
        t_stage<TG>(acc, tiles, base, full0, empty0, ctr, r, it.r1, mrow, lane, tid);
      t_store<TO>(acc, buf, epi0 + wgi * kEpiBytes, &out_map, it.e, it.n0 + 64 * wgi, it.k0, N, K, wgi, tid);
    }
    if (tid == 0) bulk_wait();
  }
}

}  // namespace wg

// The descriptors are encoded per call: the table pointer is a layer's view of
// the depth-stacked leaf.
template <typename TL, bool TRANS, typename TO>
int launch_gmm_wgmma(const void* lhs, const void* rhs, const void* sched, void* out, int n_tiles, int R, int E, int K,
                     int N, cudaStream_t st) {
  using Cfg = wg::Ring<TL>;
  if (!vectors_fit(lhs, rhs, K, N) || R < 1) return (int)cudaErrorInvalidValue;  // TMA needs 16-byte rows
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)R}, a_strides[1] = {(cuuint64_t)K * sizeof(TL)};
  const cuuint32_t a_box[2] = {Cfg::F32 ? wg::BK / 2 : wg::BK, BM};
  const cuuint64_t inner = TRANS ? K : N, outer = TRANS ? N : K;
  const cuuint64_t b_dims[3] = {inner, outer, (cuuint64_t)E}, b_strides[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t b_box[3] = {(cuuint32_t)(TRANS ? wg::BK : 64), (cuuint32_t)(TRANS ? wg::TN : wg::BK), 1};
  CUtensorMap lhs_map, rhs_map;
  if (!encode(&lhs_map, Cfg::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, a_dims,
              a_strides, a_box) ||
      !encode(&rhs_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, rhs, b_dims, b_strides, b_box))
    return (int)cudaErrorInvalidValue;
  auto kernel = wg::gmm_wgmma_kernel<TL, TRANS, TO>;
  const cudaError_t rc = allow_dynamic_smem(kernel, Cfg::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((N + wg::TN - 1) / wg::TN, n_tiles);
  kernel<<<grid, wg::kThreads, Cfg::kSmem, st>>>(lhs_map, rhs_map, static_cast<const int*>(sched),
                                                   static_cast<TO*>(out), K, N);
  return (int)cudaGetLastError();
}

// The multiprocessors of the current device: the persistent grid's width.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// tgmm's wgmma route: one block per multiprocessor (or `max_blocks`, when
// positive: at one block per item it is the one-block-per-tile grid), each
// walking its share of the E x ceil(N / 128) x ceil(K / 256) items.
template <typename TG, typename TO>
int launch_tgmm_wgmma(const void* lhs, const void* grad, const void* sizes, void* out, int R, int E, int K, int N,
                      int max_blocks, cudaStream_t st) {
  using Cfg = wg::TRing<TG>;
  constexpr bool OUT_F32 = std::is_same<TO, float>::value;
  if (!vectors_fit(lhs, grad, K, N) || reinterpret_cast<uintptr_t>(out) % 16 != 0 || R < 1 || E < 1 ||
      E > wg::kMaxGroups)
    return (int)cudaErrorInvalidValue;  // TMA needs 16-byte rows; the groups are ordered in shared memory
  const cuuint64_t g_dims[2] = {(cuuint64_t)N, (cuuint64_t)R}, g_strides[1] = {(cuuint64_t)N * sizeof(TG)};
  const cuuint32_t g_box[2] = {128 / sizeof(TG), wg::TS};
  const cuuint64_t l_dims[2] = {(cuuint64_t)K, (cuuint64_t)R}, l_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t l_box[2] = {64, wg::TS};
  const cuuint64_t o_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t o_strides[2] = {(cuuint64_t)N * sizeof(TO), (cuuint64_t)K * N * sizeof(TO)};
  const cuuint32_t o_box[3] = {OUT_F32 ? 32u : 64u, OUT_F32 ? 128u : 256u, 1};
  CUtensorMap grad_map, lhs_map, out_map;
  if (!encode(&grad_map, Cfg::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, grad,
              g_dims, g_strides, g_box) ||
      !encode(&lhs_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, l_dims, l_strides, l_box) ||
      !encode(&out_map, OUT_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, o_dims,
              o_strides, o_box))
    return (int)cudaErrorInvalidValue;
  auto kernel = wg::tgmm_wgmma_kernel<TG, TO>;
  const cudaError_t rc = allow_dynamic_smem(kernel, Cfg::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  const long items = (long)E * ((N + wg::TM - 1) / wg::TM) * ((K + wg::TN - 1) / wg::TN);
  static const int sms = sm_count();  // the persistent grid's width, queried once
  const int width = max_blocks > 0 ? max_blocks : sms;
  if (width < 1) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)(items < width ? items : width), wg::kThreads, Cfg::kSmem, st>>>(
      grad_map, lhs_map, out_map, static_cast<const int*>(sizes), R, E, K, N);
  return (int)cudaGetLastError();
}

template <typename TG, typename TO>
int launch_tgmm_route(int route, const void* lhs, const void* grad, const void* sizes, void* out, int R, int E, int K,
                      int N, int max_blocks, cudaStream_t st) {
  return route ? launch_tgmm_wgmma<TG, TO>(lhs, grad, sizes, out, R, E, K, N, max_blocks, st)
               : launch_tgmm<TG, TO>(lhs, grad, sizes, out, R, E, K, N, st);
}

template <typename TL, bool TRANS, typename TO>
int launch_gmm_route(int route, const void* lhs, const void* rhs, const void* sched, void* out, int n_tiles, int R,
                     int E, int K, int N, cudaStream_t st) {
  return route ? launch_gmm_wgmma<TL, TRANS, TO>(lhs, rhs, sched, out, n_tiles, R, E, K, N, st)
               : launch_gmm<TL, TRANS, TO>(lhs, rhs, sched, out, n_tiles, K, N, st);
}

}  // namespace

// out (R, N) = lhs (R, K) . rhs[group of each row]: rhs (E, K, N) bf16, or
// (E, N, K) read transposed with `transpose`; lhs bf16 or fp32 (lhs_f32); out
// fp32 or bf16 (out_f32); sched (n_tiles, 3) int32 (group, first row, end
// row), tiles of at most mu_gmm_tile_rows() rows, group -1 for rows of no
// group (zeros), empty entries first == end. route 1: the wgmma body (16-byte
// aligned lhs and rhs, K and N multiples of 8, else cudaErrorInvalidValue),
// 0: the mma.sync body (any widths). The wrapper chooses it by shape and
// alignment (moe_gmm.gmm_route).
extern "C" int mu_gmm(const void* lhs, const void* rhs, const void* sched, void* out, int n_tiles, int R, int E, int K,
                      int N, int lhs_f32, int transpose, int out_f32, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mode = (lhs_f32 ? 4 : 0) | (transpose ? 2 : 0) | (out_f32 ? 1 : 0);
  switch (mode) {
    case 0: return launch_gmm_route<bf16, false, bf16>(route, lhs, rhs, sched, out, n_tiles, R, E, K, N, st);
    case 1: return launch_gmm_route<bf16, false, float>(route, lhs, rhs, sched, out, n_tiles, R, E, K, N, st);
    case 2: return launch_gmm_route<bf16, true, bf16>(route, lhs, rhs, sched, out, n_tiles, R, E, K, N, st);
    case 3: return launch_gmm_route<bf16, true, float>(route, lhs, rhs, sched, out, n_tiles, R, E, K, N, st);
    case 4: return launch_gmm_route<float, false, bf16>(route, lhs, rhs, sched, out, n_tiles, R, E, K, N, st);
    case 5: return launch_gmm_route<float, false, float>(route, lhs, rhs, sched, out, n_tiles, R, E, K, N, st);
    case 6: return launch_gmm_route<float, true, bf16>(route, lhs, rhs, sched, out, n_tiles, R, E, K, N, st);
    default: return launch_gmm_route<float, true, float>(route, lhs, rhs, sched, out, n_tiles, R, E, K, N, st);
  }
}

// out (E, K, N) = per group e, lhs[rows of e]^T . grad[rows of e]: lhs (R,
// K) bf16, grad (R, N) bf16 or fp32 (grad_f32), out bf16 or fp32 (out_f32),
// fp32 accumulation rounded once; sizes (E,) int32, the groups' rows in order
// (rows past R belong to none); a group without rows gets zeros.
// route 1: the wgmma body (16-byte aligned lhs, grad and out, K and N
// multiples of 8, R >= 1, E <= 1024, else cudaErrorInvalidValue; max_blocks
// <= 0: one persistent block per multiprocessor), 0: the mma_sync body (any
// widths; max_blocks unused). The wrapper chooses it (moe_gmm.tgmm_route).
extern "C" int mu_tgmm(const void* lhs, const void* grad, const void* sizes, void* out, int R, int E, int K, int N,
                       int grad_f32, int out_f32, int route, int max_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grad_f32)
    return out_f32 ? launch_tgmm_route<float, float>(route, lhs, grad, sizes, out, R, E, K, N, max_blocks, st)
                   : launch_tgmm_route<float, bf16>(route, lhs, grad, sizes, out, R, E, K, N, max_blocks, st);
  return out_f32 ? launch_tgmm_route<bf16, float>(route, lhs, grad, sizes, out, R, E, K, N, max_blocks, st)
                 : launch_tgmm_route<bf16, bf16>(route, lhs, grad, sizes, out, R, E, K, N, max_blocks, st);
}

// Rows per schedule tile the gmm kernel was compiled for.
extern "C" int mu_gmm_tile_rows(void) { return BM; }
