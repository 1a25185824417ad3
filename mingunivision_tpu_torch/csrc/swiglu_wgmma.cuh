// The tensor-core body of the prefill MoE (grouped SwiGLU over expert-sorted
// rows) that moe_swiglu_gmm.cu (bf16 tables, row 2) and the exact modes of
// moe_swiglu_gmm_q4.cu (linear int4 tables, row 5) and moe_swiglu_gmm_q8.cu
// (int8 tables, row 7c) share, one table kind each (`Tab`): two launches over
// the schedule's (expert, first row, end row) tiles of at most BM = 128 rows,
//   up    grid (128-column tile of m, tile): g = x W1, u = x W3 into two fp32
//         accumulators, a = silu(g) * u (int4 / int8: silu(g s1) * (u s3))
//         rounded to bf16 into the (R, m) intermediate;
//   down  grid (256-column tile of h, tile): y = a W2 (int4 / int8: times
//         s2), stored bf16 at the sorted row under the tile's row bound.
// What bounds all three on the H100 is the bytes of the expert tables (1.1 GB
// a layer in bf16, 554 MB in int8, 277 MB packed int4), then their operations
// (120 GFLOP at the understanding prompt's 1,152 tokens). So each block reads
// its expert's table tile once for the whole 128-row tile (each table once per
// column tile while an expert holds at most 128 rows), keeps those reads in
// flight through a ring of stages, and runs the products on the tensor cores.
//
// A block is three warpgroups (gmm.cu's wgmma design): two consumers, each
// 64 rows of the tile with wgmma.m64n256k16 bf16 products into fp32
// registers (up: W1's 128 columns and W3's side by side, one product for
// both; down: 256 columns), and a producer warpgroup. A stage
// holds 64 of K: A, the tile's 128 rows (128-byte swizzled rows of 64 bf16),
// and B, four 64-column chunks of the table over those 64 rows of K, N-major
// (the tables are (E, K, N)) and read through wgmma's MN-major descriptor
// and its transpose-B bit, as gmm reads its forward table.
//   A  TMA cannot gather rows: the up launch reads x through the row map (the
//      token of each sorted row), so the producer's 128 threads stage A with
//      16-byte cp.async copies by token, writing the 128-byte swizzle by
//      hand, for the tile's rows only (the rows past its end that an active
//      consumer reads are zeroed once: computed, never stored; the capacity
//      dispatch's empty slots are never read). Each thread waits for its
//      copies two stages behind (one stage less than the ring's slack, so
//      the signal never waits on the consumers' latest release), fences them
//      to the async proxy and arrives on the stage's barrier. The down
//      launch's rows are the intermediate's, contiguous: one TMA box a stage.
//   B  bf16: one producer thread's TMA copies (128-byte swizzle), counted on
//      the same barrier. int4: TMA copies the packed bytes (a quarter of the
//      bf16 bytes) into a ring of their own, and the producer threads convert
//      each stage into bf16 B chunks in the TMA's swizzle (a nibble n as
//      0x4300 | n is 128 + n; minus 136 is n - 8, exact), fenced before the
//      products. A packed row p of a table holds contraction row p (low
//      nibble) and p + K/2 (high nibble), so a stage of 32 packed rows is K
//      rows p0..p0+31 and K/2+p0..K/2+p0+31 in that order, and A's 64 columns
//      are x's columns at the same two offsets; the up launch stores the
//      intermediate with each down stage's two planes' columns side by side
//      (`a_column`), so the down launch's A is one box too. Products of
//      matching operands in any order are the exact dot; the scales apply in
//      the epilogue, from shared memory. A tile of 64 rows or fewer leaves
//      the second consumer warpgroup without products: it converts half of
//      each packed stage beside the producer threads.
// int8 tables take the transposed product instead (`swiglu_ra_kernel`, its
// note below): the table's bytes converted in the consumers' registers into
// wgmma's register A, x's rows as B, no bf16 copy of the table in shared
// memory.
// Consumers wait for a stage, issue its four k16 steps, wait for the
// products and free the stage. The epilogue stores from registers under the
// row mask and the column bound (TMA zero-fills the table's columns past N;
// int4 reads them as -8, never stored either). Registers: the producer
// warpgroup 104 a thread, the consumers 200 (setmaxnreg).
// What sets the time on an H100 (tools/trace_swiglu_wgmma.py's stamps): bf16,
// the table bytes (the producer waits on free slots); int4, the producer
// threads' convert and copies (the consumers wait on full stages); int8
// converted that way took 1.5-1.6x the transposed product's time.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace swg {

constexpr int BM = 128;                          // rows per schedule tile
constexpr int BK = 64;                           // K per stage: one 128-byte swizzled row of bf16
constexpr int kSetCols = 128;                    // columns per accumulator set (wgmma n128)
constexpr int kConsumers = 2;                    // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup (a fourth would leave ptxas
                                                  // 128 registers a thread: too few for wgmma's 128 sums)
constexpr uint32_t kGroupBytes = 1024;           // 8 swizzled rows of 128 bytes
constexpr uint32_t kABytes = BM * BK * 2;        // 16 KB
constexpr uint32_t kChunkBytes = 64 * BK * 2;    // one 64-column chunk of B: 8 KB
constexpr uint32_t kBBytes = 4 * kChunkBytes;    // four chunks: 32 KB
constexpr uint32_t kStageBytes = kABytes + kBBytes;
constexpr int kPackedRows = BK / 2;               // int4: packed rows per stage
constexpr uint32_t kPChunkBytes = kPackedRows * 64;  // one packed 64-column chunk: 2 KB
constexpr uint32_t kPBytes = 4 * kPChunkBytes;        // a packed stage: 8 KB
constexpr uint32_t kPChunkBytes8 = BK * 64;          // int8: one 64-column chunk of 64 rows of bytes: 4 KB

// The table kinds of the body's clients: bf16 (row 2), linear int4 two nibbles
// a byte (row 5), both through `swiglu_wgmma_kernel`, and int8 (row 7c),
// through `swiglu_ra_kernel`.
enum class Tab { kBf16, kInt4, kInt8 };

// The ring of swiglu_wgmma_kernel's table kinds: bf16, 4 stages of A and B
// (192 KB); int4, 4 stages of A and converted B and 4 packed stages (224 KB).
// Barriers, the tile's row map and (int4) the block's columns of the scales
// follow.
template <Tab T>
struct Ring {
  static constexpr int kStages = 4;
  static constexpr int kPStages = T == Tab::kInt4 ? 4 : 0;
  static constexpr uint32_t kBarOff = kStages * kStageBytes + kPStages * kPBytes;
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 2 * kPStages) * 8 + BM * 4 + 2 * kSetCols * 4 + 1024;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

#define SWG_ACC \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define SWG_OUTS(d) \
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

// d (64 x 256 fp32, the warpgroup's accumulators: columns 0-127 the first set,
// 128-255 the second) += A (64 x 16, K-major in shared memory) . B (16 x 256,
// N-major in shared memory: the transpose-B bit; its four 64-column chunks a
// leading byte offset apart).
__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SWG_ACC ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : SWG_OUTS(d)
      : "l"(da), "l"(db), "r"(1));
}

#undef SWG_ACC
#undef SWG_OUTS

// Four packed bytes (columns c..c+3 of one packed row) as their low and high
// nibbles minus 8, bf16 pairs: lo[0] = (c, c+1), lo[1] = (c+2, c+3), the same for hi.
__device__ __forceinline__ void nibbles_bf16(uint32_t w, uint32_t* lo, uint32_t* hi) {
  const bf162 bias = __floats2bfloat162_rn(136.0f, 136.0f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t t = __byte_perm(w, 0x43u, i == 0 ? 0x4140 : 0x4342);  // 0x43 b_{2i+1} 0x43 b_{2i}
    const uint32_t l = (t & 0xFF0FFF0Fu), h = ((t >> 4) & 0x000F000Fu) | 0x43004300u;
    const bf162 lv = __hsub2(*reinterpret_cast<const bf162*>(&l), bias);
    const bf162 hv = __hsub2(*reinterpret_cast<const bf162*>(&h), bias);
    lo[i] = *reinterpret_cast<const uint32_t*>(&lv);
    hi[i] = *reinterpret_cast<const uint32_t*>(&hv);
  }
}

// Units first .. first + count - 1 (strided by 128 threads, from thread `ct`)
// of a packed stage converted into its bf16 B chunks: 8 bytes a unit, one
// packed row's 8 columns, both nibble planes stored in the TMA's swizzle.
__device__ __forceinline__ void convert_stage(const uint8_t* packed, uint8_t* bp, int ct, int first, int count) {
#pragma unroll
  for (int i = 0; i < count; ++i) {
    const int v = ct + 128 * (first + i);  // (chunk, packed row, 8-column unit)
    const int c = v >> 8, p = (v >> 3) & 31, j = v & 7;
    const uint2 w = *reinterpret_cast<const uint2*>(packed + c * kPChunkBytes + p * 64 + 8 * j);
    uint32_t lo[4], hi[4];
    nibbles_bf16(w.x, lo, hi);
    nibbles_bf16(w.y, lo + 2, hi + 2);
    uint8_t* chunk = bp + c * kChunkBytes;
    const int kl = p, kh = p + kPackedRows;  // the low plane's K row, the high plane's
    *reinterpret_cast<uint4*>(chunk + kl * 128 + ((j ^ (kl & 7)) << 4)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(chunk + kh * 128 + ((j ^ (kh & 7)) << 4)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// The intermediate's column of a's column c (of m): the down launch's stage kt
// reads columns 64 kt .. 64 kt + 63 with one TMA box, so for int4 tables the up
// epilogue stores each stage's two nibble planes' columns side by side: c <
// m/2 at 64 (c / 32) + c % 32, c >= m/2 at 64 ((c - m/2) / 32) + 32 + c % 32.
template <Tab T>
__device__ __forceinline__ int a_column(int c, int m) {
  if constexpr (T == Tab::kBf16) return c;
  const int half = m / 2, plane = c >= half, cc = c - plane * half;
  return 64 * (cc / kPackedRows) + kPackedRows * plane + cc % kPackedRows;
}

// One block of the up (UP) or down launch over a bf16 or packed int4 table.
// map0 / map1: the tables' tensor maps (up: W1, W3; down: W2 twice), (N, K or
// K/2, E) innermost first, boxes of 64 columns x 64 rows (bf16, 128-byte
// swizzle) or 64 bytes x 32 packed rows (int4, no swizzle); map_a (down): the
// intermediate's (K, R), boxes of 64 columns x 128 rows, 128-byte swizzle.
// x (up) (tokens, K) bf16, read through row_token. sc0 / sc1 (E, N) fp32: up
// s1 and s3, down s2 (int4 only). out (R, N) bf16: up the intermediate (in
// a_column order), down ys. K and N multiples of 64.
template <Tab T, bool UP>
__global__ void __launch_bounds__(kThreads, 1)
    swiglu_wgmma_kernel(const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
                        const __grid_constant__ CUtensorMap map_a, const bf16* __restrict__ x,
                        const int* __restrict__ row_token, const float* __restrict__ sc0,
                        const float* __restrict__ sc1, const int* __restrict__ sched, bf16* __restrict__ out, int K,
                        int N) {
  static_assert(T != Tab::kInt8, "int8 tables take swiglu_ra_kernel");
  using Cfg = Ring<T>;
  constexpr int S = Cfg::kStages, PS = Cfg::kPStages;
  constexpr bool Q4 = T == Tab::kInt4;
  constexpr int kBlockCols = UP ? kSetCols : 2 * kSetCols;
  // who fills a stage: every producer thread (up: A's copies; int4: B's convert), one expect_tx for TMA's bytes
  constexpr bool kThreadWork = UP || Q4;
  constexpr uint32_t kTmaBytes = (UP ? 0 : kABytes) + (Q4 ? 0 : kBBytes);
  // up: stages of A's copies a producer thread keeps in flight before it signals one (one stage less than the
  // ring's slack: the signal then never waits on the consumers' latest release)
  constexpr int kLag = S - 2;
  const int tile = blockIdx.y;
  const int e = sched[3 * tile], r0 = sched[3 * tile + 1], r1 = sched[3 * tile + 2];
  if (r0 >= r1) return;
  if (r1 - r0 > BM) __trap();  // a schedule built for longer tiles than the kernel's: refused
  const int rows = r1 - r0, n0 = blockIdx.x * kBlockCols;
  // int4: a tile of 64 rows or fewer leaves the second consumer warpgroup without products; it converts half
  // of each packed stage beside the producer threads
  const bool helper = Q4 && rows <= 64;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms start on 1024-byte boundaries
  uint8_t* tiles = smem_raw + (base - raw);
  const uint32_t pbase = base + S * kStageBytes;  // int4: the packed ring
  const uint32_t full0 = base + Cfg::kBarOff, empty0 = full0 + 8 * S;
  const uint32_t pfull0 = empty0 + 8 * S, pempty0 = pfull0 + 8 * PS;
  int* tok = reinterpret_cast<int*>(tiles + (Cfg::kBarOff + (2 * S + 2 * PS) * 8));
  float* scl = reinterpret_cast<float*>(tok + BM);  // int4: the block's columns of s1 and s3 (up) or s2 (down)
  if (UP && threadIdx.x < BM) tok[threadIdx.x] = threadIdx.x < rows ? row_token[r0 + threadIdx.x] : 0;
  if (Q4 && threadIdx.x >= BM) {
    const int i = threadIdx.x - BM, c = n0 + (UP ? i % kSetCols : i);
    const float* sc = UP && i >= kSetCols ? sc1 : sc0;
    scl[i] = c < N ? sc[(size_t)e * N + c] : 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, (kThreadWork ? 128 : 0) + (helper ? 128 : 0) + (kTmaBytes ? 1 : 0));
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    for (int s = 0; s < PS; ++s) {
      mbar_init(pfull0 + 8 * s, 1);
      mbar_init(pempty0 + 8 * s, helper ? 256 : 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int k_tiles = K / BK;
  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
    const int pt = threadIdx.x - kConsumers * 128;
    if constexpr (UP) {  // A's rows past the tile's end, zeros in every stage once (they are never copied)
      const int zrows = (rows <= 64 ? 64 : BM) - rows, per = zrows * 8;  // the rows the active consumers read
      for (int v = pt; v < S * per; v += 128)
        *reinterpret_cast<uint4*>(tiles + (v / per) * kStageBytes + (rows + v % per / 8) * 128 + (v % 8) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    // the table's column of B chunk c, and its map (up: chunks 0-1 of W1, 2-3 of W3)
    const CUtensorMap* const maps[2] = {&map0, &map1};
    auto chunk_col = [&](int c) { return UP ? n0 + 64 * (c & 1) : n0 + 64 * c; };
    auto chunk_map = [&](int c) { return maps[UP && c >= 2]; };
    constexpr int PSm = PS > 0 ? PS : 1;  // the packed ring's depth where there is one
    auto issue_packed = [&](int i) {  // int4: packed stage i by TMA (thread 0)
      const int ps = i % PSm;
      const uint32_t bar = pfull0 + 8 * ps;
      mbar_wait(pempty0 + 8 * ps, ((i / PSm) & 1) ^ 1);
      mbar_expect_tx(bar, kPBytes);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tma_load_3d(pbase + ps * kPBytes + c * kPChunkBytes, chunk_map(c), bar, chunk_col(c), i * kPackedRows, e);
    };
    if (Q4 && pt == 0)
      for (int i = 0; i < PS - 1 && i < k_tiles; ++i) issue_packed(i);
    for (int kt = 0; kt < k_tiles && (kThreadWork || pt == 0); ++kt) {
      const int s = kt % S;
      const uint32_t a = base + s * kStageBytes, b = a + kABytes;
      if (Q4 && pt == 0 && kt + PS - 1 < k_tiles) issue_packed(kt + PS - 1);
      mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
      if (kTmaBytes && pt == 0) {
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, kTmaBytes);
        if (!UP) tma_load_2d(a, &map_a, full, kt * BK, r0);
        if (!Q4) {
#pragma unroll
          for (int c = 0; c < 4; ++c) tma_load_3d(b + c * kChunkBytes, chunk_map(c), full, chunk_col(c), kt * BK, e);
        }
      }
      if constexpr (UP) {
        // A: x's row of token tok[r] for rows r = pt / 8 + 16 i of the tile, 16-byte unit pt % 8 of each (4 rows
        // of 128 bytes a warp instruction); int4: the stage's columns at its two planes' offsets
        const int u = pt & 7;
        const int col = Q4 ? (u < 4 ? 0 : K / 2) + kt * kPackedRows + 8 * (u & 3) : kt * BK + 8 * u;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = (pt >> 3) + 16 * i;
          if (r < rows) cp_async16(a + r * 128 + ((u ^ (r & 7)) << 4), x + (size_t)tok[r] * K + col);
        }
        cp_async_commit();
        if (kt >= kLag) {  // the stage kLag before: its copies landed, its writes fenced to the async proxy
          cp_async_wait<kLag>();
          fence_async_smem();
          mbar_arrive(full0 + 8 * ((kt - kLag) % S));
        }
      }
      if constexpr (Q4) {  // convert the packed stage into B: 8 bytes a unit, 8 units a thread (4 when helped)
        const int ps = kt % PS;
        mbar_wait(pfull0 + 8 * ps, (kt / PS) & 1);
        const uint8_t* packed = tiles + (pbase - base) + ps * kPBytes;
        if (helper) convert_stage(packed, tiles + (b - base), pt, 0, 4);
        else convert_stage(packed, tiles + (b - base), pt, 0, 8);
        mbar_arrive(pempty0 + 8 * ps);
        if constexpr (!UP) {  // down: the stage's A is TMA's, so it is signalled once converted
          fence_async_smem();
          mbar_arrive(full0 + 8 * s);
        }
      }
    }
    if constexpr (UP) {
      cp_async_wait<0>();
      fence_async_smem();
      for (int kt = k_tiles > kLag ? k_tiles - kLag : 0; kt < k_tiles; ++kt) mbar_arrive(full0 + 8 * (kt % S));
    }
  } else {  // a consumer: rows 64 wgi .. 64 wgi + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    float acc[kSetCols];  // 64 x 256 fp32: the first set's columns (up: g), then the second's (up: u)
#pragma unroll
    for (int i = 0; i < kSetCols; ++i) acc[i] = 0.0f;
    const bool active = wgi * 64 < rows;  // else the tile's rows end in the first warpgroup's half
    if constexpr (Q4) {
      if (helper && wgi == 1) {  // a short tile: convert the second half of each packed stage
        const int ct = threadIdx.x - 128;
        for (int kt = 0; kt < k_tiles; ++kt) {
          const int s = kt % S, ps = kt % PS;
          mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);  // the first warpgroup's products of the stage before
          mbar_wait(pfull0 + 8 * ps, (kt / PS) & 1);
          convert_stage(tiles + (pbase - base) + ps * kPBytes, tiles + s * kStageBytes + kABytes, ct, 4, 4);
          mbar_arrive(pempty0 + 8 * ps);
          fence_async_smem();
          mbar_arrive(full0 + 8 * s);
          if (ct == 0) mbar_arrive(empty0 + 8 * s);  // it reads nothing of the stage
        }
        return;
      }
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % S;
      const uint32_t a = base + s * kStageBytes, b = a + kABytes;
      mbar_wait(full0 + 8 * s, (kt / S) & 1);
      if (active) {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          mma_n256(acc, smem_desc(a + wgi * 64 * 128 + ks * 32, 16, kGroupBytes),
                   smem_desc(b + ks * 16 * 128, kChunkBytes, kGroupBytes));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free once both warpgroups are done
    }
    if (!active) return;
    // thread (warp w, lane g * 4 + t) holds rows 16 w + g (+ 8), columns 8 j + 2 t (+ 1) of each set
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int row = wgi * 64 + (threadIdx.x % 128) / 32 * 16 + g;
#pragma unroll
    for (int j = 0; j < kSetCols / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row + 8 * hh;
        if (r >= rows) continue;
        bf16* dst = out + (size_t)(r0 + r) * N;
        const int lc = 8 * j + 2 * t, c = n0 + lc;  // the column in the block, in the output
        float a0 = acc[4 * j + 2 * hh], a1 = acc[4 * j + 2 * hh + 1];
        float b0 = acc[kSetCols / 2 + 4 * j + 2 * hh], b1 = acc[kSetCols / 2 + 4 * j + 2 * hh + 1];
        if constexpr (Q4) {  // up: g s1 and u s3; down: each set times s2
          a0 *= scl[lc], a1 *= scl[lc + 1], b0 *= scl[kSetCols + lc], b1 *= scl[kSetCols + lc + 1];
        }
        if constexpr (UP) {
          if (c < N)
            *reinterpret_cast<bf162*>(dst + a_column<T>(c, N)) =
                __floats2bfloat162_rn(silu_f32(a0) * b0, silu_f32(a1) * b1);
        } else {
          if (c < N) *reinterpret_cast<bf162*>(dst + c) = __floats2bfloat162_rn(a0, a1);
          if (c + kSetCols < N) *reinterpret_cast<bf162*>(dst + c + kSetCols) = __floats2bfloat162_rn(b0, b1);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// int8 tables (row 7c): the transposed product, the weights as register A
// ---------------------------------------------------------------------------
// y^T = W^T x^T: wgmma's A (64 rows x 16 of K) is 64 table columns, converted
// from the table's bytes in the consumers' registers, and B is the tile's rows
// of x (up) or of the intermediate (down), the stage's A above read K-major
// (no transpose bit); D is 64 table columns x the tile's rows. So no bf16 copy
// of the table is written to shared memory: a stage is x's 16 KB and the
// table's 16 KB of bytes (TMA, 64-byte swizzle), six stages in the ring, and
// the producer warpgroup only issues copies. Each consumer warpgroup takes 64
// of the block's columns of both tables (up: W1's and W3's, one accumulator
// each, so g and u of a column meet in one thread; down: two 64-column
// slices of W2) over all the tile's rows: 32 (tiles of 32 rows or fewer) or
// 128, the rows past the tile's computed and never stored. Thread (warp wp,
// lane 4 g + t) holds A rows g and g + 8, which stand for table columns
// 16 wp + 2 g and + 1 (any order of A's rows is the same product; the
// epilogue stores each pair side by side), at K rows 2 t, 2 t + 1, 2 t + 8 and
// 2 t + 9 of each k16 step: two bytes a row, read without bank conflicts
// through the swizzle, paired by __byte_perm and converted exactly
// (`byte_pair_bf16`). A k16 step's A is converted while the step before's products run (two
// register buffers; a buffer is refilled once its products are done).
constexpr uint32_t kRaBytes = 4 * kPChunkBytes8;   // a stage's table bytes: 4 chunks of 64 rows x 64 columns
constexpr uint32_t kRaStage = kABytes + kRaBytes;  // 32 KB

struct RaRing {
  static constexpr int kStages = 6;
  static constexpr uint32_t kBarOff = kStages * kRaStage;
  static constexpr size_t kSmem = kBarOff + 2 * kStages * 8 + BM * 4 + 2 * kSetCols * 4 + 1024;
  static_assert(kSmem <= 232448, "past a block's shared memory");
};

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) . B (16 x 128: 128 rows of the stage, K-major).
__device__ __forceinline__ void mma_ra(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32 fp32) += A (64 x 16 bf16, registers) . B (16 x 32: the stage's first 32 rows, K-major).
__device__ __forceinline__ void mma_ra(float (&d)[16], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Two bytes of each of two K rows (w = row k's pair | row k + 1's pair << 16) as the bf16 pair (k, k + 1)
// of one column: sel 0x4240 the first byte of each pair, 0x4341 the second. Exact: a byte r beside 0x43 is
// the bf16 0x43rr, whose sign bit cleared gives 128 + (r & 127) and whose 0xFF80 mask gives 128 (r >= 0)
// or 256 (r < 0); their difference is the byte's value, -128..127, which bf16 holds exactly, so the
// subtraction rounds nothing.
__device__ __forceinline__ uint32_t byte_pair_bf16(uint32_t w, uint32_t sel) {
  const uint32_t t = __byte_perm(w, 0x43u, sel);
  const uint32_t v = t & 0xFF7FFF7Fu, s = t & 0xFF80FF80u;
  const bf162 r = __hsub2(*reinterpret_cast<const bf162*>(&v), *reinterpret_cast<const bf162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One block of the up (UP) or down launch over int8 tables, the transposed product. The arguments are
// swiglu_wgmma_kernel's; map0 / map1 over the tables' bytes in boxes of 64 x 64 rows, 64-byte swizzle.
template <bool UP>
__global__ void __launch_bounds__(kThreads, 1)
    swiglu_ra_kernel(const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
                     const __grid_constant__ CUtensorMap map_a, const bf16* __restrict__ x,
                     const int* __restrict__ row_token, const float* __restrict__ sc0, const float* __restrict__ sc1,
                     const int* __restrict__ sched, bf16* __restrict__ out, int K, int N) {
  constexpr int S = RaRing::kStages;
  constexpr int kBlockCols = UP ? kSetCols : 2 * kSetCols;
  constexpr uint32_t kTmaBytes = (UP ? 0 : kABytes) + kRaBytes;
  constexpr int kLag = S - 2;  // up: stages of A's copies in flight before a producer thread signals one
  const int tile = blockIdx.y;
  const int e = sched[3 * tile], r0 = sched[3 * tile + 1], r1 = sched[3 * tile + 2];
  if (r0 >= r1) return;
  if (r1 - r0 > BM) __trap();  // a schedule built for longer tiles than the kernel's: refused
  const int rows = r1 - r0, n0 = blockIdx.x * kBlockCols;
  const int nr = rows <= 32 ? 32 : BM;  // the product's rows
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms start on 1024-byte boundaries
  uint8_t* tiles = smem_raw + (base - raw);
  const uint32_t full0 = base + RaRing::kBarOff, empty0 = full0 + 8 * S;
  int* tok = reinterpret_cast<int*>(tiles + (RaRing::kBarOff + 2 * S * 8));
  float* scl = reinterpret_cast<float*>(tok + BM);  // the block's columns of s1 and s3 (up) or s2 (down)
  if (UP && threadIdx.x < BM) tok[threadIdx.x] = threadIdx.x < rows ? row_token[r0 + threadIdx.x] : 0;
  if (threadIdx.x >= BM) {
    const int i = threadIdx.x - BM, c = n0 + (UP ? i % kSetCols : i);
    const float* sc = UP && i >= kSetCols ? sc1 : sc0;
    scl[i] = c < N ? sc[(size_t)e * N + c] : 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, (UP ? 128 : 0) + 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int k_tiles = K / BK;
  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {  // the producer warpgroup: copies only
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
    const int pt = threadIdx.x - kConsumers * 128;
    if constexpr (UP) {  // A's rows past the tile's end that the product reads, zeros in every stage once
      const int per = (nr - rows) * 8;
      for (int v = pt; v < S * per; v += 128)
        *reinterpret_cast<uint4*>(tiles + (v / per) * kRaStage + (rows + v % per / 8) * 128 + (v % 8) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    // the table's column of byte chunk c, and its map (up: chunks 0-1 of W1, 2-3 of W3)
    const CUtensorMap* const maps[2] = {&map0, &map1};
    for (int kt = 0; kt < k_tiles && (UP || pt == 0); ++kt) {
      const int s = kt % S;
      const uint32_t a = base + s * kRaStage, b = a + kABytes;
      mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
      if (pt == 0) {
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, kTmaBytes);
        if (!UP) tma_load_2d(a, &map_a, full, kt * BK, r0);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tma_load_3d(b + c * kPChunkBytes8, maps[UP && c >= 2], full, UP ? n0 + 64 * (c & 1) : n0 + 64 * c, kt * BK,
                      e);
      }
      if constexpr (UP) {  // A: x's rows by token, as swiglu_wgmma_kernel stages them
        const int u = pt & 7;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = (pt >> 3) + 16 * i;
          if (r < rows) cp_async16(a + r * 128 + ((u ^ (r & 7)) << 4), x + (size_t)tok[r] * K + kt * BK + 8 * u);
        }
        cp_async_commit();
        if (kt >= kLag) {
          cp_async_wait<kLag>();
          fence_async_smem();
          mbar_arrive(full0 + 8 * ((kt - kLag) % S));
        }
      }
    }
    if constexpr (UP) {
      cp_async_wait<0>();
      fence_async_smem();
      for (int kt = k_tiles > kLag ? k_tiles - kLag : 0; kt < k_tiles; ++kt) mbar_arrive(full0 + 8 * (kt % S));
    }
    return;
  }
  // a consumer: the block's columns 64 wgi .. + 63 of W1 and W3 (up) or 128 wgi .. + 127 of W2 (down)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
  const int tid = threadIdx.x % 128, wp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int ch0 = UP ? wgi : 2 * wgi, ch1 = UP ? 2 + wgi : 2 * wgi + 1;  // the warpgroup's two byte chunks
  // the thread's two columns in each 64-byte row of a chunk: 16-byte unit wp, swizzled by (row / 2) % 4 = t
  const uint32_t col = ((wp ^ t) << 4) + 2 * g;
  auto run = [&](auto rows_c) {
    constexpr int NR = decltype(rows_c)::value;
    float acc0[NR / 2], acc1[NR / 2];
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc0[i] = acc1[i] = 0.0f;
    uint32_t ab[2][8];  // A of two k16 steps: [0..3] from chunk ch0, [4..7] from chunk ch1
    auto convert = [&](const uint8_t* bytes, int ks, uint32_t* a) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint8_t* p = bytes + (hh ? ch1 : ch0) * kPChunkBytes8 + (16 * ks + 2 * t) * 64 + col;
        auto pair = [&](int off) { return (uint32_t)*reinterpret_cast<const uint16_t*>(p + off); };
        const uint32_t w01 = pair(0) | pair(64) << 16, w89 = pair(512) | pair(576) << 16;  // K rows +0 +1, +8 +9
        a[4 * hh] = byte_pair_bf16(w01, 0x4240);      // row g: column 2 g, K rows 2 t, 2 t + 1
        a[4 * hh + 1] = byte_pair_bf16(w01, 0x4341);  // row g + 8: column 2 g + 1
        a[4 * hh + 2] = byte_pair_bf16(w89, 0x4240);  // K rows 2 t + 8, 2 t + 9
        a[4 * hh + 3] = byte_pair_bf16(w89, 0x4341);
      }
    };
    fence_regs(acc0);
    fence_regs(acc1);
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % S;
      mbar_wait(full0 + 8 * s, (kt / S) & 1);
      const uint8_t* bytes = tiles + s * kRaStage + kABytes;
      const uint32_t xa = base + s * kRaStage;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        if (ks >= 2) wgmma_wait<1>();  // step ks - 2's products are done: its A buffer is free
        convert(bytes, ks, ab[ks & 1]);
        wgmma_fence();  // A's registers were written
        const uint64_t db = smem_desc(xa + ks * 32, 16, kGroupBytes);
        mma_ra(acc0, ab[ks & 1], db);
        mma_ra(acc1, ab[ks & 1] + 4, db);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (tid == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free once both warpgroups are done
    }
    // thread (wp, g, t) holds columns 16 wp + 2 g, + 1 of each slice (its A rows g, g + 8) at rows 8 j + 2 t + h
    const int lc = (UP ? 64 : 128) * wgi + 16 * wp + 2 * g;  // the first slice's column in the block
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 8 * j + 2 * t + hh;
        if (r >= rows) continue;
        bf16* dst = out + (size_t)(r0 + r) * N;
        const float a0 = acc0[4 * j + hh], a1 = acc0[4 * j + 2 + hh];
        const float b0 = acc1[4 * j + hh], b1 = acc1[4 * j + 2 + hh];
        if constexpr (UP) {  // g s1 and u s3 of columns c, c + 1
          const int c = n0 + lc;
          if (c < N)
            *reinterpret_cast<bf162*>(dst + c) =
                __floats2bfloat162_rn(silu_f32(a0 * scl[lc]) * (b0 * scl[kSetCols + lc]),
                                      silu_f32(a1 * scl[lc + 1]) * (b1 * scl[kSetCols + lc + 1]));
        } else {  // the two slices, 64 columns apart, times s2
          const int c = n0 + lc;
          if (c < N) *reinterpret_cast<bf162*>(dst + c) = __floats2bfloat162_rn(a0 * scl[lc], a1 * scl[lc + 1]);
          if (c + 64 < N)
            *reinterpret_cast<bf162*>(dst + c + 64) = __floats2bfloat162_rn(b0 * scl[lc + 64], b1 * scl[lc + 65]);
        }
      }
  };
  if (nr == 32) run(std::integral_constant<int, 32>{});
  else run(std::integral_constant<int, BM>{});
}

// A table's tensor map: (E, rows, N) innermost first; bf16 boxes of 64
// columns x 64 rows, 128-byte swizzled; packed int4 bytes in boxes of 64 x 32
// rows, unswizzled; int8 bytes in boxes of 64 x 64 rows, 64-byte swizzled (the
// consumers' two-byte reads of register A meet no bank conflict).
template <Tab T>
static inline bool table_map(CUtensorMap* map, const void* table, int E, int rows, int N) {
  const cuuint64_t esize = T == Tab::kBf16 ? 2 : 1;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * esize, (cuuint64_t)rows * N * esize};
  const cuuint32_t box[3] = {64, (cuuint32_t)(T == Tab::kInt4 ? kPackedRows : BK), 1};
  if constexpr (T == Tab::kBf16) return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, table, dims, strides, box);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, table, dims, strides, box,
                T == Tab::kInt8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

static inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The two launches over one layer's tables: x (tokens, h) bf16 through
// row_token, t1 / t3 (E, h or h/2, m) and t2 (E, m or m/2, h) bf16, packed
// int4 or int8 with fp32 scales s1 / s3 (E, m) and s2 (E, h) (int4, int8),
// sched (n_tiles, 3), hbuf (R, m) bf16, ys (R, h) bf16. h and m multiples of
// 64, x, the tables, hbuf and ys 16-byte aligned, else cudaErrorInvalidValue.
template <Tab T>
static int launch_swiglu(const void* x, const void* row_token, const void* t1, const void* s1, const void* t3,
                         const void* s3, const void* t2, const void* s2, const void* sched, void* hbuf, void* ys,
                         int n_tiles, int R, int E, int h, int m, cudaStream_t st) {
  if (n_tiles == 0) return (int)cudaSuccess;
  if (R < 1 || E < 1 || h % 64 || m % 64 || !aligned16(x) || !aligned16(t1) || !aligned16(t3) || !aligned16(t2) ||
      !aligned16(hbuf) || !aligned16(ys))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m1, m3, m2, ma;
  const int div = T == Tab::kInt4 ? 2 : 1;
  const cuuint64_t a_dims[2] = {(cuuint64_t)m, (cuuint64_t)R}, a_strides[1] = {(cuuint64_t)m * 2};
  const cuuint32_t a_box[2] = {BK, BM};
  if (!table_map<T>(&m1, t1, E, h / div, m) || !table_map<T>(&m3, t3, E, h / div, m) ||
      !table_map<T>(&m2, t2, E, m / div, h) ||
      !encode(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hbuf, a_dims, a_strides, a_box))
    return (int)cudaErrorInvalidValue;
  constexpr bool kRa = T == Tab::kInt8;
  constexpr size_t kSmem = kRa ? RaRing::kSmem : Ring<T>::kSmem;
  auto up = [] {
    if constexpr (kRa) return swiglu_ra_kernel<true>;
    else return swiglu_wgmma_kernel<T, true>;
  }();
  auto down = [] {
    if constexpr (kRa) return swiglu_ra_kernel<false>;
    else return swiglu_wgmma_kernel<T, false>;
  }();
  cudaError_t rc = allow_dynamic_smem(up, kSmem);
  if (rc == cudaSuccess) rc = allow_dynamic_smem(down, kSmem);
  if (rc != cudaSuccess) return (int)rc;
  const int* sc = static_cast<const int*>(sched);
  up<<<dim3((m + kSetCols - 1) / kSetCols, n_tiles), kThreads, kSmem, st>>>(
      m1, m3, ma, static_cast<const bf16*>(x), static_cast<const int*>(row_token), static_cast<const float*>(s1),
      static_cast<const float*>(s3), sc, static_cast<bf16*>(hbuf), h, m);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  down<<<dim3((h + 2 * kSetCols - 1) / (2 * kSetCols), n_tiles), kThreads, kSmem, st>>>(
      m2, m2, ma, nullptr, nullptr, static_cast<const float*>(s2), nullptr, sc, static_cast<bf16*>(ys), m, h);
  return (int)cudaGetLastError();
}

}  // namespace swg
}  // namespace
