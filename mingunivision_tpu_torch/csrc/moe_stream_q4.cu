// Decode-shape MoE over linear int4 tables: sum over routed experts of
// gate * (silu(x@W1[e] * s1) * (x@W3[e] * s3)) @ W2[e] * s2, the weights
// split-halves packed (utils/quantize.py), in two dot modes.
//
// Replaces the TPU kernels mingunivision_tpu/ops/kernels/moe_stream.py
// (moe_experts_stream -> _kernel_q4_s8, the default, and _kernel_q4, under
// moe_int_dots=False). On the H100 the op is bound by the bytes of packed
// weights: one expert is 3 x 1024 x 1408 B = 4.33 MB at the 16B-A3B shape, and
// a 2-row CFG decode step routes up to 12 experts per layer (52 MB, 15.5 us at
// 3.35 TB/s); the activations are a few KB. At a 16-slot serving step some 50
// experts meet 16 rows each: 16 integer dots per weight byte, past what the
// CUDA cores' dp4a keep up with at 3.35 TB/s, so the s8 mode's products run on
// the tensor cores.
//
// S8 (mu_moe_stream_q4s8): the activations quantized per row to the s8
// operand pair (ops/kernels/intdot.py quant_rows_s8_pair: a1 = x_lo - x_hi/16,
// a2 = x_hi), two integer dots per packed table, (w & 0x0F0F0F0F) . a1 and
// (w ^ 0x80808080) . a2, h = silu(g) * u in fp32 re-quantized per row over
// ALL of m before the down dots. Two launches, no other device op, on the
// bf16 kernel's design (moe_stream.cu; the routing, the cp.async copies and
// the ticket merge are moe_decode.cuh's); blocks of 256 threads, 8 warps of
// 32 columns:
//
//   up    grid (64 column pairs (j, j + m/2), slot). Each block first stages
//         the rows of x in its ring, builds the routing (slot s the s-th
//         routed expert in ascending id; blocks of slots past the number
//         routed exit at once) while they arrive, and quantizes them to the
//         s8 pair in shared memory; only then does it start the ring on its
//         tile of W1 and W3 (issued first, the weight copies would hold up
//         x's loads). g and u by the fp32 epilogue times the column scales
//         (read before the ring), h = silu(g) * u in fp32 into the workspace,
//         and the tile's per-row maxima of |h_j - h_{j+m/2} / 16| and
//         |h_{j+m/2}|. The slot's last block (by ticket) re-quantizes the
//         slot's h rows over all of m once, from those maxima, and lowers the
//         ticket: the down blocks then read N x m bytes of s8 each instead of
//         quantizing N x m x 4 bytes of fp32 h themselves (some 72 MB of L2
//         reads over the grid at 16 rows); the cost is one pass of one block
//         per slot over its h from L2 at the end of the slot's tiles (1.9 us
//         at 2 rows, some 11 us at 16 on the card).
//   down  grid (256-column tile of h, slot), launched as the up launch's
//         programmatic dependent: its blocks start as the up launch's blocks
//         exit, build the routing, then wait for the up launch
//         (griddepcontrol.wait) before they start the ring on their tile of
//         W2 with the slot's s8 h rows; y by the epilogue times the column
//         scale into the workspace; the tile's last block sums gate * y over
//         each row's slots in ascending order, each product rounded before
//         the sum, as the plain version does, writes the bf16 output and
//         lowers the tile's ticket.
//
// Each block streams its tile of the packed (E, h/2, m) / (E, m/2, h) tables
// (contraction on rows: a stage is 64 packed rows x 256 bytes, up 64 columns
// of W1 at j and at j + m/2, then of W3, down 256 columns of W2) through a
// ring of shared-memory stages filled by 16-byte cp.async, several stages in
// flight while the block multiplies the oldest: mma.sync.m16n8k32 s8 with
// int32 accumulators, the weight tile as A (the output columns as M), the
// rows as B (N: 8 per n-tile). sm_90 has no 8-bit ldmatrix .trans and wgmma
// wants K-major s8 operands while the tables are column-contiguous, so each
// lane forms its A fragments in registers: it reads one word (4 columns) from
// each of 4 contraction rows and byte-transposes them (transpose4x4) into a
// register per column; the staged rows' 16-byte chunks are swizzled so that
// these reads fall on distinct banks. Every weight byte is read from device
// memory once whatever N. The integer sums are exact in any order, and the
// fp32 epilogue, the row maxima, the scales and the merge keep the plain
// version's steps: the result is its bits.
//
// Exact (mu_moe_stream_q4, moe_int_dots=False): each nibble (-8..7) converted
// to fp32 (exact), products with x's bf16 values summed in fp32 per nibble
// plane (x[:, :h/2] @ lo + x[:, h/2:] @ hi), h = silu(g) * u rounded to bf16
// before the down dots, the scales on the sums; the wrapper builds the unique
// routed experts and their gate rows on the device (expert_slots):
//   phase A  grid (slot, 128-column tile of m): each block stages the rows of
//            x in shared memory as fp32, then g and u: each warp takes the
//            4-row groups warp, warp + 8, ... of the K/2 packed rows, a lane
//            loading one 32-bit word (4 columns) of each row of the group and
//            converting each byte's two nibbles; the 8 warps' partial sums
//            are added in order in shared memory; h goes to device memory;
//   phase B  grid (slot, 128-column tile of h): the down dots the same way;
//   phase C  out = sum over slots of gate * y, in ascending slot order
//            (deterministic, no atomics).
#include "moe_decode.cuh"
#include "q4_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// S8: two launches, the routing built in the kernel, s8 products on the tensor cores
// ---------------------------------------------------------------------------

namespace s8 {

using namespace moe_decode;

constexpr int kThreads = 256;   // 8 warps, 32 columns each
constexpr int kTileK = 64;      // packed rows per stage: two k32 steps
constexpr int kRowBytes = 256;  // a staged row: up 64 column pairs of W1 then of W3; down 256 columns of W2
constexpr int kChunks = kRowBytes / 16;
constexpr int kStageBytes = kTileK * kRowBytes;
constexpr int kUpPairs = 64;                 // up: column pairs (j, j + m/2) per block
constexpr int kDownCols = kThreads;          // down: columns of h per block: one per thread in the merge
static_assert(8 * 32 == kRowBytes && 4 * kUpPairs == kRowBytes && kDownCols == kRowBytes, "a warp per 32 bytes");

// ring depth by n-tiles: two blocks on an SM at up to 16 rows
template <int NT>
struct Ring {
  static constexpr int kStages = NT <= 2 ? 4 : 3;
};

// Pitch in bytes of a staged s8 operand row of `half` (a multiple of 64)
// contraction values: + 16, so that a B fragment's 8 rows x 4 words fall on
// 32 distinct banks.
__host__ __device__ constexpr int op_pitch(int half) { return half + 16; }

// Where 16-byte chunk c of staged row k lies: the chunk index XOR 2 * ((k / 4)
// % 4), so that the four 4-row groups an A fragment's word reads span fall on
// distinct banks (every row starts on bank 0).
__device__ __forceinline__ int swizzled(int k, int c) { return k * kRowBytes + ((c ^ (((k >> 2) & 3) << 1)) << 4); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) { cp_async16_zfill(dst, src, true); }

// The byte offset, within a staged row, of the word lane (g, t) reads for the
// warp's 32 columns at byte `col` of the row (columns col + 4g .. + 3; the
// swizzle of each row it reads is 2t).
__device__ __forceinline__ int a_offset(int col, int lane) {
  const int g = lane >> 2, t = lane & 3;
  return ((((col >> 4) + (g >> 2)) ^ (2 * t)) << 4) + ((4 * g) & 15);
}

// The warp's two integer dots over one staged tile of kTileK packed rows
// (q4_k32 per k32 step, q4_mma.cuh). A: lane (g, t) reads, for contraction
// rows kk + 16 hf + 4t + r (r < 4), the word of its 4 columns. B: the rows'
// s8 operands a1, a2 (pitch ld) from contraction row k0. Accumulator element i
// of d[p][nt] is column 4g + 2p + i / 2, row nt * 8 + 2t + i % 2.
template <int NT>
__device__ __forceinline__ void tile_dots(const unsigned char* stage, int a_off, const int8_t* a1, const int8_t* a2,
                                          int ld, int k0, int (&d1)[2][NT][4], int (&d2)[2][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 32) {
    uint32_t b1[NT][2], b2[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int off = (nt * 8 + g) * ld + k0 + kk + 4 * t;
      b1[nt][0] = *reinterpret_cast<const uint32_t*>(a1 + off);
      b1[nt][1] = *reinterpret_cast<const uint32_t*>(a1 + off + 16);
      b2[nt][0] = *reinterpret_cast<const uint32_t*>(a2 + off);
      b2[nt][1] = *reinterpret_cast<const uint32_t*>(a2 + off + 16);
    }
    uint32_t w[2][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[hf][r] = *reinterpret_cast<const uint32_t*>(stage + (kk + 16 * hf + 4 * t + r) * kRowBytes + a_off);
    q4_k32<NT>(w, b1, b2, d1, d2);
  }
}

// The ring over KT stages: `load(s, kt)` issues stage kt's copies into ring
// slot s; the caller has committed the first S - 1 groups. Every thread calls it.
template <int NT, int S, typename Load>
__device__ __forceinline__ void stream_dots(unsigned char* ring, Load load, int KT, int a_off, const int8_t* a1,
                                            const int8_t* a2, int ld, int (&d1)[2][NT][4], int (&d2)[2][NT][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) d1[p][nt][i] = d2[p][nt][i] = 0;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage kt arrived for every thread; every warp is done with the stage overwritten next
    if (kt + S - 1 < KT) load((kt + S - 1) % S, kt + S - 1);
    cp_async_commit();
    tile_dots<NT>(ring + (kt % S) * kStageBytes, a_off, a1, a2, ld, kt * kTileK, d1, d2);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and the staged operands are free
}

// The column scales a thread's accumulators need (columns 4g + 2p + q of the
// warp's 32 at `sc`), read before the ring so that the epilogue waits on none.
__device__ __forceinline__ void load_scales(const float* sc, float (&v)[2][2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) v[p][q] = __ldg(sc + 4 * g + 2 * p + q);
}

// The accumulators times the column scales through the fp32 epilogue, as
// `put(row, column of the warp's 32, value)` for the rows < N.
template <int NT, typename Put>
__device__ __forceinline__ void epilogue(const int (&d1)[2][NT][4], const int (&d2)[2][NT][4], const float* st,
                                         const float (&scale)[2][2], int N, Put put) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * t + (i & 1);
        if (n < N) put(n, 4 * g + 2 * p + (i >> 1), __fmul_rn(mm4_epilogue(d1[p][nt][i], d2[p][nt][i], st + 4 * n),
                                                               scale[p][i >> 1]));
      }
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& v, float (&f)[8]) {
  const bf162* p = reinterpret_cast<const bf162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// Non-negative floats compare as their bits: the row maxima go through atomicMax on unsigned.
__device__ __forceinline__ void max_to(unsigned* p, float v, bool warp_uniform) {
  if (warp_uniform) {
    v = warp_max(v);
    if ((threadIdx.x & 31) == 0) atomicMax(p, __float_as_uint(v));
  } else {
    atomicMax(p, __float_as_uint(v));
  }
}
__device__ __forceinline__ void add_to(int* p, int v, bool warp_uniform) {
  if (warp_uniform) {
    v = __reduce_add_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) atomicAdd(p, v);
  } else {
    atomicAdd(p, v);
  }
}

// Rows [r0, r0 + nr) of x, staged in shared memory as bf16 (xs, h values a
// row), to the s8 pair: a1, a2 rows of pitch ld and st[4 n ..] = sa1, sa2,
// corr. A thread per 8-value chunk of both halves; the rows' maxima and sums
// in row_max, row_sum (at least nr rows).
__device__ void quant_x_rows(const bf16* xs, int r0, int nr, int h, int8_t* a1, int8_t* a2, int ld, float* st,
                             unsigned (*row_max)[2], int (*row_sum)[2]) {
  const int tid = threadIdx.x, half = h / 2, C = half / 8;
  const bool uniform = C % 32 == 0;  // a warp's chunks lie in one row
  if (tid < nr) row_max[tid][0] = row_max[tid][1] = 0u, row_sum[tid][0] = row_sum[tid][1] = 0;
  __syncthreads();
  for (int i = tid; i < nr * C; i += kThreads) {
    const int r = i / C, c = i % C;
    float lo[8], hi[8], m1 = 0.0f, m2 = 0.0f;
    unpack_bf16x8(reinterpret_cast<const uint4*>(xs + (size_t)r * h)[c], lo);
    unpack_bf16x8(reinterpret_cast<const uint4*>(xs + (size_t)r * h + half)[c], hi);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      m1 = fmaxf(m1, fabsf(pair_c1(lo[e], hi[e])));
      m2 = fmaxf(m2, fabsf(hi[e]));
    }
    max_to(&row_max[r][0], m1, uniform);
    max_to(&row_max[r][1], m2, uniform);
  }
  __syncthreads();
  for (int i = tid; i < nr * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const float sa1 = pair_scale(__uint_as_float(row_max[r][0])), sa2 = pair_scale(__uint_as_float(row_max[r][1]));
    float lo[8], hi[8];
    unpack_bf16x8(reinterpret_cast<const uint4*>(xs + (size_t)r * h)[c], lo);
    unpack_bf16x8(reinterpret_cast<const uint4*>(xs + (size_t)r * h + half)[c], hi);
    int q1[8], q2[8], t1 = 0, t2 = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      q1[e] = pair_q(pair_c1(lo[e], hi[e]), sa1);
      q2[e] = pair_q(hi[e], sa2);
      t1 += q1[e];
      t2 += q2[e];
    }
    *reinterpret_cast<uint2*>(a1 + (r0 + r) * ld + 8 * c) =
        make_uint2(pack_s8(q1[0], q1[1], q1[2], q1[3]), pack_s8(q1[4], q1[5], q1[6], q1[7]));
    *reinterpret_cast<uint2*>(a2 + (r0 + r) * ld + 8 * c) =
        make_uint2(pack_s8(q2[0], q2[1], q2[2], q2[3]), pack_s8(q2[4], q2[5], q2[6], q2[7]));
    add_to(&row_sum[r][0], t1, uniform);
    add_to(&row_sum[r][1], t2, uniform);
  }
  __syncthreads();
  if (tid < nr) {
    const float sa1 = pair_scale(__uint_as_float(row_max[tid][0])), sa2 = pair_scale(__uint_as_float(row_max[tid][1]));
    st[4 * (r0 + tid)] = sa1;
    st[4 * (r0 + tid) + 1] = sa2;
    st[4 * (r0 + tid) + 2] = pair_corr(row_sum[tid][0], row_sum[tid][1], sa1, sa2);
  }
}

// up: hbuf (n_slots, N, m) fp32 <- silu(g) * u of slot blockIdx.y at the
// column pairs (j, j + m/2), j in [64 * blockIdx.x, + 64); hmax (n_slots, T,
// N) each tile's per-row maxima of |h_j - h_{j+m/2} / 16| and |h_{j+m/2}|.
// Each block quantizes the rows of x itself first: they are staged in its
// ring (at most the ring's bytes at a time) while it builds the routing, and
// only then does it start the ring on the weights. The block exits without a
// trigger, so the down launch starts as the blocks exit. The slot's last block
// (by ticket) writes hq[slot]: a1 (RP, m/2), a2 (RP, m/2) s8 of h re-quantized per
// row over all of m from the tiles' maxima, then per row (sa1, sa2, corr, 0)
// fp32, and lowers the slot's ticket (RP = NT * 8 rows; those past N unused).
template <int NT>
__global__ void __launch_bounds__(kThreads) q4s8_up_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ q1, const float* __restrict__ s1,
    const uint8_t* __restrict__ q3, const float* __restrict__ s3, const void* topk_idx, int idx64,
    float* __restrict__ hbuf, float2* __restrict__ hmax, int8_t* __restrict__ hq, int* __restrict__ tickets, int N,
    int K, int E, int h, int m) {
  constexpr int S = Ring<NT>::kStages, RP = NT * 8;
  __shared__ Routing R;
  __shared__ float row_scale[kMaxRows][2];
  __shared__ int row_sum[kMaxRows][2];
  __shared__ unsigned x_max[kMaxRows][2];
  __shared__ bool last;
  const int slot = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hh = h / 2, mh = m / 2, ldx = op_pitch(hh), p0 = blockIdx.x * kUpPairs, T = gridDim.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* xa1 = reinterpret_cast<int8_t*>(smem_raw + S * kStageBytes);
  int8_t* xa2 = xa1 + RP * ldx;
  float* st = reinterpret_cast<float*>(xa2 + RP * ldx);  // [RP][4]: sa1, sa2, corr of each row of x
  const int batch = min(N, S * kStageBytes / (2 * h));  // rows of x the ring holds as bf16
  auto stage_x = [&](int r0) {
    const int chunks = min(batch, N - r0) * h / 8;
    for (int i = tid; i < chunks; i += kThreads) cp_async16(smem_raw + 16 * i, x + (size_t)r0 * h + 8 * i);
    cp_async_commit();
  };
  stage_x(0);  // first, while the routing is built
  build_routing(R, topk_idx, idx64, nullptr, 0, false, N, K, E, slot);
  if (slot >= R.n_unique) {
    cp_async_wait<0>();
    return;
  }
  for (int r0 = 0; r0 < N; r0 += batch) {
    if (r0 > 0) stage_x(r0);
    cp_async_wait<0>();
    __syncthreads();
    quant_x_rows(reinterpret_cast<const bf16*>(smem_raw), r0, min(batch, N - r0), h, xa1, xa2, ldx, st, x_max,
                 row_sum);
    __syncthreads();  // the staged rows are read before the ring (or the next batch) overwrites them
  }

  const size_t table = (size_t)R.expert * hh * m;
  auto load = [&](int s, int kt) {  // staged row: W1 at the 64 j, at the 64 j + m/2, then W3 the same, 64 bytes each
    unsigned char* d = smem_raw + s * kStageBytes;
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const uint8_t* src = (c < 8 ? q1 : q3) + table + (size_t)(kt * kTileK + r) * m + ((c >> 2) & 1) * mh + p0 +
                           (c & 3) * 16;
      cp_async16(d + swizzled(r, c), src);
    }
  };
  const int KT = hh / kTileK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  // warp w: table w / 4 (W1, W3), half (w / 2) % 2 (j, j + m/2), pairs 32 (w % 2) .. + 32
  const int table_u = warp >> 2, cw = (warp & 3) * 32;  // cw: the warp's 32 of the tile's 128 (j's, then j + m/2's)
  float scale[2][2];
  load_scales((table_u ? s3 : s1) + (size_t)R.expert * m + ((warp >> 1) & 1) * mh + p0 + (warp & 1) * 32, scale);
  int d1[2][NT][4], d2[2][NT][4];
  stream_dots<NT, S>(smem_raw, load, KT, a_offset(warp * 32, lane), xa1, xa2, ldx, d1, d2);

  // g (warps 0-3) and u (warps 4-7) into shared memory, then h = silu(g) * u
  float* gu = reinterpret_cast<float*>(smem_raw);  // [2][RP][128]: the 64 j, then the 64 j + m/2
  epilogue<NT>(d1, d2, st, scale, N, [&](int n, int c, float v) { gu[(table_u * RP + n) * 128 + cw + c] = v; });
  __syncthreads();
  float* hs = hbuf + (size_t)slot * N * m;
  for (int i = tid; i < N * 128; i += kThreads) {
    const int n = i / 128, c = i % 128;
    const float hv = __fmul_rn(silu_exact(gu[i]), gu[RP * 128 + i]);
    gu[i] = hv;
    hs[(size_t)n * m + (c >> 6) * mh + p0 + (c & 63)] = hv;
  }
  __syncthreads();
  for (int n = warp; n < N; n += kThreads / 32) {  // the tile's row maxima, a warp per row
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float lo = gu[n * 128 + 32 * j + lane], hi = gu[n * 128 + 64 + 32 * j + lane];
      m1 = fmaxf(m1, fabsf(pair_c1(lo, hi)));
      m2 = fmaxf(m2, fabsf(hi));
    }
    m1 = warp_max(m1);
    m2 = warp_max(m2);
    if (lane == 0) hmax[((size_t)slot * T + blockIdx.x) * N + n] = make_float2(m1, m2);
  }

  // the block's writes, one fence, the slot's ticket; the slot's last block quantizes its h
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&tickets[slot], 1) == T - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float2* tmax = hmax + (size_t)slot * T * N;
  for (int n = warp; n < N; n += kThreads / 32) {  // the rows' scales over the tiles (T <= 32)
    float2 v = lane < T ? __ldcg(tmax + (size_t)lane * N + n) : make_float2(0.0f, 0.0f);
    v.x = warp_max(v.x);
    v.y = warp_max(v.y);
    if (lane == 0) {
      row_scale[n][0] = pair_scale(v.x);
      row_scale[n][1] = pair_scale(v.y);
      row_sum[n][0] = row_sum[n][1] = 0;
    }
  }
  __syncthreads();
  // every (row, 4-pair chunk) of the slot's h, four chunks a thread in flight at a time
  int8_t* q = hq + (size_t)slot * RP * (m + 16);
  const int per_row = mh / 4, total = N * per_row;
  for (int c0 = 0; c0 < total; c0 += 4 * kThreads) {
    float4 lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j * kThreads + tid;
      if (c < total) {
        const float* hr = hs + (size_t)(c / per_row) * m + 4 * (c % per_row);
        lo[j] = __ldcg(reinterpret_cast<const float4*>(hr));
        hi[j] = __ldcg(reinterpret_cast<const float4*>(hr + mh));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j * kThreads + tid;
      if (c >= total) continue;
      const int n = c / per_row, i = c % per_row;
      const float sa1 = row_scale[n][0], sa2 = row_scale[n][1];
      const int a0 = pair_q(pair_c1(lo[j].x, hi[j].x), sa1), a1 = pair_q(pair_c1(lo[j].y, hi[j].y), sa1);
      const int a2 = pair_q(pair_c1(lo[j].z, hi[j].z), sa1), a3 = pair_q(pair_c1(lo[j].w, hi[j].w), sa1);
      const int b0 = pair_q(hi[j].x, sa2), b1 = pair_q(hi[j].y, sa2), b2 = pair_q(hi[j].z, sa2);
      const int b3 = pair_q(hi[j].w, sa2);
      reinterpret_cast<uint32_t*>(q + (size_t)n * mh)[i] = pack_s8(a0, a1, a2, a3);
      reinterpret_cast<uint32_t*>(q + (size_t)(RP + n) * mh)[i] = pack_s8(b0, b1, b2, b3);
      atomicAdd(&row_sum[n][0], a0 + a1 + a2 + a3);
      atomicAdd(&row_sum[n][1], b0 + b1 + b2 + b3);
    }
  }
  __syncthreads();
  if (tid < N) {
    const float sa1 = row_scale[tid][0], sa2 = row_scale[tid][1];
    reinterpret_cast<float4*>(q + (size_t)RP * m)[tid] =
        make_float4(sa1, sa2, pair_corr(row_sum[tid][0], row_sum[tid][1], sa1, sa2), 0.0f);
  }
  if (tid == 0) tickets[slot] = 0;
}

// down: ypart (n_slots, N, h) fp32 <- the slot's quantized h @ W2[e] for
// columns [256 * blockIdx.x, + 256); then the tile's last block writes out
// (N, h) bf16 for those columns. The up launch's programmatic dependent: it
// waits for the up launch (griddepcontrol.wait) before its ring and hq.
template <int NT>
__global__ void __launch_bounds__(kThreads) q4s8_down_kernel(
    const int8_t* __restrict__ hq, const uint8_t* __restrict__ q2, const float* __restrict__ s2, const void* topk_idx,
    int idx64, const void* topk_w, int w_f32, float* __restrict__ ypart, int* __restrict__ tickets,
    bf16* __restrict__ out, int N, int K, int E, int h, int m) {
  constexpr int S = Ring<NT>::kStages, RP = NT * 8;
  __shared__ Routing R;
  __shared__ MergeLists M;
  const int slot = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  build_routing(R, topk_idx, idx64, topk_w, w_f32, true, N, K, E, slot);
  const int U = R.n_unique;
  if (slot >= U) return;
  const int mh = m / 2, ldh = op_pitch(mh), col0 = blockIdx.x * kDownCols;
  const uint8_t* W2 = q2 + (size_t)R.expert * mh * h + col0;
  const int8_t* Q = hq + (size_t)slot * RP * (m + 16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* hb1 = reinterpret_cast<int8_t*>(smem_raw + S * kStageBytes);
  int8_t* hb2 = hb1 + RP * ldh;
  float* st = reinterpret_cast<float*>(hb2 + RP * ldh);  // [RP][4]

  auto load = [&](int s, int kt) {
    unsigned char* d = smem_raw + s * kStageBytes;
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      cp_async16(d + swizzled(r, c), W2 + (size_t)(kt * kTileK + r) * h + c * 16);
    }
  };
  const int KT = mh / kTileK;
  float scale[2][2];
  load_scales(s2 + (size_t)R.expert * h + col0 + warp * 32, scale);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the up launch is done: hq is written
  // the first group: stage 0 and the slot's N quantized h rows (a1, a2) with their scales (rows past N unread)
  load(0, 0);
  for (int i = tid; i < N * (mh / 16); i += kThreads) {
    const int n = i / (mh / 16), c = (i % (mh / 16)) * 16;
    cp_async16(hb1 + n * ldh + c, Q + (size_t)n * mh + c);
    cp_async16(hb2 + n * ldh + c, Q + (size_t)(RP + n) * mh + c);
  }
  for (int n = tid; n < N; n += kThreads) cp_async16(st + 4 * n, Q + (size_t)RP * m + 16 * n);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < S - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  int d1[2][NT][4], d2[2][NT][4];
  stream_dots<NT, S>(smem_raw, load, KT, a_offset(warp * 32, lane), hb1, hb2, ldh, d1, d2);

  // y into shared memory, then the tile's rows to the workspace
  float* ys = reinterpret_cast<float*>(smem_raw);  // [RP][kDownCols]
  epilogue<NT>(d1, d2, st, scale, N, [&](int n, int c, float v) { ys[n * kDownCols + warp * 32 + c] = v; });
  __syncthreads();
  float* yp = ypart + (size_t)slot * N * h + col0;
  for (int i = tid; i < N * kDownCols; i += kThreads) yp[(size_t)(i / kDownCols) * h + i % kDownCols] = ys[i];

  merge_tile<false>(R, M, ypart, tickets, out, N, K, h, col0, U);
}

template <int NT>
int launch(const bf16* x, const uint8_t* q1, const float* s1, const uint8_t* q3, const float* s3, const uint8_t* q2,
           const float* s2, const void* topk_idx, const void* topk_w, float* fbuf, int8_t* qbuf, int* tickets,
           bf16* out, int N, int K, int E, int h, int m, int idx64, int w_f32, cudaStream_t st) {
  constexpr int S = Ring<NT>::kStages, RP = NT * 8;
  const size_t up_smem = (size_t)S * kStageBytes + 2 * RP * op_pitch(h / 2) + RP * 16;
  const size_t down_smem = (size_t)S * kStageBytes + 2 * RP * op_pitch(m / 2) + RP * 16;
  // once per device: the kernels may take the most this instantiation needs (h = m = 2048), set whatever the
  // size, as their static shared memory (the routing) counts against the 48 KB default too
  static unsigned allowed = 0u;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(allowed >> dev & 1u)) {
    const int most = S * kStageBytes + 2 * RP * op_pitch(1024) + RP * 16;
    err = cudaFuncSetAttribute(q4s8_up_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(q4s8_down_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) allowed |= 1u << dev;
  }
  const int n_slots = min(N * K, E), down_tiles = h / kDownCols, up_tiles = m / (2 * kUpPairs);
  // the workspace (the wrapper's q4s8_workspace_sizes): fbuf h (slots x N x m), then the up tiles' row maxima;
  // qbuf each slot's quantized h (RP x (m + 16) bytes); tickets the down tiles', then the slots'
  q4s8_up_kernel<NT><<<dim3(up_tiles, n_slots), kThreads, up_smem, st>>>(
      x, q1, s1, q3, s3, topk_idx, idx64, fbuf, reinterpret_cast<float2*>(fbuf + (size_t)n_slots * N * m), qbuf,
      tickets + down_tiles, N, K, E, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(down_tiles, n_slots);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = down_smem;
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, q4s8_down_kernel<NT>, qbuf, q2, s2, topk_idx, idx64, topk_w, w_f32, fbuf, tickets,
                           out, N, K, E, h, m);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace s8

// ---------------------------------------------------------------------------
// exact dequant: three launches over the wrapper's expert list
// ---------------------------------------------------------------------------

namespace exact {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;  // output columns per block: 32 lanes x 4 bytes

// Shared memory: the staged rows [R][n] fp32, then the per-warp partial sums
// red [kWarps][R][kCols][NACC].
template <int R, int NACC>
struct Smem {
  __host__ __device__ static size_t rows(int n) { return align16((size_t)R * n * sizeof(float)); }
  __host__ __device__ static size_t bytes(int n) { return rows(n) + (size_t)kWarps * R * kCols * NACC * 4; }
};

// Stage R rows of length n (lo half [0, n/2), hi half [n/2, n)) into xf
// [R][n] as fp32. Rows >= nr are zero. `row(r, i)` gives element i of row r.
template <int R, typename Row>
__device__ void stage_rows(Row row, int nr, int n, float* xf) {
  for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
    for (int r = 0; r < R; ++r) xf[r * n + i] = r < nr ? row(r, i) : 0.0f;
  __syncthreads();
}

// The R-row sums of one 128-column tile of NT packed (K/2, ncols) tables:
// acc[r][c][2q], acc[r][c][2q+1] are, for table q, the low- and high-plane
// fp32 sums of column 4 * lane + c. Each warp takes the 4-row groups warp,
// warp + 8, ... of the kh = K/2 packed rows.
template <int R, int NT>
__device__ __forceinline__ void q4_dots(const uint8_t* const (&p)[NT], int kh, size_t ld, const float* xf,
                                        float (&acc)[R][4][2 * NT]) {
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < kh / 4; g += kWarps) {
    const int i = 4 * g;
    uint32_t w[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) w[q][rr] = __ldg(reinterpret_cast<const uint32_t*>(p[q] + (size_t)(i + rr) * ld));
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float lo[NT][4], hi[NT][4];
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = (w[q][rr] >> (8 * c)) & 0xFF;
          lo[q][c] = (float)((b & 15) - 8);
          hi[q][c] = (float)((b >> 4) - 8);
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xl = xf[r * 2 * kh + i + rr], xh = xf[r * 2 * kh + kh + i + rr];
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c][2 * q] = fmaf(xl, lo[q][c], acc[r][c][2 * q]);
            acc[r][c][2 * q + 1] = fmaf(xh, hi[q][c], acc[r][c][2 * q + 1]);
          }
      }
    }
  }
}

// The warps' partial sums of one tile into red, then `emit(r, c, sums)` for each
// row r < nr and column c < valid_cols of the tile, with the NACC sums of all warps.
template <int R, int NACC, typename Emit>
__device__ __forceinline__ void reduce_tile(float (&acc)[R][4][NACC], float* red, int nr, int valid_cols, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < NACC; ++k) red[((size_t)(warp * R + r) * kCols + 4 * lane + c) * NACC + k] = acc[r][c][k];
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx % kCols;
    if (c >= valid_cols) continue;
    float s[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) s[k] = 0;
    for (int wp = 0; wp < kWarps; ++wp)
#pragma unroll
      for (int k = 0; k < NACC; ++k) s[k] += red[((size_t)(wp * R + r) * kCols + c) * NACC + k];
    emit(r, c, s);
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(kThreads) q4_up_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ q1, const float* __restrict__ s1,
    const uint8_t* __restrict__ q3, const float* __restrict__ s3, const int* __restrict__ slot_expert,
    const int* __restrict__ n_unique, float* __restrict__ hbuf, int n_rows, int h, int m) {
  typedef Smem<R, 4> L;
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int hh = h / 2;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < m;  // m % 8 == 0: a word never straddles the edge

  extern __shared__ __align__(16) unsigned char smem[];
  float* xf = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + L::rows(h));

  const uint8_t* const p[2] = {q1 + (size_t)e * hh * m + (active ? col : 0), q3 + (size_t)e * hh * m + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const bf16* xr = x + (size_t)r0 * h;
    stage_rows<R>([&](int r, int i) { return __bfloat162float(xr[(size_t)r * h + i]); }, nr, h, xf);
    float acc[R][4][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][c][k] = 0;
    if (active) q4_dots<R, 2>(p, hh, m, xf, acc);
    reduce_tile<R, 4>(acc, red, nr, m - col0, [&](int r, int c, const float(&s)[4]) {
      const size_t j = (size_t)e * m + col0 + c;
      const float g = __fmul_rn(__fadd_rn(s[0], s[1]), s1[j]);
      const float u = __fmul_rn(__fadd_rn(s[2], s[3]), s3[j]);
      // the down dots' bf16 operand
      const float hv = __fmul_rn(silu_exact(g), u);
      hbuf[((size_t)slot * n_rows + r0 + r) * m + col0 + c] = __bfloat162float(__float2bfloat16(hv));
    });
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads) q4_down_kernel(
    const float* __restrict__ hbuf, const uint8_t* __restrict__ q2, const float* __restrict__ s2,
    const int* __restrict__ slot_expert, const int* __restrict__ n_unique, float* __restrict__ ybuf, int n_rows,
    int h, int m) {
  typedef Smem<R, 2> L;
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int mh = m / 2;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < h;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xf = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + L::rows(m));

  const uint8_t* const p[1] = {q2 + (size_t)e * mh * h + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const float* hr = hbuf + ((size_t)slot * n_rows + r0) * m;
    stage_rows<R>([&](int r, int i) { return hr[(size_t)r * m + i]; }, nr, m, xf);
    float acc[R][4][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c][0] = acc[r][c][1] = 0;
    if (active) q4_dots<R, 1>(p, mh, h, xf, acc);
    reduce_tile<R, 2>(acc, red, nr, h - col0, [&](int r, int c, const float(&s)[2]) {
      const float d = __fadd_rn(s[0], s[1]);
      ybuf[((size_t)slot * n_rows + r0 + r) * h + col0 + c] = __fmul_rn(d, s2[(size_t)e * h + col0 + c]);
    });
  }
}

template <int R>
cudaError_t launch(const bf16* x, const uint8_t* q1, const float* s1, const uint8_t* q3, const float* s3,
                   const uint8_t* q2, const float* s2, const int* slot_expert, const int* n_unique, const float* gates,
                   float* hbuf, float* ybuf, bf16* out, int n_rows, int n_slots, int h, int m, cudaStream_t stream) {
  const size_t up_smem = Smem<R, 4>::bytes(h), down_smem = Smem<R, 2>::bytes(m);
  cudaError_t err = allow_dynamic_smem(q4_up_kernel<R>, up_smem);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(q4_down_kernel<R>, down_smem);
  if (err != cudaSuccess) return err;
  q4_up_kernel<R><<<dim3(n_slots, (m + kCols - 1) / kCols), kThreads, up_smem, stream>>>(
      x, q1, s1, q3, s3, slot_expert, n_unique, hbuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q4_down_kernel<R><<<dim3(n_slots, (h + kCols - 1) / kCols), kThreads, down_smem, stream>>>(
      hbuf, q2, s2, slot_expert, n_unique, ybuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_slot_combine_kernel<<<dim3(n_rows, (h + 255) / 256), 256, 0, stream>>>(ybuf, gates, n_unique, out, n_rows, h);
  return cudaGetLastError();
}

}  // namespace exact

}  // namespace

// S8. x (N, h) bf16; q1/q3 (E, h/2, m) and q2 (E, m/2, h) uint8 split-halves
// packed int4 for ONE layer with fp32 scales s1/s3 (E, 1, m) and s2 (E, 1, h),
// all 16-byte aligned; topk_idx (N, K) int32 (int64 with idx64) and topk_w
// (N, K) bf16 (fp32 with w_f32); workspace, with S = min(N K, E) slots and RP
// = mu_moe_stream_rows_pad(N) (the wrapper's q4s8_workspace_sizes): fbuf S x N
// x max(h, m + m / 64) fp32 (h and the up tiles' row maxima, then the down
// products), qbuf S x RP x (m + 16) bytes (each slot's h quantized), tickets
// h / 256 + S int32, zero before the first launch (every launch pair leaves
// them zero); out (N, h) bf16. 1 <= N <= 64, 1 <= K <= 8, E <= 1024, h a
// multiple of 256 and m of 128 (whole column tiles, whole stages of 64 packed
// rows), each at most 2048 (the wrapper checks; the rows' s8 operands sit in
// shared memory).
extern "C" int mu_moe_stream_q4s8(const void* x, const void* q1, const void* s1, const void* q3, const void* s3,
                                  const void* q2, const void* s2, const void* topk_idx, const void* topk_w, void* fbuf,
                                  void* qbuf, void* tickets, void* out, int N, int K, int E, int h, int m, int idx64,
                                  int w_f32, void* stream) {
  using namespace moe_decode;
  if (N < 1 || N > kMaxRows || K < 1 || K > kMaxK || E < 1 || E > kMaxE || h < 256 || h % 256 || m < 128 ||
      m % 128 || h > 2048 || m > 2048)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t *a = static_cast<const uint8_t*>(q1), *b = static_cast<const uint8_t*>(q3),
                *c = static_cast<const uint8_t*>(q2);
  const float *sa = static_cast<const float*>(s1), *sb = static_cast<const float*>(s3),
              *sc = static_cast<const float*>(s2);
  float* fb = static_cast<float*>(fbuf);
  int8_t* qb = static_cast<int8_t*>(qbuf);
  int* tk = static_cast<int*>(tickets);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pad = rows_pad(N);
#define MU_Q4S8_LAUNCH(NT) \
  s8::launch<NT>(xb, a, sa, b, sb, c, sc, topk_idx, topk_w, fb, qb, tk, ob, N, K, E, h, m, idx64, w_f32, st)
  if (pad == 8) return MU_Q4S8_LAUNCH(1);
  if (pad == 16) return MU_Q4S8_LAUNCH(2);
  if (pad == 32) return MU_Q4S8_LAUNCH(4);
  return MU_Q4S8_LAUNCH(8);
#undef MU_Q4S8_LAUNCH
}

// Exact dequant. x (n_rows, h) bf16; q1/q3 (E, h/2, m) and q2 (E, m/2, h)
// uint8 split-halves packed int4 for ONE layer with fp32 scales s1/s3 (E, 1,
// m) and s2 (E, 1, h); slot_expert (n_slots,) int32 unique routed experts
// first; n_unique (1,) int32; gates (n_slots, n_rows) fp32; scratch hbuf
// (n_slots, n_rows, m) and ybuf (n_slots, n_rows, h) fp32; out (n_rows, h)
// bf16. h and m must be multiples of 8 (the wrapper checks). Rows are taken
// up to four at a time.
extern "C" int mu_moe_stream_q4(const void* x, const void* q1, const void* s1, const void* q3, const void* s3,
                                const void* q2, const void* s2, const void* slot_expert, const void* n_unique,
                                const void* gates, void* hbuf, void* ybuf, void* out, int n_rows, int n_slots, int h,
                                int m, void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t *a = static_cast<const uint8_t*>(q1), *b = static_cast<const uint8_t*>(q3),
                *c = static_cast<const uint8_t*>(q2);
  const float *sa = static_cast<const float*>(s1), *sb = static_cast<const float*>(s3),
              *sc = static_cast<const float*>(s2);
  const int *se = static_cast<const int*>(slot_expert), *nu = static_cast<const int*>(n_unique);
  const float* gt = static_cast<const float*>(gates);
  float *hb = static_cast<float*>(hbuf), *yb = static_cast<float*>(ybuf);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n_rows <= 1)
    err = exact::launch<1>(xb, a, sa, b, sb, c, sc, se, nu, gt, hb, yb, o, n_rows, n_slots, h, m, st);
  else if (n_rows <= 2)
    err = exact::launch<2>(xb, a, sa, b, sb, c, sc, se, nu, gt, hb, yb, o, n_rows, n_slots, h, m, st);
  else
    err = exact::launch<4>(xb, a, sa, b, sb, c, sc, se, nu, gt, hb, yb, o, n_rows, n_slots, h, m, st);
  return (int)err;
}
