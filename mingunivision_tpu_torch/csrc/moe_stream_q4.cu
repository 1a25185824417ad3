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
// experts meet 16 rows each: 16 dots per weight byte, past what the CUDA cores
// keep up with at 3.35 TB/s, so the products of both modes run on the tensor
// cores.
//
// Both modes are two launches and no other device op, on the bf16 kernel's
// design (moe_stream.cu), with the ring of moe_decode.cuh (`ring`: the
// routing, the 16-byte cp.async copies into swizzled stages of 64 packed rows x
// 256 bytes, the down launch as the up launch's programmatic dependent, the
// ticket merge); blocks of 256 threads, 8 warps of 32 columns. Each block
// streams its tile of the packed (E, h/2, m) / (E, m/2, h) tables through the
// ring, several stages in flight while the block multiplies the oldest, the
// weight tile as A (the output columns as M), the rows as B (N: 8 per n-tile).
// sm_90 has no 8-bit ldmatrix .trans and the tables are column-contiguous, so
// each lane forms its A fragments in registers from one word (4 columns) of
// each of 4 staged rows (q4_mma.cuh). Every weight byte is read from device
// memory once whatever N.
//
// S8 (mu_moe_stream_q4s8): the activations quantized per row to the s8
// operand pair (ops/kernels/intdot.py quant_rows_s8_pair: a1 = x_lo - x_hi/16,
// a2 = x_hi), two integer dots per packed table, (w & 0x0F0F0F0F) . a1 and
// (w ^ 0x80808080) . a2 on mma.sync.m16n8k32 s8, h = silu(g) * u in fp32
// re-quantized per row over ALL of m before the down dots:
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
// The integer sums are exact in any order, and the fp32 epilogue, the row
// maxima, the scales and the merge keep the plain version's steps: the
// result is its bits.
//
// Exact (mu_moe_stream_q4, moe_int_dots=False): each nibble (-8..7) converted
// to bf16 in registers (exact), products with x's bf16 values on
// mma.sync.m16n8k16 bf16 with fp32 sums per nibble plane (x[:, :h/2] @ lo,
// x[:, h/2:] @ hi), the scales on the sums, h = silu(g) * u rounded to bf16
// before the down dots, at most kMaxRowsExact (32) rows a launch pair (their bf16
// values sit in shared memory):
//
//   up    grid (128 columns of m, slot). Each block issues the copies of the
//         rows of x into shared memory (once, bf16, as B), builds the routing,
//         then streams its tile of W1 and W3 (a staged row: 128 columns of
//         each); g and u by the epilogue times the column scales, h = silu(g)
//         * u rounded to bf16 into the workspace (slot, N, m).
//   down  grid (256-column tile of h, slot), the up launch's programmatic
//         dependent: the slot's bf16 h rows staged once beside the first
//         stage of W2; y by the epilogue into the workspace, and the ticket
//         merge, each product rounded before the sum, as the plain version.
//
// The products are exact and summed in fp32 in the tensor cores' order, the
// plain version's in its matmul's: the two agree within bf16's precision.
#include "moe_decode.cuh"
#include "q4_mma.cuh"

namespace {

using namespace moe_decode;
using namespace moe_decode::ring;

// ---------------------------------------------------------------------------
// S8: s8 products on the tensor cores
// ---------------------------------------------------------------------------

namespace s8 {

constexpr int kUpPairs = 64;  // up: column pairs (j, j + m/2) per block
static_assert(4 * kUpPairs == kRowBytes, "a staged up row: 64 pairs of W1, then of W3");

// ring depth by n-tiles: two blocks on an SM at up to 16 rows
template <int NT>
struct Ring {
  static constexpr int kStages = NT <= 2 ? 4 : 3;
};

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
    a_words(stage, kk, a_off, w);
    q4_k32<NT>(w, b1, b2, d1, d2);
  }
}

// The two integer dots of a tile over the ring (the caller has committed the first S - 1 groups).
template <int NT, int S, typename Load>
__device__ __forceinline__ void stream_dots(unsigned char* smem, Load load, int KT, int a_off, const int8_t* a1,
                                            const int8_t* a2, int ld, int (&d1)[2][NT][4], int (&d2)[2][NT][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) d1[p][nt][i] = d2[p][nt][i] = 0;
  stream<S>(smem, load, KT, [&](const unsigned char* stage, int kt) {
    tile_dots<NT>(stage, a_off, a1, a2, ld, kt * kTileK, d1, d2);
  });
}

// The fp32 epilogue of the two integer dots (st: the rows' sa1, sa2, corr, 4 a row).
template <int NT, typename Put>
__device__ __forceinline__ void epilogue2(const int (&d1)[2][NT][4], const int (&d2)[2][NT][4], const float* st,
                                          const float (&scale)[2][2], int N, Put put) {
  epilogue<NT>(scale, N, [&](int p, int nt, int i, int n) { return mm4_epilogue(d1[p][nt][i], d2[p][nt][i], st + 4 * n); },
               put);
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
  prime<S>(load, KT);
  // warp w: table w / 4 (W1, W3), half (w / 2) % 2 (j, j + m/2), pairs 32 (w % 2) .. + 32
  const int table_u = warp >> 2, cw = (warp & 3) * 32;  // cw: the warp's 32 of the tile's 128 (j's, then j + m/2's)
  float scale[2][2];
  load_scales((table_u ? s3 : s1) + (size_t)R.expert * m + ((warp >> 1) & 1) * mh + p0 + (warp & 1) * 32, scale);
  int d1[2][NT][4], d2[2][NT][4];
  stream_dots<NT, S>(smem_raw, load, KT, a_offset(warp * 32, lane), xa1, xa2, ldx, d1, d2);

  // g (warps 0-3) and u (warps 4-7) into shared memory, then h = silu(g) * u
  float* gu = reinterpret_cast<float*>(smem_raw);  // [2][RP][128]: the 64 j, then the 64 j + m/2
  epilogue2<NT>(d1, d2, st, scale, N, [&](int n, int c, float v) { gu[(table_u * RP + n) * 128 + cw + c] = v; });
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
  if (!last_block(&tickets[slot], T)) return;
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

  auto load = [&](int s, int kt) { load_tile(smem_raw + s * kStageBytes, W2, h, kt); };
  const int KT = mh / kTileK;
  float scale[2][2];
  load_scales(s2 + (size_t)R.expert * h + col0 + warp * 32, scale);
  wait_for_up();  // hq is written
  // the first group: stage 0 and the slot's N quantized h rows (a1, a2) with their scales (rows past N unread)
  load(0, 0);
  for (int i = tid; i < N * (mh / 16); i += kThreads) {
    const int n = i / (mh / 16), c = (i % (mh / 16)) * 16;
    cp_async16(hb1 + n * ldh + c, Q + (size_t)n * mh + c);
    cp_async16(hb2 + n * ldh + c, Q + (size_t)(RP + n) * mh + c);
  }
  for (int n = tid; n < N; n += kThreads) cp_async16(st + 4 * n, Q + (size_t)RP * m + 16 * n);
  cp_async_commit();
  prime<S>(load, KT, 1);
  int d1[2][NT][4], d2[2][NT][4];
  stream_dots<NT, S>(smem_raw, load, KT, a_offset(warp * 32, lane), hb1, hb2, ldh, d1, d2);

  // y into shared memory, then the tile's rows to the workspace
  float* ys = reinterpret_cast<float*>(smem_raw);  // [RP][kDownCols]
  epilogue2<NT>(d1, d2, st, scale, N, [&](int n, int c, float v) { ys[n * kDownCols + warp * 32 + c] = v; });
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
  // once per device: the most this instantiation needs (h = m = 2048), whatever the size
  static unsigned allowed = 0u;
  cudaError_t err = allow_once(allowed, q4s8_up_kernel<NT>, q4s8_down_kernel<NT>,
                               S * kStageBytes + 2 * RP * op_pitch(1024) + RP * 16);
  if (err != cudaSuccess) return (int)err;
  const int n_slots = min(N * K, E), down_tiles = h / kDownCols, up_tiles = m / (2 * kUpPairs);
  // the workspace (the wrapper's q4s8_workspace_sizes): fbuf h (slots x N x m), then the up tiles' row maxima;
  // qbuf each slot's quantized h (RP x (m + 16) bytes); tickets the down tiles', then the slots'
  q4s8_up_kernel<NT><<<dim3(up_tiles, n_slots), kThreads, up_smem, st>>>(
      x, q1, s1, q3, s3, topk_idx, idx64, fbuf, reinterpret_cast<float2*>(fbuf + (size_t)n_slots * N * m), qbuf,
      tickets + down_tiles, N, K, E, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dependent(q4s8_down_kernel<NT>, dim3(down_tiles, n_slots), down_smem, st, qbuf, q2, s2, topk_idx,
                               idx64, topk_w, w_f32, fbuf, tickets, out, N, K, E, h, m);
}

}  // namespace s8

// ---------------------------------------------------------------------------
// Exact: bf16 products of the converted nibbles on the tensor cores
// ---------------------------------------------------------------------------

namespace exact {

constexpr int kMaxRowsExact = 32;  // rows per launch pair: their bf16 values sit in shared memory
constexpr int kUpCols = 128;       // up: columns of m per block, of W1 and of W3

// ring depth by n-tiles: two blocks on an SM at 1 n-tile (up and down) and 2 (down); one block a deeper ring else
template <int NT>
struct Ring {
  static constexpr int kUp = NT == 1 ? 4 : NT == 2 ? 5 : 3;
  static constexpr int kDown = NT == 1 ? 4 : 3;
};

// Elements of a staged bf16 row of n values: + 16, so that each half-warp's 8-byte B reads (4 rows x 32 bytes) fall
// on 32 distinct banks.
__host__ __device__ constexpr int bf16_pitch(int n) { return n + 16; }

// The warp's exact dots of one staged tile of kTileK packed rows (q4_bf16_k32 per 32 packed rows): B from the
// staged bf16 rows `rows` (pitch ld elements), the low plane's values from k0, the high plane's from half + k0.
template <int NT>
__device__ __forceinline__ void tile_dots(const unsigned char* stage, int a_off, const bf16* rows, int ld, int half,
                                          int k0, float (&d)[2][2][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 32) {
    uint2 b[NT][2][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          b[nt][hf][q] =
              *reinterpret_cast<const uint2*>(rows + (nt * 8 + g) * ld + q * half + k0 + kk + 16 * hf + 4 * t);
    uint32_t w[2][4];
    a_words(stage, kk, a_off, w);
    q4_bf16_k32<NT>(w, b, d);
  }
}

// The planes' sums of a tile over the ring (the caller has committed the first S - 1 groups).
template <int NT, int S, typename Load>
__device__ __forceinline__ void stream_dots(unsigned char* smem, Load load, int KT, int a_off, const bf16* rows,
                                            int ld, int half, float (&d)[2][2][NT][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[q][p][nt][i] = 0.0f;
  stream<S>(smem, load, KT, [&](const unsigned char* stage, int kt) {
    tile_dots<NT>(stage, a_off, rows, ld, half, kt * kTileK, d);
  });
}

// up: hbuf (n_slots, N, m) bf16 <- silu(g) * u of slot blockIdx.y at columns [128 * blockIdx.x, + 128): g, u the
// planes' fp32 sums added, times the column scales. The rows of x are copied into shared memory first, while the
// routing is built; the block exits without a trigger, so the down launch starts as the blocks exit.
template <int NT>
__global__ void __launch_bounds__(kThreads) q4_up_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ q1, const float* __restrict__ s1,
    const uint8_t* __restrict__ q3, const float* __restrict__ s3, const void* topk_idx, int idx64,
    bf16* __restrict__ hbuf, int N, int K, int E, int h, int m) {
  constexpr int S = Ring<NT>::kUp, RP = NT * 8;
  __shared__ Routing R;
  const int slot = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hh = h / 2, ldx = bf16_pitch(h), p0 = blockIdx.x * kUpCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + S * kStageBytes);  // [RP][ldx]: rows past N unwritten (their
                                                                    // products unread)
  for (int i = tid; i < N * (h / 8); i += kThreads) {
    const int n = i / (h / 8), c = (i % (h / 8)) * 8;
    cp_async16(xs + n * ldx + c, x + (size_t)n * h + c);
  }
  cp_async_commit();  // the first group, while the routing is built
  build_routing(R, topk_idx, idx64, nullptr, 0, false, N, K, E, slot);
  if (slot >= R.n_unique) {
    cp_async_wait<0>();
    return;
  }
  const size_t table = (size_t)R.expert * hh * m;
  auto load = [&](int s, int kt) { load_pair_tiles(smem_raw + s * kStageBytes, q1 + table, q3 + table, m, kt, p0); };
  const int KT = hh / kTileK;
  prime<S>(load, KT);
  const int table_u = warp >> 2, cw = (warp & 3) * 32;  // warp w: table w / 4 (W1, W3), columns cw .. + 32
  float scale[2][2];
  load_scales((table_u ? s3 : s1) + (size_t)R.expert * m + p0 + cw, scale);
  float d[2][2][NT][4];
  stream_dots<NT, S>(smem_raw, load, KT, a_offset(warp * 32, lane), xs, ldx, hh, d);

  // g (warps 0-3) and u (warps 4-7) into shared memory, then h = silu(g) * u rounded to bf16
  float* gu = reinterpret_cast<float*>(smem_raw);  // [2][RP][128]
  epilogue<NT>(scale, N, [&](int p, int nt, int i, int) { return __fadd_rn(d[0][p][nt][i], d[1][p][nt][i]); },
               [&](int n, int c, float v) { gu[(table_u * RP + n) * kUpCols + cw + c] = v; });
  __syncthreads();
  bf16* hs = hbuf + (size_t)slot * N * m + p0;
  for (int i = tid; i < N * kUpCols / 2; i += kThreads) {
    const int n = i / (kUpCols / 2), c = 2 * (i % (kUpCols / 2));
    const float* gr = gu + n * kUpCols + c;
    const float* ur = gu + (RP + n) * kUpCols + c;
    *reinterpret_cast<bf162*>(hs + (size_t)n * m + c) =
        __floats2bfloat162_rn(__fmul_rn(silu_exact(gr[0]), ur[0]), __fmul_rn(silu_exact(gr[1]), ur[1]));
  }
}

// down: ypart (n_slots, N, h) fp32 <- the slot's bf16 h @ W2[e] times the column scale, for columns [256 *
// blockIdx.x, + 256); then the tile's last block writes out (N, h) bf16 for those columns. The up launch's
// programmatic dependent: it waits for the up launch before it reads h.
template <int NT>
__global__ void __launch_bounds__(kThreads) q4_down_kernel(
    const bf16* __restrict__ hbuf, const uint8_t* __restrict__ q2, const float* __restrict__ s2, const void* topk_idx,
    int idx64, const void* topk_w, int w_f32, float* __restrict__ ypart, int* __restrict__ tickets,
    bf16* __restrict__ out, int N, int K, int E, int h, int m) {
  constexpr int S = Ring<NT>::kDown, RP = NT * 8;
  __shared__ Routing R;
  __shared__ MergeLists M;
  const int slot = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  build_routing(R, topk_idx, idx64, topk_w, w_f32, true, N, K, E, slot);
  const int U = R.n_unique;
  if (slot >= U) return;
  const int mh = m / 2, ldh = bf16_pitch(m), col0 = blockIdx.x * kDownCols;
  const uint8_t* W2 = q2 + (size_t)R.expert * mh * h + col0;
  const bf16* H = hbuf + (size_t)slot * N * m;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + S * kStageBytes);  // [RP][ldh], rows past N unwritten

  auto load = [&](int s, int kt) { load_tile(smem_raw + s * kStageBytes, W2, h, kt); };
  const int KT = mh / kTileK;
  float scale[2][2];
  load_scales(s2 + (size_t)R.expert * h + col0 + warp * 32, scale);
  wait_for_up();  // h is written
  load(0, 0);  // the first group: stage 0 and the slot's N rows of h
  for (int i = tid; i < N * (m / 8); i += kThreads) {
    const int n = i / (m / 8), c = (i % (m / 8)) * 8;
    cp_async16(hs + n * ldh + c, H + (size_t)n * m + c);
  }
  cp_async_commit();
  prime<S>(load, KT, 1);
  float d[2][2][NT][4];
  stream_dots<NT, S>(smem_raw, load, KT, a_offset(warp * 32, lane), hs, ldh, mh, d);

  float* ys = reinterpret_cast<float*>(smem_raw);  // [RP][kDownCols]
  epilogue<NT>(scale, N, [&](int p, int nt, int i, int) { return __fadd_rn(d[0][p][nt][i], d[1][p][nt][i]); },
               [&](int n, int c, float v) { ys[n * kDownCols + warp * 32 + c] = v; });
  __syncthreads();
  float* yp = ypart + (size_t)slot * N * h + col0;
  for (int i = tid; i < N * kDownCols; i += kThreads) yp[(size_t)(i / kDownCols) * h + i % kDownCols] = ys[i];

  merge_tile<false>(R, M, ypart, tickets, out, N, K, h, col0, U);
}

template <int NT>
int launch(const bf16* x, const uint8_t* q1, const float* s1, const uint8_t* q3, const float* s3, const uint8_t* q2,
           const float* s2, const void* topk_idx, const void* topk_w, float* ypart, bf16* hbuf, int* tickets,
           bf16* out, int N, int K, int E, int h, int m, int idx64, int w_f32, cudaStream_t st) {
  using Rg = Ring<NT>;
  constexpr int RP = NT * 8;
  auto smem = [](int stages, int n) { return (size_t)stages * kStageBytes + (size_t)RP * bf16_pitch(n) * 2; };
  static unsigned allowed = 0u;  // once per device: the most this instantiation needs (h = m = 2048)
  const size_t most = smem(Rg::kUp, 2048) > smem(Rg::kDown, 2048) ? smem(Rg::kUp, 2048) : smem(Rg::kDown, 2048);
  cudaError_t err = allow_once(allowed, q4_up_kernel<NT>, q4_down_kernel<NT>, (int)most);
  if (err != cudaSuccess) return (int)err;
  const int n_slots = min(N * K, E), down_tiles = h / kDownCols;
  // the workspace (the wrapper's q4_workspace_sizes): ypart, hbuf (slots x N x m bf16), the down tiles' tickets
  q4_up_kernel<NT><<<dim3(m / kUpCols, n_slots), kThreads, smem(Rg::kUp, h), st>>>(x, q1, s1, q3, s3, topk_idx,
                                                                                   idx64, hbuf, N, K, E, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dependent(q4_down_kernel<NT>, dim3(down_tiles, n_slots), smem(Rg::kDown, m), st, hbuf, q2, s2,
                               topk_idx, idx64, topk_w, w_f32, ypart, tickets, out, N, K, E, h, m);
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
// them zero); out (N, h) bf16. 1 <= N <= 64 and the shapes of ring::shape_ok
// (the wrapper checks).
extern "C" int mu_moe_stream_q4s8(const void* x, const void* q1, const void* s1, const void* q3, const void* s3,
                                  const void* q2, const void* s2, const void* topk_idx, const void* topk_w, void* fbuf,
                                  void* qbuf, void* tickets, void* out, int N, int K, int E, int h, int m, int idx64,
                                  int w_f32, void* stream) {
  if (!moe_decode::ring::shape_ok(N, moe_decode::kMaxRows, K, E, h, m)) return (int)cudaErrorInvalidValue;
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
  const int pad = moe_decode::rows_pad(N);
#define MU_Q4S8_LAUNCH(NT) \
  s8::launch<NT>(xb, a, sa, b, sb, c, sc, topk_idx, topk_w, fb, qb, tk, ob, N, K, E, h, m, idx64, w_f32, st)
  if (pad == 8) return MU_Q4S8_LAUNCH(1);
  if (pad == 16) return MU_Q4S8_LAUNCH(2);
  if (pad == 32) return MU_Q4S8_LAUNCH(4);
  return MU_Q4S8_LAUNCH(8);
#undef MU_Q4S8_LAUNCH
}

// Exact dequant. x, the tables, topk_idx and topk_w as for mu_moe_stream_q4s8;
// workspace, with S = min(N K, E) slots (the wrapper's q4_workspace_sizes):
// ypart S x N x h fp32 (the down products), hbuf S x N x m bf16 (h), tickets
// h / 256 int32, zero before the first launch (every launch pair leaves them
// zero); out (N, h) bf16. 1 <= N <= 32 and the shapes of ring::shape_ok (the
// wrapper checks).
extern "C" int mu_moe_stream_q4(const void* x, const void* q1, const void* s1, const void* q3, const void* s3,
                                const void* q2, const void* s2, const void* topk_idx, const void* topk_w, void* ypart,
                                void* hbuf, void* tickets, void* out, int N, int K, int E, int h, int m, int idx64,
                                int w_f32, void* stream) {
  if (!moe_decode::ring::shape_ok(N, exact::kMaxRowsExact, K, E, h, m)) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t *a = static_cast<const uint8_t*>(q1), *b = static_cast<const uint8_t*>(q3),
                *c = static_cast<const uint8_t*>(q2);
  const float *sa = static_cast<const float*>(s1), *sb = static_cast<const float*>(s3),
              *sc = static_cast<const float*>(s2);
  float* yb = static_cast<float*>(ypart);
  bf16* hb = static_cast<bf16*>(hbuf);
  int* tk = static_cast<int*>(tickets);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pad = moe_decode::rows_pad(N);
#define MU_Q4_LAUNCH(NT) \
  exact::launch<NT>(xb, a, sa, b, sb, c, sc, topk_idx, topk_w, yb, hb, tk, ob, N, K, E, h, m, idx64, w_f32, st)
  if (pad == 8) return MU_Q4_LAUNCH(1);
  if (pad == 16) return MU_Q4_LAUNCH(2);
  return MU_Q4_LAUNCH(4);
#undef MU_Q4_LAUNCH
}
