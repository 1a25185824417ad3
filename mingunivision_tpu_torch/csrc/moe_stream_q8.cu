// Decode-shape MoE over int8 tables: sum over routed experts of
// gate * (silu(x@W1[e] * s1) * (x@W3[e] * s3)) @ W2[e] * s2, the weights int8
// per-output-channel (utils/quantize.py), in two dot modes.
//
// Replaces the TPU kernels mingunivision_tpu/ops/kernels/moe_stream.py
// (moe_experts_stream -> _kernel_q8_s8, the default, and _kernel_q8, under
// moe_int_dots=False). On the H100 the op is bound by the bytes of int8
// weights: one expert is 3 x 2048 x 1408 B = 8.65 MB at the 16B-A3B shape, and
// a 2-row CFG decode step routes up to 12 experts per layer (104 MB, 31 us at
// 3.35 TB/s); the activations are a few KB.
//
// S8 (mu_moe_stream_q8s8): the activations quantized per row to s8
// (ops/kernels/intdot.py quant_rows_s8: max|x| / 127 + 1e-12, round half to
// even), the dots s8 x s8 -> s32 on mma.sync.m16n8k32, h = silu(g) * u in fp32
// re-quantized per row over ALL of m before the down dot. Two launches, no
// other device op, on the int4 kernel's s8 design (moe_stream_q4.cu) with the
// ring of moe_decode.cuh (`ring`: the routing, 16-byte cp.async copies into
// swizzled stages of 64 rows x 256 bytes, the A fragments byte-transposed in
// registers, q4_mma.cuh's s8_k32, the down launch as the up launch's
// programmatic dependent, the ticket merge); blocks of 256 threads, 8 warps of
// 32 columns:
//
//   up    grid (128 columns of m, slot). Each block stages the rows of x in
//         its ring while it builds the routing (blocks of slots past the
//         number routed exit at once), quantizes them to s8 in shared memory,
//         then streams its tile of W1 and W3 (a staged row: 128 columns of
//         each, 32 stages at h = 2048); g and u by the fp32 epilogue times the
//         row and column scales, h = silu(g) * u in fp32 into the workspace,
//         and the tile's per-row maxima of |h|. The slot's last block (by
//         ticket) re-quantizes the slot's h rows over all of m once, from the
//         tiles' maxima, and lowers the slot's ticket.
//   down  grid (256-column tile of h, slot), the up launch's programmatic
//         dependent: it waits for the up launch before it stages the slot's
//         s8 h rows beside the first stage of W2; y by the epilogue times the
//         row and column scales into the workspace; the tile's last block
//         sums gate * y over each row's slots in ascending order, each
//         product rounded before the sum, as the plain version does.
//
// The integer sums are exact in any order, and the fp32 epilogue, the row
// maxima, the scales and the merge keep the plain version's steps: the
// result is its bits.
//
// Exact (mu_moe_stream_q8, moe_int_dots=False): each int8 weight converted to
// fp32 (exact), products with x's bf16 values summed in fp32, h rounded to
// bf16 before the down dot, s2 applied per expert; the wrapper builds the
// unique routed experts (ascending id) and per-expert gate rows on the device:
//   phase A  grid (slot, 128-column tile of m): each block stages the rows of
//            x in shared memory as fp32, then g and u: each warp takes the
//            4-row groups warp, warp + 8, ... of the contraction; a lane loads
//            one 32-bit word (4 columns) of each of the group's 4 rows and
//            multiplies each byte in fp32. The 8 warps' partial sums are added
//            in order in shared memory; h goes to device memory;
//   phase B  grid (slot, 128-column tile of h): the down dots the same way;
//   phase C  out = sum over slots of gate * y, in ascending slot order
//            (deterministic, no atomics). Slots past the number of unique
//            experts (read from device memory, no host sync) exit at once.
#include "moe_decode.cuh"
#include "q4_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// S8: two launches, the routing built in the kernel, s8 products on the tensor cores
// ---------------------------------------------------------------------------

namespace s8 {

using namespace moe_decode;
using namespace moe_decode::ring;

constexpr int kUpCols = 128;  // up: columns of m per block, of W1 and of W3

// ring depth by n-tiles: two blocks on an SM at up to 32 rows in the down launch, 16 in the up launch
template <int NT>
struct Ring {
  static constexpr int kStages = NT <= 2 ? 4 : 3;
};

// The warp's integer dots over one staged tile of kTileK rows (s8_k32 per k32 step, q4_mma.cuh): B from the rows'
// s8 operands (pitch ld bytes) at contraction row k0. Accumulator element i of d[p][nt] is column 4g + 2p + i / 2,
// row nt * 8 + 2t + i % 2.
template <int NT>
__device__ __forceinline__ void tile_dots(const unsigned char* stage, int a_off, const int8_t* rows, int ld, int k0,
                                          int (&d)[2][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 32) {
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int off = (nt * 8 + g) * ld + k0 + kk + 4 * t;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(rows + off);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(rows + off + 16);
    }
    uint32_t w[2][4];
    a_words(stage, kk, a_off, w);
    s8_k32<NT>(w, b, d);
  }
}

// The integer dots of a tile over the ring (the caller has committed the first S - 1 groups).
template <int NT, int S, typename Load>
__device__ __forceinline__ void stream_dots(unsigned char* smem, Load load, int KT, int a_off, const int8_t* rows,
                                            int ld, int (&d)[2][NT][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[p][nt][i] = 0;
  stream<S>(smem, load, KT,
            [&](const unsigned char* stage, int kt) { tile_dots<NT>(stage, a_off, rows, ld, kt * kTileK, d); });
}

// Eight values to s8 on scale sc (rounded as quant_rows_s8 rounds them), packed.
__device__ __forceinline__ uint2 quant8(const float (&v)[8], float sc) {
  int q[8];
  pair_q_rc<8>(v, sc, __frcp_rn(sc), q);
  return make_uint2(pack_s8(q[0], q[1], q[2], q[3]), pack_s8(q[4], q[5], q[6], q[7]));
}

// Rows [r0, r0 + nr) of x, staged in shared memory as bf16 (xs, h values a row), to s8: xq rows of pitch ld and
// sx[r] each row's scale. A thread per 8-value chunk; the rows' maxima in row_max (at least nr rows).
__device__ void quant_x_rows(const bf16* xs, int r0, int nr, int h, int8_t* xq, int ld, float* sx,
                             unsigned* row_max) {
  const int tid = threadIdx.x, C = h / 8;
  const bool uniform = C % 32 == 0;  // a warp's chunks lie in one row
  if (tid < nr) row_max[tid] = 0u;
  __syncthreads();
  for (int i = tid; i < nr * C; i += kThreads) {
    float v[8], mx = 0.0f;
    unpack_bf16x8(reinterpret_cast<const uint4*>(xs)[i], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) mx = fmaxf(mx, fabsf(v[e]));
    max_to(&row_max[i / C], mx, uniform);
  }
  __syncthreads();
  for (int i = tid; i < nr * C; i += kThreads) {
    const int r = i / C, c = i % C;
    float v[8];
    unpack_bf16x8(reinterpret_cast<const uint4*>(xs)[i], v);
    *reinterpret_cast<uint2*>(xq + (r0 + r) * ld + 8 * c) = quant8(v, pair_scale(__uint_as_float(row_max[r])));
  }
  if (tid < nr) sx[r0 + tid] = pair_scale(__uint_as_float(row_max[tid]));
}

// up: hbuf (n_slots, N, m) fp32 <- silu(g) * u of slot blockIdx.y at columns [128 * blockIdx.x, + 128); hmax
// (n_slots, T, N) each tile's per-row maxima of |h|. Each block quantizes the rows of x itself first: they are
// staged in its ring (at most the ring's bytes at a time) while it builds the routing, and only then does it start
// the ring on the weights. The block exits without a trigger, so the down launch starts as the blocks exit. The
// slot's last block (by ticket) writes hq[slot]: (RP, m) s8 of h re-quantized per row over all of m from the
// tiles' maxima, then per row (sh, 0, 0, 0) fp32, and lowers the slot's ticket (RP = NT * 8 rows; those past N
// unused).
template <int NT>
__global__ void __launch_bounds__(kThreads) q8s8_up_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ q1, const float* __restrict__ s1,
    const uint8_t* __restrict__ q3, const float* __restrict__ s3, const void* topk_idx, int idx64,
    float* __restrict__ hbuf, float* __restrict__ hmax, int8_t* __restrict__ hq, int* __restrict__ tickets, int N,
    int K, int E, int h, int m) {
  constexpr int S = Ring<NT>::kStages, RP = NT * 8;
  __shared__ Routing R;
  __shared__ unsigned row_max[kMaxRows];
  __shared__ float row_scale[kMaxRows];
  const int slot = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldx = op_pitch(h), p0 = blockIdx.x * kUpCols, T = gridDim.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw + S * kStageBytes);
  float* sx = reinterpret_cast<float*>(xq + RP * ldx);  // [RP]: each row's scale
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
    quant_x_rows(reinterpret_cast<const bf16*>(smem_raw), r0, min(batch, N - r0), h, xq, ldx, sx, row_max);
    __syncthreads();  // the staged rows are read before the ring (or the next batch) overwrites them
  }

  const size_t table = (size_t)R.expert * h * m;
  auto load = [&](int s, int kt) { load_pair_tiles(smem_raw + s * kStageBytes, q1 + table, q3 + table, m, kt, p0); };
  const int KT = h / kTileK;
  prime<S>(load, KT);
  const int table_u = warp >> 2, cw = (warp & 3) * 32;  // warp w: table w / 4 (W1, W3), columns cw .. + 32
  float scale[2][2];
  load_scales((table_u ? s3 : s1) + (size_t)R.expert * m + p0 + cw, scale);
  int d[2][NT][4];
  stream_dots<NT, S>(smem_raw, load, KT, a_offset(warp * 32, lane), xq, ldx, d);

  // g (warps 0-3) and u (warps 4-7) into shared memory, then h = silu(g) * u
  float* gu = reinterpret_cast<float*>(smem_raw);  // [2][RP][128]
  epilogue<NT>(scale, N, [&](int p, int nt, int i, int n) { return __fmul_rn((float)d[p][nt][i], sx[n]); },
               [&](int n, int c, float v) { gu[(table_u * RP + n) * kUpCols + cw + c] = v; });
  __syncthreads();
  float* hs = hbuf + (size_t)slot * N * m;
  for (int i = tid; i < N * kUpCols; i += kThreads) {
    const int n = i / kUpCols, c = i % kUpCols;
    const float hv = __fmul_rn(silu_exact(gu[i]), gu[RP * kUpCols + i]);
    gu[i] = hv;
    hs[(size_t)n * m + p0 + c] = hv;
  }
  __syncthreads();
  for (int n = warp; n < N; n += kThreads / 32) {  // the tile's row maxima, a warp per row
    float mx = 0.0f;
#pragma unroll
    for (int j = 0; j < kUpCols / 32; ++j) mx = fmaxf(mx, fabsf(gu[n * kUpCols + 32 * j + lane]));
    mx = warp_max(mx);
    if (lane == 0) hmax[((size_t)slot * T + blockIdx.x) * N + n] = mx;
  }

  // the block's writes, one fence, the slot's ticket; the slot's last block quantizes its h
  if (!last_block(&tickets[slot], T)) return;
  for (int n = warp; n < N; n += kThreads / 32) {  // the rows' scales over the tiles (T <= 32)
    float v = lane < T ? __ldcg(hmax + ((size_t)slot * T + lane) * N + n) : 0.0f;
    v = warp_max(v);
    if (lane == 0) row_scale[n] = pair_scale(v);
  }
  __syncthreads();
  // every (row, 8-column chunk) of the slot's h, two chunks a thread in flight at a time
  int8_t* q = hq + (size_t)slot * RP * (m + 16);
  const int per_row = m / 8, total = N * per_row;
  for (int c0 = 0; c0 < total; c0 += 2 * kThreads) {
    float4 v[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + j * kThreads + tid;
      if (c < total) {
        const float4* hr = reinterpret_cast<const float4*>(hs + (size_t)(c / per_row) * m + 8 * (c % per_row));
        v[j][0] = __ldcg(hr);
        v[j][1] = __ldcg(hr + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + j * kThreads + tid;
      if (c >= total) continue;
      const int n = c / per_row;
      const float f[8] = {v[j][0].x, v[j][0].y, v[j][0].z, v[j][0].w, v[j][1].x, v[j][1].y, v[j][1].z, v[j][1].w};
      *reinterpret_cast<uint2*>(q + (size_t)n * m + 8 * (c % per_row)) = quant8(f, row_scale[n]);
    }
  }
  if (tid < N) reinterpret_cast<float4*>(q + (size_t)RP * m)[tid] = make_float4(row_scale[tid], 0.0f, 0.0f, 0.0f);
  if (tid == 0) tickets[slot] = 0;
}

// down: ypart (n_slots, N, h) fp32 <- the slot's s8 h @ W2[e] times the row and column scales, for columns [256 *
// blockIdx.x, + 256); then the tile's last block writes out (N, h) bf16 for those columns. The up launch's
// programmatic dependent: it waits for the up launch before its ring and hq.
template <int NT>
__global__ void __launch_bounds__(kThreads) q8s8_down_kernel(
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
  const int ldh = op_pitch(m), col0 = blockIdx.x * kDownCols;
  const uint8_t* W2 = q2 + (size_t)R.expert * m * h + col0;
  const int8_t* Q = hq + (size_t)slot * RP * (m + 16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* hb = reinterpret_cast<int8_t*>(smem_raw + S * kStageBytes);
  float* st = reinterpret_cast<float*>(hb + RP * ldh);  // [RP][4]: sh, 0, 0, 0

  auto load = [&](int s, int kt) { load_tile(smem_raw + s * kStageBytes, W2, h, kt); };
  const int KT = m / kTileK;
  float scale[2][2];
  load_scales(s2 + (size_t)R.expert * h + col0 + warp * 32, scale);
  wait_for_up();  // hq is written
  // the first group: stage 0 and the slot's N s8 h rows with their scales (rows past N unread)
  load(0, 0);
  for (int i = tid; i < N * (m / 16); i += kThreads) {
    const int n = i / (m / 16), c = (i % (m / 16)) * 16;
    cp_async16(hb + n * ldh + c, Q + (size_t)n * m + c);
  }
  for (int n = tid; n < N; n += kThreads) cp_async16(st + 4 * n, Q + (size_t)RP * m + 16 * n);
  cp_async_commit();
  prime<S>(load, KT, 1);
  int d[2][NT][4];
  stream_dots<NT, S>(smem_raw, load, KT, a_offset(warp * 32, lane), hb, ldh, d);

  float* ys = reinterpret_cast<float*>(smem_raw);  // [RP][kDownCols]
  epilogue<NT>(scale, N, [&](int p, int nt, int i, int n) { return __fmul_rn((float)d[p][nt][i], st[4 * n]); },
               [&](int n, int c, float v) { ys[n * kDownCols + warp * 32 + c] = v; });
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
  constexpr size_t kGu = 2 * RP * kUpCols * sizeof(float);  // g and u over the ring and x's rows after the stream
  auto up = [&](int w) {
    const size_t b = (size_t)S * kStageBytes + RP * op_pitch(w) + RP * 16;
    return b > kGu ? b : kGu;
  };
  const size_t down_smem = (size_t)S * kStageBytes + RP * op_pitch(m) + RP * 16;
  static unsigned allowed = 0u;  // once per device: the most this instantiation needs (h = m = 2048)
  cudaError_t err = allow_once(allowed, q8s8_up_kernel<NT>, q8s8_down_kernel<NT>, (int)up(2048));
  if (err != cudaSuccess) return (int)err;
  const int n_slots = min(N * K, E), down_tiles = h / kDownCols;
  // the workspace (the wrapper's q8s8_workspace_sizes): fbuf h (slots x N x m), then the up tiles' row maxima, and
  // later the down products; qbuf each slot's s8 h (RP x (m + 16) bytes); tickets the down tiles', then the slots'
  q8s8_up_kernel<NT><<<dim3(m / kUpCols, n_slots), kThreads, up(h), st>>>(
      x, q1, s1, q3, s3, topk_idx, idx64, fbuf, fbuf + (size_t)n_slots * N * m, qbuf, tickets + down_tiles, N, K, E,
      h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dependent(q8s8_down_kernel<NT>, dim3(down_tiles, n_slots), down_smem, st, qbuf, q2, s2, topk_idx,
                               idx64, topk_w, w_f32, fbuf, tickets, out, N, K, E, h, m);
}

}  // namespace s8

// ---------------------------------------------------------------------------
// exact dequant: three launches over the wrapper's expert list
// ---------------------------------------------------------------------------

namespace exact {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;  // output columns per block: 32 lanes x 4 bytes

// Shared memory: the staged rows [R][n] fp32, then the per-warp partial sums red [kWarps][R][kCols][NT].
template <int R, int NT>
struct Smem {
  __host__ __device__ static size_t rows(int n) { return align16((size_t)R * n * 4); }
  __host__ __device__ static size_t bytes(int n) { return rows(n) + (size_t)kWarps * R * kCols * NT * 4; }
};

// Stage R rows of length n into xf [R][n] as fp32. Rows >= nr are zero. `row(r, i)` gives element i of row r.
template <int R, typename Row>
__device__ void stage_rows(Row row, int nr, int n, float* xf) {
  for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
    for (int r = 0; r < R; ++r) xf[r * n + i] = r < nr ? row(r, i) : 0.0f;
  __syncthreads();
}

// The R-row dot products of one 128-column tile of NT int8 (K, ncols) tables, each warp over the 4-row groups
// warp, warp + 8, ... of K; acc[r][c][q] is column 4 * lane + c of table q.
template <int R, int NT>
__device__ __forceinline__ void q8_dots(const int8_t* const (&p)[NT], int K, size_t ld, const float* xf,
                                        float (&acc)[R][4][NT]) {
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < K / 4; g += kWarps) {
    const int i = 4 * g;
    uint32_t w[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) w[q][rr] = __ldg(reinterpret_cast<const uint32_t*>(p[q] + (size_t)(i + rr) * ld));
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float wf[NT][4];
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) wf[q][c] = (float)(int8_t)(w[q][rr] >> (8 * c));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = xf[r * K + i + rr];
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c][q] = fmaf(xv, wf[q][c], acc[r][c][q]);
      }
    }
  }
}

// The warps' partial sums of one tile into red, then `emit(r, c, sums)` for each row r < nr and column c <
// valid_cols of the tile, with the NT sums of all warps.
template <int R, int NT, typename Emit>
__device__ __forceinline__ void reduce_tile(float (&acc)[R][4][NT], float* red, int nr, int valid_cols, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NT; ++q) red[((size_t)(warp * R + r) * kCols + 4 * lane + c) * NT + q] = acc[r][c][q];
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx % kCols;
    if (c >= valid_cols) continue;
    float s[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) s[q] = 0;
    for (int wp = 0; wp < kWarps; ++wp)
#pragma unroll
      for (int q = 0; q < NT; ++q) s[q] += red[((size_t)(wp * R + r) * kCols + c) * NT + q];
    emit(r, c, s);
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(kThreads) q8_up_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q1, const float* __restrict__ s1,
    const int8_t* __restrict__ q3, const float* __restrict__ s3, const int* __restrict__ slot_expert,
    const int* __restrict__ n_unique, float* __restrict__ hbuf, int n_rows, int h, int m) {
  typedef Smem<R, 2> L;
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < m;  // m % 4 == 0: a word never straddles the edge

  extern __shared__ __align__(16) unsigned char smem[];
  float* xf = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + L::rows(h));

  const int8_t* const p[2] = {q1 + (size_t)e * h * m + (active ? col : 0), q3 + (size_t)e * h * m + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const bf16* xr = x + (size_t)r0 * h;
    stage_rows<R>([&](int r, int i) { return __bfloat162float(xr[(size_t)r * h + i]); }, nr, h, xf);
    float acc[R][4][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c][0] = acc[r][c][1] = 0;
    if (active) q8_dots<R, 2>(p, h, m, xf, acc);
    reduce_tile<R, 2>(acc, red, nr, m - col0, [&](int r, int c, const float(&s)[2]) {
      const size_t j = (size_t)e * m + col0 + c;
      const float hv = __fmul_rn(silu_exact(__fmul_rn(s[0], s1[j])), __fmul_rn(s[1], s3[j]));
      hbuf[((size_t)slot * n_rows + r0 + r) * m + col0 + c] = __bfloat162float(__float2bfloat16(hv));  // the down
                                                                                                      // dot's operand
    });
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads) q8_down_kernel(
    const float* __restrict__ hbuf, const int8_t* __restrict__ q2, const float* __restrict__ s2,
    const int* __restrict__ slot_expert, const int* __restrict__ n_unique, float* __restrict__ ybuf, int n_rows,
    int h, int m) {
  typedef Smem<R, 1> L;
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < h;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xf = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + L::rows(m));

  const int8_t* const p[1] = {q2 + (size_t)e * m * h + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const float* hr = hbuf + ((size_t)slot * n_rows + r0) * m;
    stage_rows<R>([&](int r, int i) { return hr[(size_t)r * m + i]; }, nr, m, xf);
    float acc[R][4][1];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c][0] = 0;
    if (active) q8_dots<R, 1>(p, m, h, xf, acc);
    reduce_tile<R, 1>(acc, red, nr, h - col0, [&](int r, int c, const float(&s)[1]) {
      ybuf[((size_t)slot * n_rows + r0 + r) * h + col0 + c] = __fmul_rn(s[0], s2[(size_t)e * h + col0 + c]);
    });
  }
}

template <int R>
cudaError_t launch(const bf16* x, const int8_t* q1, const float* s1, const int8_t* q3, const float* s3,
                   const int8_t* q2, const float* s2, const int* slot_expert, const int* n_unique, const float* gates,
                   float* hbuf, float* ybuf, bf16* out, int n_rows, int n_slots, int h, int m, cudaStream_t stream) {
  const size_t up_smem = Smem<R, 2>::bytes(h), down_smem = Smem<R, 1>::bytes(m);
  cudaError_t err = allow_dynamic_smem(q8_up_kernel<R>, up_smem);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(q8_down_kernel<R>, down_smem);
  if (err != cudaSuccess) return err;
  q8_up_kernel<R><<<dim3(n_slots, (m + kCols - 1) / kCols), kThreads, up_smem, stream>>>(
      x, q1, s1, q3, s3, slot_expert, n_unique, hbuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q8_down_kernel<R><<<dim3(n_slots, (h + kCols - 1) / kCols), kThreads, down_smem, stream>>>(
      hbuf, q2, s2, slot_expert, n_unique, ybuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_slot_combine_kernel<<<dim3(n_rows, (h + 255) / 256), 256, 0, stream>>>(ybuf, gates, n_unique, out, n_rows, h);
  return cudaGetLastError();
}

}  // namespace exact

}  // namespace

// S8. x (N, h) bf16; q1/q3 (E, h, m) and q2 (E, m, h) int8 for ONE layer with fp32 scales s1/s3 (E, 1, m) and s2
// (E, 1, h), all 16-byte aligned; topk_idx (N, K) int32 (int64 with idx64) and topk_w (N, K) bf16 (fp32 with
// w_f32); workspace, with S = min(N K, E) slots and RP = mu_moe_stream_rows_pad(N) (the wrapper's
// q8s8_workspace_sizes): fbuf S x N x max(h, m + m / 128) fp32 (h and the up tiles' row maxima, then the down
// products), qbuf S x RP x (m + 16) bytes (each slot's h quantized), tickets h / 256 + S int32, zero before the
// first launch (every launch pair leaves them zero); out (N, h) bf16. 1 <= N <= 64 and the shapes of
// ring::shape_ok (the wrapper checks).
extern "C" int mu_moe_stream_q8s8(const void* x, const void* q1, const void* s1, const void* q3, const void* s3,
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
#define MU_Q8S8_LAUNCH(NT) \
  s8::launch<NT>(xb, a, sa, b, sb, c, sc, topk_idx, topk_w, fb, qb, tk, ob, N, K, E, h, m, idx64, w_f32, st)
  if (pad == 8) return MU_Q8S8_LAUNCH(1);
  if (pad == 16) return MU_Q8S8_LAUNCH(2);
  if (pad == 32) return MU_Q8S8_LAUNCH(4);
  return MU_Q8S8_LAUNCH(8);
#undef MU_Q8S8_LAUNCH
}

// Exact dequant. x (n_rows, h) bf16; q1/q3 (E, h, m) and q2 (E, m, h) int8 for ONE layer with fp32 scales s1/s3
// (E, 1, m) and s2 (E, 1, h); slot_expert (n_slots,) int32 unique routed experts first; n_unique (1,) int32; gates
// (n_slots, n_rows) fp32; scratch hbuf (n_slots, n_rows, m) and ybuf (n_slots, n_rows, h) fp32; out (n_rows, h)
// bf16. h and m must be multiples of 8 (the wrapper checks). Rows are taken up to four at a time.
extern "C" int mu_moe_stream_q8(const void* x, const void* q1, const void* s1, const void* q3, const void* s3,
                                const void* q2, const void* s2, const void* slot_expert, const void* n_unique,
                                const void* gates, void* hbuf, void* ybuf, void* out, int n_rows, int n_slots, int h,
                                int m, void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t *a = static_cast<const int8_t*>(q1), *b = static_cast<const int8_t*>(q3),
               *c = static_cast<const int8_t*>(q2);
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
