// Prefill MoE over linear int4 tables: grouped SwiGLU over expert-sorted rows,
// ys[r] = (silu(x[tok[r]] @ W1[e] * s1) * (x[tok[r]] @ W3[e] * s3)) @ W2[e] * s2
// for the rows r of expert e, W = the split-halves packed nibbles - 8, in two
// dot modes:
//   exact   the nibbles converted to fp32 (exact), x's bf16 values, fp32 sums,
//           a = silu(g) * u rounded to bf16 before the down dot;
//   S8      x's split halves quantized per row to the s8 operand pair
//           (intdot.quant_rows_s8_pair: a1 = x_lo - x_hi/16, a2 = x_hi), gate
//           and up through the two-dot identity on the packed bytes (the
//           low nibbles, and the bytes ^ 0x80 as s8); a = silu(g) * u in fp32
//           re-quantized per row over each 64-row segment of the down table
//           (the JAX package's seg = chunk / 2 = 64), each segment inside one
//           nibble plane: lo plane sa * (aq . m - 8 * sum(aq)), hi plane
//           sa * (aq . bx - aq . m) / 16, bx = s8(b ^ 0x80); the segments added
//           in order, s2 once at the store.
//
// Replaces the TPU kernels mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py
// (swiglu_gmm_quant -> _swiglu_gmm_q4_chunked -> _kernel_q4_chunked, exact,
// and _kernel_q4_chunked_s8, which the JAX package switches on with
// INT_DOT_PREFILL_INT4 or s8=True; the port with
// RuntimeConfig.moe_prefill_int_dots), and, in a third mode, the full-expert
// block kernel swiglu_gmm_quant(int4_chunked=False) -> _kernel_q in both of
// its branches (int4 and int8 tables; the port's full_block=True). At the slice's prompt (128 tokens x
// top-6 = 768 rows over 64 experts) the op reads a layer's packed tables once,
// 64 x 4.33 MB = 277 MB (83 us at 3.35 TB/s), and does 13 G operations.
//
// Design. Exact: the bf16 kernel's (moe_swiglu_gmm.cu) body, swiglu_wgmma.cuh:
// 128-row schedule tiles (mu_swiglu_gmm_q4_tile_rows(0)), two launches of
// wgmma bf16 products with fp32 sums; TMA streams the packed bytes into a ring
// of their own and the producer threads convert each stage's nibbles (-8..7,
// exact in bf16) into the B stage. A packed row k of a gate/up table holds
// contraction row k (low nibble) and row k + h/2 (high nibble), so a stage of
// 32 packed rows multiplies x[:, k0..k0+31] and x[:, h/2+k0..h/2+k0+31]
// against the two planes; the down table likewise: its logical row j is the
// low nibble of packed row j for j < m/2, else the high nibble of packed row
// j - m/2. Activations enter as their bf16 values, sums are fp32; g * s1 and
// u * s3 after the dots, a = silu(g) * u rounded to bf16 before the down dot,
// s2 once at the store. S8: 32-row tiles (mu_swiglu_gmm_q4_tile_rows(1)),
// four launches (quantize x per token, the
// up dots with __dp4a on byte-transposed packed words, the per-segment
// quantization of a, the down dots segment by segment), the integer sums
// exact and every fp32 step rounded as the plain version writes it, so that
// the two agree to the bit. Simple smem-tiled CUDA-core dots. The full-block
// mode: one launch over 32-row tiles (mu_swiglu_gmm_full_tile_rows). The
// 32-row kernels trap on a longer tile.
#include "swiglu_wgmma.cuh"

namespace {

constexpr int TM = 32;  // rows per tile of the s8 and full-block kernels (their schedules' tile rows)
constexpr int BN = 64;  // output columns per block
constexpr int BK = 32;  // packed contraction rows per step (2 * BK logical rows)
constexpr int kThreads = 256;  // 16 x 16: each thread owns 2 rows x 4 columns

// Unpack a BK x BN tile of packed bytes (rows k0.., columns n0.. of a table
// with `ld` columns) into its low- and high-nibble weights.
__device__ __forceinline__ void load_nibble_tile(const uint8_t* __restrict__ q, size_t ld, int k0, int n0,
                                                 float (*lo)[BN], float (*hi)[BN]) {
  for (int idx = threadIdx.x; idx < BK * BN / 4; idx += kThreads) {
    const int kk = idx / (BN / 4);
    const int c = 4 * (idx % (BN / 4));
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(k0 + kk) * ld + n0 + c));
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int byte = (w >> (8 * b)) & 0xFF;
      lo[kk][c + b] = (float)((byte & 15) - 8);
      hi[kk][c + b] = (float)((byte >> 4) - 8);
    }
  }
}

__device__ __forceinline__ void fma_2x4(float a0, float a1, const float* b, float (&acc)[2][4]) {
  const float4 v = *reinterpret_cast<const float4*>(b);
  acc[0][0] = fmaf(a0, v.x, acc[0][0]); acc[0][1] = fmaf(a0, v.y, acc[0][1]);
  acc[0][2] = fmaf(a0, v.z, acc[0][2]); acc[0][3] = fmaf(a0, v.w, acc[0][3]);
  acc[1][0] = fmaf(a1, v.x, acc[1][0]); acc[1][1] = fmaf(a1, v.y, acc[1][1]);
  acc[1][2] = fmaf(a1, v.z, acc[1][2]); acc[1][3] = fmaf(a1, v.w, acc[1][3]);
}

// ---------------------------------------------------------------------------
// S8 mode
// ---------------------------------------------------------------------------

constexpr int kSeg = 64;  // down-table rows per re-quantization segment (the JAX package's seg)

// x (N, h) bf16 -> the s8 pair a1, a2 (N, h/2) and st (N, 4): sa1, sa2, corr;
// one block per token row.
__global__ void __launch_bounds__(kThreads) quant_x_pair_kernel(const bf16* __restrict__ x, int8_t* __restrict__ a1,
                                                                int8_t* __restrict__ a2, float* __restrict__ st,
                                                                int h) {
  __shared__ float fscratch[64];
  __shared__ int iscratch[64];
  const size_t n = blockIdx.x;
  const bf16* row = x + n * h;
  quant_pair_rows<1>([&](int, int i) { return __bfloat162float(row[i]); }, 1, h, a1 + n * (h / 2), a2 + n * (h / 2),
                     st + 4 * n, fscratch, iscratch);
}

// A BK x BN tile of packed bytes (rows k0.., columns n0.., `ld` columns) into
// wt [BK / 4][BN] words, word (g, c) holding rows 4g..4g+3 of column c.
__device__ __forceinline__ void load_u8_tile_t(const uint8_t* __restrict__ q, size_t ld, int k0, int n0,
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

// The s8 rows of a tile (rows of `src` with `ld` bytes, picked by row_of(r), -1
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

// acc1 += x1 . (w & 0x0F...), acc2 += x2 . (w ^ 0x80...) for 2 rows x 4 columns.
__device__ __forceinline__ void dp4a_pair_2x4(int x1a, int x1b, int x2a, int x2b, const uint32_t* w,
                                              int (&acc1)[2][4], int (&acc2)[2][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int lo = nib_lo(w[c]), bx = nib_x80(w[c]);
    acc1[0][c] = __dp4a(x1a, lo, acc1[0][c]);
    acc1[1][c] = __dp4a(x1b, lo, acc1[1][c]);
    acc2[0][c] = __dp4a(x2a, bx, acc2[0][c]);
    acc2[1][c] = __dp4a(x2b, bx, acc2[1][c]);
  }
}

__global__ void __launch_bounds__(kThreads) gmm_q4s8_up_kernel(
    const int8_t* __restrict__ a1, const int8_t* __restrict__ a2, const float* __restrict__ st,
    const int* __restrict__ row_token, const uint8_t* __restrict__ q1, const float* __restrict__ s1,
    const uint8_t* __restrict__ q3, const float* __restrict__ s3, const int* __restrict__ sched,
    float* __restrict__ hbuf, int h, int m) {
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
  const int hh = h / 2;

  __shared__ int x1w[TM][BK / 4 + 1], x2w[TM][BK / 4 + 1];
  __shared__ __align__(16) uint32_t w1t[BK / 4][BN], w3t[BK / 4][BN];
  __shared__ int tok[TM];
  if (tid < TM) tok[tid] = (r0 + tid < r1) ? row_token[r0 + tid] : -1;
  __syncthreads();

  const uint8_t* Q1 = q1 + (size_t)e * hh * m;
  const uint8_t* Q3 = q3 + (size_t)e * hh * m;
  int g1[2][4] = {}, g2[2][4] = {}, u1[2][4] = {}, u2[2][4] = {};
  const int half = (BK / 4) * (BN / 4);
  for (int k0 = 0; k0 < hh; k0 += BK) {
    auto row_of = [&](int r) { return (long)tok[r]; };
    load_s8_rows(a1, (size_t)hh, k0, row_of, x1w);
    load_s8_rows(a2, (size_t)hh, k0, row_of, x2w);
    if (tid < half) load_u8_tile_t(Q1, m, k0, n0, w1t, tid);
    else load_u8_tile_t(Q3, m, k0, n0, w3t, tid - half);
    __syncthreads();
#pragma unroll
    for (int kg = 0; kg < BK / 4; ++kg) {
      const int xa = x1w[2 * ty][kg], xb = x1w[2 * ty + 1][kg], ya = x2w[2 * ty][kg], yb = x2w[2 * ty + 1][kg];
      dp4a_pair_2x4(xa, xb, ya, yb, &w1t[kg][4 * tx], g1, g2);
      dp4a_pair_2x4(xa, xb, ya, yb, &w3t[kg][4 * tx], u1, u2);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 2 * ty + i;
    if (r < r1) {
      const float* str = st + 4 * (size_t)tok[2 * ty + i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + 4 * tx + c;
        const float gv = __fmul_rn(mm4_epilogue(g1[i][c], g2[i][c], str), s1[(size_t)e * m + col]);
        const float uv = __fmul_rn(mm4_epilogue(u1[i][c], u2[i][c], str), s3[(size_t)e * m + col]);
        hbuf[(size_t)r * m + col] = __fmul_rn(silu_exact(gv), uv);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) gmm_q4s8_down_kernel(
    const int8_t* __restrict__ aq, const float* __restrict__ sa, const int* __restrict__ rs,
    const uint8_t* __restrict__ q2, const float* __restrict__ s2, const int* __restrict__ sched,
    bf16* __restrict__ ys, int h, int m) {
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
  const int mh = m / 2, n_segs = m / kSeg;

  __shared__ int xw[TM][BK / 4 + 1];
  __shared__ __align__(16) uint32_t wt[BK / 4][BN];

  const uint8_t* Q2 = q2 + (size_t)e * mh * h;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int sg = 0; sg < n_segs; ++sg) {
    const int s0 = sg * kSeg, p0 = s0 % mh, plane = s0 / mh;
    int dm[2][4] = {}, dbx[2][4] = {};
    for (int k = 0; k < kSeg; k += BK) {
      load_s8_rows(aq, (size_t)m, s0 + k, [&](int r) { return r0 + r < r1 ? (long)(r0 + r) : -1L; }, xw);
      load_u8_tile_t(Q2, h, p0 + k, n0, wt, tid);
      __syncthreads();
#pragma unroll
      for (int kg = 0; kg < BK / 4; ++kg) {
        const int xa = xw[2 * ty][kg], xb = xw[2 * ty + 1][kg];
        dp4a_pair_2x4(xa, xb, xa, xb, &wt[kg][4 * tx], dm, dbx);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 2 * ty + i;
      if (r >= r1) continue;
      const float sr = sa[(size_t)r * n_segs + sg];
      const int sum = rs[(size_t)r * n_segs + sg];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = plane == 0 ? __fmul_rn((float)(dm[i][c] - 8 * sum), sr)
                                   : __fmul_rn((float)(dbx[i][c] - dm[i][c]), __fmul_rn(sr, 0.0625f));
        acc[i][c] = __fadd_rn(acc[i][c], v);
      }
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

// ---------------------------------------------------------------------------
// Full-expert-block mode (swiglu_gmm_quant(int4_chunked=False) -> _kernel_q)
// ---------------------------------------------------------------------------

// A BK x BN tile of an int8 table (rows k0.., columns n0.., `ld` columns) as fp32.
__device__ __forceinline__ void load_s8_tile(const int8_t* __restrict__ q, size_t ld, int k0, int n0,
                                             float (*t)[BN]) {
  for (int idx = threadIdx.x; idx < BK * BN / 4; idx += kThreads) {
    const int kk = idx / (BN / 4), c = 4 * (idx % (BN / 4));
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(k0 + kk) * ld + n0 + c));
#pragma unroll
    for (int b = 0; b < 4; ++b) t[kk][c + b] = (float)(int8_t)(w >> (8 * b));
  }
}

// One CTA per schedule tile (TM rows of one expert): g and u over all m
// columns in fp32 (BN at a time; int4: both nibble planes of every packed
// contraction row, int8: the bytes as they are), a = silu(g * s1) * (u * s3)
// rounded to bf16 ONCE into shared memory (TM x m: the TPU kernel's full
// block, 88 KB at m = 1408), then the down product over all of m (int4: both
// planes), s2 at the store. The TPU's (128 x m) block would not fit a CTA's
// shared memory; the schedule's 32-row tiles do.
template <int BITS>
__global__ void __launch_bounds__(kThreads) gmm_full_kernel(
    const bf16* __restrict__ x, const int* __restrict__ row_token, const void* __restrict__ q1,
    const float* __restrict__ s1, const void* __restrict__ q3, const float* __restrict__ s3,
    const void* __restrict__ q2, const float* __restrict__ s2, const int* __restrict__ sched,
    bf16* __restrict__ ys, int h, int m) {
  const int tile = blockIdx.x;
  const int e = sched[3 * tile];
  const int r0 = sched[3 * tile + 1];
  const int r1 = sched[3 * tile + 2];
  if (r0 >= r1) return;
  if (r1 - r0 > TM) __trap();  // a schedule built for longer tiles than the kernel's: refused
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int hk = BITS == 4 ? h / 2 : h, mk = BITS == 4 ? m / 2 : m;  // (packed) contraction rows

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);  // [TM][m]
  __shared__ float xlo[BK][TM + 1], xhi[BK][TM + 1];
  __shared__ __align__(16) float w1lo[BK][BN], w1hi[BK][BN], w3lo[BK][BN], w3hi[BK][BN];
  __shared__ int tok[TM];
  if (tid < TM) tok[tid] = (r0 + tid < r1) ? row_token[r0 + tid] : -1;
  __syncthreads();

  for (int n0 = 0; n0 < m; n0 += BN) {
    float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < hk; k0 += BK) {
      for (int idx = tid; idx < TM * BK; idx += kThreads) {
        const int r = idx / BK, kk = idx % BK, t = tok[r];
        xlo[kk][r] = t >= 0 ? __bfloat162float(x[(size_t)t * h + k0 + kk]) : 0.0f;
        if (BITS == 4) xhi[kk][r] = t >= 0 ? __bfloat162float(x[(size_t)t * h + hk + k0 + kk]) : 0.0f;
      }
      if constexpr (BITS == 4) {
        load_nibble_tile(static_cast<const uint8_t*>(q1) + (size_t)e * hk * m, m, k0, n0, w1lo, w1hi);
        load_nibble_tile(static_cast<const uint8_t*>(q3) + (size_t)e * hk * m, m, k0, n0, w3lo, w3hi);
      } else {
        load_s8_tile(static_cast<const int8_t*>(q1) + (size_t)e * hk * m, m, k0, n0, w1lo);
        load_s8_tile(static_cast<const int8_t*>(q3) + (size_t)e * hk * m, m, k0, n0, w3lo);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float l0 = xlo[kk][2 * ty], l1 = xlo[kk][2 * ty + 1];
        fma_2x4(l0, l1, &w1lo[kk][4 * tx], g);
        fma_2x4(l0, l1, &w3lo[kk][4 * tx], u);
        if constexpr (BITS == 4) {
          const float h0 = xhi[kk][2 * ty], h1 = xhi[kk][2 * ty + 1];
          fma_2x4(h0, h1, &w1hi[kk][4 * tx], g);
          fma_2x4(h0, h1, &w3hi[kk][4 * tx], u);
        }
      }
      __syncthreads();
    }
    const float* S1 = s1 + (size_t)e * m + n0 + 4 * tx;
    const float* S3 = s3 + (size_t)e * m + n0 + 4 * tx;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* dst = a_s + (size_t)(2 * ty + i) * m + n0 + 4 * tx;
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[c] = __float2bfloat16(silu_f32(g[i][c] * S1[c]) * (u[i][c] * S3[c]));
    }
  }
  __syncthreads();

  for (int n0 = 0; n0 < h; n0 += BN) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < mk; k0 += BK) {
      for (int idx = tid; idx < TM * BK; idx += kThreads) {
        const int r = idx / BK, kk = idx % BK;
        xlo[kk][r] = __bfloat162float(a_s[(size_t)r * m + k0 + kk]);
        if (BITS == 4) xhi[kk][r] = __bfloat162float(a_s[(size_t)r * m + mk + k0 + kk]);
      }
      if constexpr (BITS == 4) load_nibble_tile(static_cast<const uint8_t*>(q2) + (size_t)e * mk * h, h, k0, n0, w1lo, w1hi);
      else load_s8_tile(static_cast<const int8_t*>(q2) + (size_t)e * mk * h, h, k0, n0, w1lo);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        fma_2x4(xlo[kk][2 * ty], xlo[kk][2 * ty + 1], &w1lo[kk][4 * tx], acc);
        if constexpr (BITS == 4) fma_2x4(xhi[kk][2 * ty], xhi[kk][2 * ty + 1], &w1hi[kk][4 * tx], acc);
      }
      __syncthreads();
    }
    const float* S2 = s2 + (size_t)e * h + n0 + 4 * tx;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 2 * ty + i;
      if (r < r1) {
        bf16* dst = ys + (size_t)r * h + n0 + 4 * tx;
        *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(acc[i][0] * S2[0], acc[i][1] * S2[1]);
        *reinterpret_cast<bf162*>(dst + 2) = __floats2bfloat162_rn(acc[i][2] * S2[2], acc[i][3] * S2[3]);
      }
    }
  }
}

}  // namespace

// The full-expert-block mode over int4 (bits 4: the tables of mu_swiglu_gmm_q4)
// or int8 tables (bits 8: q1/q3 (E, h, m), q2 (E, m, h) int8): x, row_token,
// scales, sched and ys as mu_swiglu_gmm_q4 (tiles of at most
// mu_swiglu_gmm_full_tile_rows() rows); one launch, one CTA per tile, with
// TM * m * 2 bytes of dynamic shared memory (a launch that cannot have them
// is reported). h and m multiples of 64 (the wrapper checks).
extern "C" int mu_swiglu_gmm_full(const void* x, const void* row_token, const void* q1, const void* s1,
                                  const void* q3, const void* s3, const void* q2, const void* s2, const void* sched,
                                  void* ys, int n_tiles, int h, int m, int bits, void* stream) {
  const size_t smem = (size_t)TM * m * sizeof(bf16);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    // the kernel's 41 KB of static shared memory count against the default 48 KB: always opt in
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_tiles, kThreads, smem, cs>>>(static_cast<const bf16*>(x), static_cast<const int*>(row_token), q1,
                                            static_cast<const float*>(s1), q3, static_cast<const float*>(s3), q2,
                                            static_cast<const float*>(s2), static_cast<const int*>(sched),
                                            static_cast<bf16*>(ys), h, m);
    return cudaGetLastError();
  };
  if (n_tiles == 0) return (int)cudaSuccess;
  if (bits == 4) return (int)launch(gmm_full_kernel<4>);
  if (bits == 8) return (int)launch(gmm_full_kernel<8>);
  return (int)cudaErrorInvalidValue;
}

// x (n_tokens, h) bf16 token rows; row_token (A,) int32 token of each
// scheduled row; q1/q3 (E, h/2, m) and q2 (E, m/2, h) uint8 split-halves
// packed int4 for ONE layer with fp32 scales s1/s3 (E, 1, m) and s2 (E, 1, h);
// sched (n_tiles, 3) int32 (expert, first row, end row), empty entries have
// first == end, tiles of at most mu_swiglu_gmm_q4_tile_rows(s8) rows; out ys
// (A, h) bf16 in scheduled row order. Exact (s8 = 0): scratch hbuf (A, m)
// bf16; a1 .. rs unused; every operand 16-byte aligned (the scales 8-byte).
// S8 (s8 = 1): scratch hbuf (A, m) fp32, a1 / a2 (n_tokens, h/2) s8, st
// (n_tokens, 4) fp32, aq (A, m) s8, sa and rs (A, m / 64) fp32 / int32; m / 2
// a multiple of 64. h and m must be multiples of 64 (the wrapper checks).
extern "C" int mu_swiglu_gmm_q4(const void* x, const void* row_token, const void* q1, const void* s1, const void* q3,
                                const void* s3, const void* q2, const void* s2, const void* sched, void* hbuf,
                                void* ys, void* a1, void* a2, void* st, void* aq, void* sa, void* rs, int n_tiles,
                                int R, int E, int h, int m, int n_tokens, int s8, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (!s8)
    return swg::launch_swiglu<swg::Tab::kInt4>(x, row_token, q1, s1, q3, s3, q2, s2, sched, hbuf, ys, n_tiles, R, E,
                                               h, m, cs);
  const int* rt = static_cast<const int*>(row_token);
  const int* sc = static_cast<const int*>(sched);
  const uint8_t *Q1 = static_cast<const uint8_t*>(q1), *Q3 = static_cast<const uint8_t*>(q3),
                *Q2 = static_cast<const uint8_t*>(q2);
  const float *S1 = static_cast<const float*>(s1), *S3 = static_cast<const float*>(s3),
              *S2 = static_cast<const float*>(s2);
  if ((m / 2) % kSeg) return (int)cudaErrorInvalidValue;
  int8_t *A1 = static_cast<int8_t*>(a1), *A2 = static_cast<int8_t*>(a2), *AQ = static_cast<int8_t*>(aq);
  float *ST = static_cast<float*>(st), *SA = static_cast<float*>(sa), *HB = static_cast<float*>(hbuf);
  int* RS = static_cast<int*>(rs);
  quant_x_pair_kernel<<<n_tokens, kThreads, 0, cs>>>(static_cast<const bf16*>(x), A1, A2, ST, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gmm_q4s8_up_kernel<<<dim3(m / BN, n_tiles), kThreads, 0, cs>>>(A1, A2, ST, rt, Q1, S1, Q3, S3, sc, HB, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_chunks_s8_kernel<<<dim3(m / kSeg, n_tiles), 256, 0, cs>>>(HB, sc, AQ, SA, RS, m, kSeg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gmm_q4s8_down_kernel<<<dim3(h / BN, n_tiles), kThreads, 0, cs>>>(AQ, SA, RS, Q2, S2, sc, static_cast<bf16*>(ys), h,
                                                                   m);
  return (int)cudaGetLastError();
}

// Rows per schedule tile of each mode's kernels: exact (s8 = 0) the wgmma
// body's 128, s8 dots 32; the wrapper builds each mode's schedule with it.
extern "C" int mu_swiglu_gmm_q4_tile_rows(int s8) { return s8 ? TM : swg::BM; }
// Rows per schedule tile of the full-expert-block mode (mu_swiglu_gmm_full).
extern "C" int mu_swiglu_gmm_full_tile_rows(void) { return TM; }
