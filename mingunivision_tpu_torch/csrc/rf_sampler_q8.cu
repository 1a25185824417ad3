// Fused whole-sampler of the rectified-flow head over int8 tables: all Euler
// steps of one sample in ONE launch, in two dot modes.
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/rf_sampler.py
// (rf_sample_fused -> _sampler_q8, with _modulated_ln and _step_epilogue) in
// both of its modes: s8_dots = False (INT8_INT_DOTS off, the JAX package's
// default, the int8 quality tier) and s8_dots = True (INT8_INT_DOTS on; the
// port's RuntimeConfig.rf_int_dots). Per Euler step s and AdaLN block l (rows
// r < B, width w, SwiGLU hidden H):
//   xs   = LN(x) * ln_w + ln_b, modulated by (shift, scale) of mods[l, s],
//          rounded to the compute dtype
//   exact: g, u = xs @ Q12[:, :H] * s + b, xs @ Q12[:, H:] * s + b, each dot
//          the exact sum of its products rounded once to fp32 (digit dots,
//          below); h = silu(g) * u rounded to the compute dtype;
//          x += gate * ((h @ Q3) * s3 + b3), the dot exact and rounded once
//   S8:    xs quantized per row to s8 (intdot.quant_rows_s8); g, u = the s8 x
//          s8 -> s32 dots times the row scale, then * s + b; h = silu(g) * u
//          in fp32, re-quantized per row over each CH-column chunk (CH = 4096
//          of H = 8192, the JAX package's chunk); x += gate * (sum over the
//          chunks, in order, of (hq_c @ Q3_c) * sh_c, then * s3 + b3)
// then v = modulate(LN(x)) @ W_fin + b_fin, the CFG combine (1, 2 or 3 rows,
// optional channel renorm), latent += dt * v, and x = latent @ W_in + b_in for
// the next step. On the H100 the sample is bound by the int8 tables it
// streams: 906 MB per Euler step at the 16B-A3B width (w 3072, H 8192, 12
// blocks: w12 (3072, 16384) + w3 (8192, 3072) a block), 14.5 GB per sample,
// 4.33 ms at 3.35 TB/s.
//
// The same body also runs ONE Euler step of the residual stack alone (the
// stack mode, mu_rf_stack_q8: the per-step RF route, replacing the TPU kernel
// mingunivision_tpu/ops/kernels/rf_mlp.py rf_mlp_stack in three of its bodies,
// _kernel (int8 exact), _kernel_q8_s8 and _kernel_q4 (int4 exact)): x comes in
// from the caller and leaves after block L-1; no input_proj, final layer, CFG
// or Euler update. Its arithmetic differs from the sampler's where the stack's
// plain version (ops/kernels/rf_mlp.py) says: the s8 body quantizes the fp32
// modulated LN output (not rounded to the compute dtype), re-quantizes h per
// `chunk` columns (2,048) and adds each piece's descaled sum times s3 in piece
// order, then b3; the int4 exact body reads split-halves packed int4 tables
// (BITS 4: a stage is 64 packed rows; each byte's nibbles converted in
// registers to the s8 weights n - 8, the low plane meeting the digits of x's
// first half (h's), the high plane those of its second half, both in one exact
// sum a column).
//
// Digit dots (the exact mode). An activation row x (already rounded to the
// compute dtype) is written on a fixed point of its own: E the exponent of its
// largest |x| (frexp), X = rint(x * 2^(30 - E)), |X| < 2^30 (exact for every
// bf16 value within 2^-22 of the row's largest), as four balanced base-256 s8
// digits X = d0 + 256 d1 + 256^2 d2 + 256^3 d3. Each digit's dot with the
// int8 table is an exact integer below 2^27 in magnitude, the digits combine
// into the exact int64 sum of X * q (below 2^52), and that is rounded once:
// fp32(S * 2^(E - 30)). The result is the same in any contraction order, on
// any split of the contraction, so the stream-K units and their arrival order
// cannot move a bit, and the tensor cores can form the products. The plain
// version (ops/kernels/rf_sampler.py `_digit_dot`) computes the same rounded
// exact sums.
//
// Design: rf_sampler_q4.cu's body (rf_persistent.cuh): a PERSISTENT
// COOPERATIVE grid (one CTA per SM, or the caller's grid) whose weight stream
// never waits on the arithmetic. One PRODUCER warp walks the CTA's fixed
// sequence of weight stages for the whole sample (per step and block: its up
// units, then its down units) and fills a ring of 16 KB stages by TMA (four
// 64-row x 64-byte boxes a stage, 64-byte swizzle; full / empty mbarriers),
// held back only by free slots; eight CONSUMER warps do everything else. Per
// block, between two grid barriers:
//   every CTA   x (B x w fp32) into shared memory, the modulated LN in place,
//               in the compute dtype, with its row maxima; then x's operands
//               over all w rows (exact: 4 digits a value on the row's fixed
//               point; S8: 1 s8 value on the row's scale);
//   up units    (tile of 128 h columns: gate j0..j0+127 and up H+j0..H+j0+127,
//               its four boxes) x (stage of 64 rows of W12); each CTA takes a
//               contiguous run of the tile-major units (stream-K), keeps its
//               int32 partials in registers along the run, adds them once per
//               tile into the tile's int64 accumulators (red.add; exact: the
//               four digits' sums combined in registers), then takes the
//               tile's ticket (acq_rel). The last contributor runs the
//               epilogue: g, u, h to the workspace (exact: in the compute
//               dtype) and h's row maxima (S8: per chunk) by atomicMax on
//               their bits (exact: they are >= 0);                  -- barrier
//   every CTA   the operands of the h stages its own down units read, from h
//               and its row maxima in one round trip;
//   down units  (256 columns of W3) x (64 rows), stream-K as above, the
//               partials flushed per chunk of h (S8; the exact mode has one);
//               the last contributor writes the residual update of its
//               columns into the block's output x (S8: the chunks' descaled
//               sums added in chunk order).                         -- barrier
// After the last block, every CTA, redundantly and identically, runs the
// final layer, CFG combine and Euler update of the latent kept in shared
// memory, and input_proj of the next step. Accumulators and tickets are left
// at zero by their last users, the row maxima double-buffered and zeroed by CTA
// 0 after each block, x triple-buffered, the barrier counts reset by the last
// CTA out: the workspace needs no memset between launches. bf16 modulations
// and projections are read as they are where the compute dtype is bf16.
//
// The products are s8 tensor-core mma.sync m16n8k32 (q4_mma.cuh's s8_k32): the
// weight stage as A, byte-transposed in registers from the swizzled stage; the
// operand rows (row, digit) as B, one n-tile (exact at 1-2 rows, S8) or two
// (exact at 3-4 rows). Every fp32 step is rounded as written (__f*_rn: no fused
// multiply-add), 1/sqrt is IEEE, exp is taken in double (silu_exact), and the
// plain version sums its LN and final layer in this kernel's order: the two
// agree to the bit.
#include "q4_mma.cuh"
#include "rf_persistent.cuh"

namespace {

using namespace rf;

constexpr int kUpCols = 2 * kBoxW;  // h columns of an up tile: their gate and up columns fill its four boxes
constexpr int kDigits = 4;          // the exact mode's s8 digits an activation
constexpr int kFix = 30;            // its fixed point: X = rint(x * 2^(kFix - E)), E the row's exponent

// The workspace's int32 words (ops/kernels/rf_sampler.py's q8_workspace_sizes; its fp32 part: h (kMaxRows x
// H), then x's two block buffers and input_proj's (3 x kMaxRows x w)).
struct Workspace {
  long long *acc_up, *acc_dn;
  int* tickets;
  unsigned *hmax, *bar;
  __host__ __device__ Workspace(int* base, int Tu, int Td, int pieces) {
    acc_up = reinterpret_cast<long long*>(base);                          // [Tu][kMaxRows][kTileCols]
    acc_dn = acc_up + (size_t)Tu * kMaxRows * kTileCols;                   // [pieces][Td][kMaxRows][kTileCols]
    tickets = reinterpret_cast<int*>(acc_dn + (size_t)pieces * Td * kMaxRows * kTileCols);  // [Tu + Td]
    hmax = reinterpret_cast<unsigned*>(tickets + Tu + Td);  // [2 parities][kMaxRows][pieces]: h's row maxima
    bar = hmax + 2 * kMaxRows * pieces;                     // arrivals, exits
  }
  __host__ __device__ static size_t words(int Tu, int Td, int pieces) {
    return 2 * ((size_t)Tu + (size_t)pieces * Td) * kMaxRows * kTileCols + Tu + Td + 2 * kMaxRows * pieces + 2;
  }
};

struct alignas(64) Params {
  CUtensorMap m12, m3;  // (2H, w, L) and (w, H, L) int8 bytes, 64-byte x 64-row boxes
  RFArgs a;             // a.xcur / a.hbuf: the workspace's fp32 parts
  // the modulations and the input and final projections (wfin transposed), in the kernel's In: bf16 where the
  // compute dtype is bf16 and the modulations are bf16 (the values are those of fp32 ones), else fp32
  const void *mods, *fmods, *win, *wfin_t;
  int* iws;
  int ch;      // h's columns a piece (S8: re-quantized together; the exact mode: all of H)
  int pieces;  // H / ch
  int ring;    // stages of the ring
  int nslots;  // stages of h's operands a CTA keeps: min(its longest down run, KTd)
  // the stack mode: one step (S = 1), x (B x w fp32) from x_ext, the last block's output to out_ext
  int stack;
  int round_x;       // x's operands from the modulated LN rounded to the compute dtype (all but the stack's s8 body)
  int s3_per_piece;  // S8: each piece's descaled sum times s3 before it is added, then b3 (the stack's s8 body)
  const float* x_ext;
  float* out_ext;
};

// Shared memory, from a 1024-byte aligned base; nd operand rows a row of x or h (its digits, or 1); planes: h's
// operand rows once (int8 tables) or twice (int4: h's first half for the low nibbles, its second for the high).
struct Smem {
  size_t ring, bars, xs, lat, vel, xd, hd, xsc, hsc, stats, fscr, misc, bytes;
  int ldx, ldh;
  __host__ __device__ Smem(int R, int nd, int w, int pieces, int ring_n, int nslots, int planes) {
    ldx = w + 16;  // + 16: a B fragment's rows on distinct banks
    ldh = nslots * kRows + 16;
    size_t o = 0;
    ring = o; o += (size_t)ring_n * kStageBytes;
    bars = o; o += align16((size_t)ring_n * 16);
    xs = o; o += align16((size_t)R * w * 4);
    lat = o; o += align16((size_t)R * kLat * 4);
    vel = o; o += align16((size_t)R * kLat * 4);
    xd = o; o += align16((size_t)R * nd * ldx);
    hd = o; o += align16((size_t)planes * R * nd * ldh);
    xsc = o; o += align16((size_t)R * 8);
    hsc = o; o += align16((size_t)R * pieces * 8);
    stats = o; o += align16(2 * R * 4);
    fscr = o; o += align16(32 * 2 * R * 4);
    misc = o; o += 16;
    bytes = o + 1024;  // the base's alignment
  }
};

// The exponent E of a row's largest magnitude mx (frexp: mx = m 2^E, m in [0.5, 1); 0 for 0).
__device__ __forceinline__ int row_exponent(float mx) {
  int e;
  frexpf(mx, &e);
  return e;
}

// The ND s8 operands of 4-value groups: exact (ND = kDigits): the balanced base-256 digits, lowest first, of X =
// rint(v * up), up = 2^(kFix - E) (the product is exact in double; |X| < 2^30); S8: rint(v / sc) (pair_q_rc, rc
// = 1 / sc).
template <bool S8, int N>
__device__ __forceinline__ void operands(const float (&v)[N], double up, float sc, float rc,
                                         int (&q)[S8 ? 1 : kDigits][N]) {
  if constexpr (S8) {
    pair_q_rc(v, sc, rc, q[0]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      int x = __double2int_rn((double)v[e] * up);
#pragma unroll
      for (int i = 0; i < kDigits - 1; ++i) {
        q[i][e] = ((x + 128) & 255) - 128;
        x = (x - q[i][e]) >> 8;
      }
      q[kDigits - 1][e] = x;
    }
  }
}

// A dot's fp32 value from its exact integer sum d: exact: d * 2^(E - kFix) rounded once (sc = that power of
// two; d < 2^52 converts exactly); S8: fp32(d) * sc (int_dot's rounding, then the row scale).
template <bool S8>
__device__ __forceinline__ float dot_value(long long d, double sc) {
  if constexpr (S8) return __fmul_rn(__ll2float_rn(d), (float)sc);
  else return __double2float_rn(__ll2double_rn(d) * sc);
}

// BITS 8: int8 tables; BITS 4 (exact only): split-halves packed int4 tables, a stage 64 packed rows.
template <bool S8, int BITS, int R, typename In>
__global__ void __launch_bounds__(kAll, 1) rf_sampler_q8_kernel(const __grid_constant__ Params p) {
  static_assert(BITS == 8 || !S8, "the int4 tables' mode here is the exact one");
  constexpr int ND = S8 ? 1 : kDigits;  // operand rows a row
  constexpr int NN = R * ND;            // B columns: operand row n = r * ND + digit
  constexpr int NT = (NN + 7) / 8;      // their n-tiles
  constexpr int PL = BITS == 4 ? 2 : 1;  // nibble planes a table row
  const RFArgs& a = p.a;
  const int w = a.w, H = a.H, C = a.C, B = a.B, L = a.L, S = a.S;
  const int NS = p.ring, CH = p.ch, NP = p.pieces;
  const int Tu = cdiv(H, kUpCols), KTu = w / PL / kRows, Td = cdiv(w, kTileCols), KTd = H / PL / kRows;
  const int G = gridDim.x, cta = blockIdx.x;
  const int u0 = run_first(cta, Tu * KTu, G), u1 = run_first(cta + 1, Tu * KTu, G);
  const int d0 = run_first(cta, Td * KTd, G), d1 = run_first(cta + 1, Td * KTd, G);
  const Smem lay(R, ND, w, NP, NS, p.nslots, PL);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring_u32 = smem_u32(sm + lay.ring), full0 = smem_u32(sm + lay.bars), empty0 = full0 + 8 * NS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  float* lat = reinterpret_cast<float*>(sm + lay.lat);
  for (int i = tid; i < R * kLat; i += kAll) {
    const int r = i / kLat, c = i % kLat;
    lat[i] = c < C ? a.x0[r * C + c] : 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer: one lane issues every stage of the sample in order
    if (lane == 0) {
      // stage k of the sequence: per block (k / nb), the CTA's up units, then its down units
      const int nu = u1 - u0, nb = nu + (d1 - d0), total = S * L * nb;
      const uint64_t once = l2_evict_first();  // the tables are read once a step: keep L2 for what is read again
      for (int it = 0; it < total; ++it) {
        const int j = it % nb, l = (it / nb) % L;
        const CUtensorMap* map;
        int col[4], row;
        bool box[4];  // the boxes loaded (a box wholly past its table's columns is not)
        if (j < nu) {
          const int u = u0 + j, j0 = (u / KTu) * kUpCols;
          const bool second = j0 + kBoxW < H;
          map = &p.m12, row = (u % KTu) * kRows;
          col[0] = j0, col[1] = j0 + kBoxW, col[2] = H + j0, col[3] = H + j0 + kBoxW;
          box[0] = box[2] = true, box[1] = box[3] = second;
        } else {
          const int u = d0 + j - nu, c0 = (u / KTd) * kTileCols;
          map = &p.m3, row = (u % KTd) * kRows;
#pragma unroll
          for (int q = 0; q < 4; ++q) col[q] = c0 + q * kBoxW, box[q] = col[q] < w;
        }
        const int slot = it % NS;
        if (it >= NS) wait_phase(empty0 + 8 * slot, ((it / NS) - 1) & 1);
        mbar_expect_tx(full0 + 8 * slot, (box[0] + box[1] + box[2] + box[3]) * kBoxBytes);
        for (int q = 0; q < 4; ++q)
          if (box[q])
            tma_load_3d_hint(ring_u32 + slot * kStageBytes + q * kBoxBytes, map, full0 + 8 * slot, col[q], row, l,
                             once);
      }
    }
    return;
  }

  // ---- the consumers ----
  float* xs = reinterpret_cast<float*>(sm + lay.xs);
  float* vel = reinterpret_cast<float*>(sm + lay.vel);
  int8_t* xd = reinterpret_cast<int8_t*>(sm + lay.xd);  // [R * ND][ldx]: x's operand rows, the lanes' order
  int8_t* hd = reinterpret_cast<int8_t*>(sm + lay.hd);  // [R * ND][ldh]: those of h's kept stages
  double* xsc = reinterpret_cast<double*>(sm + lay.xsc);  // [R]: x's 2^(E - kFix) (S8: its scale)
  double* hsc = reinterpret_cast<double*>(sm + lay.hsc);  // [R][NP]: h's, per piece
  float* stats = reinterpret_cast<float*>(sm + lay.stats);
  float* fscr = reinterpret_cast<float*>(sm + lay.fscr);
  int* flag = reinterpret_cast<int*>(sm + lay.misc);
  const unsigned char* ring = sm + lay.ring;
  const Workspace ws(p.iws, Tu, Td, NP);
  const int ldx = lay.ldx, ldh = lay.ldh;
  const int g = lane >> 2, t = lane & 3;
  int bn[NT];  // the lane's B operand row in each n-tile (past NN: row 0, whose D is not read)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) bn[nt] = 8 * nt + g < NN ? 8 * nt + g : 0;
  int aoff[4];  // the lane's A words in a stage: its warp's box and 32-byte half, rows phys_row(t, r)
#pragma unroll
  for (int r = 0; r < 4; ++r)
    aoff[r] = (warp >> 1) * kBoxBytes + phys_row(t, r) * kBoxW +
              ((((warp & 1) * 2 + (g >> 2)) ^ ((phys_row(t, r) >> 1) & 3)) << 4) + 4 * (g & 3);

  int slot = 0, phase = 0;  // the ring's next slot and its phase, counted (no division in the stage loop)
  int dv[2][NT][4];
  auto zero = [&]() {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[q][nt][i] = 0;
  };
  // the next stage's products against the operand rows ops (pitch ld) from row k0; int4: the high plane's
  // operands hi bytes further on
  auto consume = [&](const int8_t* ops, int ld, int k0, int hi) {
    wait_phase(full0 + 8 * slot, phase);
    const unsigned char* st = ring + slot * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kRows; kk += 32) {
      uint32_t b[NT][2], bh[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int off = bn[nt] * ld + k0 + kk + 4 * t;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(ops + off);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(ops + off + 16);
        if constexpr (BITS == 4) {
          bh[nt][0] = *reinterpret_cast<const uint32_t*>(ops + hi + off);
          bh[nt][1] = *reinterpret_cast<const uint32_t*>(ops + hi + off + 16);
        }
      }
      uint32_t wd[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wd[hf][r] = *reinterpret_cast<const uint32_t*>(st + aoff[r] + (kk + 16 * hf) * kBoxW);
      if constexpr (BITS == 4) q4x_k32<NT>(wd, b, bh, dv);
      else s8_k32<NT>(wd, b, dv);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    if (++slot == NS) slot = 0, phase ^= 1;
  };
  // the partials into a tile's accumulators acc [kMaxRows][kTileCols], columns where ok(column). Element i of
  // dv[q][nt] is column 32 warp + 4 g + 2 q + i / 2 and operand row n = 8 nt + 2 t + i % 2 (mma_s8's layout):
  // S8: row n; exact: row n / 4 = 2 nt + t / 2, digits 2 (t & 1) and 2 (t & 1) + 1, combined with the other two
  // (lane t ^ 1) into the row's exact sum
  auto flush = [&](long long* acc, auto ok) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const int col = 32 * warp + 4 * g + 2 * q + hc;
          if constexpr (S8) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 2 * t + e, v = dv[q][nt][2 * hc + e];
              if (n < R && ok(col) && v)
                atomicAdd(reinterpret_cast<unsigned long long*>(acc + n * kTileCols + col), (unsigned long long)(long long)v);
            }
          } else {
            long long v = (long long)dv[q][nt][2 * hc] + 256ll * dv[q][nt][2 * hc + 1];
            if (t & 1) v *= 65536ll;
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            const int r = 2 * nt + (t >> 1);
            if (!(t & 1) && r < R && ok(col) && v)
              atomicAdd(reinterpret_cast<unsigned long long*>(acc + r * kTileCols + col), (unsigned long long)v);
          }
        }
    zero();
  };

  // x lives in the workspace, by block b: its input xbuf[b & 1] (b a step's first block: xin, input_proj's),
  // its output xbuf[(b + 1) & 1]; each buffer [kMaxRows][w]
  float* const xbuf = a.xcur;
  float* const xin = a.xcur + 2 * kMaxRows * w;
  unsigned barriers = 0;
  const int hb = p.round_x ? a.h_bf16 : 0;  // the rounding of x's modulated LN before its operands
  for (int s = 0; s < S; ++s) {
    if (!p.stack) input_proj_rows<R>(a, static_cast<const In*>(p.win), lat, xs, xin, G, cta);
    for (int l = 0; l < L; ++l) {
      const int b = s * L + l, par = b & 1;
      const float* x_in = l > 0 ? xbuf + par * kMaxRows * w : p.stack ? p.x_ext : xin;
      float* const x_out = p.stack && l == L - 1 ? p.out_ext : xbuf + (par ^ 1) * kMaxRows * w;
      const size_t m0 = ((size_t)l * S + s) * B * 3 * w;  // mods[l, s]: [B][3w] shift, scale, gate
      const In* md = static_cast<const In*>(p.mods) + m0;
      if (l > 0 || p.stack) {
        for (int i = 4 * tid; i < R * w; i += 4 * kConsumers)
          *reinterpret_cast<float4*>(xs + i) = __ldcg(reinterpret_cast<const float4*>(x_in + i));
        ConsumerSync::sync();
      }
      // x: the modulated LN in the compute dtype (the row statistics in the plain version's order) in place of x,
      // a thread per 4 columns, with the row maxima; then x's operands over all w rows from shared memory
      row_stats<R, ConsumerSync>(xs, w, a.ln_eps, stats, fscr);
      // a thread per 4 columns: the modulated LN in place, and its share of the row maxima
      float mx[R];
#pragma unroll
      for (int r = 0; r < R; ++r) mx[r] = 0.0f;
      {
        const float* lw = a.lnw + (size_t)l * w;
        const float* lb = a.lnb + (size_t)l * w;
#pragma unroll 2
        for (int i = tid; i < R * (w / 4); i += kConsumers) {
          const int r = i / (w / 4), c0 = (i % (w / 4)) * 4;
          const float4 sh = load4(md + (size_t)r * 3 * w + c0), sc = load4(md + (size_t)r * 3 * w + w + c0);
          const float4 gw = __ldg(reinterpret_cast<const float4*>(lw + c0));
          const float4 gb = __ldg(reinterpret_cast<const float4*>(lb + c0));
          float4& x = *reinterpret_cast<float4*>(xs + r * w + c0);
          float v[4], m = 0.0f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = __fmul_rn(__fsub_rn(lane4(x, e), stats[2 * r]), stats[2 * r + 1]);
            const float ln = __fadd_rn(__fmul_rn(d, lane4(gw, e)), lane4(gb, e));
            v[e] = to_compute(__fadd_rn(__fmul_rn(ln, __fadd_rn(1.0f, lane4(sc, e))), lane4(sh, e)), hb);
            m = fmaxf(m, fabsf(v[e]));
          }
          x = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
            if (rr == r) mx[rr] = fmaxf(mx[rr], m);
        }
      }
      {
        block_allreduce<R>(mx, fscr, MaxOp<float>(), ConsumerSync());
        double up[R];
        float sc[R], rc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sc[r] = S8 ? pair_scale(mx[r]) : 0.0f;
          rc[r] = S8 ? __frcp_rn(sc[r]) : 0.0f;
          up[r] = S8 ? 0.0 : ldexp(1.0, kFix - row_exponent(mx[r]));
        }
        const int xchunks = w / 4, nx = R * xchunks;  // 4-row chunks
        for (int i = tid; i < cdiv(nx, 32) * 32; i += kConsumers) {  // whole warps: the 4 chunks of a group swap bytes
          const int r = i < nx ? i / xchunks : 0, row0 = (i % xchunks) * 4;
          int q[ND][4];
#pragma unroll
          for (int k = 0; k < ND; ++k) q[k][0] = q[k][1] = q[k][2] = q[k][3] = 0;
          if (i < nx) {
            const float4 x4 = *reinterpret_cast<const float4*>(xs + r * w + row0);
            const float v[4] = {x4.x, x4.y, x4.z, x4.w};
            double upr = 0.0;
            float scr = 0.0f, rcr = 0.0f;
#pragma unroll
            for (int rr = 0; rr < R; ++rr)
              if (rr == r) upr = up[rr], scr = sc[rr], rcr = rc[rr];
            operands<S8>(v, upr, scr, rcr, q);
          }
          // word m of the group holds rows phys_row(m, 0..3): bytes 0, 2 (m even) or 1, 3 (m odd) of chunks m / 2
          // and m / 2 + 2
          const int m = i & 3, base = lane & ~3;
          const uint32_t sel = m & 1 ? 0x7531u : 0x6420u;
#pragma unroll
          for (int k = 0; k < ND; ++k) {
            const uint32_t pk = pack_s8(q[k][0], q[k][1], q[k][2], q[k][3]);
            const uint32_t wd = __byte_perm(__shfl_sync(0xffffffffu, pk, base + (m >> 1)),
                                            __shfl_sync(0xffffffffu, pk, base + (m >> 1) + 2), sel);
            if (i < nx) *reinterpret_cast<uint32_t*>(xd + (r * ND + k) * ldx + row0) = wd;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (tid == r) xsc[r] = S8 ? (double)sc[r] : ldexp(1.0, row_exponent(mx[r]) - kFix);
        ConsumerSync::sync();
      }

      // up units: gate / up columns; the tile's last contributor writes h and the row maxima
      const float* s12 = a.s12 + (size_t)l * 2 * H;
      const float* b12 = a.b12 + (size_t)l * 2 * H;
      zero();
      for (int u = u0, tile = u0 / KTu, ks = u0 % KTu; u < u1; ++u, ks = ks == KTu - 1 ? 0 : ks + 1,
               tile += ks == 0) {
        consume(xd, ldx, ks * kRows, w / 2);  // int4: x's second half meets the high nibbles
        if (ks < KTu - 1 && u < u1 - 1) continue;
        const int j0 = tile * kUpCols;
        flush(ws.acc_up + (size_t)tile * kMaxRows * kTileCols, [&](int col) { return j0 + col % kUpCols < H; });
        if (!take_ticket(ws.tickets + tile, u - max(u0, tile * KTu) + 1, KTu, flag)) continue;
        for (int i = tid; i < R * kUpCols; i += kConsumers) {  // a thread per (row, column): a warp's 32 in one row
          const int r = i / kUpCols, c = i % kUpCols, j = j0 + c;
          float m = 0.0f;
          if (j < H) {
            long long* acc = ws.acc_up + ((size_t)tile * kMaxRows + r) * kTileCols + c;
            const long long dg = take(acc), du = take(acc + kUpCols);
            const float gv = __fadd_rn(__fmul_rn(dot_value<S8>(dg, xsc[r]), s12[j]), b12[j]);
            const float uv = __fadd_rn(__fmul_rn(dot_value<S8>(du, xsc[r]), s12[H + j]), b12[H + j]);
            float hv = __fmul_rn(silu_exact(gv), uv);
            if constexpr (!S8) hv = to_compute(hv, a.h_bf16);
            __stcg(a.hbuf + (size_t)r * H + j, hv);
            m = fabsf(hv);
          }
          m = warp_max(m);
          if (lane == 0 && j < H) atomicMax(ws.hmax + (par * kMaxRows + r) * NP + j / CH, __float_as_uint(m));
        }
      }
      grid_barrier(ws.bar, ++barriers * G);

      // h: the operands of the stages this CTA's down units read, a thread per 16-row group of a kept stage and
      // row, each with its piece's row maximum (one round trip); and every piece's scale, for the down epilogue
      constexpr int kGroups = kRows / 16;  // 16-row groups a stage
      const int nsl = min(d1 - d0, KTd), kbase = d1 > d0 ? d0 % KTd : 0, nh = PL * R * nsl * kGroups;
      for (int i = tid; i < R * NP; i += kConsumers) {
        const float mxh = __uint_as_float(__ldcg(ws.hmax + par * kMaxRows * NP + i));
        hsc[i] = S8 ? (double)pair_scale(mxh) : ldexp(1.0, row_exponent(mxh) - kFix);
      }
      for (int i = tid; i < nh; i += kConsumers) {  // int4: i past R * nsl * kGroups, the high plane's operands
        const int pr = i / (nsl * kGroups), r = pr % R, hslot = (i / kGroups) % nsl, grp = i % kGroups;
        const int row0 = (pr / R) * (H / 2) + ((kbase + hslot) % KTd) * kRows + grp * 16;
        const float mxh = __uint_as_float(__ldcg(ws.hmax + (par * kMaxRows + r) * NP + row0 / CH));
        const float* hr = a.hbuf + (size_t)r * H + row0;
        float v[16];
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const float4 h4 = __ldcg(reinterpret_cast<const float4*>(hr + e));
          v[e] = h4.x, v[e + 1] = h4.y, v[e + 2] = h4.z, v[e + 3] = h4.w;
        }
        const float sch = S8 ? pair_scale(mxh) : 0.0f;
        int q[ND][16];
        operands<S8>(v, S8 ? 0.0 : ldexp(1.0, kFix - row_exponent(mxh)), sch, S8 ? __frcp_rn(sch) : 0.0f, q);
#pragma unroll
        for (int k = 0; k < ND; ++k)
#pragma unroll
          for (int tt = 0; tt < 4; ++tt)  // word tt: rows phys_row(tt, 0..3)
            reinterpret_cast<uint32_t*>(hd + ((pr / R) * NN + r * ND + k) * ldh + hslot * kRows + grp * 16)[tt] =
                pack_s8(q[k][phys_row(tt, 0)], q[k][phys_row(tt, 1)], q[k][phys_row(tt, 2)], q[k][phys_row(tt, 3)]);
      }
      ConsumerSync::sync();

      // down units: the residual through the gate modulation, written by each tile's last contributor
      const float* s3 = a.s3 + (size_t)l * w;
      const float* b3 = a.b3 + (size_t)l * w;
      const int kp = CH / kRows;  // stages a piece
      zero();
      for (int u = d0, tile = d0 / KTd, k = kbase, hs = 0; u < d1;  // hs: the stage's slot of h's operands
           ++u, k = k == KTd - 1 ? 0 : k + 1, tile += k == 0, hs = hs == KTd - 1 ? 0 : hs + 1) {
        const int c0 = tile * kTileCols;
        consume(hd, ldh, hs * kRows, NN * ldh);  // int4: h's second half meets the high nibbles
        const bool tile_end = k == KTd - 1 || u == d1 - 1;
        if (!tile_end && (k + 1) % kp) continue;
        flush(ws.acc_dn + ((size_t)(k / kp) * Td + tile) * kMaxRows * kTileCols, [&](int col) { return c0 + col < w; });
        if (!tile_end) continue;
        const int kf = max(d0, tile * KTd) - tile * KTd;  // the run's first stage in the tile
        if (!take_ticket(ws.tickets + Tu + tile, k - kf + 1, KTd, flag)) continue;
        // a thread per column, every row (S8: the loads of up to 4 pieces in one round trip)
        for (int col = tid, j = c0 + tid; col < kTileCols && j < w; col += kConsumers, j += kConsumers) {
          const float s3j = s3[j], b3j = b3[j];
          float po[R];
          if constexpr (S8) {  // the pieces' descaled sums in piece order (the stack: each times s3)
#pragma unroll
            for (int r = 0; r < R; ++r) po[r] = 0.0f;
            for (int pc0 = 0; pc0 < NP; pc0 += 4) {
              long long d[4][R];
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int r = 0; r < R; ++r)
                  if (pc0 + q < NP) d[q][r] = take(ws.acc_dn + (((size_t)(pc0 + q) * Td + tile) * kMaxRows + r) * kTileCols + col);
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int r = 0; r < R; ++r)
                  if (pc0 + q < NP) {
                    const float dq = dot_value<true>(d[q][r], hsc[r * NP + pc0 + q]);
                    po[r] = __fadd_rn(po[r], p.s3_per_piece ? __fmul_rn(dq, s3j) : dq);
                  }
            }
          } else {
#pragma unroll
            for (int r = 0; r < R; ++r)
              po[r] = dot_value<false>(take(ws.acc_dn + ((size_t)tile * kMaxRows + r) * kTileCols + col), hsc[r]);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float gate = to_f32(md[(size_t)r * 3 * w + 2 * w + j]), xv = __ldcg(x_in + (size_t)r * w + j);
            const float y = __fadd_rn(p.s3_per_piece ? po[r] : __fmul_rn(po[r], s3j), b3j);
            __stcg(x_out + (size_t)r * w + j, __fadd_rn(xv, __fmul_rn(gate, y)));
          }
        }
      }
      grid_barrier(ws.bar, ++barriers * G);
      if (cta == 0)  // this block's row maxima, read by all before the barrier
        for (int i = tid; i < kMaxRows * NP; i += kConsumers) ws.hmax[par * kMaxRows * NP + i] = 0u;
    }
    if (p.stack) continue;  // the stack's one step ends with its last block's x
    // the velocity of x (rf_persistent.cuh), then the CFG combine and the Euler update (rf_sampler_common.cuh)
    const float* x_last = xbuf + ((s * L + L) & 1) * kMaxRows * w;
    final_velocity<R>(a, s, static_cast<const In*>(p.fmods), static_cast<const In*>(p.wfin_t), x_last, xs, vel,
                      stats, fscr);
    guide_step<R, ConsumerSync>(a, s, lat, vel);
  }
  reset_barrier(ws.bar, G);
  if (cta == 0)
    for (int i = tid; i < B * C; i += kConsumers) a.out[i] = lat[(i / C) * kLat + i % C];
}

template <bool S8, int BITS>
cudaError_t launch_rows(const Params& p, size_t smem, cudaStream_t st, int G, int B, int bf16_in) {
  auto go = [&](auto kernel) { return launch_cooperative(kernel, smem, p, st, kAll, G); };
  if constexpr (BITS == 4) {  // the stack's int4 exact body only: fp32 modulations
    switch (B) {
      case 1: return go(rf_sampler_q8_kernel<false, 4, 1, float>);
      case 2: return go(rf_sampler_q8_kernel<false, 4, 2, float>);
      case 3: return go(rf_sampler_q8_kernel<false, 4, 3, float>);
      default: return go(rf_sampler_q8_kernel<false, 4, 4, float>);
    }
  } else {
    switch (B * 2 + (bf16_in ? 1 : 0)) {
      case 2: return go(rf_sampler_q8_kernel<S8, 8, 1, float>);
      case 3: return go(rf_sampler_q8_kernel<S8, 8, 1, bf16>);
      case 4: return go(rf_sampler_q8_kernel<S8, 8, 2, float>);
      case 5: return go(rf_sampler_q8_kernel<S8, 8, 2, bf16>);
      case 6: return go(rf_sampler_q8_kernel<S8, 8, 3, float>);
      case 7: return go(rf_sampler_q8_kernel<S8, 8, 3, bf16>);
      case 8: return go(rf_sampler_q8_kernel<S8, 8, 4, float>);
      default: return go(rf_sampler_q8_kernel<S8, 8, 4, bf16>);
    }
  }
}

// The launch shared by both entries: p.a, the operand pointers and the mode's fields set; here the pieces, the
// ring, h's kept stages and the tensor maps. bits 4: split-halves packed int4 tables (exact only).
int run(Params& p, const void* q12, const void* q3, int bits, int s8_dots, int chunk, int grid, int bf16_in,
        cudaStream_t st) {
  const int w = p.a.w, H = p.a.H, L = p.a.L, B = p.a.B, pl = bits == 4 ? 2 : 1;
  p.ch = s8_dots ? chunk : H;
  p.pieces = H / p.ch;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int G = grid ? grid : sms, Td = cdiv(w, kTileCols), KTd = H / pl / kRows, nd = s8_dots ? 1 : kDigits;
  p.nslots = min(cdiv(Td * KTd, G), KTd);
  const size_t rest = Smem(B, nd, w, p.pieces, 0, p.nslots, pl).bytes;
  p.ring = (int)min((size_t)kMaxRing, ((size_t)optin - min((size_t)optin, rest)) / (kStageBytes + 16));
  if (p.ring < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = Smem(B, nd, w, p.pieces, p.ring, p.nslots, pl).bytes;
  // the tables as 3-D byte tensors (columns, rows, layer; int4: packed rows), 64-byte x 64-row boxes, 64-byte
  // swizzle
  const cuuint64_t d12[3] = {(cuuint64_t)2 * H, (cuuint64_t)w / pl, (cuuint64_t)L};
  const cuuint64_t s12s[2] = {(cuuint64_t)2 * H, (cuuint64_t)w / pl * 2 * H};
  const cuuint64_t d3[3] = {(cuuint64_t)w, (cuuint64_t)H / pl, (cuuint64_t)L};
  const cuuint64_t s3s[2] = {(cuuint64_t)w, (cuuint64_t)H / pl * w};
  const cuuint32_t box[3] = {kBoxW, (cuuint32_t)kRows, 1};
  if (!encode(&p.m12, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, q12, d12, s12s, box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(&p.m3, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, q3, d3, s3s, box, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  err = bits == 4 ? launch_rows<false, 4>(p, smem, st, G, B, 0)
        : s8_dots ? launch_rows<true, 8>(p, smem, st, G, B, bf16_in)
                  : launch_rows<false, 8>(p, smem, st, G, B, bf16_in);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is reported here, not to the next kernel's check
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One Euler sample (S steps x L blocks) of B <= 4 CFG rows, the arguments of
// mu_rf_sampler_q4s8 with int8 block tables: q12 (L, w, 2H) and q3 (L, H, w)
// int8 with fp32 scales s12 (L, 2H) / s3 (L, w) and biases b12 / b3; win,
// mods, fmods and wfin_t bf16 with bf16_in (the compute dtype bf16), else
// fp32. s8_dots: 1 for s8 dots (h re-quantized per `chunk` columns, a multiple
// of 64 dividing H), 0 for the exact digit dots (chunk unread). The workspace
// (ops/kernels/rf_sampler.py q8_workspace_sizes, zeroed once when allocated;
// every launch leaves it so): fws fp32 h (4 x H) then x (3 x 4 x w); iws int32
// words: int64 accumulators, tickets, row maxima and the barrier counts
// (mu_rf_sampler_q8_workspace). grid: the CTAs, 0 for one per SM. w and H
// multiples of 64, C <= 128. One cooperative launch.
extern "C" int mu_rf_sampler_q8(const void* dts, const void* x0, const void* win, const void* binp, const void* lnw,
                                const void* lnb, const void* q12, const void* s12, const void* b12, const void* q3,
                                const void* s3, const void* b3, const void* mods, const void* fmods,
                                const void* wfin_t, const void* bfin, void* fws, void* iws, void* out, int B,
                                int cfg_rows, int renorm, int S, int L, int w, int H, int C, int h_bf16,
                                int bf16_in, int s8_dots, int chunk, int grid, float text_cfg, float image_cfg,
                                float ln_eps, void* stream) {
  if (B < 1 || B > kMaxRows || w <= 0 || H <= 0 || w % 64 || H % 64 || C > kLat || grid < 0 ||
      (s8_dots && (chunk <= 0 || chunk % kRows || H % chunk)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  float* f = static_cast<float*>(fws);
  p.a = rf::make_args(dts, x0, nullptr, binp, lnw, lnb, q12, s12, b12, q3, s3, b3, nullptr, nullptr, nullptr, bfin,
                      f + (size_t)kMaxRows * H, f, out, B, cfg_rows, renorm, S, L, w, H, C, h_bf16, text_cfg,
                      image_cfg, ln_eps);
  p.mods = mods;
  p.fmods = fmods;
  p.win = win;
  p.wfin_t = wfin_t;
  p.iws = static_cast<int*>(iws);
  p.round_x = 1;
  return run(p, q12, q3, 8, s8_dots, chunk, grid, bf16_in, static_cast<cudaStream_t>(stream));
}

// One Euler step of the residual stack (the stack mode, see the top of this
// file) over B <= 4 rows: x (B, w) fp32 holding compute-dtype values (h_bf16:
// the compute dtype is bf16); lnw / lnb (L, w); bits 8: q12 (L, w, 2H) / q3
// (L, H, w) int8, exact digit dots or (s8_dots) s8 dots with h re-quantized per
// `chunk` columns (a multiple of 64 dividing H); bits 4 (exact only): q12 (L,
// w/2, 2H) / q3 (L, H/2, w) split-halves packed int4 (w and H multiples of
// 128); fp32 scales s12 (L, 2H) / s3 (L, w), biases b12 / b3; mods (L, B, 3w)
// fp32; out (B, w) fp32, x after block L-1. The workspace as
// mu_rf_sampler_q8's (int32 words: mu_rf_sampler_q8_workspace(w, H, s8_dots,
// chunk) at either bits). grid: the CTAs, 0 for one per SM. One cooperative
// launch.
extern "C" int mu_rf_stack_q8(const void* x, const void* lnw, const void* lnb, const void* q12, const void* s12,
                              const void* b12, const void* q3, const void* s3, const void* b3, const void* mods,
                              void* out, void* fws, void* iws, int B, int L, int w, int H, int h_bf16, int bits,
                              int s8_dots, int chunk, int grid, float ln_eps, void* stream) {
  if (B < 1 || B > kMaxRows || w <= 0 || H <= 0 || w % 64 || H % 64 || grid < 0 || (bits != 8 && bits != 4) ||
      (bits == 4 && (s8_dots || w % 128 || H % 128)) || (s8_dots && (chunk <= 0 || chunk % kRows || H % chunk)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  float* f = static_cast<float*>(fws);
  p.a = rf::make_args(nullptr, nullptr, nullptr, nullptr, lnw, lnb, q12, s12, b12, q3, s3, b3, nullptr, nullptr,
                      nullptr, nullptr, f + (size_t)kMaxRows * H, f, nullptr, B, 1, 0, 1, L, w, H, 0, h_bf16, 0.0f,
                      0.0f, ln_eps);
  p.mods = mods;
  p.iws = static_cast<int*>(iws);
  p.stack = 1;
  p.round_x = !s8_dots;
  p.s3_per_piece = s8_dots;
  p.x_ext = static_cast<const float*>(x);
  p.out_ext = static_cast<float*>(out);
  return run(p, q12, q3, bits, s8_dots, chunk, grid, 0, static_cast<cudaStream_t>(stream));
}

// Words of the int32 workspace a launch over (w, H) reads: s8 dots with h in `chunk`-column pieces, or the exact
// mode's one piece (the fp32 one: 4 x (H + 3w)).
extern "C" int mu_rf_sampler_q8_workspace(int w, int H, int s8_dots, int chunk) {
  const int pieces = s8_dots ? H / chunk : 1;
  return (int)Workspace::words(cdiv(H, kUpCols), cdiv(w, kTileCols), pieces);
}
