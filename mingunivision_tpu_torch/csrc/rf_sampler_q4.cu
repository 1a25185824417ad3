// Fused whole-sampler of the rectified-flow head over linear int4 tables: all
// Euler steps of one sample in ONE launch.
//
// Replaces the TPU kernels mingunivision_tpu/ops/kernels/rf_sampler.py
// (rf_sample_fused -> _sampler_q4_s8, with _modulated_ln and _step_epilogue;
// and rf_sample_fused(schedule="pipelined") -> _sampler_q4_s8_pipelined).
// Per Euler step s and AdaLN block l (rows r < B, width w, SwiGLU hidden H):
//   xs   = LN(x) * ln_w + ln_b, modulated by (shift, scale) of mods[l, s]
//   g, u = xs @ W12[:, :H] * s + b, xs @ W12[:, H:] * s + b  (s8 pair dots)
//   h    = silu(g) * u, rounded to the compute dtype
//   x   += gate * ((h @ W3) * s3 + b3)                      (s8 pair dots)
// then v = modulate(LN(x)) @ W_fin + b_fin, the CFG combine (1, 2 or 3 rows,
// optional channel renorm), latent += dt * v, and x = latent @ W_in + b_in for
// the next step. On the H100 the sample is bound by the packed int4 tables it
// streams: 453 MB per Euler step at the 16B-A3B width (w 3072, H 8192, 12
// blocks), 7.25 GB per sample, 2.16 ms at 3.35 TB/s.
//
// Design: a PERSISTENT COOPERATIVE grid (one CTA per SM, or the caller's
// grid; cudaLaunchCooperativeKernel, refused launches are reported) whose
// weight stream never waits on the arithmetic. Each CTA is warp-specialized:
//   one PRODUCER warp walks the CTA's fixed sequence of weight stages for the
//     whole sample (for each step and block: its up units, then its down
//     units) and fills a ring of 16 KB shared-memory stages by TMA (four
//     64-row x 64-byte boxes a stage, 64-byte swizzle; full / empty
//     mbarriers). The weights never depend on the activations, so it runs
//     ahead across phase ends, grid barriers and the step epilogue, held back
//     only by free ring slots;
//   eight CONSUMER warps (256 threads) do everything else, synchronized by a
//     named barrier; the grid barrier is theirs alone (an arrival counter in
//     the workspace, one thread spinning on it with acquire loads).
// Per block, between exactly two grid barriers:
//   every CTA   x (B x w fp32) into shared memory, the modulated LN (row
//               stats over the 256 consumer threads, the plain version's
//               order) in place, x's s8 pair over all of w / 2 packed rows;
//   up units    (tile of 64 column pairs: gate columns j and j + H/2, up
//               columns H + j and H + H/2 + j, 256 bytes a packed row) x
//               (stage of 64 packed rows of W12); each CTA takes a contiguous
//               run of the tile-major units (stream-K: every SM streams an
//               equal share, within one unit), keeps both dots' int32
//               partials in registers along the run, adds them into the
//               tile's accumulators (red.global.add) once per tile it
//               touches, then takes the tile's ticket (an acq_rel atomic).
//               The tile's last contributor runs its epilogue: g, u by the
//               fp32 steps, h = silu(g) * u in the compute dtype to the
//               workspace, the tile's row maxima of |h_j - h_{j+H/2} / 16|
//               and |h_{j+H/2}| by atomicMax on their bits (exact: they are
//               >= 0);                                              -- barrier
//   every CTA   the s8 pair of the packed rows its own down units read, from
//               h and its row maxima (one round trip), with each stage's
//               integer sums;
//   down units  (256 columns of W3) x (64 packed rows), stream-K as above;
//               with the partials, the integer sums of h's operands over the
//               stages the run covers in the tile (so the tile's last
//               contributor has corr's full sums); the pipelined schedule
//               keeps its partials per kc-row piece. The last contributor
//               writes the residual update of its columns into the block's
//               output x (the pieces' descaled sums added in piece order;
//               the block schedule's one sum is the same arithmetic, as
//               0 + s == s).                                        -- barrier
// After the last block, every CTA, redundantly and identically, runs the
// final layer, CFG combine and Euler update of the latent kept in shared
// memory, and input_proj of the next step (writing its share of it to the
// workspace, the first block's input). Every last contributor resets its
// tile's accumulators and ticket to zero, the row maxima and the operand sums
// are double-buffered and zeroed by CTA 0 after each block, x is
// triple-buffered (a block's input and output, input_proj's), and the last
// CTA out resets the barrier counter: the workspace needs no memset between
// launches. Where the compute dtype is bf16 and the modulations are bf16, the
// kernel reads them and the two projections as bf16 (their values are those of
// fp32 copies: one template), else as fp32. Under the saturated stream every
// global round trip costs the serial work about a microsecond, so each phase
// issues its loads together.
//
// The dots are s8 tensor-core products (q4_mma.cuh: mma.sync m16n8k32, the
// weight stage as A, the <= 4 rows as B in one n-tile). A lane reads its A
// words from contraction rows t0 + 2 r0 + 4 t1 + 8 r1 of each 16-row group
// (t = t0 + 2 t1 its lane's k quarter, r = r0 + 2 r1 the word), which the
// 64-byte swizzle puts on 32 distinct banks; the activations' s8 operands are
// stored in the same order. Integer sums are exact in any order, so neither
// the units' split nor the arrival order can change a bit; every fp32 step is
// rounded as written (__f*_rn: no fused multiply-add), 1/sqrt is IEEE, exp is
// taken in double (silu_exact), and the plain version (ops/kernels/
// rf_sampler.py) sums its LN and final layer in this kernel's order: the two
// agree to the bit.
//
// The same body also runs ONE Euler step of the residual stack alone (the
// stack mode, mu_rf_stack_q4s8: the per-step RF route, replacing the TPU
// kernel mingunivision_tpu/ops/kernels/rf_mlp.py rf_mlp_stack -> _kernel_q4_s8):
// x comes in from the caller and leaves after block L-1; no input_proj, final
// layer, CFG or Euler update. Its down dots run in the pipelined schedule's kc
// pieces (1,024 packed rows), each piece's two descaled sums added one after
// the other, (po + d1 * sb1) + d2 * sb2 / 16, as the stack's plain version
// (ops/kernels/rf_mlp.py) adds them.
#include "q4_mma.cuh"
#include "rf_persistent.cuh"

namespace {

using namespace rf;

constexpr int kPairs = kBoxW;  // column pairs of an up tile

// The workspace's int32 words (ops/kernels/rf_sampler.py's q4_workspace_sizes; its fp32 part: h (kMaxRows x
// H), then x's two block buffers and input_proj's (3 x kMaxRows x w)).
struct Workspace {
  int *acc_up, *acc_dn, *dsum, *tickets;
  unsigned *hmax, *bar;
  __host__ __device__ Workspace(int* base, int Tu, int Td, int pieces) {
    acc_up = base;                                       // [Tu][2 dots][kMaxRows][kTileCols]
    acc_dn = acc_up + (size_t)Tu * 2 * kMaxRows * kTileCols;  // [pieces][Td][2][kMaxRows][kTileCols]
    dsum = acc_dn + (size_t)pieces * Td * 2 * kMaxRows * kTileCols;  // [2 parities][Td][kMaxRows][2]: h's sums
    tickets = dsum + 2 * Td * kMaxRows * 2;              // [Tu + Td]
    hmax = reinterpret_cast<unsigned*>(tickets + Tu + Td);  // [2 parities][kMaxRows][2]
    bar = hmax + 2 * kMaxRows * 2;                       // arrivals, exits
  }
  __host__ __device__ static size_t words(int Tu, int Td, int pieces) {
    return (size_t)Tu * 2 * kMaxRows * kTileCols + (size_t)pieces * Td * 2 * kMaxRows * kTileCols +
           2 * Td * kMaxRows * 2 + Tu + Td + 2 * kMaxRows * 2 + 2;
  }
};

struct alignas(64) Params {
  CUtensorMap m12, m3;  // (2H, w/2, L) and (w, H/2, L) packed bytes, 64-byte x 64-row boxes
  RFArgs a;             // a.xcur / a.hbuf: the workspace's fp32 parts
  // the modulations and the input and final projections (wfin transposed), in the kernel's In: bf16 where the
  // compute dtype is bf16 and the modulations are bf16 (the values are those of fp32 ones), else fp32
  const void *mods, *fmods, *win, *wfin_t;
  int* iws;
  int kc;      // the pipelined schedule's packed w3 rows a piece (0: the block schedule)
  int pieces;  // H/2 / kc, or 1
  int ring;    // stages of the ring
  int nslots;  // stages of h's operands a CTA keeps: min(its longest down run, KTd)
  // the stack mode: one step (S = 1), x (B x w fp32) from x_ext, the last block's output to out_ext; a piece's
  // two descaled sums added one after the other
  int stack;
  const float* x_ext;
  float* out_ext;
};

// Shared memory, from a 1024-byte aligned base.
struct Smem {
  size_t ring, bars, xs, lat, vel, xa1, xa2, hb1, hb2, ssum, stx, sth, stats, fscr, misc, bytes;
  int ldx, ldh;
  __host__ __device__ Smem(int R, int w, int ring_n, int nslots) {
    ldx = cdiv(w / 2, kRows) * kRows + 16;  // + 16: a B fragment's rows on distinct banks
    ldh = nslots * kRows + 16;
    size_t o = 0;
    ring = o; o += (size_t)ring_n * kStageBytes;
    bars = o; o += align16((size_t)ring_n * 16);
    xs = o; o += align16((size_t)R * w * 4);
    lat = o; o += align16((size_t)R * kLat * 4);
    vel = o; o += align16((size_t)R * kLat * 4);
    xa1 = o; o += align16((size_t)R * ldx);
    xa2 = o; o += align16((size_t)R * ldx);
    hb1 = o; o += align16((size_t)R * ldh);
    hb2 = o; o += align16((size_t)R * ldh);
    ssum = o; o += align16((size_t)nslots * R * 2 * 4);
    stx = o; o += align16(4 * R * 4);
    sth = o; o += align16(4 * R * 4);
    stats = o; o += align16(2 * R * 4);
    fscr = o; o += align16(32 * 2 * R * 4);
    misc = o; o += 16;
    bytes = o + 1024;  // the base's alignment
  }
};

// The s8 pair of 16 packed rows (lo[i] = x_lo, hi[i] = x_hi at physical row
// row0 + i) into the operand rows o1 / o2 at row0 in the lanes' order, with
// their sums added to s1 / s2.
__device__ __forceinline__ void store_pair16(const float (&lo)[16], const float (&hi)[16], float sa1, float sa2,
                                             int8_t* o1, int8_t* o2, int row0, int& s1, int& s2) {
  const float rc1 = __frcp_rn(sa1), rc2 = __frcp_rn(sa2);
#pragma unroll
  for (int t = 0; t < 4; ++t) {  // word t: rows phys_row(t, 0..3)
    float c1[4], c2[4];
    int q1[4], q2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) c1[r] = pair_c1(lo[phys_row(t, r)], hi[phys_row(t, r)]), c2[r] = hi[phys_row(t, r)];
    pair_q_rc(c1, sa1, rc1, q1);
    pair_q_rc(c2, sa2, rc2, q2);
    reinterpret_cast<uint32_t*>(o1 + row0)[t] = pack_s8(q1[0], q1[1], q1[2], q1[3]);
    reinterpret_cast<uint32_t*>(o2 + row0)[t] = pack_s8(q2[0], q2[1], q2[2], q2[3]);
    s1 += q1[0] + q1[1] + q1[2] + q1[3];
    s2 += q2[0] + q2[1] + q2[2] + q2[3];
  }
}

template <int R, typename In>
__global__ void __launch_bounds__(kAll, 1) rf_sampler_q4s8_kernel(const __grid_constant__ Params p) {
  const RFArgs& a = p.a;
  const int w = a.w, H = a.H, C = a.C, B = a.B, L = a.L, S = a.S;
  const int wq = w / 2, Hh = H / 2, NS = p.ring;
  const int Tu = cdiv(Hh, kPairs), KTu = cdiv(wq, kRows), Td = cdiv(w, kTileCols), KTd = cdiv(Hh, kRows);
  const int G = gridDim.x, cta = blockIdx.x;
  const int u0 = run_first(cta, Tu * KTu, G), u1 = run_first(cta + 1, Tu * KTu, G);
  const int d0 = run_first(cta, Td * KTd, G), d1 = run_first(cta + 1, Td * KTd, G);
  const Smem lay(R, w, NS, p.nslots);
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
      auto stage_of = [&](int k, const CUtensorMap*& map, int& nbox, int (&col)[4], int& row) {
        const int j = k % nb;
        if (j < nu) {
          const int u = u0 + j, j0 = (u / KTu) * kPairs;
          map = &p.m12, nbox = 4, row = (u % KTu) * kRows;
          col[0] = j0, col[1] = Hh + j0, col[2] = H + j0, col[3] = H + Hh + j0;
        } else {
          const int u = d0 + j - nu, c0 = (u / KTd) * kTileCols;
          map = &p.m3, nbox = min(4, cdiv(w - c0, kBoxW)), row = (u % KTd) * kRows;  // boxes wholly past w: none
          col[0] = c0, col[1] = c0 + kBoxW, col[2] = c0 + 2 * kBoxW, col[3] = c0 + 3 * kBoxW;
        }
        return (k / nb) % L;
      };
      const uint64_t once = l2_evict_first();  // the tables are read once a step: keep L2 for what is read again
      for (int it = 0; it < total; ++it) {
        const CUtensorMap* map;
        int nbox, col[4], row;
        const int l = stage_of(it, map, nbox, col, row);
        const int slot = it % NS;
        if (it >= NS) wait_phase(empty0 + 8 * slot, ((it / NS) - 1) & 1);
        mbar_expect_tx(full0 + 8 * slot, nbox * kBoxBytes);
        for (int q = 0; q < nbox; ++q)
          tma_load_3d_hint(ring_u32 + slot * kStageBytes + q * kBoxBytes, map, full0 + 8 * slot, col[q], row, l, once);
      }
    }
    return;
  }

  // ---- the consumers ----
  float* xs = reinterpret_cast<float*>(sm + lay.xs);
  float* vel = reinterpret_cast<float*>(sm + lay.vel);
  int8_t* xa1 = reinterpret_cast<int8_t*>(sm + lay.xa1);
  int8_t* xa2 = reinterpret_cast<int8_t*>(sm + lay.xa2);
  int8_t* hb1 = reinterpret_cast<int8_t*>(sm + lay.hb1);
  int8_t* hb2 = reinterpret_cast<int8_t*>(sm + lay.hb2);
  int* ssum = reinterpret_cast<int*>(sm + lay.ssum);  // [slot][R][2]: each kept stage's sums of h's operands
  float* stx = reinterpret_cast<float*>(sm + lay.stx);  // [R][4]: x's sa1, sa2, corr
  float* sth = reinterpret_cast<float*>(sm + lay.sth);  // [R][4]: h's sa1, sa2, and the tile's corr
  float* stats = reinterpret_cast<float*>(sm + lay.stats);
  float* fscr = reinterpret_cast<float*>(sm + lay.fscr);
  int* flag = reinterpret_cast<int*>(sm + lay.misc);
  const unsigned char* ring = sm + lay.ring;
  const Workspace ws(p.iws, Tu, Td, p.pieces);
  const int ldx = lay.ldx, ldh = lay.ldh;
  const int g = lane >> 2, t = lane & 3, bn = g < R ? g : 0;  // B rows past R repeat row 0; their D is not read
  int aoff[4];  // the lane's A words in a stage: its warp's box and 32-byte half, rows phys_row(t, r)
#pragma unroll
  for (int r = 0; r < 4; ++r)
    aoff[r] = (warp >> 1) * kBoxBytes + phys_row(t, r) * kBoxW +
              ((((warp & 1) * 2 + (g >> 2)) ^ ((phys_row(t, r) >> 1) & 3)) << 4) + 4 * (g & 3);

  int slot = 0, phase = 0;  // the ring's next slot and its phase, counted (no division in the stage loop)
  int d1v[2][1][4], d2v[2][1][4];
  auto zero = [&]() {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) d1v[q][0][i] = d2v[q][0][i] = 0;
  };
  // the next stage's products against operand rows o1 / o2 (pitch ld) from row k0
  auto consume = [&](const int8_t* o1, const int8_t* o2, int ld, int k0) {
    wait_phase(full0 + 8 * slot, phase);
    const unsigned char* st = ring + slot * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kRows; kk += 32) {
      const int off = bn * ld + k0 + kk + 4 * t;
      const uint32_t b1[1][2] = {{*reinterpret_cast<const uint32_t*>(o1 + off),
                                  *reinterpret_cast<const uint32_t*>(o1 + off + 16)}};
      const uint32_t b2[1][2] = {{*reinterpret_cast<const uint32_t*>(o2 + off),
                                  *reinterpret_cast<const uint32_t*>(o2 + off + 16)}};
      uint32_t wd[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wd[hf][r] = *reinterpret_cast<const uint32_t*>(st + aoff[r] + (kk + 16 * hf) * kBoxW);
      q4_k32<1>(wd, b1, b2, d1v, d2v);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    if (++slot == NS) slot = 0, phase ^= 1;
  };
  // the partials into a tile's accumulators acc [2 dots][kMaxRows][kTileCols], columns where ok(column)
  auto flush = [&](int* acc, auto ok) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 32 * warp + 4 * g + 2 * q + (i >> 1), n = 2 * t + (i & 1);
        if (n < R && ok(col)) {
          if (d1v[q][0][i]) atomicAdd(acc + n * kTileCols + col, d1v[q][0][i]);
          if (d2v[q][0][i]) atomicAdd(acc + (kMaxRows + n) * kTileCols + col, d2v[q][0][i]);
        }
      }
    zero();
  };

  // x lives in the workspace, by block b: its input xbuf[b & 1] (b a step's first block: xin, input_proj's),
  // its output xbuf[(b + 1) & 1]; each buffer [kMaxRows][w]
  float* const xbuf = a.xcur;
  float* const xin = a.xcur + 2 * kMaxRows * w;
  unsigned barriers = 0;
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
      // x: the modulated LN (the row statistics in the plain version's order) in place of x, four columns a
      // thread, the loads of several issued together; then its s8 pair over all w / 2 packed rows (rows past
      // them zero) from shared memory: the row maxima, then the operands and their sums
      row_stats<R, ConsumerSync>(xs, w, a.ln_eps, stats, fscr);
      // a thread per 4 columns of x's low half and the 4 of its high half: the modulated LN of both in place, and
      // their share of the pair's row maxima
      const int xchunks = KTu * kRows / 4, nx = R * xchunks;  // 4-row chunks of the padded packed rows
      float mx[2 * R];
#pragma unroll
      for (int k = 0; k < 2 * R; ++k) mx[k] = 0.0f;
      {
        const float* lw = a.lnw + (size_t)l * w;
        const float* lb = a.lnb + (size_t)l * w;
#pragma unroll 2
        for (int i = tid; i < R * (wq / 4); i += kConsumers) {
          const int r = i / (wq / 4), i0 = (i % (wq / 4)) * 4;
          float v[2][4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int c0 = hf * wq + i0;
            const float4 sh = load4(md + (size_t)r * 3 * w + c0), sc = load4(md + (size_t)r * 3 * w + w + c0);
            const float4 gw = __ldg(reinterpret_cast<const float4*>(lw + c0));
            const float4 gb = __ldg(reinterpret_cast<const float4*>(lb + c0));
            float4& x = *reinterpret_cast<float4*>(xs + r * w + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float d = __fmul_rn(__fsub_rn(lane4(x, e), stats[2 * r]), stats[2 * r + 1]);
              const float ln = __fadd_rn(__fmul_rn(d, lane4(gw, e)), lane4(gb, e));
              v[hf][e] = __fadd_rn(__fmul_rn(ln, __fadd_rn(1.0f, lane4(sc, e))), lane4(sh, e));
            }
            x = make_float4(v[hf][0], v[hf][1], v[hf][2], v[hf][3]);
          }
          float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            m1 = fmaxf(m1, fabsf(pair_c1(v[0][e], v[1][e])));
            m2 = fmaxf(m2, fabsf(v[1][e]));
          }
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
            if (rr == r) mx[2 * rr] = fmaxf(mx[2 * rr], m1), mx[2 * rr + 1] = fmaxf(mx[2 * rr + 1], m2);
        }
      }
      {
        block_allreduce<2 * R>(mx, fscr, MaxOp<float>(), ConsumerSync());
        float sc[2 * R], rc[2 * R];
#pragma unroll
        for (int k = 0; k < 2 * R; ++k) sc[k] = pair_scale(mx[k]), rc[k] = __frcp_rn(sc[k]);
        int sums[2 * R];
#pragma unroll
        for (int k = 0; k < 2 * R; ++k) sums[k] = 0;
        for (int i = tid; i < cdiv(nx, 32) * 32; i += kConsumers) {  // whole warps: the 4 chunks of a group swap bytes
          const int r = i < nx ? i / xchunks : 0, row0 = (i % xchunks) * 4;
          int q1[4] = {0, 0, 0, 0}, q2[4] = {0, 0, 0, 0};
          if (i < nx && row0 < wq) {
            const float4 lo = *reinterpret_cast<const float4*>(xs + r * w + row0);
            const float4 hi = *reinterpret_cast<const float4*>(xs + r * w + wq + row0);
            float sa1 = 0.0f, sa2 = 0.0f, rc1 = 0.0f, rc2 = 0.0f;
#pragma unroll
            for (int rr = 0; rr < R; ++rr)
              if (rr == r) sa1 = sc[2 * rr], sa2 = sc[2 * rr + 1], rc1 = rc[2 * rr], rc2 = rc[2 * rr + 1];
            const float c1[4] = {pair_c1(lo.x, hi.x), pair_c1(lo.y, hi.y), pair_c1(lo.z, hi.z), pair_c1(lo.w, hi.w)};
            const float c2[4] = {hi.x, hi.y, hi.z, hi.w};
            pair_q_rc(c1, sa1, rc1, q1);
            pair_q_rc(c2, sa2, rc2, q2);
          }
          // word m of the group holds rows phys_row(m, 0..3): bytes 0, 2 (m even) or 1, 3 (m odd) of chunks m / 2
          // and m / 2 + 2
          const int m = i & 3, base = lane & ~3;
          const uint32_t p1 = pack_s8(q1[0], q1[1], q1[2], q1[3]), p2 = pack_s8(q2[0], q2[1], q2[2], q2[3]);
          const uint32_t sel = m & 1 ? 0x7531u : 0x6420u;
          const uint32_t w1 = __byte_perm(__shfl_sync(0xffffffffu, p1, base + (m >> 1)),
                                          __shfl_sync(0xffffffffu, p1, base + (m >> 1) + 2), sel);
          const uint32_t w2 = __byte_perm(__shfl_sync(0xffffffffu, p2, base + (m >> 1)),
                                          __shfl_sync(0xffffffffu, p2, base + (m >> 1) + 2), sel);
          if (i < nx) {
            *reinterpret_cast<uint32_t*>(xa1 + r * ldx + row0) = w1;
            *reinterpret_cast<uint32_t*>(xa2 + r * ldx + row0) = w2;
#pragma unroll
            for (int rr = 0; rr < R; ++rr)
              if (rr == r)
                sums[2 * rr] += q1[0] + q1[1] + q1[2] + q1[3], sums[2 * rr + 1] += q2[0] + q2[1] + q2[2] + q2[3];
          }
        }
        block_allreduce<2 * R>(sums, reinterpret_cast<int*>(fscr), SumOp<int>(), ConsumerSync());
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (tid == r) {
            stx[4 * r] = sc[2 * r];
            stx[4 * r + 1] = sc[2 * r + 1];
            stx[4 * r + 2] = pair_corr(sums[2 * r], sums[2 * r + 1], sc[2 * r], sc[2 * r + 1]);
          }
        ConsumerSync::sync();
      }

      // up units: gate / up columns; the tile's last contributor writes h and the row maxima
      const float* s12 = a.s12 + (size_t)l * 2 * H;
      const float* b12 = a.b12 + (size_t)l * 2 * H;
      zero();
      for (int u = u0, tile = u0 / KTu, ks = u0 % KTu; u < u1; ++u, ks = ks == KTu - 1 ? 0 : ks + 1,
               tile += ks == 0) {
        consume(xa1, xa2, ldx, ks * kRows);
        if (ks < KTu - 1 && u < u1 - 1) continue;
        const int j0 = tile * kPairs;
        flush(ws.acc_up + (size_t)tile * 2 * kMaxRows * kTileCols, [&](int col) { return j0 + col % kPairs < Hh; });
        if (!take_ticket(ws.tickets + tile, u - max(u0, tile * KTu) + 1, KTu, flag)) continue;
        for (int i = tid; i < R * kPairs; i += kConsumers) {  // a thread per (row, pair): a warp's 32 in one row
          const int r = i / kPairs, c = i % kPairs, j = j0 + c;
          float m1 = 0.0f, m2 = 0.0f;
          if (j < Hh) {
            int* acc = ws.acc_up + (size_t)tile * 2 * kMaxRows * kTileCols + r * kTileCols + c;
            float v[4];  // gate j, gate j + H/2, up H + j, up H + H/2 + j
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int colg = (q & 1) * Hh + (q >> 1) * H + j;
              v[q] = __fadd_rn(__fmul_rn(mm4_epilogue(take(acc + kPairs * q), take(acc + kMaxRows * kTileCols + kPairs * q),
                                                      stx + 4 * r),
                                         s12[colg]),
                               b12[colg]);
            }
            const float hlo = to_compute(__fmul_rn(silu_exact(v[0]), v[2]), a.h_bf16);
            const float hhi = to_compute(__fmul_rn(silu_exact(v[1]), v[3]), a.h_bf16);
            __stcg(a.hbuf + (size_t)r * H + j, hlo);
            __stcg(a.hbuf + (size_t)r * H + Hh + j, hhi);
            m1 = fabsf(pair_c1(hlo, hhi));
            m2 = fabsf(hhi);
          }
          m1 = warp_max(m1);
          m2 = warp_max(m2);
          if (lane == 0) {
            atomicMax(ws.hmax + (par * kMaxRows + r) * 2, __float_as_uint(m1));
            atomicMax(ws.hmax + (par * kMaxRows + r) * 2 + 1, __float_as_uint(m2));
          }
        }
      }
      grid_barrier(ws.bar, ++barriers * G);

      // h: the s8 pair of the stages this CTA's down units read, a thread per 16-row group of a kept stage and
      // row, each with its row's maxima (one round trip); each stage's sums by the group's 4 threads
      constexpr int kGroups = kRows / 16;  // 16-row groups a stage
      const int nsl = min(d1 - d0, KTd), kbase = d1 > d0 ? d0 % KTd : 0, nh = R * nsl * kGroups;
      if (tid < R) {  // the scales, for the down epilogue (issued with the loads below)
        sth[4 * tid] = pair_scale(__uint_as_float(__ldcg(ws.hmax + (par * kMaxRows + tid) * 2)));
        sth[4 * tid + 1] = pair_scale(__uint_as_float(__ldcg(ws.hmax + (par * kMaxRows + tid) * 2 + 1)));
      }
      for (int i = tid; i < cdiv(nh, 32) * 32; i += kConsumers) {
        const int r = i < nh ? i / (nsl * kGroups) : 0, slot = i < nh ? (i / kGroups) % nsl : 0;
        const int row0 = ((kbase + slot) % KTd) * kRows + (i % kGroups) * 16;
        const float sa1 = pair_scale(__uint_as_float(__ldcg(ws.hmax + (par * kMaxRows + r) * 2)));
        const float sa2 = pair_scale(__uint_as_float(__ldcg(ws.hmax + (par * kMaxRows + r) * 2 + 1)));
        const float* hr = a.hbuf + (size_t)r * H;
        float lo[16], hi[16];
        if (i < nh && row0 + 16 <= Hh) {
#pragma unroll
          for (int e = 0; e < 16; e += 4) {
            const float4 vl = __ldcg(reinterpret_cast<const float4*>(hr + row0 + e));
            const float4 vh = __ldcg(reinterpret_cast<const float4*>(hr + Hh + row0 + e));
            lo[e] = vl.x, lo[e + 1] = vl.y, lo[e + 2] = vl.z, lo[e + 3] = vl.w;
            hi[e] = vh.x, hi[e + 1] = vh.y, hi[e + 2] = vh.z, hi[e + 3] = vh.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const bool in = i < nh && row0 + e < Hh;
            lo[e] = in ? __ldcg(hr + row0 + e) : 0.0f;
            hi[e] = in ? __ldcg(hr + Hh + row0 + e) : 0.0f;
          }
        }
        int s1 = 0, s2 = 0;
        if (i < nh)
          store_pair16(lo, hi, sa1, sa2, hb1 + r * ldh, hb2 + r * ldh, slot * kRows + (i % kGroups) * 16, s1, s2);
#pragma unroll
        for (int o = 1; o < kGroups; o <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (i < nh && i % kGroups == 0) ssum[(slot * R + r) * 2] = s1, ssum[(slot * R + r) * 2 + 1] = s2;
      }
      ConsumerSync::sync();

      // down units: the residual through the gate modulation, written by each tile's last contributor
      const float* s3 = a.s3 + (size_t)l * w;
      const float* b3 = a.b3 + (size_t)l * w;
      int* const dsum = ws.dsum + par * Td * kMaxRows * 2;  // [Td][kMaxRows][2], zeroed after the block
      const int kp = p.kc ? p.kc / kRows : KTd;  // stages a piece
      zero();
      for (int u = d0, tile = d0 / KTd, k = kbase, hs = 0; u < d1;  // hs: the stage's slot of h's operands
           ++u, k = k == KTd - 1 ? 0 : k + 1, tile += k == 0, hs = hs == KTd - 1 ? 0 : hs + 1) {
        const int c0 = tile * kTileCols;
        consume(hb1, hb2, ldh, hs * kRows);
        const bool tile_end = k == KTd - 1 || u == d1 - 1;
        if (!tile_end && (!p.kc || (k + 1) % kp)) continue;
        flush(ws.acc_dn + ((size_t)(k / kp) * Td + tile) * 2 * kMaxRows * kTileCols,
              [&](int col) { return c0 + col < w; });
        if (!tile_end) continue;
        const int kf = max(d0, tile * KTd) - tile * KTd;  // the run's first stage in the tile
        if (tid < 2 * R) {  // the sums of h's operands over the run's stages kf..k of the tile
          int sum = 0;
          for (int kk = kf; kk <= k; ++kk) sum += ssum[(((kk - kbase + KTd) % KTd) * R + tid / 2) * 2 + tid % 2];
          atomicAdd(dsum + (tile * kMaxRows + tid / 2) * 2 + tid % 2, sum);
        }
        if (!take_ticket(ws.tickets + Tu + tile, k - kf + 1, KTd, flag)) continue;
        // a thread per column, every row, the loads of up to 4 pieces in one round trip
        for (int col = tid, j = c0 + tid; col < kTileCols && j < w; col += kConsumers, j += kConsumers) {
          float sum[R];  // the pieces' descaled sums in piece order (the block schedule: its one sum, as 0 + x == x;
                         // the stack: each piece's two added one after the other)
#pragma unroll
          for (int r = 0; r < R; ++r) sum[r] = 0.0f;
          for (int pc0 = 0; pc0 < p.pieces; pc0 += 4) {
            int d[4][R][2];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int r = 0; r < R; ++r)
                if (pc0 + q < p.pieces) {
                  int* acc = ws.acc_dn + ((size_t)(pc0 + q) * Td + tile) * 2 * kMaxRows * kTileCols + r * kTileCols + col;
                  d[q][r][0] = take(acc);
                  d[q][r][1] = take(acc + kMaxRows * kTileCols);
                }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int r = 0; r < R; ++r)
                if (pc0 + q < p.pieces) {
                  const float d1s = __fmul_rn((float)d[q][r][0], sth[4 * r]);
                  const float d2s = __fmul_rn((float)d[q][r][1], __fmul_rn(sth[4 * r + 1], 0.0625f));
                  sum[r] = p.stack ? __fadd_rn(__fadd_rn(sum[r], d1s), d2s) : __fadd_rn(sum[r], __fadd_rn(d1s, d2s));
                }
          }
          const float s3j = s3[j], b3j = b3[j];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float corr = pair_corr(__ldcg(dsum + (tile * kMaxRows + r) * 2),
                                         __ldcg(dsum + (tile * kMaxRows + r) * 2 + 1), sth[4 * r], sth[4 * r + 1]);
            const float gate = to_f32(md[(size_t)r * 3 * w + 2 * w + j]), xv = __ldcg(x_in + (size_t)r * w + j);
            const float po = __fadd_rn(__fmul_rn(__fsub_rn(sum[r], corr), s3j), b3j);
            __stcg(x_out + (size_t)r * w + j, __fadd_rn(xv, __fmul_rn(gate, po)));
          }
        }
      }
      grid_barrier(ws.bar, ++barriers * G);
      if (cta == 0) {  // this block's row maxima and operand sums, read by all before the barrier
        if (tid < 2 * kMaxRows) ws.hmax[par * kMaxRows * 2 + tid] = 0u;
        for (int i = tid; i < Td * kMaxRows * 2; i += kConsumers) dsum[i] = 0;
      }
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

// The launch shared by both entries: p.a, the operand pointers, kc and the mode's fields set; here the ring, h's
// kept stages and the tensor maps.
int run(Params& p, const void* q12, const void* q3, int grid, int bf16_in, cudaStream_t st) {
  const int w = p.a.w, H = p.a.H, L = p.a.L, B = p.a.B, Hh = H / 2;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int G = grid ? grid : sms, Td = cdiv(w, kTileCols), KTd = cdiv(Hh, kRows);
  p.nslots = min(cdiv(Td * KTd, G), KTd);
  const size_t rest = Smem(B, w, 0, p.nslots).bytes;
  p.ring = (int)min((size_t)kMaxRing, ((size_t)optin - min((size_t)optin, rest)) / (kStageBytes + 16));
  if (p.ring < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = Smem(B, w, p.ring, p.nslots).bytes;
  // the packed tables as 3-D byte tensors (columns, packed rows, layer), 64-byte x 64-row boxes, 64-byte swizzle
  const cuuint64_t d12[3] = {(cuuint64_t)2 * H, (cuuint64_t)w / 2, (cuuint64_t)L};
  const cuuint64_t s12s[2] = {(cuuint64_t)2 * H, (cuuint64_t)w / 2 * 2 * H};
  const cuuint64_t d3[3] = {(cuuint64_t)w, (cuuint64_t)Hh, (cuuint64_t)L};
  const cuuint64_t s3s[2] = {(cuuint64_t)w, (cuuint64_t)Hh * w};
  const cuuint32_t box[3] = {kBoxW, (cuuint32_t)kRows, 1};
  if (!encode(&p.m12, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, q12, d12, s12s, box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(&p.m3, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, q3, d3, s3s, box, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  auto launch = [&](auto kernel) { return launch_cooperative(kernel, smem, p, st, kAll, G); };
  switch (B * 2 + (bf16_in ? 1 : 0)) {
    case 2: err = launch(rf_sampler_q4s8_kernel<1, float>); break;
    case 3: err = launch(rf_sampler_q4s8_kernel<1, bf16>); break;
    case 4: err = launch(rf_sampler_q4s8_kernel<2, float>); break;
    case 5: err = launch(rf_sampler_q4s8_kernel<2, bf16>); break;
    case 6: err = launch(rf_sampler_q4s8_kernel<3, float>); break;
    case 7: err = launch(rf_sampler_q4s8_kernel<3, bf16>); break;
    case 8: err = launch(rf_sampler_q4s8_kernel<4, float>); break;
    default: err = launch(rf_sampler_q4s8_kernel<4, bf16>); break;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is reported here, not to the next kernel's check
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// kc (packed w3 rows a piece, 0 or H/2 for one piece) as the kernel takes it, or -1 where it is not a whole
// number of stages dividing H/2.
int pieces_kc(int kc, int Hh) {
  if (kc < 0 || (kc && (Hh % kc || (kc % kRows && kc != Hh)))) return -1;
  return kc == Hh ? 0 : kc;  // one piece is the block schedule's sum
}

}  // namespace

// One Euler sample (S steps x L blocks) of B <= 4 CFG rows. dts (S,); x0 (B, C)
// noise; win (C, w) and wfin_t (C, w) the input and final projections
// (compute-dtype values; wfin transposed); binp (w,), bfin (C,);
// lnw/lnb (L, w); q12 (L, w/2, 2H) / q3 (L, H/2, w) uint8 split-halves packed
// int4 with fp32 scales s12 (L, 2H) / s3 (L, w) and biases b12 / b3; mods
// (L, S, B, 3w) and fmods (S, B, 2w) modulations; win, mods, fmods and wfin_t
// bf16 with bf16_in (the compute dtype bf16), else fp32;
// out (B, C) fp32 latent. The workspace (ops/kernels/rf_sampler.py
// q4_workspace_sizes, zeroed once when allocated; every launch leaves it so):
// fws fp32 h (4 x H) then x (3 x 4 x w); iws int32 accumulators, operand
// sums, tickets, row maxima and the barrier counter
// (mu_rf_sampler_q4s8_workspace words). kc: 0 for the block schedule,
// or the pipelined schedule's packed w3 rows per piece (dividing H/2, a
// multiple of 64 or H/2 itself). grid: the CTAs, 0 for one per SM. w and H
// multiples of 64, C <= 128. One cooperative launch.
extern "C" int mu_rf_sampler_q4s8(const void* dts, const void* x0, const void* win, const void* binp, const void* lnw,
                                  const void* lnb, const void* q12, const void* s12, const void* b12, const void* q3,
                                  const void* s3, const void* b3, const void* mods, const void* fmods,
                                  const void* wfin_t, const void* bfin, void* fws, void* iws, void* out, int B,
                                  int cfg_rows, int renorm, int S, int L, int w, int H, int C, int h_bf16,
                                  int bf16_in, int kc, int grid, float text_cfg, float image_cfg, float ln_eps,
                                  void* stream) {
  const int Hh = H / 2;
  if (B < 1 || B > kMaxRows || w <= 0 || H <= 0 || w % 64 || H % 64 || C > kLat || grid < 0 || pieces_kc(kc, Hh) < 0)
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
  p.kc = pieces_kc(kc, Hh);
  p.pieces = p.kc ? Hh / p.kc : 1;
  return run(p, q12, q3, grid, bf16_in, static_cast<cudaStream_t>(stream));
}

// One Euler step of the residual stack (the stack mode, see the top of this
// file) over B <= 4 rows: x (B, w) fp32 holding compute-dtype values (h_bf16:
// the compute dtype is bf16); lnw / lnb, the packed tables, their scales and
// biases as mu_rf_sampler_q4s8's; mods (L, B, 3w) fp32; kc the down pieces'
// packed w3 rows (as mu_rf_sampler_q4s8's); out (B, w) fp32, x after block
// L-1. The workspace as mu_rf_sampler_q4s8's (int32 words:
// mu_rf_sampler_q4s8_workspace(w, H, kc)). grid: the CTAs, 0 for one per SM.
// One cooperative launch.
extern "C" int mu_rf_stack_q4s8(const void* x, const void* lnw, const void* lnb, const void* q12, const void* s12,
                                const void* b12, const void* q3, const void* s3, const void* b3, const void* mods,
                                void* out, void* fws, void* iws, int B, int L, int w, int H, int h_bf16, int kc,
                                int grid, float ln_eps, void* stream) {
  const int Hh = H / 2;
  if (B < 1 || B > kMaxRows || w <= 0 || H <= 0 || w % 64 || H % 64 || grid < 0 || pieces_kc(kc, Hh) < 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  float* f = static_cast<float*>(fws);
  p.a = rf::make_args(nullptr, nullptr, nullptr, nullptr, lnw, lnb, q12, s12, b12, q3, s3, b3, nullptr, nullptr,
                      nullptr, nullptr, f + (size_t)kMaxRows * H, f, nullptr, B, 1, 0, 1, L, w, H, 0, h_bf16, 0.0f,
                      0.0f, ln_eps);
  p.mods = mods;
  p.iws = static_cast<int*>(iws);
  p.kc = pieces_kc(kc, Hh);
  p.pieces = p.kc ? Hh / p.kc : 1;
  p.stack = 1;
  p.x_ext = static_cast<const float*>(x);
  p.out_ext = static_cast<float*>(out);
  return run(p, q12, q3, grid, 0, static_cast<cudaStream_t>(stream));
}

// The grid a launch of mu_rf_sampler_q4s8 uses by default: one CTA per SM.
extern "C" int mu_rf_sampler_grid(void) { return device_sms(); }

// Words of the int32 workspace a launch over (w, H) with kc reads (the fp32 one: 4 x (H + 3w)).
extern "C" int mu_rf_sampler_q4s8_workspace(int w, int H, int kc) {
  const int Hh = H / 2, pieces = kc && kc != Hh ? Hh / kc : 1;
  return (int)Workspace::words(cdiv(Hh, kPairs), cdiv(w, kTileCols), pieces);
}
