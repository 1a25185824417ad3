// Flash attention: softmax(Q K^T * scale) V over full sequences, tile by tile,
// with the scores never written to device memory. Two forward entry points on
// one wgmma body fed by a TMA ring:
//   mu_flash_prefill_bf16  first-round LLM prefill, token-major (B, T, H, D),
//                          GQA by indexing the kv head, causal, and a row sees
//                          a key only when both are valid or both are padding;
//   mu_flash_vit_bf16      non-causal ViT attention, head-major (B, H, N, D),
//                          also writing each row's log-sum-exp (fp32, B x H x N)
//                          when asked: the residual of the backward;
// and the two backward kernels of the ViT entry, mu_flash_vit_bwd_dkv_bf16 and
// mu_flash_vit_bwd_dq_bf16 (wgmma bodies fed by TMA rings, built from the
// forward's pieces; see their note below).
//
// Replaces the TPU path mingunivision_tpu/ops/kernels/flash.py
// (flash_prefill_attention and flash_vit_attention, which call the Pallas
// flash-attention kernel that ships with JAX, with segment ids for padding;
// and, under training's autodiff, that library's custom VJP: the forward with
// residuals and its backward kernels _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq).
// On the H100 the function is bound by operations at both shapes (4 * D
// operations per allowed query-key pair against q, k, v and the output moved
// once); what a kernel must do about that is keep the two products on the
// tensor cores and the (rows, keys) scores on chip.
//
// Design of the forward's wgmma body (N a multiple of 128, 16-byte aligned
// operands, D 64 or 128; the pixel decoder's 16 heads x 1,024 tokens x 64, the
// understanding prompt's 1,152 tokens x 16 / 4 heads x 128). One block of
// three warpgroups per (128-row query tile, head, image or prompt). The producer warpgroup gives up registers
// (setmaxnreg) and one of its threads loads the block's Q tile once by TMA,
// then keeps a ring of 128-key K and V tiles full (4 stages at D 64, 2 at D
// 128; 128-byte swizzled TMA boxes of 64 columns; full and empty mbarriers
// for K and for V apart: a stage's K is refilled once its scores have read it,
// its V once its P V product has, so at D 128 the next tile's K loads while
// the current V is still read).
// Each consumer warpgroup owns 64 query rows: per stage, S = Q K^T is
// wgmma.m64n128k16 with Q and K both K-major in shared memory (D / 16 k16
// steps); the online softmax runs on S in fp32 registers, the scale inside
// exp2 as above; P is rounded to bf16 in registers and is the register A of
// O += P V, wgmma.m64n64k16 (n128 at D 128) with V read N-major from its tile
// (the descriptor's MN-major layout and the transpose-B bit), 8 k16 steps.
// At D 64 the exponentials cost the SM about as long as the products, so the
// two are overlapped as FlashAttention-3 does: a warpgroup issues tile j's
// S = Q K^T and tile j - 1's O += P V together, takes tile j's softmax while
// the second product runs, then frees tile j - 1's stage, rescales O and
// keeps tile j's P for the next round; and the consumer warpgroups take
// turns to issue their products (named barriers), so one's softmax runs
// beside the others' products. The output is normalised by l once at the
// end and stored from registers; the lse beside it when asked. TMA fills
// zeros only past the tensor's end, so the entry asks N to be a multiple of
// the tile: no read runs past a head's N keys, and no tile is partial.
// The prefill mode reads q, k and v where they lie, token-major: tensor maps
// over (D, heads, B * T) with the head a coordinate (boxes of 64 columns x 1
// head x 128 tokens land as the ViT's 128 swizzled rows), the kv head
// hq / group. A block's query tile qt visits key tiles 0..qt only; blocks
// run the query heads of a tile side by side (a GQA group's heads read the
// same K and V tiles, which L2 serves) and the heaviest query tiles first.
// The causal mask applies on the diagonal tile only (the last, peeled); the
// valid rule (key j allowed for row i iff valid[i] == valid[j]) only in blocks
// whose rows or keys hold a padding byte, both by predicate on the score
// registers after the product: ptxas would serialize the products behind a
// branch between their issue and their wait (C7520), so the two kinds of
// block run two copies of the loop, chosen once before it. A row that has met
// no allowed key keeps a maximum of -inf; its exponent's offset is then 0,
// never -inf - -inf, so a fully masked tile adds zeros and no NaN. Every row
// allows itself, so its final sum is positive.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---------------------------------------------------------------------------
// The forward on wgmma (mu_flash_prefill_bf16, mu_flash_vit_bf16): see the
// note at the head of this file
// ---------------------------------------------------------------------------
namespace vw {

constexpr int kConsumers = 2;              // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * kConsumers;        // query rows per block
constexpr int BN = 128;                    // keys per stage
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
constexpr uint32_t kBox = BN * 128;        // one TMA box: 128 rows of 64 bf16 columns, 128-byte swizzled
constexpr uint32_t kGroup = 1024;          // 8 swizzled rows: the stride of 8-row groups

// Shared memory: the Q tile, then per stage a K tile and a V tile (each
// D / 64 boxes), then the barriers: 144 KB at D 64 (4 stages), 160 KB at D 128 (2).
template <int D>
struct Cfg {
  static constexpr int kBoxes = D / 64;
  static constexpr uint32_t kTile = kBoxes * kBox;
  static constexpr int kStages = D == 64 ? 4 : 2;
  // K and V on barriers of their own where the ring has 2 stages (D 128): with one barrier a stage is freed
  // only once its P V is done, when the next tile's K is already due
  static constexpr bool kSplitKV = kStages == 2;
  static constexpr size_t kSmem = (1 + 2 * kStages) * kTile + (1 + 4 * kStages) * 8 + 1024;
};

// S (64 x 128 fp32, the warpgroup's scores) = Q (64 x 16, shared, K-major) . K^T
// (16 x 128: K's 128 rows, K-major), added to S unless `accumulate` is 0.
__device__ __forceinline__ void wg_qk(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x D fp32) += P (64 x 16 bf16, registers) . V (16 x D: 16 of V's rows, N-major:
// wgmma's transpose-B bit), at D 64 and 128.
__device__ __forceinline__ void wg_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wg_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
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

// The forward in its two modes. ViT: q_map / k_map / v_map over (B * H, N, D)
// bf16 (innermost first: D, N, B * H; boxes of 64 x 128 x 1); out (B, H, N, D)
// bf16; lse (B, H, N) fp32 when LSE; grid (N / BM, H, B). Prefill (PREFILL):
// the maps over (B * N, heads, D) token-major (innermost first: D, heads,
// B * N; boxes of 64 x 1 x 128), q's heads Hq = gridDim.x, k's and v's Hq /
// group; out (B, N, Hq, D) bf16; valid (B, N) bytes, 0 or 1; grid (Hq, N / BM,
// B). N a multiple of BN.
template <int D, bool LSE, bool PREFILL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out, float* __restrict__ lse,
                           const uint8_t* __restrict__ valid, int N, int group, float scale_log2e) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms start on 1024-byte boundaries
  const uint32_t kv0 = q_s + C::kTile;                        // stage s: K at kv0 + 2 s kTile, V after it
  // barriers: Q's; per stage K's full and empty, V's full and empty (kSplitKV: K is freed once the scores have
  // read it, V once the P V product has; else K's barriers stand for both, freed after the P V product)
  const uint32_t q_bar = kv0 + 2 * C::kStages * C::kTile, full0 = q_bar + 8, empty0 = full0 + 8 * C::kStages;
  const uint32_t vfull0 = empty0 + 8 * C::kStages, vempty0 = vfull0 + 8 * C::kStages;
  // prefill: the prompt's valid bytes of keys 0 .. the tile's last row, after the barriers
  uint8_t* kval = smem_raw + (vempty0 + 8 * C::kStages - smem_u32(smem_raw));
  // the block's query tile (prefill: the heaviest, the last, first), query head and image or prompt
  const int qt = PREFILL ? gridDim.y - 1 - blockIdx.y : blockIdx.x, hq = PREFILL ? blockIdx.x : blockIdx.y;
  const int b = blockIdx.z, n0 = qt * BM, n_kt = PREFILL ? qt + 1 : N / BN;
  const int bh = b * (PREFILL ? 0 : gridDim.y) + hq;  // ViT: the maps' third coordinate
  // the maps' second and third coordinates of Q's tile and of key tile kt
  const int q1 = PREFILL ? hq : n0, q2 = PREFILL ? b * N + n0 : bh, hk = hq / group;
  auto kv1 = [&](int kt) { return PREFILL ? hk : kt * BN; };
  auto kv2 = [&](int kt) { return PREFILL ? b * N + kt * BN : bh; };
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      // kSplitKV: lane 0 of each consumer warp arrives on K's (no branch while P V runs)
      mbar_init(empty0 + 8 * s, C::kSplitKV ? 4 * kConsumers : kConsumers);
      mbar_init(vfull0 + 8 * s, 1);
      mbar_init(vempty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int masked = 0;  // prefill: a padding byte among the block's keys (and so its rows): the valid rule applies
  if constexpr (PREFILL) {
    const uint32_t* vb = reinterpret_cast<const uint32_t*>(valid + (size_t)b * N);
    int pad = 0;
    for (int i = threadIdx.x; i < n_kt * BN / 4; i += kThreads) {
      const uint32_t w = vb[i];
      reinterpret_cast<uint32_t*>(kval)[i] = w;
      pad |= w != 0x01010101u;
    }
    masked = __syncthreads_or(pad);
  } else {
    __syncthreads();
  }
  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {  // the producer: one thread loads Q once and keeps the ring of K and V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_bar, C::kTile);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c) tma_load_3d(q_s + c * kBox, &q_map, q_bar, 64 * c, q1, q2);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % C::kStages, phase = ((kt / C::kStages) & 1) ^ 1;
        const uint32_t k_s = kv0 + 2 * s * C::kTile, v_s = k_s + C::kTile;
        mbar_wait(empty0 + 8 * s, phase);
        mbar_expect_tx(full0 + 8 * s, C::kSplitKV ? C::kTile : 2 * C::kTile);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load_3d(k_s + c * kBox, &k_map, full0 + 8 * s, 64 * c, kv1(kt), kv2(kt));
        const uint32_t v_full = C::kSplitKV ? vfull0 + 8 * s : full0 + 8 * s;
        if constexpr (C::kSplitKV) {
          mbar_wait(vempty0 + 8 * s, phase);
          mbar_expect_tx(v_full, C::kTile);
        }
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c) tma_load_3d(v_s + c * kBox, &v_map, v_full, 64 * c, kv1(kt), kv2(kt));
      }
    }
    return;
  }
  // a consumer: query rows n0 + 64 wgi .. + 63; thread (warp, g, t) holds rows 16 warp + g and + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int lr0 = wgi * 64 + warp * 16 + g, lr1 = lr0 + 8;  // the thread's rows in the tile
  float o[D / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of the raw scores
  float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the running sums
  const uint32_t q_rows = q_s + wgi * 64 * 128;
  uint32_t p[BN / 16][4];  // P of the tile before, bf16 pairs: the A fragments of O += P V
  auto scores = [&](uint32_t k_s) {  // S = Q K^T: 32 bytes of D per k16 step, the next box every 4
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * kBox + (ks % 4) * 32;
      wg_qk(s, smem_desc(q_rows + off, 16, kGroup), smem_desc(k_s + off, 16, kGroup), ks);
    }
  };
  auto products = [&](uint32_t v_s) {  // O += P V
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wg_pv(o, p[kk], smem_desc(v_s + kk * 16 * 128, kBox, kGroup));
  };
  // Prefill: the masks of key tile kt on S, by predicate: the causal one on the diagonal tile (kCausal), the
  // valid rule where the block has a padding byte (kValid); column 8 j + 2 t (+ 1) of each row's registers.
  auto mask = [&](auto causal, auto valid_rule, int kt) {
    constexpr bool kCausal = decltype(causal)::value, kValid = decltype(valid_rule)::value;
    if constexpr (kCausal || kValid) {
      const uint32_t rv0 = kval[n0 + lr0], rv1 = kval[n0 + lr1];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * t;
        bool ok00 = true, ok01 = true, ok10 = true, ok11 = true;  // (row g or g + 8, column c or c + 1)
        if constexpr (kCausal) ok00 = c <= lr0, ok01 = c + 1 <= lr0, ok10 = c <= lr1, ok11 = c + 1 <= lr1;
        if constexpr (kValid) {
          const uint32_t w = *reinterpret_cast<const uint16_t*>(kval + kt * BN + c), k0 = w & 0xFF, k1 = w >> 8;
          ok00 = ok00 && k0 == rv0, ok01 = ok01 && k1 == rv0, ok10 = ok10 && k0 == rv1, ok11 = ok11 && k1 == rv1;
        }
        s[4 * j] = ok00 ? s[4 * j] : -INFINITY;
        s[4 * j + 1] = ok01 ? s[4 * j + 1] : -INFINITY;
        s[4 * j + 2] = ok10 ? s[4 * j + 2] : -INFINITY;
        s[4 * j + 3] = ok11 ? s[4 * j + 3] : -INFINITY;
      }
    }
  };
  float corr0, corr1;
  // The online softmax update of the thread's two rows (each spread over a quad of threads), in place in S.
  // A row with no allowed key yet keeps m = -inf and subtracts 0: its terms are exp2(-inf) = 0.
  auto softmax = [&]() {
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float ms0 = (mx0 == -INFINITY) ? 0.0f : mx0 * scale_log2e;
    const float ms1 = (mx1 == -INFINITY) ? 0.0f : mx1 * scale_log2e;
    corr0 = ex2_fast(m0 * scale_log2e - ms0);
    corr1 = ex2_fast(m1 * scale_log2e - ms1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[4 * j] = ex2_fast(s[4 * j] * scale_log2e - ms0);
      s[4 * j + 1] = ex2_fast(s[4 * j + 1] * scale_log2e - ms0);
      s[4 * j + 2] = ex2_fast(s[4 * j + 2] * scale_log2e - ms1);
      s[4 * j + 3] = ex2_fast(s[4 * j + 3] * scale_log2e - ms1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
  };
  auto keep_p = [&]() {  // keys 16 kk .. 16 kk + 15 are score blocks 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // The consumer warpgroups take turns, in order, to issue their products: warpgroup i waits at named
  // barrier 1 + i for the one before it (warpgroup 0 first). No branch may run while a product is in
  // flight: ptxas would serialize every wgmma (C7520).
  const int my_turn = 1 + wgi, next_turn = 1 + (wgi + 1) % kConsumers;
  const uint32_t v_empty0 = C::kSplitKV ? vempty0 : empty0;  // where a tile's V is freed
  constexpr std::false_type no{};
  constexpr std::true_type yes{};
  // The loop over the key tiles, under the valid rule or not (one copy each, chosen once before the loop).
  auto run = [&](auto valid_rule) {
    mbar_wait(q_bar, 0);
    if (wgi == kConsumers - 1) named_bar_arrive(1, 256);
    mbar_wait(full0, 0);  // tile 0: its scores and softmax; its P V goes with tile 1's scores
    named_bar(my_turn, 256);
    fence_regs(s);
    wgmma_fence();
    scores(kv0);
    wgmma_commit();
    named_bar_arrive(next_turn, 256);
    wgmma_wait<0>();
    fence_regs(s);
    if constexpr (C::kSplitKV) mbar_arrive_if(empty0, lane == 0);  // the scores have read K's stage 0
    if (PREFILL && n_kt == 1) mask(yes, valid_rule, 0);  // the diagonal (nothing in flight: a branch is free)
    else mask(no, valid_rule, 0);
    softmax();
    keep_p();
    // tile kt's scores beside tile kt - 1's P V; `causal`: the diagonal tile
    auto step = [&](int kt, auto causal) {
      const int st = kt % C::kStages, prev = (kt - 1) % C::kStages;
      mbar_wait(full0 + 8 * st, (kt / C::kStages) & 1);
      if constexpr (C::kSplitKV) mbar_wait(vfull0 + 8 * prev, ((kt - 1) / C::kStages) & 1);
      named_bar(my_turn, 256);
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      scores(kv0 + 2 * st * C::kTile);
      wgmma_commit();
      products(kv0 + (2 * prev + 1) * C::kTile);
      wgmma_commit();
      named_bar_arrive(next_turn, 256);
      wgmma_wait<1>();  // S is ready; the P V product runs on under the softmax
      fence_regs(s);
      if constexpr (C::kSplitKV) mbar_arrive_if(empty0 + 8 * st, lane == 0);  // the scores have read K's stage
      mask(causal, valid_rule, kt);
      softmax();
      wgmma_wait<0>();
      fence_regs(o);
      if (tid == 0) mbar_arrive(v_empty0 + 8 * prev);  // the P V product of the tile before has read its V
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }
      keep_p();
    };
    const int peeled = PREFILL && n_kt > 1;  // prefill: the diagonal tile after the loop
    for (int kt = 1; kt < n_kt - peeled; ++kt) step(kt, no);
    if (peeled) step(n_kt - 1, yes);
    {  // the last tile's O += P V
      const int last = (n_kt - 1) % C::kStages;
      if constexpr (C::kSplitKV) mbar_wait(vfull0 + 8 * last, ((n_kt - 1) / C::kStages) & 1);
      fence_regs(o);
      wgmma_fence();
      products(kv0 + (2 * last + 1) * C::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (tid == 0) mbar_arrive(v_empty0 + 8 * last);
    }
  };
  if constexpr (PREFILL) {
    if (masked) run(yes);
    else run(no);
  } else {
    run(no);
  }
  if (wgi == 0) named_bar(1, 256);  // the last warpgroup's last arrival

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int row0 = n0 + lr0, row1 = row0 + 8;
  if (LSE && t == 0) {
    lse[(size_t)bh * N + row0] = (m0 * scale_log2e + log2f(l0)) * 0.6931471805599453f;
    lse[(size_t)bh * N + row1] = (m1 * scale_log2e + log2f(l1)) * 0.6931471805599453f;
  }
  // prefill: row r of prompt b, head hq at ((b N + r) Hq + hq) D; ViT: row r of (image, head) bh at (bh N + r) D
  const size_t heads = PREFILL ? gridDim.x : 1, head = PREFILL ? hq : 0;
  const size_t rbase = (size_t)(PREFILL ? b : bh) * N;
  bf16* o0 = out + ((rbase + row0) * heads + head) * D;
  bf16* o1 = out + ((rbase + row1) * heads + head) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<bf162*>(o0 + 8 * j + 2 * t) = __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<bf162*>(o1 + 8 * j + 2 * t) = __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

}  // namespace vw

// The tensor maps are encoded per call (the operands are new tensors every call).
template <int D, bool LSE>
int launch_vit_wgmma(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H, int N,
                     float scale, cudaStream_t st) {
  using C = vw::Cfg<D>;
  const void* ops[3] = {q, k, v};
  for (const void* p : ops)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;  // TMA needs 16-byte rows
  if (N < vw::BN || N % vw::BN != 0 || reinterpret_cast<uintptr_t>(out) % 4 != 0) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)B * H};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2};
  const cuuint32_t box[3] = {64, vw::BN, 1};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i)
    if (!encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ops[i], dims, strides, box))
      return (int)cudaErrorInvalidValue;
  auto kernel = vw::flash_fwd_wgmma_kernel<D, LSE, false>;
  const cudaError_t rc = allow_dynamic_smem(kernel, C::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid(N / vw::BM, H, B);
  kernel<<<grid, vw::kThreads, C::kSmem, st>>>(maps[0], maps[1], maps[2], static_cast<bf16*>(out),
                                                 static_cast<float*>(lse), nullptr, N, 1, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int D>
int launch_vit(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H, int N, float scale,
               cudaStream_t st) {
  return lse != nullptr ? launch_vit_wgmma<D, true>(q, k, v, out, lse, B, H, N, scale, st)
                        : launch_vit_wgmma<D, false>(q, k, v, out, lse, B, H, N, scale, st);
}

// The prefill on the same body: token-major maps over (D, heads, B * T), the valid bytes beside the barriers.
template <int D>
int launch_prefill(const void* q, const void* k, const void* v, const void* valid, void* out, int B, int T, int Hq,
                   int Hkv, float scale, cudaStream_t st) {
  using C = vw::Cfg<D>;
  const void* ops[3] = {q, k, v};
  for (const void* p : ops)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;  // TMA needs 16-byte rows
  const size_t smem = C::kSmem + align16((size_t)T);
  if (T < vw::BN || T % vw::BN != 0 || Hkv < 1 || Hq % Hkv != 0 || smem > 232448 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0 || reinterpret_cast<uintptr_t>(valid) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int heads[3] = {Hq, Hkv, Hkv};
  const cuuint32_t box[3] = {64, 1, vw::BN};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)heads[i], (cuuint64_t)B * T};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)heads[i] * D * 2};
    if (!encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ops[i], dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = vw::flash_fwd_wgmma_kernel<D, false, true>;
  const cudaError_t rc = allow_dynamic_smem(kernel, smem);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid(Hq, T / vw::BM, B);
  kernel<<<grid, vw::kThreads, smem, st>>>(maps[0], maps[1], maps[2], static_cast<bf16*>(out), nullptr,
                                           static_cast<const uint8_t*>(valid), T, Hq / Hkv,
                                           scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q / out (B, T, Hq, D), k / v (B, T, Hkv, D) bf16 contiguous, 16-byte
// aligned; valid (B, T) bool as bytes, 4-byte aligned. Row i attends to key j
// iff j <= i and valid[i] == valid[j]. T a multiple of 128, D 64 or 128, Hq a
// multiple of Hkv, else cudaErrorInvalidValue (the wrapper checks the shapes).
extern "C" int mu_flash_prefill_bf16(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
                                     int T, int Hq, int Hkv, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_prefill<128>(q, k, v, valid, out, B, T, Hq, Hkv, scale, st);
  if (D == 64) return launch_prefill<64>(q, k, v, valid, out, B, T, Hq, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// q / k / v / out (B, H, N, D) bf16 contiguous, head-major; non-causal; lse
// (B, H, N) fp32 or null (then not written: inference): m * scale + log(l)
// of each row, the natural-log normaliser of its softmax (the library's
// residuals m and l in one number). N a multiple of 128, 16-byte aligned q, k,
// v, D 64 or 128, else cudaErrorInvalidValue (the wrapper checks the shapes).
extern "C" int mu_flash_vit_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
                                 int N, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_vit<64>(q, k, v, out, lse, B, H, N, scale, st);
  if (D == 128) return launch_vit<128>(q, k, v, out, lse, B, H, N, scale, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward of the ViT entry (non-causal, head-major, bf16), for training.
//
// Replaces the library Pallas kernels behind the custom VJP of JAX's flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py):
// _flash_attention_bwd_dkv (:941, its kernel body :796-940) and
// _flash_attention_bwd_dq (:1287, its body :1146-1286). The split is the
// library's: one kernel accumulates dK and dV over the query tiles of a key
// tile, the other dQ over the key tiles of a query tile, so no two blocks
// write the same output and no atomics are needed; the result does not
// depend on the order blocks run in, and two calls on the same inputs agree
// to the bit. Both recompute the scores from q, k and the forward's
// log-sum-exp: P = exp(S * scale - lse). delta = rowsum(O * dO) (fp32) comes
// from the caller, as the library computes it in XLA.
//
//   dkv: dV += P^T dO, dP = dO V^T, dS = P * (dP - delta) * scale, dK += dS^T Q
//   dq:  dQ += dS K (dS recomputed the same way)
//
// Roundings, as the library's kernels round: S, dP and every product
// accumulate in fp32 from bf16 operands; P is rounded to bf16 for the P^T dO
// product only (`p.T.astype(do.dtype)`, :889) and dS to bf16 for the dS^T Q
// and dS K products (`ds.T.astype(do.dtype)`, :915; `ds.astype(k.dtype)`,
// :1257); dS itself is formed in fp32 from the fp32 P; the outputs are fp32
// sums rounded once to bf16.
//
// Bound: operations. A head and image of N tokens needs 10 N^2 D of them for
// the four products and the score recompute (the pair: dkv 8 N^2 D, dq 6 N^2 D,
// since each recomputes S and dP) against 8 N D bf16 elements read and 3 N D
// written.
//
// Design: wgmma fed by TMA rings, the forward's pieces (N a multiple of 128,
// 16-byte aligned operands, D 64 or 128). Both kernels run one block of three
// warpgroups per (128-row tile, head, image): a producer warpgroup that gives
// up registers (setmaxnreg) and of which one thread loads the block's two
// resident tiles once by TMA, then keeps a ring of 4 stages of the streamed
// tiles full (128-byte swizzled boxes of 64 columns; full and empty
// mbarriers); and two consumer warpgroups that each own 64 rows of the
// resident tiles. A stage streams T rows: 128 at D 64, 64 at D 128, where the
// accumulators of D columns leave no registers for 128-wide score tiles.
// Every product is one of two shapes: a score-shaped one (64 x T) with both
// operands K-major in shared memory (wgmma.m64n128k16, m64n64k16 at T 64),
// and a D-wide one whose A is a score-shaped block in registers (packed to
// bf16 straight from the fp32 accumulators, as the forward's P) and whose B
// is a streamed tile read N-major (the MN-major descriptor, the transpose-B
// bit), as the forward's V.
//
//   dkv (resident K and V of 128 keys; streamed Q, dO and the stage's lse and
//   delta, the last two by plain bulk copies): per stage a consumer issues
//   S^T = K Q^T and dP^T = V dO^T together, takes P^T = exp2(S^T scale log2 e
//   - lse log2 e) while dP^T runs, then dS^T = P^T (dP^T - delta) scale in
//   fp32, packs both to bf16 and issues dV += P^T dO and dK += dS^T Q, and
//   frees the stage when they are done. lse and delta are indexed by the
//   accumulator's column (the stage's queries), so they come from the stage
//   in shared memory, never from device memory inside the loop. Its
//   consumers do not take turns: measured, turns did not make it faster.
//   dq (resident Q and dO of 128 queries; streamed K and V): per stage a
//   consumer issues S = Q K^T and dP = dO V^T beside the stage before's
//   dQ += dS K, takes P while they run (each thread's two rows' lse and delta
//   sit in registers), then dS, packed to bf16 for the next round; the first
//   stage is peeled and the consumers take turns to issue (named barriers), as
//   in the forward. No branch runs while a product is in flight: ptxas would
//   serialize every wgmma (C7520).
// dK, dV and dQ are stored once at the end from registers.
// ---------------------------------------------------------------------------

namespace {
namespace vw {

// S (64 x 64 fp32) = A (64 x 16, shared, K-major) . B^T (16 x 64: B's 64 rows, K-major): the score-shaped
// product of a 64-row stage.
__device__ __forceinline__ void wg_qk(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Shared memory of both backward kernels: two resident tiles of 128 rows, then per stage two streamed
// tiles of T rows, then per stage T lse and T delta values (dkv only), then the barriers: 165 KB at D 64,
// 195 KB at D 128.
template <int D>
struct Bwd {
  static constexpr int kBoxes = D / 64;
  static constexpr int T = D == 64 ? 128 : 64;  // rows of a streamed tile
  static constexpr int kStages = 4;
  static constexpr uint32_t kResBox = BM * 128, kStrBox = T * 128;  // one 64-column box of each
  static constexpr uint32_t kRes = kBoxes * kResBox, kStr = kBoxes * kStrBox;
  static constexpr uint32_t kRows = 2 * T * 4;  // a stage's lse and delta
  static constexpr size_t kSmem = 2 * kRes + kStages * (2 * kStr + kRows) + (1 + 2 * kStages) * 8 + 1024;
};

// Score-shaped product of 64 resident rows (a) against a streamed tile (b), D / 16 k16 steps: 32 bytes of D
// per step, the next 64-column box every 4.
template <int D, int N>
__device__ __forceinline__ void scores_bwd(float (&d)[N], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t k = (ks % 4) * 32;
    wg_qk(d, smem_desc(a + (ks / 4) * Bwd<D>::kResBox + k, 16, kGroup),
          smem_desc(b + (ks / 4) * Bwd<D>::kStrBox + k, 16, kGroup), ks);
  }
}

// acc (64 x D) += A (64 x T, bf16 fragments in registers) . B (a streamed tile, T x D, read N-major).
template <int D, int N>
__device__ __forceinline__ void products_bwd(float (&acc)[N], const uint32_t (&a)[Bwd<D>::T / 16][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < Bwd<D>::T / 16; ++kk)
    wg_pv(acc, a[kk], smem_desc(b + kk * 16 * 128, Bwd<D>::kStrBox, kGroup));
}

// The A fragments of k16 step kk are score blocks 2 kk and 2 kk + 1: register pairs 8 kk + 2 e, e = 0..3,
// of columns 16 kk + 8 (e / 2) + 2 t and + 1.
template <int N>
__device__ __forceinline__ uint32_t pack_pair(const float (&d)[N], int kk, int e) {
  return pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

template <int D>
__device__ __forceinline__ void zero(float (&d)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) d[i] = 0.0f;
}

// Store a consumer's 64 x D fp32 accumulator as bf16 rows: thread (warp, g, t) holds rows 16 warp + g and + 8.
template <int D>
__device__ __forceinline__ void store_bwd(bf16* dst, const float (&acc)[D / 2], int warp, int g, int t) {
  bf16* r0 = dst + (size_t)(warp * 16 + g) * D;
  bf16* r1 = r0 + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<bf162*>(r0 + 8 * j + 2 * t) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<bf162*>(r1 + 8 * j + 2 * t) = __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Maps over (B * H, N, D) bf16 as the forward's; the resident operands' boxes have 128 rows, the streamed
// ones' T. lse, delta (B, H, N) fp32, 16-byte aligned; dk, dv (B, H, N, D) bf16. Grid (N / 128, H, B).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_vit_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                                   const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   bf16* __restrict__ dk, bf16* __restrict__ dv, int N, float scale) {
  using C = Bwd<D>;
  constexpr int T = C::T;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms on 1024 bytes
  const uint32_t k_s = smem_u32(base), v_s = k_s + C::kRes;
  const uint32_t str0 = v_s + C::kRes;                           // stage s: Q at str0 + 2 s kStr, dO after it
  const uint32_t rows_off = 2 * C::kRes + 2 * C::kStages * C::kStr;  // stage s: lse, then delta, at + s kRows
  const uint32_t kv_bar = k_s + rows_off + C::kStages * C::kRows, full0 = kv_bar + 8, empty0 = full0 + 8 * C::kStages;
  const int n0 = blockIdx.x * BM, bh = blockIdx.z * gridDim.y + blockIdx.y, n_st = N / T;
  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {  // the producer: K and V once, then the ring of Q, dO, lse and delta stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(kv_bar, 2 * C::kRes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c) {
        tma_load_3d(k_s + c * C::kResBox, &k_map, kv_bar, 64 * c, n0, bh);
        tma_load_3d(v_s + c * C::kResBox, &v_map, kv_bar, 64 * c, n0, bh);
      }
      const float* lse_h = lse + (size_t)bh * N;
      const float* delta_h = delta + (size_t)bh * N;
      for (int j = 0; j < n_st; ++j) {
        const int s = j % C::kStages;
        const uint32_t full = full0 + 8 * s, q_st = str0 + 2 * s * C::kStr, r_st = k_s + rows_off + s * C::kRows;
        mbar_wait(empty0 + 8 * s, ((j / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kStr + C::kRows);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load_3d(q_st + c * C::kStrBox, &q_map, full, 64 * c, j * T, bh);
          tma_load_3d(q_st + C::kStr + c * C::kStrBox, &do_map, full, 64 * c, j * T, bh);
        }
        bulk_load(r_st, lse_h + j * T, T * 4, full);
        bulk_load(r_st + T * 4, delta_h + j * T, T * 4, full);
      }
    }
    return;
  }
  // a consumer: keys n0 + 64 wgi .. + 63; thread (warp, g, t) holds keys 16 warp + g and + 8, and of the
  // stage's queries the columns 8 j + 2 t and + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const float scale_log2e = scale * 1.4426950408889634f;
  float dk_acc[D / 2], dv_acc[D / 2], s[T / 2], dp[T / 2];
  uint32_t pa[T / 16][4], da[T / 16][4];  // P^T and dS^T in bf16: the A fragments of dV and dK
  zero(dk_acc);
  zero(dv_acc);
  const uint32_t k_rows = k_s + wgi * 64 * 128, v_rows = v_s + wgi * 64 * 128;
  mbar_wait(kv_bar, 0);
  for (int j = 0; j < n_st; ++j) {
    const int st = j % C::kStages;
    const uint32_t q_st = str0 + 2 * st * C::kStr, do_st = q_st + C::kStr;
    const float2* lse2 = reinterpret_cast<const float2*>(base + rows_off + st * C::kRows);
    const float2* delta2 = lse2 + T / 2;
    mbar_wait(full0 + 8 * st, (j / C::kStages) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    scores_bwd<D>(s, k_rows, q_st);  // S^T = K Q^T
    wgmma_commit();
    scores_bwd<D>(dp, v_rows, do_st);  // dP^T = V dO^T, under the exponentials
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int c = 0; c < T / 8; ++c) {  // P^T = exp2(S^T scale log2 e - lse log2 e), lse by column
      const float2 l = lse2[4 * c + t];
      const float l0 = l.x * 1.4426950408889634f, l1 = l.y * 1.4426950408889634f;
      s[4 * c] = ex2_fast(s[4 * c] * scale_log2e - l0);
      s[4 * c + 1] = ex2_fast(s[4 * c + 1] * scale_log2e - l1);
      s[4 * c + 2] = ex2_fast(s[4 * c + 2] * scale_log2e - l0);
      s[4 * c + 3] = ex2_fast(s[4 * c + 3] * scale_log2e - l1);
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < T / 8; ++c) {  // dS^T = P^T (dP^T - delta) scale, in fp32
      const float2 dl = delta2[4 * c + t];
      dp[4 * c] = s[4 * c] * (dp[4 * c] - dl.x) * scale;
      dp[4 * c + 1] = s[4 * c + 1] * (dp[4 * c + 1] - dl.y) * scale;
      dp[4 * c + 2] = s[4 * c + 2] * (dp[4 * c + 2] - dl.x) * scale;
      dp[4 * c + 3] = s[4 * c + 3] * (dp[4 * c + 3] - dl.y) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack_pair(s, kk, e);
        da[kk][e] = pack_pair(dp, kk, e);
      }
    }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    products_bwd<D>(dv_acc, pa, do_st);  // dV += P^T dO
    products_bwd<D>(dk_acc, da, q_st);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if (tid == 0) mbar_arrive(empty0 + 8 * st);  // both products have read the stage
  }
  const size_t row = (size_t)bh * N + n0 + wgi * 64;
  store_bwd<D>(dk + row * D, dk_acc, warp, g, t);
  store_bwd<D>(dv + row * D, dv_acc, warp, g, t);
}

// The same maps and inputs; the resident operands are Q and dO, the streamed ones K and V. dq (B, H, N, D)
// bf16. Grid (N / 128, H, B).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_vit_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                                  const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  bf16* __restrict__ dq, int N, float scale) {
  using C = Bwd<D>;
  constexpr int T = C::T;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u, do_s = q_s + C::kRes;
  const uint32_t str0 = do_s + C::kRes;  // stage s: K at str0 + 2 s kStr, V after it
  const uint32_t qd_bar = str0 + 2 * C::kStages * C::kStr, full0 = qd_bar + 8, empty0 = full0 + 8 * C::kStages;
  const int n0 = blockIdx.x * BM, bh = blockIdx.z * gridDim.y + blockIdx.y, n_st = N / T;
  if (threadIdx.x == 0) {
    mbar_init(qd_bar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {  // the producer: Q and dO once, then the ring of K and V stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(qd_bar, 2 * C::kRes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c) {
        tma_load_3d(q_s + c * C::kResBox, &q_map, qd_bar, 64 * c, n0, bh);
        tma_load_3d(do_s + c * C::kResBox, &do_map, qd_bar, 64 * c, n0, bh);
      }
      for (int j = 0; j < n_st; ++j) {
        const int s = j % C::kStages;
        const uint32_t full = full0 + 8 * s, k_st = str0 + 2 * s * C::kStr;
        mbar_wait(empty0 + 8 * s, ((j / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kStr);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load_3d(k_st + c * C::kStrBox, &k_map, full, 64 * c, j * T, bh);
          tma_load_3d(k_st + C::kStr + c * C::kStrBox, &v_map, full, 64 * c, j * T, bh);
        }
      }
    }
    return;
  }
  // a consumer: queries n0 + 64 wgi .. + 63; thread (warp, g, t) holds rows 16 warp + g and + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const float scale_log2e = scale * 1.4426950408889634f;
  const size_t row = (size_t)bh * N + n0 + wgi * 64, r0 = row + warp * 16 + g, r1 = r0 + 8;
  const float l0 = lse[r0] * 1.4426950408889634f, l1 = lse[r1] * 1.4426950408889634f;
  const float d0 = delta[r0], d1 = delta[r1];
  float dq_acc[D / 2], s[T / 2], dp[T / 2];
  uint32_t da[T / 16][4];  // dS of the stage before in bf16: the A fragments of dQ += dS K
  zero(dq_acc);
  const uint32_t q_rows = q_s + wgi * 64 * 128, do_rows = do_s + wgi * 64 * 128;
  auto probs = [&]() {  // P = exp2(S scale log2 e - lse log2 e), in place
#pragma unroll
    for (int c = 0; c < T / 8; ++c) {
      s[4 * c] = ex2_fast(s[4 * c] * scale_log2e - l0);
      s[4 * c + 1] = ex2_fast(s[4 * c + 1] * scale_log2e - l0);
      s[4 * c + 2] = ex2_fast(s[4 * c + 2] * scale_log2e - l1);
      s[4 * c + 3] = ex2_fast(s[4 * c + 3] * scale_log2e - l1);
    }
  };
  auto grads = [&]() {  // dS = P (dP - delta) scale in fp32, kept as bf16 A fragments
#pragma unroll
    for (int c = 0; c < T / 8; ++c) {
      dp[4 * c] = s[4 * c] * (dp[4 * c] - d0) * scale;
      dp[4 * c + 1] = s[4 * c + 1] * (dp[4 * c + 1] - d0) * scale;
      dp[4 * c + 2] = s[4 * c + 2] * (dp[4 * c + 2] - d1) * scale;
      dp[4 * c + 3] = s[4 * c + 3] * (dp[4 * c + 3] - d1) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) da[kk][e] = pack_pair(dp, kk, e);
    }
  };

  // The consumers take turns, in order, to issue their products (named barriers 1 and 2), as in the forward.
  const int my_turn = 1 + wgi, next_turn = 1 + (wgi + 1) % kConsumers;
  mbar_wait(qd_bar, 0);
  if (wgi == kConsumers - 1) named_bar_arrive(1, 256);
  mbar_wait(full0, 0);  // stage 0: its S and dP; its dS K goes with stage 1's
  named_bar(my_turn, 256);
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  scores_bwd<D>(s, q_rows, str0);
  wgmma_commit();
  scores_bwd<D>(dp, do_rows, str0 + C::kStr);
  wgmma_commit();
  named_bar_arrive(next_turn, 256);
  wgmma_wait<1>();
  fence_regs(s);
  probs();
  wgmma_wait<0>();
  fence_regs(dp);
  grads();
  for (int j = 1; j < n_st; ++j) {
    const int st = j % C::kStages, prev = (j - 1) % C::kStages;
    const uint32_t k_st = str0 + 2 * st * C::kStr;
    mbar_wait(full0 + 8 * st, (j / C::kStages) & 1);
    named_bar(my_turn, 256);
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dq_acc);
    wgmma_fence();
    scores_bwd<D>(s, q_rows, k_st);  // S = Q K^T
    wgmma_commit();
    scores_bwd<D>(dp, do_rows, k_st + C::kStr);  // dP = dO V^T
    products_bwd<D>(dq_acc, da, str0 + 2 * prev * C::kStr);  // dQ += dS K of the stage before
    wgmma_commit();
    named_bar_arrive(next_turn, 256);
    wgmma_wait<1>();  // S is ready; dP and the dQ product run on under the exponentials
    fence_regs(s);
    probs();
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(dq_acc);
    if (tid == 0) mbar_arrive(empty0 + 8 * prev);  // the dQ product has read the stage before
    grads();
  }
  {  // the last stage's dQ += dS K
    const int last = (n_st - 1) % C::kStages;
    fence_regs(dq_acc);
    wgmma_fence();
    products_bwd<D>(dq_acc, da, str0 + 2 * last * C::kStr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    if (tid == 0) mbar_arrive(empty0 + 8 * last);
  }
  if (wgi == 0) named_bar(1, 256);  // the last warpgroup's last arrival
  store_bwd<D>(dq + row * D, dq_acc, warp, g, t);
}

}  // namespace vw

// One backward launch: the four tensor maps (the resident operands' boxes of 128 rows, the streamed ones' of
// T), encoded per call. `dkv`: dK / dV (out0, out1), else dQ (out0).
template <int D>
int launch_vit_bwd(bool dkv, const void* q, const void* k, const void* v, const void* lse, const void* dout,
                   const void* delta, void* out0, void* out1, int B, int H, int N, float scale, cudaStream_t st) {
  using C = vw::Bwd<D>;
  const void* ops[6] = {q, k, v, dout, lse, delta};
  for (const void* p : ops)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;  // TMA and bulk copies
  if (N < vw::BM || N % vw::BM != 0) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)B * H};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2};
  const cuuint32_t res_box[3] = {64, (cuuint32_t)vw::BM, 1}, str_box[3] = {64, (cuuint32_t)C::T, 1};
  const bool resident[4] = {!dkv, dkv, dkv, !dkv};  // q, k, v, dO
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ops[i], dims, strides, resident[i] ? res_box : str_box))
      return (int)cudaErrorInvalidValue;
  const dim3 grid(N / vw::BM, H, B);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  if (dkv) {
    auto kernel = vw::flash_vit_bwd_dkv_wgmma_kernel<D>;
    const cudaError_t rc = allow_dynamic_smem(kernel, C::kSmem);
    if (rc != cudaSuccess) return (int)rc;
    kernel<<<grid, vw::kThreads, C::kSmem, st>>>(maps[0], maps[1], maps[2], maps[3], l, d, static_cast<bf16*>(out0),
                                                  static_cast<bf16*>(out1), N, scale);
  } else {
    auto kernel = vw::flash_vit_bwd_dq_wgmma_kernel<D>;
    const cudaError_t rc = allow_dynamic_smem(kernel, C::kSmem);
    if (rc != cudaSuccess) return (int)rc;
    kernel<<<grid, vw::kThreads, C::kSmem, st>>>(maps[0], maps[1], maps[2], maps[3], l, d, static_cast<bf16*>(out0),
                                                  N, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q / k / v / dO / dK / dV (B, H, N, D) bf16 contiguous, head-major; lse (the
// forward's residual) and delta = rowsum(O * dO) (B, H, N) fp32. N a multiple
// of 128, every pointer 16-byte aligned, D 64 or 128, else
// cudaErrorInvalidValue (the wrapper checks).
extern "C" int mu_flash_vit_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* lse, const void* dout,
                                         const void* delta, void* dk, void* dv, int B, int H, int N, int D,
                                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_vit_bwd<64>(true, q, k, v, lse, dout, delta, dk, dv, B, H, N, scale, st);
  if (D == 128) return launch_vit_bwd<128>(true, q, k, v, lse, dout, delta, dk, dv, B, H, N, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The same inputs; writes dQ (B, H, N, D) bf16.
extern "C" int mu_flash_vit_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* lse, const void* dout,
                                        const void* delta, void* dq, int B, int H, int N, int D, float scale,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_vit_bwd<64>(false, q, k, v, lse, dout, delta, dq, nullptr, B, H, N, scale, st);
  if (D == 128) return launch_vit_bwd<128>(false, q, k, v, lse, dout, delta, dq, nullptr, B, H, N, scale, st);
  return (int)cudaErrorInvalidValue;
}
