// Flash attention: softmax(Q K^T * scale) V over full sequences, tile by tile,
// with the scores never written to device memory. Two forward entry points:
//   mu_flash_prefill_bf16  first-round LLM prefill, token-major (B, T, H, D),
//                          GQA by indexing the kv head, causal, and a row sees
//                          a key only when both are valid or both are padding
//                          (an mma.sync body);
//   mu_flash_vit_bf16      non-causal ViT attention, head-major (B, H, N, D),
//                          also writing each row's log-sum-exp (fp32, B x H x N)
//                          when asked: the residual of the backward (a wgmma
//                          body fed by a TMA ring);
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
// Design of the prefill's mma.sync body. One block of 4 warps per (batch,
// query head, 64-row query tile);
// each warp owns 16 query rows. The block loops over 64-key tiles: K and V
// tiles are staged in shared memory (rows padded by 16 bytes, so ldmatrix
// reads hit distinct banks), S = Q K^T and O += P V run as
// mma.sync.m16n8k16 bf16 products with fp32 accumulators in registers, and the
// running maximum and sum of the online softmax stay in registers (fp32). The
// softmax scale is applied to the fp32 scores inside the exponent
// (exp2(s * scale * log2 e - m)), so q is never rounded a second time. The
// probabilities are rounded to bf16 for the P V product, as the plain version
// rounds them to V's type. Causal tiles above the diagonal are never visited,
// and the heaviest query tiles are scheduled first. K and V of a GQA group are
// read through the query head's kv head; they are never repeated in memory.
// Loads are plain 16-byte copies followed by a barrier.
//
// Design of the ViT forward's wgmma body (N a multiple of 128, 16-byte aligned
// operands, D 64 or 128; the pixel decoder's 16 heads x 1,024 tokens x 64). One block of three warpgroups per (128-row
// query tile, head, image). The producer warpgroup gives up registers
// (setmaxnreg) and one of its threads loads the block's Q tile once by TMA,
// then keeps a ring of 128-key K and V tiles full (4 stages at D 64, 2 at D
// 128; 128-byte swizzled TMA boxes of 64 columns; full and empty mbarriers).
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
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int kThreads = 128; // 4 warps x 16 query rows

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Copy a (rows x D) bf16 tile from device memory (row stride `stride`
// elements) into shared memory (row stride LD), 16 bytes a thread.
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride, int rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c * 8);
  }
}

// q / out: element (b, h, row, d) at b * q_bs + h * q_hs + row * q_rs + d;
// k / v likewise with k_bs, k_hs, k_rs; valid (B, n_rows) bytes.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ valid, bf16* __restrict__ out, int n_rows, int group,
    size_t q_bs, size_t q_hs, size_t q_rs, size_t k_bs, size_t k_hs, size_t k_rs, float scale_log2e) {
  constexpr int LD = D + 8;  // padded shared row, in elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * LD;
  bf16* Vs = Ks + BN * LD;
  uint8_t* kval = reinterpret_cast<uint8_t*>(Vs + BN * LD);

  // causal: the last query tiles visit the most key tiles, so they go first
  const int qt = (int)(gridDim.x - 1 - blockIdx.x);
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row of the thread within an 8-row fragment
  const int t = lane & 3;   // column pair of the thread within a fragment

  const bf16* qb = q + (size_t)b * q_bs + (size_t)hq * q_hs + (size_t)qt * BM * q_rs;
  bf16* ob = out + (size_t)b * q_bs + (size_t)hq * q_hs + (size_t)qt * BM * q_rs;
  const bf16* kb = k + (size_t)b * k_bs + (size_t)hk * k_hs;
  const bf16* vb = v + (size_t)b * k_bs + (size_t)hk * k_hs;
  const uint8_t* vrow = valid + (size_t)b * n_rows;

  load_tile<D, LD>(Qs, qb, q_rs, BM);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 + (lane >> 4) * 8);
  }

  // this thread's two query rows: r0 = g, r1 = g + 8 of the warp's 16
  const int row0 = qt * BM + warp * 16 + g;
  const int row1 = row0 + 8;
  const uint8_t qv0 = vrow[row0];
  const uint8_t qv1 = vrow[row1];

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of the raw scores
  float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the running sums

  const int n_kt = qt + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<D, LD>(Ks, kb + (size_t)kt * BN * k_rs, k_rs, BN);
    load_tile<D, LD>(Vs, vb + (size_t)kt * BN * k_rs, k_rs, BN);
    if (tid < BN) kval[tid] = vrow[kt * BN + tid];
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < BN / 16; ++nj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nj], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * nj + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // mask, then the online softmax update of the two rows
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = j * 8 + 2 * t + (c & 1);
        const int key = kt * BN + kc;
        const bool ok = (c < 2) ? (key <= row0 && kval[kc] == qv0) : (key <= row1 && kval[kc] == qv1);
        if (!ok) s[j][c] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no allowed key so far keeps m = -inf; its terms are exp2(-inf) = 0
    const float ms0 = (mn0 == -INFINITY) ? 0.0f : mn0 * scale_log2e;
    const float ms1 = (mn1 == -INFINITY) ? 0.0f : mn1 * scale_log2e;
    const float corr0 = exp2f(m0 * scale_log2e - ms0);
    const float corr1 = exp2f(m1 * scale_log2e - ms1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = exp2f(s[j][0] * scale_log2e - ms0);
      s[j][1] = exp2f(s[j][1] * scale_log2e - ms0);
      s[j][2] = exp2f(s[j][2] * scale_log2e - ms1);
      s[j][3] = exp2f(s[j][3] * scale_log2e - ms1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr0;
      acc[j][1] *= corr0;
      acc[j][2] *= corr1;
      acc[j][3] *= corr1;
    }

    // O += P V: the score fragments of two adjacent 8-key tiles are one A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dj = 0; dj < D / 16; ++dj) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dj * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dj], pf, vf[0], vf[1]);
        mma_bf16(acc[2 * dj + 1], pf, vf[2], vf[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);

  // Stage the warp's 16 output rows in its own rows of Qs (read for the last
  // time before the loop's first barrier), then write 16 bytes a thread.
  bf16* stage = Qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<bf162*>(stage + g * LD + j * 8 + 2 * t) = __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<bf162*>(stage + (g + 8) * LD + j * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    *reinterpret_cast<uint4*>(ob + (size_t)(warp * 16 + r) * q_rs + c * 8) =
        *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, const void* valid, void* out, int B, int heads,
                 int n_rows, int group, size_t q_bs, size_t q_hs, size_t q_rs, size_t k_bs, size_t k_hs, size_t k_rs,
                 float scale, void* stream) {
  const size_t smem = (size_t)(BM + 2 * BN) * (D + 8) * sizeof(bf16) + BN;
  cudaError_t err = allow_dynamic_smem(flash_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_rows / BM, heads, B);
  flash_kernel<D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(out), n_rows, group, q_bs, q_hs, q_rs, k_bs, k_hs, k_rs,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The ViT forward on wgmma (mu_flash_vit_bf16): see the note at the head of
// this file
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
  static constexpr size_t kSmem = (1 + 2 * kStages) * kTile + (1 + 2 * kStages) * 8 + 1024;
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

// q_map / k_map / v_map over (B * H, N, D) bf16 (innermost first: D, N, B * H;
// boxes of 64 x 128 x 1); out (B, H, N, D) bf16; lse (B, H, N) fp32 when LSE.
// N a multiple of BN. Grid (N / BM, H, B).
template <int D, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_vit_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out, float* __restrict__ lse,
                           int N, float scale_log2e) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms start on 1024-byte boundaries
  const uint32_t kv0 = q_s + C::kTile;                        // stage s: K at kv0 + 2 s kTile, V after it
  const uint32_t q_bar = kv0 + 2 * C::kStages * C::kTile, full0 = q_bar + 8, empty0 = full0 + 8 * C::kStages;
  const int n0 = blockIdx.x * BM, bh = blockIdx.z * gridDim.y + blockIdx.y, n_kt = N / BN;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {  // the producer: one thread loads Q once and keeps the ring of K and V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_bar, C::kTile);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c) tma_load_3d(q_s + c * kBox, &q_map, q_bar, 64 * c, n0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % C::kStages;
        const uint32_t full = full0 + 8 * s, k_s = kv0 + 2 * s * C::kTile, v_s = k_s + C::kTile;
        mbar_wait(empty0 + 8 * s, ((kt / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kTile);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load_3d(k_s + c * kBox, &k_map, full, 64 * c, kt * BN, bh);
          tma_load_3d(v_s + c * kBox, &v_map, full, 64 * c, kt * BN, bh);
        }
      }
    }
    return;
  }
  // a consumer: query rows n0 + 64 wgi .. + 63; thread (warp, g, t) holds rows 16 warp + g and + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
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
  float corr0, corr1;
  // The online softmax update of the thread's two rows (each spread over a quad of threads), in place in S.
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
  softmax();
  keep_p();
  for (int kt = 1; kt < n_kt; ++kt) {
    const int st = kt % C::kStages, prev = (kt - 1) % C::kStages;
    mbar_wait(full0 + 8 * st, (kt / C::kStages) & 1);
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
    softmax();
    wgmma_wait<0>();
    fence_regs(o);
    if (tid == 0) mbar_arrive(empty0 + 8 * prev);  // both products of the tile before have read its stage
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    keep_p();
  }
  {  // the last tile's O += P V
    const int last = (n_kt - 1) % C::kStages;
    fence_regs(o);
    wgmma_fence();
    products(kv0 + (2 * last + 1) * C::kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (tid == 0) mbar_arrive(empty0 + 8 * last);
  }
  if (wgi == 0) named_bar(1, 256);  // the last warpgroup's last arrival

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int row0 = n0 + wgi * 64 + warp * 16 + g, row1 = row0 + 8;
  if (LSE && t == 0) {
    lse[(size_t)bh * N + row0] = (m0 * scale_log2e + log2f(l0)) * 0.6931471805599453f;
    lse[(size_t)bh * N + row1] = (m1 * scale_log2e + log2f(l1)) * 0.6931471805599453f;
  }
  bf16* o0 = out + ((size_t)bh * N + row0) * D;
  bf16* o1 = out + ((size_t)bh * N + row1) * D;
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
  auto kernel = vw::flash_vit_wgmma_kernel<D, LSE>;
  const cudaError_t rc = allow_dynamic_smem(kernel, C::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid(N / vw::BM, H, B);
  kernel<<<grid, vw::kThreads, C::kSmem, st>>>(maps[0], maps[1], maps[2], static_cast<bf16*>(out),
                                                 static_cast<float*>(lse), N, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int D>
int launch_vit(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H, int N, float scale,
               cudaStream_t st) {
  return lse != nullptr ? launch_vit_wgmma<D, true>(q, k, v, out, lse, B, H, N, scale, st)
                        : launch_vit_wgmma<D, false>(q, k, v, out, lse, B, H, N, scale, st);
}

}  // namespace

// q / out (B, T, Hq, D), k / v (B, T, Hkv, D) bf16 contiguous; valid (B, T)
// bool as bytes. Row i attends to key j iff j <= i and valid[i] == valid[j].
// T must be a multiple of 64, D 64 or 128, Hq a multiple of Hkv (the wrapper checks).
extern "C" int mu_flash_prefill_bf16(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
                                     int T, int Hq, int Hkv, int D, float scale, void* stream) {
  const size_t qrs = (size_t)Hq * D, krs = (size_t)Hkv * D;
  if (D == 128)
    return launch_flash<128>(q, k, v, valid, out, B, Hq, T, Hq / Hkv, T * qrs, D, qrs, T * krs, D, krs, scale, stream);
  if (D == 64)
    return launch_flash<64>(q, k, v, valid, out, B, Hq, T, Hq / Hkv, T * qrs, D, qrs, T * krs, D, krs, scale, stream);
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
