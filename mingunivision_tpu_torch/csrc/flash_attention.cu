// Flash attention: softmax(Q K^T * scale) V over full sequences, tile by tile,
// with the scores never written to device memory. Two entry points from one
// templated body:
//   mu_flash_prefill_bf16  first-round LLM prefill, token-major (B, T, H, D),
//                          GQA by indexing the kv head, causal, and a row sees
//                          a key only when both are valid or both are padding;
//   mu_flash_vit_bf16      non-causal ViT attention, head-major (B, H, N, D).
//
// Replaces the TPU path mingunivision_tpu/ops/kernels/flash.py
// (flash_prefill_attention and flash_vit_attention, which call the Pallas
// flash-attention kernel that ships with JAX, with segment ids for padding).
// On the H100 the function is bound by operations at both shapes (4 * D
// operations per allowed query-key pair against q, k, v and the output moved
// once); what a kernel must do about that is keep the two products on the
// tensor cores and the (rows, keys) scores on chip.
//
// Design. One block of 4 warps per (batch, query head, 64-row query tile);
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
// Loads are plain 16-byte copies followed by a barrier: cp.async / TMA
// pipelining and wgmma are later work.
#include "common.cuh"

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
// k / v likewise with k_bs, k_hs, k_rs; valid (B, n_rows) bytes (PREFILL only).
template <int D, bool PREFILL>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ valid, bf16* __restrict__ out, int n_rows, int group, size_t q_bs, size_t q_hs,
    size_t q_rs, size_t k_bs, size_t k_hs, size_t k_rs, float scale_log2e) {
  constexpr int LD = D + 8;  // padded shared row, in elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * LD;
  bf16* Vs = Ks + BN * LD;
  uint8_t* kval = reinterpret_cast<uint8_t*>(Vs + BN * LD);

  // causal: the last query tiles visit the most key tiles, so they go first
  const int qt = PREFILL ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
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
  const uint8_t* vrow = PREFILL ? valid + (size_t)b * n_rows : nullptr;

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
  const uint8_t qv0 = PREFILL ? vrow[row0] : 1;
  const uint8_t qv1 = PREFILL ? vrow[row1] : 1;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of the raw scores
  float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the running sums

  const int n_kt = PREFILL ? qt + 1 : n_rows / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<D, LD>(Ks, kb + (size_t)kt * BN * k_rs, k_rs, BN);
    load_tile<D, LD>(Vs, vb + (size_t)kt * BN * k_rs, k_rs, BN);
    if (PREFILL && tid < BN) kval[tid] = vrow[kt * BN + tid];
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
        if (PREFILL) {
          const int kc = j * 8 + 2 * t + (c & 1);
          const int key = kt * BN + kc;
          const bool ok = (c < 2) ? (key <= row0 && kval[kc] == qv0) : (key <= row1 && kval[kc] == qv1);
          if (!ok) s[j][c] = -INFINITY;
        }
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

template <int D, bool PREFILL>
int launch_flash(const void* q, const void* k, const void* v, const void* valid, void* out, int B, int heads,
                 int n_rows, int group, size_t q_bs, size_t q_hs, size_t q_rs, size_t k_bs, size_t k_hs, size_t k_rs,
                 float scale, void* stream) {
  const size_t smem = (size_t)(BM + 2 * BN) * (D + 8) * sizeof(bf16) + BN;
  cudaError_t err = allow_dynamic_smem(flash_kernel<D, PREFILL>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_rows / BM, heads, B);
  flash_kernel<D, PREFILL><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(out), n_rows, group, q_bs, q_hs, q_rs, k_bs, k_hs, k_rs,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q / out (B, T, Hq, D), k / v (B, T, Hkv, D) bf16 contiguous; valid (B, T)
// bool as bytes. Row i attends to key j iff j <= i and valid[i] == valid[j].
// T must be a multiple of 64, D 64 or 128, Hq a multiple of Hkv (the wrapper checks).
extern "C" int mu_flash_prefill_bf16(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
                                     int T, int Hq, int Hkv, int D, float scale, void* stream) {
  const size_t qrs = (size_t)Hq * D, krs = (size_t)Hkv * D;
  if (D == 128)
    return launch_flash<128, true>(q, k, v, valid, out, B, Hq, T, Hq / Hkv, T * qrs, D, qrs, T * krs, D, krs, scale,
                                   stream);
  if (D == 64)
    return launch_flash<64, true>(q, k, v, valid, out, B, Hq, T, Hq / Hkv, T * qrs, D, qrs, T * krs, D, krs, scale,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

// q / k / v / out (B, H, N, D) bf16 contiguous, head-major; non-causal.
// N must be a multiple of 64 and D 64 or 128 (the wrapper checks).
extern "C" int mu_flash_vit_bf16(const void* q, const void* k, const void* v, void* out, int B, int H, int N, int D,
                                 float scale, void* stream) {
  const size_t hs = (size_t)N * D, bs = (size_t)H * hs;
  if (D == 64)
    return launch_flash<64, false>(q, k, v, nullptr, out, B, H, N, 1, bs, hs, D, bs, hs, D, scale, stream);
  if (D == 128)
    return launch_flash<128, false>(q, k, v, nullptr, out, B, H, N, 1, bs, hs, D, bs, hs, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}
