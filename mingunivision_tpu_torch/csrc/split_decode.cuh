// The pieces of one-token split-S attention that decode_attention.cu (a dense
// head-major cache under a mask) and paged_attention.cu (a block-paged pool
// read through block tables) share: the 16-byte cp.async copies that stage a
// split's K and V rows, a split's fp32 partial (m, l and acc per query head of
// the GQA group) over its staged rows, and the merge of a (row, kv head)'s
// partials by log-sum-exp, in split order, that the last block of the row
// runs. Both kernels run kThreads threads per block over kTileS positions per
// split, G <= kMaxG query heads per kv head.
//
// A partial is G maxima m, G sums l, then G x D sums acc (fp32), in the
// base-2 domain: q is pre-scaled by scale * log2 e, so p = exp2(s - m).
#pragma once

#include "common.cuh"

namespace split_decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileS = 64;  // positions per split
constexpr int kMaxG = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory at head dim D: K and V rows of the split (padded), q (fp32,
// G x D) and the scores / probabilities (G x kTileS). The merge reuses the
// K and V rows for 2 x kThreads x kMaxG floats.
template <int D>
struct Smem {
  static constexpr int kLd = D + 8;  // bf16 elements per staged row
  static constexpr size_t kBytes = 2 * kTileS * kLd * sizeof(bf16) + kMaxG * D * 4 + kMaxG * kTileS * 4;
  static_assert(2 * kTileS * kLd * sizeof(bf16) >= 2 * kThreads * kMaxG * 4, "the merge's staging fits the rows");
};

// The split's partial over its n >= 1 staged rows Ks / Vs (kLd apart) and the
// pre-scaled q (qs, G x D fp32), written to `mine`. ps: G x kTileS fp32 of
// shared scratch. The caller synchronizes after the rows and q are staged;
// every thread of the block calls this.
template <int D>
__device__ __forceinline__ void split_partial(const bf16* Ks, const bf16* Vs, const float* qs, float* ps, int n, int G,
                                              float* mine) {
  using Sm = Smem<D>;
  constexpr int kPer = (D + kThreads - 1) / kThreads;  // head dimensions per thread in the sums
  constexpr int kChunks = D / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // scores: pair (position r, head g), neighbouring threads on neighbouring positions
  for (int idx = tid; idx < G * kTileS; idx += kThreads) {
    const int r = idx % kTileS, g = idx / kTileS;
    if (r >= n) continue;
    const bf16* kr = Ks + r * Sm::kLd;
    const float* qg = qs + g * D;
    float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // four sums in flight, not one chain of D
#pragma unroll 4
    for (int c = 0; c < kChunks; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 8);
      const bf162* pr = reinterpret_cast<const bf162*>(&raw);
      const float4 q0 = *reinterpret_cast<const float4*>(qg + c * 8), q1 = *reinterpret_cast<const float4*>(qg + c * 8 + 4);
      const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 kf = __bfloat1622float2(pr[i]);
        dot[i] = fmaf(qv[2 * i], kf.x, dot[i]);
        dot[i] = fmaf(qv[2 * i + 1], kf.y, dot[i]);
      }
    }
    ps[g * kTileS + r] = (dot[0] + dot[1]) + (dot[2] + dot[3]);
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {  // the split's m and l of head g
    float mx = -INFINITY;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, ps[g * kTileS + r]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int r = lane; r < n; r += 32) {
      const float e = ex2_fast(ps[g * kTileS + r] - mx);
      ps[g * kTileS + r] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      mine[g] = mx;
      mine[G + g] = sum;
    }
  }
  __syncthreads();
  float acc[kPer][kMaxG];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[j][g] = 0.0f;
#pragma unroll 8
  for (int r = 0; r < n; ++r) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = tid + j * kThreads;
      if (d >= D) continue;
      const float vv = __bfloat162float(Vs[r * Sm::kLd + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[j][g] = fmaf(ps[g * kTileS + r], vv, acc[j][g]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = tid + j * kThreads;
    if (d >= D) continue;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) mine[2 * G + g * D + d] = acc[j][g];
  }
}

// The last block of a (row, kv head) merges its partials rp[0 .. n_split) (psize
// floats apart) into ob (G x D bf16), 128 splits at a time, in split order: with
// `flags`, only the splits whose flag is up (each flag lowered to 0 as it is
// read); without, every split. Each listed split's m and l are staged in shared
// memory (`stage`, 2 x kThreads x kMaxG floats over the K and V rows, no longer
// read), the running maximum and sum of each head updated by one warp, then
// every thread adds its head dimensions of the listed splits' sums, weighted by
// exp2(m - maximum): loads that do not wait on each other. A row with nothing
// merged gives zeros (l clamped at 1e-30, as on the TPU). The caller fences
// after winning the ticket; every thread of the block calls this.
template <int D>
__device__ __forceinline__ void merge_partials(const float* rp, int n_split, size_t psize, int* flags, int G,
                                               float* stage, bf16* ob) {
  constexpr int kPer = (D + kThreads - 1) / kThreads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __shared__ float m_run[kMaxG], l_run[kMaxG], scl[kMaxG];  // the merge's running maximum, sum, rescale
  __shared__ int listed[kThreads], per_warp[kWarps];
  float* wm = stage;                 // [kThreads][kMaxG]: m, then the weight exp2(m - max)
  float* wl = wm + kThreads * kMaxG;  // [kThreads][kMaxG]: l
  if (tid < kMaxG) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.0f;
  }
  float o[kPer][kMaxG];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) o[j][g] = 0.0f;
  for (int c0 = 0; c0 < n_split; c0 += kThreads) {
    const int sp = c0 + tid;
    const float* pp = rp + (size_t)sp * psize;
    const bool in = sp < n_split;
    float mv[kMaxG], lv[kMaxG];  // read beside the flag (unused where it is down)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      mv[g] = in && g < G ? __ldcg(pp + g) : 0.0f;
      lv[g] = in && g < G ? __ldcg(pp + G + g) : 0.0f;
    }
    const bool full = in && (flags == nullptr || __ldcg(flags + sp) != 0);
    const unsigned fv = __ballot_sync(0xffffffffu, full);
    if (lane == 0) per_warp[warp] = __popc(fv);
    __syncthreads();
    int n_full = 0, at = __popc(fv & ((1u << lane) - 1));
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += per_warp[w];
      n_full += per_warp[w];
    }
    if (full) {
      listed[at] = sp;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        wm[at * kMaxG + g] = mv[g];
        wl[at * kMaxG + g] = lv[g];
      }
      if (flags != nullptr) flags[sp] = 0;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float mx = m_run[g];
      for (int i = lane; i < n_full; i += 32) mx = fmaxf(mx, wm[i * kMaxG + g]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int i = lane; i < n_full; i += 32) {
        const float w = ex2_fast(wm[i * kMaxG + g] - mx);
        wm[i * kMaxG + g] = w;
        sum += w * wl[i * kMaxG + g];
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = mx == -INFINITY ? 1.0f : ex2_fast(m_run[g] - mx);  // nothing merged yet: o and l are 0
        scl[g] = c;
        l_run[g] = l_run[g] * c + sum;
        m_run[g] = mx;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) o[j][g] *= g < G ? scl[g] : 0.0f;
    for (int i0 = 0; i0 < n_full; i0 += 4) {  // four splits' loads issued before any is summed
      float a[4][kPer][kMaxG];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* pa = rp + (size_t)listed[min(i0 + u, n_full - 1)] * psize + 2 * G;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            a[u][j][g] = g < G && tid + j * kThreads < D ? __ldcg(pa + g * D + tid + j * kThreads) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u >= n_full) break;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) o[j][g] = fmaf(wm[(i0 + u) * kMaxG + g], a[u][j][g], o[j][g]);
      }
    }
    __syncthreads();  // listed, wm, wl are written again for the next 128
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = tid + j * kThreads;
    if (d >= D) continue;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) ob[g * D + d] = __float2bfloat16(o[j][g] / fmaxf(l_run[g], 1e-30f));
  }
}

}  // namespace split_decode
