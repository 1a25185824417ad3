// One-token GQA attention over a block-paged KV pool, read through per-row
// block tables (the paged serving engine's decode attention).
//
// Replaces both TPU entries of mingunivision_tpu/ops/kernels/paged_attention.py:
// pallas_paged_decode_attention -> _paged_decode_kernel (one page per grid
// step) and paged_decode_attention_auto (the JAX library's multi-page kernel).
// They compute the same function: for q (B, 1, Hkv*G, D) and one layer's pages
// (Hkv, P+1, page, D), softmax(q k^T * scale) v over each row's first
// lengths[b] positions, position i of a row in page tables[b][i / page].
//
// On the H100 it is bound by the bytes of K and V at the rows' valid
// positions. The grid is one CTA per (split of up to 8 pages, kv head, row),
// so a short batch still spreads over the SMs (one CTA per (row, kv head)
// would be 4 CTAs at batch 1), followed by a log-sum-exp combine of the
// splits. A CTA reads only the table entries below ceil(len / page), copies
// each page's valid rows of K and V to shared memory with 16-byte loads, and
// keeps an fp32 online softmax per query head of its group (GQA stays
// grouped: K/V are read once for the G heads). The scale is applied to the
// fp32 scores, so q is rounded once (at its bf16 input). Positions at or past
// len are never loaded nor summed: they are excluded by the loop bounds, not
// multiplied by zero, so whatever the scratch page or a page's tail holds
// cannot reach the output. A split with no position writes m = -inf and is
// skipped by the combine; a row of length 0 gives zeros.
// wgmma, TMA and cp.async double-buffering of the pages are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPagesPerSplit = 8;
constexpr int kMaxPage = 64;
constexpr int kMaxG = 8;
constexpr int kMaxD = 128;

// o_part (B, Hkv, nsplit, G, D) fp32: each split's unnormalised sum of p * v;
// ml_part (B, Hkv, nsplit, 2, G) fp32: its running max m and sum l per head.
__global__ void __launch_bounds__(kThreads) paged_attention_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kp, const bf16* __restrict__ vp,
    const int* __restrict__ tables, const int* __restrict__ lengths, float* __restrict__ o_part,
    float* __restrict__ ml_part, int Hkv, int G, int P1, int page, int D, int maxp, float scale) {
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  const int n_pages = min((len + page - 1) / page, maxp);
  const int p0 = split * kPagesPerSplit;
  const int p1 = min(p0 + kPagesPerSplit, n_pages);
  const size_t part = ((size_t)b * Hkv + hk) * nsplit + split;
  float* ml = ml_part + part * 2 * G;
  if (p0 >= p1) {  // no position of this row in this split
    if (tid < G) {
      ml[tid] = -INFINITY;
      ml[G + tid] = 0.0f;
    }
    return;
  }

  __shared__ __align__(16) bf16 ks[kMaxPage * kMaxD];
  __shared__ __align__(16) bf16 vs[kMaxPage * kMaxD];
  __shared__ float qs[kMaxG][kMaxD];
  __shared__ float ps[kMaxG][kMaxPage];
  __shared__ float m_run[kMaxG], l_run[kMaxG], corr[kMaxG];

  const bf16* qb = q + ((size_t)b * Hkv * G + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i / D][i % D] = __bfloat162float(qb[i]);
  if (tid < G) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.0f;
  }
  const size_t page_elems = (size_t)page * D;
  const bf16* kh = kp + (size_t)hk * P1 * page_elems;
  const bf16* vh = vp + (size_t)hk * P1 * page_elems;
  const int* tb = tables + (size_t)b * maxp;

  const int d = tid % D;   // PV: this thread's head dimension
  const int pg = tid / D;  // and its share of the page's positions
  const int npg = kThreads / D;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.0f;
  __syncthreads();

  for (int pi = p0; pi < p1; ++pi) {
    const int valid = min(page, len - pi * page);  // >= 1 here
    const uint4* ksrc = reinterpret_cast<const uint4*>(kh + (size_t)tb[pi] * page_elems);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vh + (size_t)tb[pi] * page_elems);
    uint4* kdst = reinterpret_cast<uint4*>(ks);
    uint4* vdst = reinterpret_cast<uint4*>(vs);
    for (int i = tid; i < valid * D / 8; i += kThreads) {  // the valid rows only, 8 bf16 per load
      kdst[i] = ksrc[i];
      vdst[i] = vsrc[i];
    }
    __syncthreads();

    // scores: warp w takes positions w, w + 8, ...; a lane covers two dims per 64
    for (int p = warp; p < valid; p += kWarps) {
      const bf16* krow = ks + p * D;
      float dot[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot[g] = 0.0f;
      for (int d0 = 2 * lane; d0 < D; d0 += 64) {
        const float2 kv = __bfloat1622float2(*reinterpret_cast<const bf162*>(krow + d0));
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) dot[g] += qs[g][d0] * kv.x + qs[g][d0 + 1] * kv.y;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float s = warp_sum(dot[g]);
          if (lane == 0) ps[g][p] = s * scale;
        }
      }
    }
    __syncthreads();

    // online softmax: warp g owns query head g
    if (warp < G) {
      float mx = -INFINITY;
      for (int p = lane; p < valid; p += 32) mx = fmaxf(mx, ps[warp][p]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_run[warp], mx);
      float sum = 0.0f;
      for (int p = lane; p < valid; p += 32) {
        const float e = __expf(ps[warp][p] - m_new);
        ps[warp][p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = __expf(m_run[warp] - m_new);
        corr[warp] = c;
        l_run[warp] = l_run[warp] * c + sum;
        m_run[warp] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) acc[g] *= corr[g];
    }
    for (int p = pg; p < valid; p += npg) {
      const float vv = __bfloat162float(vs[p * D + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) acc[g] = fmaf(ps[g][p], vv, acc[g]);
      }
    }
    __syncthreads();  // before the next page overwrites ks / vs
  }

  float* red = reinterpret_cast<float*>(ks);  // [npg][kMaxG][D]: K's buffer is free now
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) red[(pg * kMaxG + g) * D + d] = acc[g];
  }
  __syncthreads();
  if (pg == 0) {
    float* ob = o_part + part * G * D;
    for (int g = 0; g < G; ++g) {
      float s = 0.0f;
      for (int j = 0; j < npg; ++j) s += red[(j * kMaxG + g) * D + d];
      ob[g * D + d] = s;
    }
  }
  if (tid < G) {
    ml[tid] = m_run[tid];
    ml[G + tid] = l_run[tid];
  }
}

// out[b, hk*G + g, :] = sum over the splits s with a position of
// exp(m_s - M) o_s / sum_s exp(m_s - M) l_s, M = max_s m_s; zeros for a row of
// length 0. grid (Hkv, B), 128 threads.
__global__ void __launch_bounds__(128) paged_attention_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ ml_part, bf16* __restrict__ out, int Hkv, int G,
    int D, int nsplit) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const size_t part0 = ((size_t)b * Hkv + hk) * nsplit;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml_part[(part0 + s) * 2 * G + g]);
    float num = 0.0f, den = 0.0f;
    if (M != -INFINITY) {
      for (int s = 0; s < nsplit; ++s) {
        const float m = ml_part[(part0 + s) * 2 * G + g];
        if (m == -INFINITY) continue;  // an empty split: its o_part was never written
        const float w = expf(m - M);
        num = fmaf(w, o_part[((part0 + s) * G + g) * D + d], num);
        den = fmaf(w, ml_part[(part0 + s) * 2 * G + G + g], den);
      }
    }
    out[((size_t)b * Hkv * G + (size_t)hk * G + g) * D + d] = __float2bfloat16(den > 0.0f ? num / den : 0.0f);
  }
}

}  // namespace

// q (B, 1, Hkv*G, D) bf16; k/v pages (Hkv, P1, page, D) bf16, ONE layer of the
// pool; tables (B, maxp) int32 page ids; lengths (B,) int32, the valid
// positions of each row (the token written this step included); o_part
// (B, Hkv, ceil(maxp / 8), G, D) fp32 and ml_part (B, Hkv, ceil(maxp / 8), 2, G)
// fp32 scratch; out (B, 1, Hkv*G, D) bf16. D 64 or 128, page at most 64, G at
// most 8, pages 16-byte aligned (the wrapper checks).
extern "C" int mu_paged_attention_bf16(const void* q, const void* kp, const void* vp, const void* tables,
                                       const void* lengths, void* o_part, void* ml_part, void* out, int B, int Hkv,
                                       int G, int P1, int page, int D, int maxp, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nsplit = (maxp + kPagesPerSplit - 1) / kPagesPerSplit;
  paged_attention_split_kernel<<<dim3(nsplit, Hkv, B), kThreads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<float*>(o_part),
      static_cast<float*>(ml_part), Hkv, G, P1, page, D, maxp, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_attention_combine_kernel<<<dim3(Hkv, B), 128, 0, s>>>(static_cast<const float*>(o_part),
                                                              static_cast<const float*>(ml_part),
                                                              static_cast<bf16*>(out), Hkv, G, D, nsplit);
  return (int)cudaGetLastError();
}
