// One-token GQA attention over the head-major static KV cache, with a per-row
// boolean mask (causal bound and CFG-row masks folded in by the caller).
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/decode_attention.py
// (pallas_decode_attention -> _decode_attn_kernel). On the H100 it is bound by
// the bytes of K and V it reads: the TPU kernel streams all Smax positions
// (at the slice, 2 rows x 4 kv-heads x 4096 x 128 x 2 B x 2 = 16.8 MB per
// layer) although only the allowed ones matter (about 300 of 4096 in a T2I
// image loop). This kernel reads K and V only at allowed positions: a tile of
// 256 positions with no allowed one is skipped whole, and inside a tile each
// warp skips masked rows.
//
// One block per (kv-head, batch row); its G query heads stay grouped (KV is
// never repeated). Per tile: warps compute the G scores of a position with
// coalesced bf16x2 loads and a shuffle reduction; warp g updates the online
// softmax state (max, sum) of query head g; then every thread adds p * v for
// one head dimension over a share of the tile's positions. Everything stays in
// registers and shared memory; only the (G, D) output is written.
// A fully masked row gives zeros (l is clamped at 1e-30, as on the TPU).
// One block per (row, kv-head) is 8 blocks at the slice's shape; a split-S
// (flash-decoding) pass is a later optimisation.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileS = 256;
constexpr int kMaxG = 8;
constexpr int kMaxD = 256;

__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ mask, bf16* __restrict__ out, int Hkv, int G, int S, int D, float scale) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Hq = Hkv * G;

  __shared__ float qs[kMaxG][kMaxD];
  __shared__ float ps[kMaxG][kTileS];
  __shared__ float m_run[kMaxG], l_run[kMaxG], corr[kMaxG];
  __shared__ float red[kThreads * kMaxG];  // [npg][kMaxG][D]

  const bf16* qb = q + ((size_t)b * Hq + (size_t)hk * G) * D;
  for (int idx = tid; idx < G * D; idx += kThreads) qs[idx / D][idx % D] = __bfloat162float(qb[idx]) * scale;
  if (tid < G) {
    m_run[tid] = -1e30f;
    l_run[tid] = 0.0f;
  }
  const size_t head = ((size_t)b * Hkv + hk) * (size_t)S * D;
  const bf16* kb = k + head;
  const bf16* vb = v + head;
  const uint8_t* mrow = mask + (size_t)b * S;

  const int d = tid % D;   // PV: this thread's head dimension
  const int pg = tid / D;  // and its share of the tile's positions
  const int npg = kThreads / D;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.0f;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += kTileS) {
    const bool mine = (s0 + tid < S) && mrow[s0 + tid];
    if (!__syncthreads_or(mine)) continue;  // no allowed position in this tile

    for (int pp = warp; pp < kTileS; pp += kWarps) {
      const int pos = s0 + pp;
      const bool ok = pos < S && mrow[pos];  // uniform across the warp
      if (!ok) {
        if (lane < G) ps[lane][pp] = -INFINITY;
        continue;
      }
      const bf16* krow = kb + (size_t)pos * D;
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
          if (lane == 0) ps[g][pp] = s;
        }
      }
    }
    __syncthreads();

    if (warp < G) {
      float mx = -INFINITY;
      for (int pp = lane; pp < kTileS; pp += 32) mx = fmaxf(mx, ps[warp][pp]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_run[warp], mx);
      float sum = 0.0f;
      for (int pp = lane; pp < kTileS; pp += 32) {
        const float s = ps[warp][pp];
        const float p = s == -INFINITY ? 0.0f : __expf(s - m_new);
        ps[warp][pp] = p;
        sum += p;
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
    for (int pp = pg; pp < kTileS; pp += npg) {
      const int pos = s0 + pp;
      if (pos >= S || !mrow[pos]) continue;
      const float vv = __bfloat162float(vb[(size_t)pos * D + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) acc[g] = fmaf(ps[g][pp], vv, acc[g]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) red[(pg * kMaxG + g) * D + d] = acc[g];
  }
  __syncthreads();
  if (pg == 0) {
    bf16* ob = out + ((size_t)b * Hq + (size_t)hk * G) * D;
    for (int g = 0; g < G; ++g) {
      float s = 0.0f;
      for (int j = 0; j < npg; ++j) s += red[(j * kMaxG + g) * D + d];
      ob[g * D + d] = __float2bfloat16(s / fmaxf(l_run[g], 1e-30f));
    }
  }
}

}  // namespace

// q (B, 1, Hkv*G, D) bf16; k/v (B, Hkv, S, D) bf16 head-major for ONE layer;
// mask (B, S) bool as bytes; out (B, 1, Hkv*G, D) bf16.
// D must be 64, 128 or 256 and G at most 8 (the wrapper checks).
extern "C" int mu_decode_attention_bf16(const void* q, const void* k, const void* v, const void* mask, void* out,
                                        int B, int Hkv, int G, int S, int D, float scale, void* stream) {
  dim3 grid(Hkv, B);
  decode_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), Hkv, G, S, D, scale);
  return (int)cudaGetLastError();
}
