// One-token GQA attention over the head-major static KV cache, with a per-row
// boolean mask (causal bound and CFG-row masks folded in by the caller).
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/decode_attention.py
// (pallas_decode_attention -> _decode_attn_kernel). On the H100 the function
// is bound by the bytes of K and V at the allowed positions (at the slice's
// 2 rows x 4 kv heads and about 300 of 4096 positions, 1.2 MB per layer: under
// a microsecond), so what a kernel must do is spread those few rows over the
// card and reach them in as few dependent steps as it can: it is latency, not
// bandwidth, that sets its time.
//
// Design: split-S (flash-decoding) in one launch. One block of 128 threads per
// (64-position split, kv head, row): 64 splits x 4 x 2 = 512 blocks at the
// slice's shape. A block reads its split's 64 mask bytes with one vote; a split
// with no allowed position writes nothing and goes straight to the ticket
// below, so the walk over empty tiles runs in parallel. Else it
// lists its allowed positions (ballots), copies exactly those K and V rows
// into shared memory with 16-byte cp.async (all issued, then one wait), so a
// masked position is never loaded or summed: stale, NaN or Inf cache entries
// cannot reach the output. Scores: each thread takes (position, query head)
// pairs of the G heads of the kv head and forms the dot from its K row
// (16-byte shared reads, rows padded by 16 bytes so neighbouring positions hit
// distinct banks) and q, pre-scaled by scale * log2 e in fp32 (the
// exponentials are exp2). A warp per head takes the split's maximum m and
// sum l of exp2(s - m); then each thread sums p * v for its head dimension over
// the split's positions, for the G heads. The block writes its fp32 partial
// (m, l per head; acc[G][D]) to the workspace and raises the split's flag,
// fences, and takes a ticket from its (row, kv head)'s counter: the last
// block of the row merges the flagged partials by log-sum-exp, in split order
// (so the result does not depend on which block came last), writes the bf16
// output and lowers the flags and the counter to 0 for the next launch (no
// memset launch). A fully masked row gives zeros (l clamped at 1e-30, as on
// the TPU).
#include "common.cuh"

namespace {

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

// q (B, Hkv * G, D); k / v (B, Hkv, S, D); mask (B, S) bytes; out (B, Hkv * G, D);
// part: per (row, kv head, split) the partial, G m's, G l's, then G x D acc (fp32);
// counters: B * Hkv tickets, then B * Hkv * splits flags (int32), all 0
// between launches. Grid (splits, Hkv, B).
template <int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ mask, bf16* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
    int G, int S, float scale_log2e) {
  using Sm = Smem<D>;
  constexpr int kPer = (D + kThreads - 1) / kThreads;  // head dimensions per thread in the sums
  const int split = blockIdx.x, n_split = gridDim.x, hk = blockIdx.y, Hkv = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTileS * Sm::kLd;
  float* qs = reinterpret_cast<float*>(Vs + kTileS * Sm::kLd);
  float* ps = qs + kMaxG * D;
  __shared__ int pos[kTileS];
  __shared__ int count[kTileS / 32];
  __shared__ float m_run[kMaxG], l_run[kMaxG], scl[kMaxG];  // the merge's running maximum, sum, rescale
  __shared__ int listed[kThreads], per_warp[kWarps];
  __shared__ bool last;

  const int row = b * Hkv + hk;  // the (row, kv head) pair
  const size_t psize = (size_t)G * (D + 2);
  float* mine = part + ((size_t)row * n_split + split) * psize;
  int* tickets = counters;
  int* flags = counters + gridDim.y * gridDim.z + (size_t)row * n_split;  // this row's split flags

  // the split's allowed positions, in order
  const int s0 = split * kTileS;
  const bool ok = tid < kTileS && s0 + tid < S && mask[(size_t)b * S + s0 + tid];
  const unsigned vote = __ballot_sync(0xffffffffu, ok);
  if (lane == 0 && warp < kTileS / 32) count[warp] = __popc(vote);
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int w = 0; w < kTileS / 32; ++w) n += count[w];
  if (n > 0) {
    if (ok) {
      int at = __popc(vote & ((1u << lane) - 1));
      for (int w = 0; w < warp; ++w) at += count[w];
      pos[at] = s0 + tid;
    }
    __syncthreads();
    const size_t head = (size_t)row * S * D;
    constexpr int kChunks = D / 8;
    for (int idx = tid; idx < n * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const size_t src = head + (size_t)pos[r] * D + c * 8;
      cp_async16(Ks + r * Sm::kLd + c * 8, k + src);
      cp_async16(Vs + r * Sm::kLd + c * 8, v + src);
    }
    const bf16* qb = q + (size_t)row * G * D;
    for (int idx = tid; idx < G * D; idx += kThreads) qs[idx] = __bfloat162float(qb[idx]) * scale_log2e;
    cp_async_wait_all();
    __syncthreads();

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
    if (tid == 0) flags[split] = 1;
  }

  // the last block of the (row, kv head) merges: the block's writes, then one fence (cumulative over the
  // block's writes that the barrier ordered before it), then the ticket
  __syncthreads();
  if (tid == 0) {
    if (n > 0) __threadfence();
    last = atomicAdd(&tickets[row], 1) == n_split - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The flagged partials, 128 splits at a time, in split order: each listed split's m and l staged in
  // shared memory (over the K and V rows, no longer read), the running maximum and sum of each head updated by
  // one warp, then every thread adds its head dimensions of the listed splits' sums, weighted by
  // exp2(m - maximum): loads that do not wait on each other.
  const float* rp = part + (size_t)row * n_split * psize;
  float* wm = reinterpret_cast<float*>(smem_raw);  // [kThreads][kMaxG]: m, then the weight exp2(m - max)
  float* wl = wm + kThreads * kMaxG;               // [kThreads][kMaxG]: l
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
    const bool full = in && __ldcg(flags + sp) != 0;
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
      flags[sp] = 0;
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
  bf16* ob = out + (size_t)row * G * D;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = tid + j * kThreads;
    if (d >= D) continue;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) ob[g * D + d] = __float2bfloat16(o[j][g] / fmaxf(l_run[g], 1e-30f));
  }
  if (tid == 0) tickets[row] = 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* part, void* counters, int B,
           int Hkv, int G, int S, float scale, cudaStream_t st) {
  auto kernel = decode_split_kernel<D>;
  const cudaError_t rc = allow_dynamic_smem(kernel, Smem<D>::kBytes);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((S + kTileS - 1) / kTileS, Hkv, B);
  kernel<<<grid, kThreads, Smem<D>::kBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), G, S, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, Hkv*G, D) bf16; k/v (B, Hkv, S, D) bf16 head-major for ONE layer,
// 16-byte aligned; mask (B, S) bool as bytes; out (B, 1, Hkv*G, D) bf16;
// part: B * Hkv * ceil(S / mu_decode_attention_tile()) * G * (D + 2) fp32 of
// workspace; counters: B * Hkv * (1 + ceil(S / mu_decode_attention_tile()))
// int32, zero before the first launch (every launch leaves them zero). D must be 64, 128 or 256 and G at most 8 (the
// wrapper checks).
extern "C" int mu_decode_attention_bf16(const void* q, const void* k, const void* v, const void* mask, void* out,
                                        void* part, void* counters, int B, int Hkv, int G, int S, int D, float scale,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kMaxG || S < 1) return (int)cudaErrorInvalidValue;
  if (D == 128) return launch<128>(q, k, v, mask, out, part, counters, B, Hkv, G, S, scale, st);
  if (D == 64) return launch<64>(q, k, v, mask, out, part, counters, B, Hkv, G, S, scale, st);
  if (D == 256) return launch<256>(q, k, v, mask, out, part, counters, B, Hkv, G, S, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Positions per split the kernel was compiled for.
extern "C" int mu_decode_attention_tile(void) { return kTileS; }
