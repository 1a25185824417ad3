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
// the TPU). The copies, the partial and the merge are split_decode.cuh's,
// shared with paged_attention.cu.
#include "split_decode.cuh"

namespace {

using namespace split_decode;

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
  const int split = blockIdx.x, n_split = gridDim.x, hk = blockIdx.y, Hkv = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTileS * Sm::kLd;
  float* qs = reinterpret_cast<float*>(Vs + kTileS * Sm::kLd);
  float* ps = qs + kMaxG * D;
  __shared__ int pos[kTileS];
  __shared__ int count[kTileS / 32];
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
    split_partial<D>(Ks, Vs, qs, ps, n, G, mine);
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
  // the flagged partials, in split order (flags lowered as they are read)
  merge_partials<D>(part + (size_t)row * n_split * psize, n_split, psize, flags, G,
                    reinterpret_cast<float*>(smem_raw), out + (size_t)row * G * D);
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
