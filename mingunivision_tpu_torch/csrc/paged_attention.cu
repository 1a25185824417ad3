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
// On the H100 the function is bound by the bytes of K and V at the rows'
// valid positions (16 serving slots of up to 2,047 positions: about 18 MB, 5
// us), and at the serving engine's batch sizes by latency as much: what a
// kernel must do is spread the rows' pages over the card and reach them in
// as few dependent steps as it can.
//
// Design: split by page, in one launch. One block of 128 threads per
// (64-position split, kv head, row): one page at the engine's page of 64, two
// at 32. A block reads its row's length first; a split at or past the row's
// last position exits there (for a row of length 0, split 0 writes the
// zeros first). Else it reads the table entries of its positions, copies
// exactly those K and V rows (valid positions only: never the tail of a
// page, the scratch page or an unused table entry) into shared memory with
// 16-byte cp.async, all issued then one wait, and forms its fp32 partial (m,
// l, acc per query head of the GQA group; K and V read once for the G heads;
// q pre-scaled by scale * log2 e, exponentials exp2). It writes the partial to
// the workspace, fences and takes a ticket from its (row, kv head)'s counter:
// the last of the row's ceil(len / 64) blocks merges their partials by
// log-sum-exp in split (page) order, so the result does not depend on which
// block came last, writes the bf16 output and lowers the counter to 0 for
// the next launch (no memset launch, no atomics on output values). Only
// blocks with positions take tickets, so every partial the merge reads was
// written in this launch: no flags are needed. The copies, the partial and
// the merge are split_decode.cuh's, shared with decode_attention.cu.
#include "split_decode.cuh"

namespace {

using namespace split_decode;

// q (B, Hkv * G, D); k / v pages (Hkv, P1, page, D); tables (B, maxp); lengths
// (B,); out (B, Hkv * G, D); part: per (row, kv head, split) the partial, G
// m's, G l's, then G x D acc (fp32); tickets: B * Hkv int32, 0 between
// launches. Grid (ceil(maxp * page / kTileS), Hkv, B).
template <int D>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kp, const bf16* __restrict__ vp,
    const int* __restrict__ tables, const int* __restrict__ lengths, bf16* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int G, int P1, int page, int maxp, float scale_log2e) {
  using Sm = Smem<D>;
  const int split = blockIdx.x, n_split = gridDim.x, hk = blockIdx.y, Hkv = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = b * Hkv + hk;  // the (row, kv head) pair
  const int len = min(max(lengths[b], 0), maxp * page);
  const int n_full = (len + kTileS - 1) / kTileS;  // the row's splits with a position
  if (split >= n_full) {
    if (len == 0 && split == 0) {
      bf16* ob = out + (size_t)row * G * D;
      for (int i = tid; i < G * D; i += kThreads) ob[i] = __float2bfloat16(0.0f);
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTileS * Sm::kLd;
  float* qs = reinterpret_cast<float*>(Vs + kTileS * Sm::kLd);
  float* ps = qs + kMaxG * D;
  __shared__ int pos[kTileS];  // each position's row in its kv head's pool, (page id) * page + offset
  __shared__ bool last;

  const int s0 = split * kTileS;
  const int n = min(kTileS, len - s0);
  if (tid < n) {
    const int p = s0 + tid;
    pos[tid] = tables[(size_t)b * maxp + p / page] * page + p % page;
  }
  const bf16* qb = q + (size_t)row * G * D;
  for (int idx = tid; idx < G * D; idx += kThreads) qs[idx] = __bfloat162float(qb[idx]) * scale_log2e;
  __syncthreads();
  const size_t head = (size_t)hk * P1 * page * D;
  constexpr int kChunks = D / 8;
  for (int idx = tid; idx < n * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const size_t src = head + (size_t)pos[r] * D + c * 8;
    cp_async16(Ks + r * Sm::kLd + c * 8, kp + src);
    cp_async16(Vs + r * Sm::kLd + c * 8, vp + src);
  }
  cp_async_wait_all();
  __syncthreads();
  const size_t psize = (size_t)G * (D + 2);
  split_partial<D>(Ks, Vs, qs, ps, n, G, part + ((size_t)row * n_split + split) * psize);

  // the block's writes, one fence (cumulative over the writes the barrier ordered before it), the ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&tickets[row], 1) == n_full - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge_partials<D>(part + (size_t)row * n_split * psize, n_full, psize, nullptr, G,
                    reinterpret_cast<float*>(smem_raw), out + (size_t)row * G * D);
  if (tid == 0) tickets[row] = 0;
}

template <int D>
int launch(const void* q, const void* kp, const void* vp, const void* tables, const void* lengths, void* out,
           void* part, void* tickets, int B, int Hkv, int G, int P1, int page, int maxp, float scale,
           cudaStream_t st) {
  auto kernel = paged_split_kernel<D>;
  const cudaError_t rc = allow_dynamic_smem(kernel, Smem<D>::kBytes);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((maxp * page + kTileS - 1) / kTileS, Hkv, B);
  kernel<<<grid, kThreads, Smem<D>::kBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), G, P1, page, maxp, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, Hkv*G, D) bf16; k/v pages (Hkv, P1, page, D) bf16, ONE layer of the
// pool, 16-byte aligned; tables (B, maxp) int32 page ids; lengths (B,) int32,
// the valid positions of each row (the token written this step included);
// out (B, 1, Hkv*G, D) bf16; part: B * Hkv * ceil(maxp * page /
// mu_paged_attention_tile()) * G * (D + 2) fp32 of workspace; tickets: B * Hkv
// int32, zero before the first launch (every launch leaves them zero). D 64 or
// 128, page at most 64, G at most 8 (the wrapper checks).
extern "C" int mu_paged_attention_bf16(const void* q, const void* kp, const void* vp, const void* tables,
                                       const void* lengths, void* out, void* part, void* tickets, int B, int Hkv,
                                       int G, int P1, int page, int D, int maxp, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > kMaxG || page < 1 || page > kTileS || maxp < 1) return (int)cudaErrorInvalidValue;
  if (D == 128) return launch<128>(q, kp, vp, tables, lengths, out, part, tickets, B, Hkv, G, P1, page, maxp, scale, st);
  if (D == 64) return launch<64>(q, kp, vp, tables, lengths, out, part, tickets, B, Hkv, G, P1, page, maxp, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Positions per split the kernel was compiled for.
extern "C" int mu_paged_attention_tile(void) { return kTileS; }
