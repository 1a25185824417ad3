// The pieces of the decode-shape MoE that moe_stream.cu (bf16 tables) and
// moe_stream_q4.cu (int4 tables, s8 dots) share: the 16-byte cp.async copies
// of their weight rings, the routing every block builds from the (N, k) top-k
// ids and gates, and the merge the last block of each column tile of h runs
// by ticket (a column per thread). Both take at most kMaxRows rows, top-k at
// most kMaxK of at most kMaxE experts, and pad the rows to rows_pad(N): 8 per
// n-tile, 1, 2, 4 or 8 n-tiles.
#pragma once

#include "common.cuh"

namespace moe_decode {

constexpr int kMaxK = 8;      // top-k
constexpr int kMaxRows = 64;  // rows per launch
constexpr int kMaxE = 1024;   // experts

__host__ __device__ constexpr int rows_pad(int N) {
  return 8 * ((N + 7) / 8 <= 2 ? (N + 7) / 8 : (N + 7) / 8 <= 4 ? 4 : 8);
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// The routing every block builds from the (N, k) top-k ids and gates.
struct Routing {
  int idx[kMaxRows * kMaxK];  // the ids, -1 where out of [0, E) (such an assignment is dropped)
  float w[kMaxRows * kMaxK];  // the gates, fp32 (the down launch's merge only)
  unsigned bits[kMaxE / 32];  // routed experts
  int base[kMaxE / 32];       // routed experts in the words before
  int n_unique;
  int expert;  // the expert of this block's slot (when the slot is routed)
};

// Fills R from topk_idx (int32, or int64 with idx64) and, with `gates`,
// topk_w (bf16, or fp32 with w_f32); every thread of the block calls it.
// Slot s is the s-th routed expert in ascending id.
__device__ inline void build_routing(Routing& R, const void* topk_idx, int idx64, const void* topk_w, int w_f32,
                                     bool gates, int N, int K, int E, int slot) {
  const int tid = threadIdx.x, lane = tid & 31, n_words = (E + 31) / 32;
  for (int i = tid; i < n_words; i += blockDim.x) R.bits[i] = 0u;
  __syncthreads();
  for (int i = tid; i < N * K; i += blockDim.x) {
    const long long e = idx64 ? static_cast<const long long*>(topk_idx)[i] : static_cast<const int*>(topk_idx)[i];
    const bool ok = e >= 0 && e < E;
    R.idx[i] = ok ? (int)e : -1;
    if (ok) atomicOr(&R.bits[e >> 5], 1u << (e & 31));
    if (gates)
      R.w[i] = w_f32 ? static_cast<const float*>(topk_w)[i] : __bfloat162float(static_cast<const bf16*>(topk_w)[i]);
  }
  __syncthreads();
  if (tid < 32) {  // one warp ranks the (at most 32) words, then finds the slot's expert
    const unsigned word = lane < n_words ? R.bits[lane] : 0u;
    const int count = __popc(word);
    int incl = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    R.base[lane] = incl - count;
    if (lane == 31) R.n_unique = incl;
    if (slot >= incl - count && slot < incl) {  // the slot's expert lies in this lane's word
      unsigned rest = word;
      for (int j = incl - count; j < slot; ++j) rest &= rest - 1;
      R.expert = lane * 32 + __ffs(rest) - 1;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int slot_of(const Routing& R, int e) {
  return R.base[e >> 5] + __popc(R.bits[e >> 5] & ((1u << (e & 31)) - 1u));
}


// The merge's shared memory: each row's routed slots, ascending, with their gates.
struct MergeLists {
  int slots[kMaxRows][kMaxK];
  float gates[kMaxRows][kMaxK];
  int count[kMaxRows];
  bool last;
};

// After a down block has written its slot's fp32 products ypart[slot] (U
// routed slots x N x h) for columns [col0, col0 + blockDim.x): the block's
// writes, one fence, a ticket from the tile's counter; the tile's last block
// sums, for each row, gate * y over the row's routed slots in ascending slot
// order (the gates of duplicate assignments summed in order), writes the bf16
// output and lowers the counter to 0 for the next launch. The result does not
// depend on which block came last, and no output value is summed by atomics.
// kFma: each term by one fused multiply-add; else the product rounded, then
// the sum (the int4 plain version's acc + gate * y). Every thread calls it.
template <bool kFma>
__device__ void merge_tile(const Routing& R, MergeLists& M, const float* ypart, int* tickets, bf16* out, int N, int K,
                           int h, int col0, int U) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    M.last = atomicAdd(&tickets[blockIdx.x], 1) == U - 1;
  }
  __syncthreads();
  if (!M.last) return;
  __threadfence();
  if (tid < N) {  // row tid's routed slots, ascending, each with its assignments' gates summed in order
    int cnt = 0;
    for (int j = 0; j < K; ++j) {
      const int e = R.idx[tid * K + j];
      if (e < 0) continue;
      const int sl = slot_of(R, e);
      const float w = R.w[tid * K + j];
      int at = 0;
      while (at < cnt && M.slots[tid][at] < sl) ++at;
      if (at < cnt && M.slots[tid][at] == sl) {
        M.gates[tid][at] += w;
        continue;
      }
      for (int q = cnt; q > at; --q) {
        M.slots[tid][q] = M.slots[tid][q - 1];
        M.gates[tid][q] = M.gates[tid][q - 1];
      }
      M.slots[tid][at] = sl;
      M.gates[tid][at] = w;
      ++cnt;
    }
    M.count[tid] = cnt;
  }
  __syncthreads();
  const int col = col0 + tid;
  if (col < h) {
    for (int n0 = 0; n0 < N; n0 += 4) {  // four rows' loads issued before any is summed
      float v[4][kMaxK];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kMaxK; ++q)
          v[r][q] = n0 + r < N && q < M.count[n0 + r]
                        ? __ldcg(ypart + ((size_t)M.slots[n0 + r][q] * N + n0 + r) * h + col)
                        : 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (n0 + r >= N) break;
        float sum = 0.0f;
#pragma unroll
        for (int q = 0; q < kMaxK; ++q)
          if (q < M.count[n0 + r])
            sum = kFma ? fmaf(M.gates[n0 + r][q], v[r][q], sum)
                       : __fadd_rn(sum, __fmul_rn(M.gates[n0 + r][q], v[r][q]));
        out[(size_t)(n0 + r) * h + col] = __float2bfloat16(sum);
      }
    }
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

}  // namespace moe_decode
