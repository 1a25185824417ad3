// The pieces of the decode-shape MoE that moe_stream.cu (bf16 tables),
// moe_stream_q4.cu (int4 tables, both dot modes) and moe_stream_q8.cu (int8
// tables, s8 dots) share: the 16-byte cp.async copies of their weight rings,
// the routing every block builds from the (N, k) top-k ids and gates, and the
// merge the last block of each column tile of h runs by ticket (a column per
// thread); and the 256-thread ring of the quantized kernels (`ring`): stages
// of 64 rows x 256 bytes, swizzled so that the A fragments' word reads fall on
// distinct banks, their fp32 epilogue, the slot's last block by ticket and
// the launch pair, the down launch a programmatic dependent of the up launch.
// All take at most kMaxRows rows, top-k at most kMaxK of at most kMaxE
// experts, and pad the rows to rows_pad(N): 8 per n-tile, 1, 2, 4 or 8 n-tiles.
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

// ---------------------------------------------------------------------------
// The ring of the quantized two-launch kernels: 256 threads, 8 warps of 32 bytes of each staged row
// ---------------------------------------------------------------------------

namespace ring {

constexpr int kThreads = 256;
constexpr int kTileK = 64;      // staged rows per stage (contraction rows, or packed rows of int4 tables)
constexpr int kRowBytes = 256;  // a staged row: 32 bytes a warp
constexpr int kChunks = kRowBytes / 16;
constexpr int kStageBytes = kTileK * kRowBytes;
constexpr int kDownCols = 256;  // down: columns of h per block (a byte each of int8 or packed int4 W2), a thread each
                                // in the merge
static_assert(8 * 32 == kRowBytes && kDownCols == kThreads && kDownCols == kRowBytes, "a warp per 32 bytes");

// Pitch in bytes of a staged s8 operand row of `bytes` (a multiple of 64): + 16, so that a B fragment's 8 rows x 4
// words fall on 32 distinct banks.
__host__ __device__ constexpr int op_pitch(int bytes) { return bytes + 16; }

// Where 16-byte chunk c of staged row k lies: the chunk index XOR 2 * ((k / 4) % 4), so that the four 4-row groups
// an A fragment's word reads span fall on distinct banks (every row starts on bank 0).
__device__ __forceinline__ int swizzled(int k, int c) { return k * kRowBytes + ((c ^ (((k >> 2) & 3) << 1)) << 4); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) { cp_async16_zfill(dst, src, true); }

// The byte offset, within a staged row, of the word lane (g, t) reads for the warp's 32 columns at byte `col` of
// the row (columns col + 4g .. + 3; the swizzle of each row it reads is 2t).
__device__ __forceinline__ int a_offset(int col, int lane) {
  const int g = lane >> 2, t = lane & 3;
  return ((((col >> 4) + (g >> 2)) ^ (2 * t)) << 4) + ((4 * g) & 15);
}

// Lane (g, t)'s A words of the k32 step at staged row kk: w[hf][r] the word of its 4 columns at row kk + 16 hf +
// 4t + r (q4_mma.cuh's layout).
__device__ __forceinline__ void a_words(const unsigned char* stage, int kk, int a_off, uint32_t (&w)[2][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[hf][r] = *reinterpret_cast<const uint32_t*>(stage + (kk + 16 * hf + 4 * t + r) * kRowBytes + a_off);
}

// The ring over KT stages: `load(s, kt)` issues stage kt's copies into ring slot s, the caller having committed
// the first S - 1 groups; `step(stage, kt)` multiplies stage kt once it has arrived. Every thread calls it; on
// return the ring is free.
template <int S, typename Load, typename Step>
__device__ __forceinline__ void stream(unsigned char* smem, Load load, int KT, Step step) {
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage kt arrived for every thread; every warp is done with the stage overwritten next
    if (kt + S - 1 < KT) load((kt + S - 1) % S, kt + S - 1);
    cp_async_commit();
    step(smem + (kt % S) * kStageBytes, kt);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Issues the first S - 1 groups of the ring (stage s into slot s, an empty group past KT).
template <int S, typename Load>
__device__ __forceinline__ void prime(Load load, int KT, int first = 0) {
#pragma unroll
  for (int s = first; s < S - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
}

// The up launch's stage kt: staged row r holds row kt * kTileK + r of the tables a and b (rows of ld bytes), its
// 128 columns [p0, p0 + 128) of a in chunks 0-7, then of b in chunks 8-15.
__device__ __forceinline__ void load_pair_tiles(unsigned char* stage, const uint8_t* a, const uint8_t* b, size_t ld,
                                                int kt, int p0) {
  for (int i = threadIdx.x; i < kTileK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(stage + swizzled(r, c), (c < 8 ? a : b) + (size_t)(kt * kTileK + r) * ld + p0 + (c & 7) * 16);
  }
}

// The down launch's stage kt: staged row r holds the 256 columns from w on of row kt * kTileK + r (rows of ld bytes).
__device__ __forceinline__ void load_tile(unsigned char* stage, const uint8_t* w, size_t ld, int kt) {
  for (int i = threadIdx.x; i < kTileK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(stage + swizzled(r, c), w + (size_t)(kt * kTileK + r) * ld + c * 16);
  }
}

// The column scales a thread's accumulators need (columns 4g + 2p + q of the warp's 32 at `sc`), read before the
// ring so that the epilogue waits on none.
__device__ __forceinline__ void load_scales(const float* sc, float (&v)[2][2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) v[p][q] = __ldg(sc + 4 * g + 2 * p + q);
}

// `put(row, column of the warp's 32, value(p, nt, i, row) * the column scale)` for the rows < N: element i of the
// accumulators of m16 tile p and n-tile nt is column 4g + 2p + i / 2, row nt * 8 + 2t + i % 2.
template <int NT, typename Value, typename Put>
__device__ __forceinline__ void epilogue(const float (&scale)[2][2], int N, Value value, Put put) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * t + (i & 1);
        if (n < N) put(n, 4 * g + 2 * p + (i >> 1), __fmul_rn(value(p, nt, i, n), scale[p][i >> 1]));
      }
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& v, float (&f)[8]) {
  const bf162* p = reinterpret_cast<const bf162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// Non-negative floats compare as their bits: the row maxima go through atomicMax on unsigned.
__device__ __forceinline__ void max_to(unsigned* p, float v, bool warp_uniform) {
  if (warp_uniform) {
    v = warp_max(v);
    if ((threadIdx.x & 31) == 0) atomicMax(p, __float_as_uint(v));
  } else {
    atomicMax(p, __float_as_uint(v));
  }
}
__device__ __forceinline__ void add_to(int* p, int v, bool warp_uniform) {
  if (warp_uniform) {
    v = __reduce_add_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) atomicAdd(p, v);
  } else {
    atomicAdd(p, v);
  }
}

// After the block's writes: one fence, a ticket from `*ticket`; true in the last of `count` blocks (for all its
// threads), which sees every block's writes. Every thread calls it.
__device__ __forceinline__ bool last_block(int* ticket, int count) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == count - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Waits for the launch this one depends on (its writes are then visible).
__device__ __forceinline__ void wait_for_up() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// What the ring's kernels take: 1 <= N <= rows, 1 <= K <= kMaxK, E <= kMaxE, h a multiple of 256 and m of 128
// (whole column tiles, whole stages of 64 rows), each at most 2048 (the rows' operands sit in shared memory).
inline bool shape_ok(int N, int rows, int K, int E, int h, int m) {
  return N >= 1 && N <= rows && K >= 1 && K <= kMaxK && E >= 1 && E <= kMaxE && h >= 256 && h % 256 == 0 &&
         m >= 128 && m % 128 == 0 && h <= 2048 && m <= 2048;
}

// Lets `up` and `down` take `bytes` of dynamic shared memory, once per device (`done`: the caller's bit per
// device; their static shared memory counts against the 48 KB default too, so it is set whatever the size).
template <typename Up, typename Down>
inline cudaError_t allow_once(unsigned& done, Up up, Down down, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(up, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(down, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// Launches `kernel` on `st` as the programmatic dependent of the launch before it: its blocks start as that
// launch's blocks exit, and wait for it (wait_for_up) before they read what it wrote.
template <typename... Params, typename... Args>
inline cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, size_t smem, cudaStream_t st,
                                    Args... args) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace ring

}  // namespace moe_decode
