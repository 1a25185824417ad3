// The warp-specialized persistent body that the fused RF samplers share
// (rf_sampler_q4.cu: int4 tables; rf_sampler_q8.cu: int8 tables, both dot
// modes): the stage geometry of their TMA rings, the consumer warps' named
// barrier, the grid barrier and the tiles' tickets, the stream-K partition of
// the units, the shared-memory order of the s8 operands, and the input_proj
// and final layer every CTA runs redundantly and identically (in the plain
// version's order, each fp32 step rounded as written).
#pragma once

#include "hopper.cuh"
#include "rf_sampler_common.cuh"

namespace rf {

constexpr int kConsumers = kThreads;     // 8 consumer warps
constexpr int kAll = kConsumers + 32;    // and the producer warp
constexpr int kRows = 64;                // contraction rows (int4: packed rows) a stage
constexpr int kBoxW = 64;                // bytes of a box row (64-byte swizzle)
constexpr int kBoxBytes = kRows * kBoxW;
constexpr int kStageBytes = 4 * kBoxBytes;
constexpr int kTileCols = 4 * kBoxW;     // a staged row: four boxes; a warp takes 32 of its bytes
constexpr int kMaxRows = 4;              // the workspace's row stride
constexpr int kMaxRing = 12;

// The consumer warps' barrier (named barrier 1): the producer never joins it.
struct ConsumerSync {
  __device__ static void sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
  __device__ static int warps() { return kConsumers / 32; }
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The first unit of CTA c's run over U units on G CTAs (the run is [first(c), first(c + 1))).
__host__ __device__ __forceinline__ int run_first(int c, int U, int G) { return (int)((long long)c * U / G); }

// Physical row (within a 16-row group) of the word-r byte lane quarter t reads: for one r, the 4 quarters' rows
// split 2 + 2 between the two 64-byte halves of a 128-byte bank line and, within each, differ in ((row >> 1) &
// 2), so that under the 64-byte swizzle (16-byte chunk c of row x at c ^ ((x >> 1) & 3)) a warp's 32 words fall
// on 32 banks.
__host__ __device__ __forceinline__ int phys_row(int t, int r) { return (t & 1) + 4 * (t >> 1) + 2 * (r & 1) + 8 * (r >> 1); }

// A ticket and an arrival at gpu scope: acq_rel / release, so that the CTA's writes before the named barrier
// that precedes them are visible to whoever reads the counter after them (and, for the ticket, the writes of the
// CTAs that took it before are visible here).
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ void red_add_release(unsigned* p, unsigned v) {
  asm volatile("red.add.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A wait that cannot end (a CTA that never arrives, a copy that never lands)
// stops the kernel with an error after some 10 s instead of hanging the card.
__device__ __forceinline__ void check_wait(long long t0) {
  if (clock64() - t0 > (1ll << 34)) __trap();
}

// hopper.cuh's mbar_wait under check_wait.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done) check_wait(t0);
  } while (!done);
}

// The consumers' grid barrier: the `target`-th arrival count (barriers so far x grid).
__device__ __forceinline__ void grid_barrier(unsigned* arrivals, unsigned target) {
  ConsumerSync::sync();
  if (threadIdx.x == 0) {
    red_add_release(arrivals, 1u);
    const long long t0 = clock64();
    while (ld_acquire(arrivals) < target) check_wait(t0);  // one thread a CTA: its L2 round trips pace it
  }
  ConsumerSync::sync();
}

// After the CTA's partials of a tile are added: the tile's ticket gains the n
// stages they cover; true in the tile's last contributor (total stages),
// which resets the ticket. Every consumer thread calls it.
__device__ __forceinline__ bool take_ticket(int* ticket, int n, int total, int* flag) {
  ConsumerSync::sync();
  if (threadIdx.x == 0) {
    const bool last = atom_add_acq_rel(ticket, n) + n == total;
    if (last) *ticket = 0;
    *flag = last;
  }
  ConsumerSync::sync();
  return *flag;
}

// An accumulator read by the tile's last contributor and left at zero for the next launch.
__device__ __forceinline__ int take(int* p) {
  const int v = __ldcg(p);
  __stcg(p, 0);
  return v;
}
__device__ __forceinline__ long long take(long long* p) {
  const long long v = __ldcg(p);
  __stcg(p, 0ll);
  return v;
}

// 4 consecutive values (16- or 8-byte aligned) as fp32.
__device__ __forceinline__ float4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const bf162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const bf162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float lane4(const float4& v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

// x = latent @ win + binp: a consumer thread per 4 columns, every row, the channels summed in order; every CTA
// keeps all of x in xs [R][w], and writes its share (every G-th 4 columns) to xin for the down units' residual.
template <int R, typename In>
__device__ __forceinline__ void input_proj_rows(const RFArgs& a, const In* win, const float* lat, float* xs,
                                                float* xin, int G, int cta) {
  const int w = a.w, C = a.C;
  for (int j0 = 4 * threadIdx.x; j0 < w; j0 += 4 * kConsumers) {
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float4 wv = load4(win + (size_t)c * w + j0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float lv = to_compute(lat[r * kLat + c], a.h_bf16);
        acc[r][0] = __fadd_rn(acc[r][0], __fmul_rn(lv, wv.x));
        acc[r][1] = __fadd_rn(acc[r][1], __fmul_rn(lv, wv.y));
        acc[r][2] = __fadd_rn(acc[r][2], __fmul_rn(lv, wv.z));
        acc[r][3] = __fadd_rn(acc[r][3], __fmul_rn(lv, wv.w));
      }
    }
    const float4 bv = __ldg(reinterpret_cast<const float4*>(a.binp + j0));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = make_float4(__fadd_rn(acc[r][0], bv.x), __fadd_rn(acc[r][1], bv.y),
                                   __fadd_rn(acc[r][2], bv.z), __fadd_rn(acc[r][3], bv.w));
      *reinterpret_cast<float4*>(xs + r * w + j0) = x;
      if ((j0 / 4) % G == cta) __stcg(reinterpret_cast<float4*>(xin + r * w + j0), x);
    }
  }
  ConsumerSync::sync();
}

// The velocity of step s into vel [R][kLat]: x (from x_last) through its final modulated LN in the compute dtype
// (in place of xs), the final linear (a warp per channel, every row: lane l sums k = l, l + 32, ... in order,
// then the shuffle tree) and its bias. The caller then runs the CFG combine and the Euler update (guide_step).
template <int R, typename In>
__device__ __forceinline__ void final_velocity(const RFArgs& a, int s, const In* fmods, const In* wfin_t,
                                               const float* x_last, float* xs, float* vel, float* stats,
                                               float* fscr) {
  const int w = a.w, B = a.B, C = a.C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = 4 * tid; i < R * w; i += 4 * kConsumers)
    *reinterpret_cast<float4*>(xs + i) = __ldcg(reinterpret_cast<const float4*>(x_last + i));
  ConsumerSync::sync();
  row_stats<R, ConsumerSync>(xs, w, a.ln_eps, stats, fscr);
  const size_t f0 = (size_t)s * B * 2 * w;  // fmods[s]: [B][2w] shift, scale
#pragma unroll 4
  for (int i = tid; i < R * (w / 4); i += kConsumers) {
    const int r = i / (w / 4), k0 = (i % (w / 4)) * 4;
    const In* fm = fmods + f0 + (size_t)r * 2 * w;
    const float4 sh = load4(fm + k0), sc = load4(fm + w + k0);
    float4& x = *reinterpret_cast<float4*>(xs + r * w + k0);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ln = __fmul_rn(__fsub_rn(lane4(x, e), stats[2 * r]), stats[2 * r + 1]);
      v[e] = to_compute(__fadd_rn(__fmul_rn(ln, __fadd_rn(1.0f, lane4(sc, e))), lane4(sh, e)), a.h_bf16);
    }
    x = make_float4(v[0], v[1], v[2], v[3]);
  }
  ConsumerSync::sync();
  for (int c0 = warp; c0 < C; c0 += 4 * (kConsumers / 32)) {  // a warp's channels c0, c0 + 8, ... together
    float acc[4][R];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[q][r] = 0.0f;
#pragma unroll 4
    for (int k = lane; k < w; k += 32) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + q * (kConsumers / 32);
        wv[q] = c < C ? to_f32(wfin_t[(size_t)c * w + k]) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[q][r] = __fadd_rn(acc[q][r], __fmul_rn(xs[r * w + k], wv[q]));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + q * (kConsumers / 32);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = warp_sum(acc[q][r]);
        if (lane == 0 && c < C) vel[r * kLat + c] = __fadd_rn(v, a.bfin[c]);
      }
    }
  }
  ConsumerSync::sync();
}

// The last CTA out resets the barrier's counts (no barrier is waited on after its exit): the next launch finds
// them at zero.
__device__ __forceinline__ void reset_barrier(unsigned* bar, int G) {
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == (unsigned)G - 1) {
    bar[0] = 0u;
    bar[1] = 0u;
  }
}

// The SMs of the current device (the grid of a launch that asks for none).
inline int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms;
}

}  // namespace rf
