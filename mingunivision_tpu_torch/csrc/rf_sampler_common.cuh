// Shared parts of the RF head's persistent cooperative kernels: the fused
// samplers (rf_sampler_q4.cu: int4 tables, s8 dots; rf_sampler_q8.cu: int8
// tables, exact digit dots or s8 dots; their warp-specialized body is
// rf_persistent.cuh's) and the per-step stack (rf_mlp.cu, all four of its
// bodies). Here: the samplers' arguments, the per-row LN statistics, the
// CFG combine (optional channel renorm) and Euler update, and the cooperative
// launch, which all of them use; and the stack's own pieces, the per-row s8
// quantization and the 32-column task dots of every table type and dot mode
// on the CUDA cores, the exact int8 ones summing their fp32 products in a
// fixed order that the stack's plain version (ops/kernels/rf_sampler.py
// `_split_dot`) repeats. The samplers run every CTA through the input_proj
// and the epilogue redundantly and identically, from the same inputs in the
// same order, so no grid barrier guards the latent; every fp32 step is
// rounded as written (__f*_rn: no fused multiply-add), as the plain versions
// compute it.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace rf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTask = 32;  // output columns of a gate/up or down task
constexpr int kLat = 128;  // latent channels the kernels hold

// q12 / q3 are the block tables: packed uint8 (int4) or int8.
struct RFArgs {
  const float *dts, *x0, *win, *binp, *lnw, *lnb;
  const void* q12;
  const float *s12, *b12;
  const void* q3;
  const float *s3, *b3, *mods, *fmods, *wfin_t, *bfin;
  float *xcur, *hbuf, *out;
  int B, cfg_rows, renorm, S, L, w, H, C, h_bf16;
  float text_cfg, image_cfg, ln_eps;
};

__device__ __forceinline__ float to_compute(float v, int bf) { return bf ? __bfloat162float(__float2bfloat16(v)) : v; }

// Per-row mean and 1/sqrt(var + eps) of x [R][w] in shared memory (two passes).
// Sync: the threads taking part (common.cuh's BlockSync: the whole block).
template <int R, typename Sync = BlockSync>
__device__ void row_stats(const float* x, int w, float eps, float* stats, float* fscr) {
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.0f;
  for (int i = threadIdx.x; i < w; i += kThreads)
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = __fadd_rn(s[r], x[r * w + i]);
  block_allreduce<R>(s, fscr, SumOp<float>(), Sync());
  float mu[R], v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mu[r] = __fdiv_rn(s[r], (float)w);
    v[r] = 0.0f;
  }
  for (int i = threadIdx.x; i < w; i += kThreads)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = __fsub_rn(x[r * w + i], mu[r]);
      v[r] = __fadd_rn(v[r], __fmul_rn(d, d));
    }
  block_allreduce<R>(v, fscr, SumOp<float>(), Sync());
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      stats[2 * r] = mu[r];
      stats[2 * r + 1] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(v[r], (float)w), eps)));
    }
  }
  Sync::sync();
}

// Per-row s8 quantization (intdot.quant_rows_s8) of n values of each of R
// rows, val(r, i), into q[r * ldq + i]; the scales go to sc[r] (every thread).
template <int R, typename Val>
__device__ void quant_rows(Val val, int n, int8_t* q, int ldq, float (&sc)[R], float* fscr) {
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = fmaxf(mx[r], fabsf(val(r, i)));
  block_allreduce<R>(mx, fscr, MaxOp<float>());
#pragma unroll
  for (int r = 0; r < R; ++r) sc[r] = __fadd_rn(__fdiv_rn(mx[r], 127.0f), 1e-12f);
  for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
    for (int r = 0; r < R; ++r) q[r * ldq + i] = (int8_t)(int)rintf(__fdiv_rn(val(r, i), sc[r]));
  __syncthreads();
}

// The per-step stack's 32-column task dots. Each sums, over the K
// contraction rows it is given, the R-row products with NT tables (leading
// dim ld, columns p[q]..p[q]+31) into shared memory `red`. Lane = 8 column
// threads x 4 splits, 8 warps: contraction row k = 128 j + 4 s + r goes to
// split s, each split adds its rows in the order (j, r), the four splits of
// a warp are combined as (s0 + s1) + (s2 + s3) by shuffles and the 8 warps in
// order (the plain version's rf_sampler._split_dot; integer sums are exact in
// any order). Activation row r starts at act + r * lda.

// int4 tables, s8 dots: packed rows (kh of them) byte-transposed into __dp4a
// operands against the s8 pair a1 (x_lo - x_hi/16) and a2 (x_hi);
// red [R][kTask][4] int32: d1, d2 of table 0, then of table 1.
template <int R, int NT>
__device__ void task_dots_q4s8(const uint8_t* const (&p)[NT], int kh, size_t ld, const int8_t* a1, const int8_t* a2,
                               int lda, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = lane & 7, split = warp * 4 + (lane >> 3);
  int acc[R][4][2 * NT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 2 * NT; ++k) acc[r][c][k] = 0;
#pragma unroll 2
  for (int g = split; g < kh / 4; g += 32) {
    const int i = 4 * g;
    uint32_t t[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      uint32_t wd[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) wd[rr] = __ldg(reinterpret_cast<const uint32_t*>(p[q] + (size_t)(i + rr) * ld + 4 * ct));
      transpose4x4(wd, t[q]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int x1 = *reinterpret_cast<const int*>(a1 + (size_t)r * lda + i);
      const int x2 = *reinterpret_cast<const int*>(a2 + (size_t)r * lda + i);
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c][2 * q] = __dp4a(x1, nib_lo(t[q][c]), acc[r][c][2 * q]);
          acc[r][c][2 * q + 1] = __dp4a(x2, nib_x80(t[q][c]), acc[r][c][2 * q + 1]);
        }
    }
  }
  // the 4 splits of a warp, then the 8 warps
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 2 * NT; ++k) {
        acc[r][c][k] += __shfl_xor_sync(0xffffffffu, acc[r][c][k], 8);
        acc[r][c][k] += __shfl_xor_sync(0xffffffffu, acc[r][c][k], 16);
      }
  if (lane < 8) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 2 * NT; ++k) red[((warp * R + r) * kTask + 4 * ct + c) * 4 + k] = acc[r][c][k];
  }
  __syncthreads();
  // warp 0's slots accumulate the other warps' (out-of-place is not needed: each (r, c, k) has one owner)
  for (int idx = threadIdx.x; idx < R * kTask * 2 * NT; idx += kThreads) {
    const int k = idx % (2 * NT), rc = idx / (2 * NT);
    int s = 0;
    for (int wp = 0; wp < kWarps; ++wp) s += red[(wp * R * kTask + rc) * 4 + k];
    red[rc * 4 + k] = s;  // rows (r, c) of warp 0: read above by this thread only
  }
  __syncthreads();
}

// int8 tables, s8 dots: byte-transposed words into __dp4a against the s8
// activations; red [R][kTask][NT] int32.
template <int R, int NT>
__device__ void task_dots_s8(const int8_t* const (&p)[NT], int K, size_t ld, const int8_t* act, int lda, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = lane & 7, split = warp * 4 + (lane >> 3);
  int acc[R][4][NT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NT; ++q) acc[r][c][q] = 0;
#pragma unroll 2
  for (int g = split; g < K / 4; g += 32) {
    const int i = 4 * g;
    uint32_t t[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      uint32_t wd[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        wd[rr] = __ldg(reinterpret_cast<const uint32_t*>(p[q] + (size_t)(i + rr) * ld + 4 * ct));
      transpose4x4(wd, t[q]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int x4 = *reinterpret_cast<const int*>(act + (size_t)r * lda + i);
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c][q] = __dp4a(x4, (int)t[q][c], acc[r][c][q]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        acc[r][c][q] += __shfl_xor_sync(0xffffffffu, acc[r][c][q], 8);
        acc[r][c][q] += __shfl_xor_sync(0xffffffffu, acc[r][c][q], 16);
      }
  if (lane < 8) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < NT; ++q) red[((warp * R + r) * kTask + 4 * ct + c) * NT + q] = acc[r][c][q];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * kTask * NT; idx += kThreads) {
    int s = 0;
    for (int wp = 0; wp < kWarps; ++wp) s += red[wp * R * kTask * NT + idx];
    red[idx] = s;
  }
  __syncthreads();
}

// int8 tables, exact dequant: the bytes converted to fp32 and multiplied with
// the fp32 activations, each split adding its rounded products in turn;
// red [R][kTask][NT] fp32.
template <int R, int NT>
__device__ void task_dots_f32(const int8_t* const (&p)[NT], int K, size_t ld, const float* act, int lda, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = lane & 7, split = warp * 4 + (lane >> 3);
  float acc[R][4][NT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NT; ++q) acc[r][c][q] = 0.0f;
#pragma unroll 2
  for (int g = split; g < K / 4; g += 32) {
    const int i = 4 * g;
    uint32_t wd[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        wd[q][rr] = __ldg(reinterpret_cast<const uint32_t*>(p[q] + (size_t)(i + rr) * ld + 4 * ct));
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float wf[NT][4];
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) wf[q][c] = (float)(int8_t)(wd[q][rr] >> (8 * c));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = act[(size_t)r * lda + i + rr];
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c][q] = __fadd_rn(acc[r][c][q], __fmul_rn(xv, wf[q][c]));
      }
    }
  }
  // the 4 splits of a warp, then the 8 warps in order
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        acc[r][c][q] += __shfl_xor_sync(0xffffffffu, acc[r][c][q], 8);
        acc[r][c][q] += __shfl_xor_sync(0xffffffffu, acc[r][c][q], 16);
      }
  if (lane < 8) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < NT; ++q) red[((warp * R + r) * kTask + 4 * ct + c) * NT + q] = acc[r][c][q];
  }
  __syncthreads();
  // warp 0's slots take the sum (each (r, c, q) is read and written by one thread only)
  for (int idx = threadIdx.x; idx < R * kTask * NT; idx += kThreads) {
    float s = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) s += red[wp * R * kTask * NT + idx];
    red[idx] = s;
  }
  __syncthreads();
}

// int4 tables, exact dequant: both nibble planes of each packed row (kh of
// them) converted to fp32 (b & 15) - 8 and (b >> 4) - 8, the low plane
// multiplied with the activations at lo, the high plane with those at hi,
// one sum per plane; red [R][kTask][4] fp32: lo and hi sums of table 0, then
// of table 1.
template <int R, int NT>
__device__ void task_dots_q4f(const uint8_t* const (&p)[NT], int kh, size_t ld, const float* lo, const float* hi,
                              int lda, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = lane & 7, split = warp * 4 + (lane >> 3);
  float acc[R][4][2 * NT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 2 * NT; ++k) acc[r][c][k] = 0.0f;
#pragma unroll 2
  for (int g = split; g < kh / 4; g += 32) {
    const int i = 4 * g;
    uint32_t wd[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        wd[q][rr] = __ldg(reinterpret_cast<const uint32_t*>(p[q] + (size_t)(i + rr) * ld + 4 * ct));
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float wl[NT][4], wh[NT][4];
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = (wd[q][rr] >> (8 * c)) & 0xFF;
          wl[q][c] = (float)((b & 15) - 8);
          wh[q][c] = (float)((b >> 4) - 8);
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xl = lo[(size_t)r * lda + i + rr], xh = hi[(size_t)r * lda + i + rr];
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c][2 * q] = __fadd_rn(acc[r][c][2 * q], __fmul_rn(xl, wl[q][c]));
            acc[r][c][2 * q + 1] = __fadd_rn(acc[r][c][2 * q + 1], __fmul_rn(xh, wh[q][c]));
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 2 * NT; ++k) {
        acc[r][c][k] += __shfl_xor_sync(0xffffffffu, acc[r][c][k], 8);
        acc[r][c][k] += __shfl_xor_sync(0xffffffffu, acc[r][c][k], 16);
      }
  if (lane < 8) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 2 * NT; ++k) red[((warp * R + r) * kTask + 4 * ct + c) * 4 + k] = acc[r][c][k];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * kTask * 2 * NT; idx += kThreads) {
    const int k = idx % (2 * NT), rc = idx / (2 * NT);
    float s = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) s += red[(wp * R * kTask + rc) * 4 + k];
    red[rc * 4 + k] = s;
  }
  __syncthreads();
}

// The velocity vel [R][kLat] of step s through the CFG combine (one thread
// per image; optional channel renorm) into the Euler update of the latent
// lat. Sync: the threads taking part (BlockSync: the whole block).
template <int R, typename Sync = BlockSync>
__device__ void guide_step(const RFArgs& a, int s, float* lat, float* vel) {
  const int B = a.B, C = a.C;
  const int n = B / a.cfg_rows;
  if (a.cfg_rows > 1 && threadIdx.x < n) {  // one thread per image: guided velocity into row i
    const int i = threadIdx.x;
    float nc = 0.0f, ng = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float vc = vel[i * kLat + c], vu = vel[(n + i) * kLat + c];
      float vg;
      if (a.cfg_rows == 3) {
        const float vtu = vel[(2 * n + i) * kLat + c];
        vg = __fadd_rn(__fadd_rn(vu, __fmul_rn(a.image_cfg, __fsub_rn(vtu, vu))),
                       __fmul_rn(a.text_cfg, __fsub_rn(vc, vtu)));
      } else {
        vg = __fadd_rn(vu, __fmul_rn(a.text_cfg, __fsub_rn(vc, vu)));
      }
      nc = __fadd_rn(nc, __fmul_rn(vc, vc));
      ng = __fadd_rn(ng, __fmul_rn(vg, vg));
      vel[(n + i) * kLat + c] = vg;  // parked in the uncond row until the scale is known
    }
    const float scl =
        a.renorm ? fminf(fmaxf(__fadd_rn(__fdiv_rn(__fsqrt_rn(nc), __fsqrt_rn(ng)), 1e-8f), 0.0f), 1.0f) : 1.0f;
    for (int c = 0; c < C; ++c) vel[i * kLat + c] = a.renorm ? __fmul_rn(vel[(n + i) * kLat + c], scl) : vel[(n + i) * kLat + c];
  }
  Sync::sync();
  const float dt = a.dts[s];
  for (int i = threadIdx.x; i < B * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const float v = a.cfg_rows > 1 ? vel[(r % n) * kLat + c] : vel[r * kLat + c];
    lat[r * kLat + c] = __fadd_rn(lat[r * kLat + c], __fmul_rn(dt, v));
  }
  Sync::sync();
}

// One cooperative launch of `kernel` (one CTA per SM, or `grid` CTAs when
// positive; `threads` a CTA) with `smem` bytes of dynamic shared memory and
// `args` (RFArgs, or the stack's arguments) as its one parameter; refused
// launches are reported.
template <typename Kernel, typename Args>
cudaError_t launch_cooperative(Kernel kernel, size_t smem, const Args& args, cudaStream_t stream,
                               int threads = kThreads, int grid = 0) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  Args a = args;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid > 0 ? grid : sms), dim3(threads), params, smem,
                                     stream);
}

// The arguments of the C entry points, in their order.
inline RFArgs make_args(const void* dts, const void* x0, const void* win, const void* binp, const void* lnw,
                        const void* lnb, const void* q12, const void* s12, const void* b12, const void* q3,
                        const void* s3, const void* b3, const void* mods, const void* fmods, const void* wfin_t,
                        const void* bfin, void* xcur, void* hbuf, void* out, int B, int cfg_rows, int renorm, int S,
                        int L, int w, int H, int C, int h_bf16, float text_cfg, float image_cfg, float ln_eps) {
  RFArgs a;
  a.dts = static_cast<const float*>(dts);
  a.x0 = static_cast<const float*>(x0);
  a.win = static_cast<const float*>(win);
  a.binp = static_cast<const float*>(binp);
  a.lnw = static_cast<const float*>(lnw);
  a.lnb = static_cast<const float*>(lnb);
  a.q12 = q12;
  a.s12 = static_cast<const float*>(s12);
  a.b12 = static_cast<const float*>(b12);
  a.q3 = q3;
  a.s3 = static_cast<const float*>(s3);
  a.b3 = static_cast<const float*>(b3);
  a.mods = static_cast<const float*>(mods);
  a.fmods = static_cast<const float*>(fmods);
  a.wfin_t = static_cast<const float*>(wfin_t);
  a.bfin = static_cast<const float*>(bfin);
  a.xcur = static_cast<float*>(xcur);
  a.hbuf = static_cast<float*>(hbuf);
  a.out = static_cast<float*>(out);
  a.B = B, a.cfg_rows = cfg_rows, a.renorm = renorm, a.S = S, a.L = L, a.w = w, a.H = H, a.C = C, a.h_bf16 = h_bf16;
  a.text_cfg = text_cfg, a.image_cfg = image_cfg, a.ln_eps = ln_eps;
  return a;
}

}  // namespace rf
