// Shared parts of the RF head's persistent cooperative kernels: the fused
// samplers and the per-step stack, which is a mode of theirs (rf_sampler_q4.cu:
// int4 tables, s8 dots; rf_sampler_q8.cu: int8 tables, exact digit dots or s8
// dots, and the stack's exact int4 body; their warp-specialized body is
// rf_persistent.cuh's). Here: the samplers' arguments, the per-row LN
// statistics, the CFG combine (optional channel renorm) and Euler update, and
// the cooperative launch. The samplers run every CTA through the input_proj
// and the epilogue redundantly and identically, from the same inputs in the
// same order, so no grid barrier guards the latent; every fp32 step is
// rounded as written (__f*_rn: no fused multiply-add), as the plain versions
// compute it.
#pragma once

#include "common.cuh"

namespace rf {

constexpr int kThreads = 256;
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
// `args` as its one parameter; refused
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
