// Fused whole-sampler of the rectified-flow head over linear int4 tables: all
// Euler steps of one sample in ONE launch.
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/rf_sampler.py
// (rf_sample_fused -> _sampler_q4_s8, with _modulated_ln and _step_epilogue).
// Per Euler step s and AdaLN block l (rows r < B, width w, SwiGLU hidden H):
//   xs   = LN(x) * ln_w + ln_b, modulated by (shift, scale) of mods[l, s]
//   g, u = xs @ W12[:, :H] * s + b, xs @ W12[:, H:] * s + b  (s8 pair dots)
//   h    = silu(g) * u, rounded to the compute dtype
//   x   += gate * ((h @ W3) * s3 + b3)                      (s8 pair dots)
// then v = modulate(LN(x)) @ W_fin + b_fin, the CFG combine (1, 2 or 3 rows,
// optional channel renorm), latent += dt * v, and x = latent @ W_in + b_in for
// the next step. On the H100 the sample is bound by the packed int4 tables it
// streams: 453 MB per Euler step at the 16B-A3B width (w 3072, H 8192, 12
// blocks), 7.25 GB per sample, 2.16 ms at 3.35 TB/s.
//
// Design. The TPU kernel walks a sequential (step, block, chunk) grid with the
// latent in VMEM; Hopper blocks run in parallel, so this is a PERSISTENT
// COOPERATIVE kernel: one CTA per SM (cudaLaunchCooperativeKernel, refused
// launches are reported), grid-wide barriers between dependent phases:
//   P1 (every CTA, redundantly)  load x (B x w fp32) into shared memory, LN,
//        modulate, quantize to the s8 operand pair;
//   P2 (32-column tasks over CTAs)  gate/up dots over w/2 packed rows (four
//        rows per 32-bit word, byte-transposed into __dp4a operands), h to
//        device memory;                                           -- barrier
//   P3 (every CTA)  re-quantize h per row (row maxima read from L2);
//   P4 (32-column tasks)  down dots over H/2 packed rows, the residual update
//        of the CTA's own columns of x;                            -- barrier
//   after the last block (every CTA, redundantly, identically)  the final
//        layer, CFG combine and Euler update of the latent kept in shared
//        memory, and input_proj of the next step.
// Every CTA computes the same latent from the same inputs in the same order,
// so no barrier is needed for it. Data written by other CTAs is read with
// __ldcg (L2), never through the non-coherent L1/texture path.
//
// The sampler is chaotic at the s8 rounding boundaries, so every fp32 step is
// rounded as written (__f*_rn: no fused multiply-add), 1/sqrt is IEEE, exp is
// taken in double (silu_exact), and the plain version (ops/kernels/
// rf_sampler.py) sums in this kernel's order: the two then agree to the bit.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTask = 32;  // output columns of a P2/P4 task: 8 lanes x 4 bytes
constexpr int kLat = 128;  // latent channels the kernel holds

struct RFArgs {
  const float *dts, *x0, *win, *binp, *lnw, *lnb;
  const uint8_t* q12;
  const float *s12, *b12;
  const uint8_t* q3;
  const float *s3, *b3, *mods, *fmods, *wfin_t, *bfin;
  float *xcur, *hbuf, *out;
  int B, cfg_rows, renorm, S, L, w, H, C, h_bf16;
  float text_cfg, image_cfg, ln_eps;
};

__device__ __forceinline__ float to_compute(float v, int bf) { return bf ? __bfloat162float(__float2bfloat16(v)) : v; }

// Shared memory: x [R][w], latent and velocity [R][kLat], the s8 operands of
// xs [R][w/2] x2 and of h [R][H/2] x2, quant stats, reduction scratch, and the
// per-warp partial sums of a task [kWarps][R][kTask][4].
template <int R>
struct Layout {
  size_t x, lat, vel, a1, a2, b1, b2, st, sth, stats, fscr, red, bytes;
  __host__ __device__ Layout(int w, int H) {
    size_t o = 0;
    x = o; o += align16((size_t)R * w * 4);
    lat = o; o += align16((size_t)R * kLat * 4);
    vel = o; o += align16((size_t)R * kLat * 4);
    a1 = o; o += align16((size_t)R * (w / 2));
    a2 = o; o += align16((size_t)R * (w / 2));
    b1 = o; o += align16((size_t)R * (H / 2));
    b2 = o; o += align16((size_t)R * (H / 2));
    st = o; o += align16(4 * R * 4);
    sth = o; o += align16(4 * R * 4);
    stats = o; o += align16(2 * R * 4);
    fscr = o; o += align16(32 * 2 * R * 4);
    red = o; o += (size_t)kWarps * R * kTask * 4 * 4;
    bytes = o;
  }
};

// Per-row mean and 1/sqrt(var + eps) of x [R][w] in shared memory (two passes).
template <int R>
__device__ void row_stats(const float* x, int w, float eps, float* stats, float* fscr) {
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.0f;
  for (int i = threadIdx.x; i < w; i += kThreads)
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = __fadd_rn(s[r], x[r * w + i]);
  block_allreduce<R>(s, fscr, SumOp<float>());
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
  block_allreduce<R>(v, fscr, SumOp<float>());
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      stats[2 * r] = mu[r];
      stats[2 * r + 1] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(v[r], (float)w), eps)));
    }
  }
  __syncthreads();
}

// One 32-column task: the R-row integer dots of NT packed tables (K/2 rows,
// leading dim ld, columns col0..col0+31 each) summed over the whole block into
// `out` [R][kTask][2 NT] (shared memory). Lane = 8 column threads x 4 splits,
// 8 warps: 32 contraction splits over the 4-row groups.
template <int R, int NT>
__device__ void task_dots(const uint8_t* const (&p)[NT], int kh, size_t ld, const int8_t* a1, const int8_t* a2,
                          int* red) {
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
      const int x1 = *reinterpret_cast<const int*>(a1 + r * kh + i);
      const int x2 = *reinterpret_cast<const int*>(a2 + r * kh + i);
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

template <int R>
__global__ void __launch_bounds__(kThreads) rf_sampler_q4s8_kernel(RFArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int w = a.w, H = a.H, C = a.C, B = a.B, L = a.L, S = a.S;
  const int wq = w / 2, Hh = H / 2;
  const Layout<R> lay(w, H);
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + lay.x);
  float* lat = reinterpret_cast<float*>(smem + lay.lat);
  float* vel = reinterpret_cast<float*>(smem + lay.vel);
  int8_t* a1 = reinterpret_cast<int8_t*>(smem + lay.a1);
  int8_t* a2 = reinterpret_cast<int8_t*>(smem + lay.a2);
  int8_t* b1 = reinterpret_cast<int8_t*>(smem + lay.b1);
  int8_t* b2 = reinterpret_cast<int8_t*>(smem + lay.b2);
  float* st = reinterpret_cast<float*>(smem + lay.st);
  float* sth = reinterpret_cast<float*>(smem + lay.sth);
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  float* fscr = reinterpret_cast<float*>(smem + lay.fscr);
  int* red = reinterpret_cast<int*>(smem + lay.red);

  for (int i = threadIdx.x; i < R * kLat; i += kThreads) {
    const int r = i / kLat, c = i % kLat;
    lat[i] = c < C ? a.x0[r * C + c] : 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    // input_proj of the latent (compute-dtype operands, fp32 sums), all columns
    for (int i = threadIdx.x; i < R * w; i += kThreads) {
      const int r = i / w, j = i % w;
      float acc = 0.0f;
      for (int c = 0; c < C; ++c)
        acc = __fadd_rn(acc, __fmul_rn(to_compute(lat[r * kLat + c], a.h_bf16), a.win[(size_t)c * w + j]));
      xs[i] = __fadd_rn(acc, a.binp[j]);
    }
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      const float* md = a.mods + ((size_t)l * S + s) * B * 3 * w;  // [B][3w]: shift, scale, gate
      if (l > 0) {
        for (int i = threadIdx.x; i < R * w; i += kThreads) xs[i] = __ldcg(a.xcur + i);
        __syncthreads();
      }
      // P1: modulated LN, s8 pair
      row_stats<R>(xs, w, a.ln_eps, stats, fscr);
      const float* lw = a.lnw + (size_t)l * w;
      const float* lb = a.lnb + (size_t)l * w;
      quant_pair_rows<R>(
          [&](int r, int i) {
            const float d = __fmul_rn(__fsub_rn(xs[r * w + i], stats[2 * r]), stats[2 * r + 1]);
            const float ln = __fadd_rn(__fmul_rn(d, lw[i]), lb[i]);
            return __fadd_rn(__fmul_rn(ln, __fadd_rn(1.0f, md[(size_t)r * 3 * w + w + i])), md[(size_t)r * 3 * w + i]);
          },
          B, w, a1, a2, st, fscr, reinterpret_cast<int*>(fscr));

      // P2: gate / up columns, h = silu(g) * u in the compute dtype
      const uint8_t* q12 = a.q12 + (size_t)l * wq * 2 * H;
      const float* s12 = a.s12 + (size_t)l * 2 * H;
      const float* b12 = a.b12 + (size_t)l * 2 * H;
      for (int task = blockIdx.x; task < H / kTask; task += gridDim.x) {
        const int j0 = task * kTask;
        const uint8_t* const p[2] = {q12 + j0, q12 + H + j0};
        task_dots<R, 2>(p, wq, 2 * (size_t)H, a1, a2, red);
        for (int idx = threadIdx.x; idx < B * kTask; idx += kThreads) {
          const int r = idx / kTask, c = idx % kTask, j = j0 + c;
          const int* d = red + (r * kTask + c) * 4;
          const float g = __fadd_rn(__fmul_rn(mm4_epilogue(d[0], d[1], st + 4 * r), s12[j]), b12[j]);
          const float u = __fadd_rn(__fmul_rn(mm4_epilogue(d[2], d[3], st + 4 * r), s12[H + j]), b12[H + j]);
          __stcg(a.hbuf + (size_t)r * H + j, to_compute(__fmul_rn(silu_exact(g), u), a.h_bf16));
        }
        __syncthreads();
      }
      grid.sync();

      // P3: the s8 pair of h, per row over all of H
      quant_pair_rows<R>([&](int r, int i) { return __ldcg(a.hbuf + (size_t)r * H + i); }, B, H, b1, b2, sth, fscr,
                         reinterpret_cast<int*>(fscr));

      // P4: down columns and the residual through the gate modulation
      const uint8_t* q3 = a.q3 + (size_t)l * Hh * w;
      const float* s3 = a.s3 + (size_t)l * w;
      const float* b3 = a.b3 + (size_t)l * w;
      for (int task = blockIdx.x; task < w / kTask; task += gridDim.x) {
        const int c0 = task * kTask;
        const uint8_t* const p[1] = {q3 + c0};
        task_dots<R, 1>(p, Hh, (size_t)w, b1, b2, red);
        for (int idx = threadIdx.x; idx < B * kTask; idx += kThreads) {
          const int r = idx / kTask, c = idx % kTask, j = c0 + c;
          const int* d = red + (r * kTask + c) * 4;
          const float po = __fadd_rn(__fmul_rn(mm4_epilogue(d[0], d[1], sth + 4 * r), s3[j]), b3[j]);
          __stcg(a.xcur + (size_t)r * w + j, __fadd_rn(xs[r * w + j], __fmul_rn(md[(size_t)r * 3 * w + 2 * w + j], po)));
        }
        __syncthreads();
      }
      grid.sync();
    }

    // final layer, CFG combine, Euler update (every CTA, identically)
    for (int i = threadIdx.x; i < R * w; i += kThreads) xs[i] = __ldcg(a.xcur + i);
    __syncthreads();
    row_stats<R>(xs, w, a.ln_eps, stats, fscr);
    const float* fm = a.fmods + (size_t)s * B * 2 * w;  // [B][2w]: shift, scale
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = warp; o < B * C; o += kWarps) {
      const int r = o / C, c = o % C;
      float acc = 0.0f;
      for (int k = lane; k < w; k += 32) {
        const float ln = __fmul_rn(__fsub_rn(xs[r * w + k], stats[2 * r]), stats[2 * r + 1]);
        const float xm = to_compute(
            __fadd_rn(__fmul_rn(ln, __fadd_rn(1.0f, fm[(size_t)r * 2 * w + w + k])), fm[(size_t)r * 2 * w + k]),
            a.h_bf16);
        acc = __fadd_rn(acc, __fmul_rn(xm, a.wfin_t[(size_t)c * w + k]));
      }
      acc = warp_sum(acc);
      if (lane == 0) vel[r * kLat + c] = __fadd_rn(acc, a.bfin[c]);
    }
    __syncthreads();
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
    __syncthreads();
    const float dt = a.dts[s];
    for (int i = threadIdx.x; i < B * C; i += kThreads) {
      const int r = i / C, c = i % C;
      const float v = a.cfg_rows > 1 ? vel[(r % n) * kLat + c] : vel[r * kLat + c];
      lat[r * kLat + c] = __fadd_rn(lat[r * kLat + c], __fmul_rn(dt, v));
    }
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < B * C; i += kThreads) a.out[i] = lat[(i / C) * kLat + i % C];
  }
}

template <int R>
cudaError_t launch_rf(const RFArgs& args, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const size_t smem = Layout<R>(args.w, args.H).bytes;
  err = allow_dynamic_smem(rf_sampler_q4s8_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rf_sampler_q4s8_kernel<R>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  RFArgs a = args;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)rf_sampler_q4s8_kernel<R>, dim3(sms), dim3(kThreads), params, smem,
                                     stream);
}

}  // namespace

// One Euler sample (S steps x L blocks) of B <= 4 CFG rows. dts (S,); x0 (B, C)
// noise; win (C, w) and wfin_t (C, w) the input and final projections (fp32
// holding compute-dtype values; wfin transposed); binp (w,), bfin (C,);
// lnw/lnb (L, w); q12 (L, w/2, 2H) / q3 (L, H/2, w) uint8 split-halves packed
// int4 with fp32 scales s12 (L, 2H) / s3 (L, w) and biases b12 / b3; mods
// (L, S, B, 3w) and fmods (S, B, 2w) fp32 modulations; scratch xcur (B, w) and
// hbuf (B, H) fp32; out (B, C) fp32 latent. w and H multiples of 64, C <= 128
// (the wrapper checks). One cooperative launch: one CTA per SM.
extern "C" int mu_rf_sampler_q4s8(const void* dts, const void* x0, const void* win, const void* binp, const void* lnw,
                                  const void* lnb, const void* q12, const void* s12, const void* b12, const void* q3,
                                  const void* s3, const void* b3, const void* mods, const void* fmods,
                                  const void* wfin_t, const void* bfin, void* xcur, void* hbuf, void* out, int B,
                                  int cfg_rows, int renorm, int S, int L, int w, int H, int C, int h_bf16,
                                  float text_cfg, float image_cfg, float ln_eps, void* stream) {
  RFArgs a;
  a.dts = static_cast<const float*>(dts);
  a.x0 = static_cast<const float*>(x0);
  a.win = static_cast<const float*>(win);
  a.binp = static_cast<const float*>(binp);
  a.lnw = static_cast<const float*>(lnw);
  a.lnb = static_cast<const float*>(lnb);
  a.q12 = static_cast<const uint8_t*>(q12);
  a.s12 = static_cast<const float*>(s12);
  a.b12 = static_cast<const float*>(b12);
  a.q3 = static_cast<const uint8_t*>(q3);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (B) {
    case 1: err = launch_rf<1>(a, st); break;
    case 2: err = launch_rf<2>(a, st); break;
    case 3: err = launch_rf<3>(a, st); break;
    case 4: err = launch_rf<4>(a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grid a launch of mu_rf_sampler_q4s8 uses: one CTA per SM.
extern "C" int mu_rf_sampler_grid(void) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms;
}
