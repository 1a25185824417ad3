// Fused whole-sampler of the rectified-flow head over linear int4 tables: all
// Euler steps of one sample in ONE launch.
//
// Replaces the TPU kernels mingunivision_tpu/ops/kernels/rf_sampler.py
// (rf_sample_fused -> _sampler_q4_s8, with _modulated_ln and _step_epilogue;
// and rf_sample_fused(schedule="pipelined") -> _sampler_q4_s8_pipelined).
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
//        (the pipelined schedule, rf_sampler.py:_sampler_q4_s8_pipelined, w3
//        streamed in kc-row pieces: split-K tasks of kc packed rows x 32
//        columns, each writing its descaled fp32 partial d1 * sb1 + d2 *
//        sb2 / 16 to device memory;                                -- barrier
//        then every column's partials added in chunk order, the correction,
//        scale, bias and residual update;                          -- barrier)
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
#include "rf_sampler_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rf;

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
    input_proj<R>(a, lat, xs);

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
      const uint8_t* q12 = static_cast<const uint8_t*>(a.q12) + (size_t)l * wq * 2 * H;
      const float* s12 = a.s12 + (size_t)l * 2 * H;
      const float* b12 = a.b12 + (size_t)l * 2 * H;
      for (int task = blockIdx.x; task < H / kTask; task += gridDim.x) {
        const int j0 = task * kTask;
        const uint8_t* const p[2] = {q12 + j0, q12 + H + j0};
        task_dots_q4s8<R, 2>(p, wq, 2 * (size_t)H, a1, a2, wq, red);
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
      const uint8_t* q3 = static_cast<const uint8_t*>(a.q3) + (size_t)l * Hh * w;
      const float* s3 = a.s3 + (size_t)l * w;
      const float* b3 = a.b3 + (size_t)l * w;
      if (a.kc == 0) {  // the block schedule: one task per column tile over all H/2 packed rows
        for (int task = blockIdx.x; task < w / kTask; task += gridDim.x) {
          const int c0 = task * kTask;
          const uint8_t* const p[1] = {q3 + c0};
          task_dots_q4s8<R, 1>(p, Hh, (size_t)w, b1, b2, Hh, red);
          for (int idx = threadIdx.x; idx < B * kTask; idx += kThreads) {
            const int r = idx / kTask, c = idx % kTask, j = c0 + c;
            const int* d = red + (r * kTask + c) * 4;
            const float po = __fadd_rn(__fmul_rn(mm4_epilogue(d[0], d[1], sth + 4 * r), s3[j]), b3[j]);
            __stcg(a.xcur + (size_t)r * w + j,
                   __fadd_rn(xs[r * w + j], __fmul_rn(md[(size_t)r * 3 * w + 2 * w + j], po)));
          }
          __syncthreads();
        }
      } else {  // the pipelined schedule: split-K tasks of kc packed rows, their descaled partials added in order
        const int nt = w / kTask, dc = Hh / a.kc;
        for (int task = blockIdx.x; task < dc * nt; task += gridDim.x) {
          const int k0 = (task / nt) * a.kc, c0 = (task % nt) * kTask;
          const uint8_t* const p[1] = {q3 + (size_t)k0 * w + c0};
          task_dots_q4s8<R, 1>(p, a.kc, (size_t)w, b1 + k0, b2 + k0, Hh, red);
          for (int idx = threadIdx.x; idx < B * kTask; idx += kThreads) {
            const int r = idx / kTask, c = idx % kTask;
            const int* d = red + (r * kTask + c) * 4;
            __stcg(a.part + ((size_t)(task / nt) * B + r) * w + c0 + c,
                   __fadd_rn(__fmul_rn((float)d[0], sth[4 * r]), __fmul_rn((float)d[1], __fmul_rn(sth[4 * r + 1], 0.0625f))));
          }
          __syncthreads();
        }
        grid.sync();
        for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < B * w; idx += gridDim.x * kThreads) {
          const int r = idx / w, j = idx % w;
          float acc = 0.0f;
          for (int k = 0; k < dc; ++k) acc = __fadd_rn(acc, __ldcg(a.part + ((size_t)k * B + r) * w + j));
          const float po = __fadd_rn(__fmul_rn(__fsub_rn(acc, sth[4 * r + 2]), s3[j]), b3[j]);
          __stcg(a.xcur + idx, __fadd_rn(xs[idx], __fmul_rn(md[(size_t)r * 3 * w + 2 * w + j], po)));
        }
      }
      grid.sync();
    }

    step_epilogue<R>(a, s, xs, lat, vel, stats, fscr);
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < B * C; i += kThreads) a.out[i] = lat[(i / C) * kLat + i % C];
  }
}

}  // namespace

// One Euler sample (S steps x L blocks) of B <= 4 CFG rows. dts (S,); x0 (B, C)
// noise; win (C, w) and wfin_t (C, w) the input and final projections (fp32
// holding compute-dtype values; wfin transposed); binp (w,), bfin (C,);
// lnw/lnb (L, w); q12 (L, w/2, 2H) / q3 (L, H/2, w) uint8 split-halves packed
// int4 with fp32 scales s12 (L, 2H) / s3 (L, w) and biases b12 / b3; mods
// (L, S, B, 3w) and fmods (S, B, 2w) fp32 modulations; scratch xcur (B, w) and
// hbuf (B, H) fp32; out (B, C) fp32 latent. kc: 0 for the block schedule, or
// the pipelined schedule's packed w3 rows per down task (a multiple of 4
// dividing H/2), with scratch part (H/2 / kc, B, w) fp32. w and H multiples
// of 64, C <= 128 (the wrapper checks). One cooperative launch: one CTA per SM.
extern "C" int mu_rf_sampler_q4s8(const void* dts, const void* x0, const void* win, const void* binp, const void* lnw,
                                  const void* lnb, const void* q12, const void* s12, const void* b12, const void* q3,
                                  const void* s3, const void* b3, const void* mods, const void* fmods,
                                  const void* wfin_t, const void* bfin, void* xcur, void* hbuf, void* out, void* part,
                                  int B, int cfg_rows, int renorm, int S, int L, int w, int H, int C, int h_bf16,
                                  int kc, float text_cfg, float image_cfg, float ln_eps, void* stream) {
  RFArgs a = rf::make_args(dts, x0, win, binp, lnw, lnb, q12, s12, b12, q3, s3, b3, mods, fmods, wfin_t, bfin, xcur,
                           hbuf, out, B, cfg_rows, renorm, S, L, w, H, C, h_bf16, text_cfg, image_cfg, ln_eps);
  if (kc < 0 || (kc && (kc % 4 || (H / 2) % kc || part == nullptr))) return (int)cudaErrorInvalidValue;
  a.part = static_cast<float*>(part);
  a.kc = kc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (B) {
    case 1: err = launch_cooperative(rf_sampler_q4s8_kernel<1>, Layout<1>(w, H).bytes, a, st); break;
    case 2: err = launch_cooperative(rf_sampler_q4s8_kernel<2>, Layout<2>(w, H).bytes, a, st); break;
    case 3: err = launch_cooperative(rf_sampler_q4s8_kernel<3>, Layout<3>(w, H).bytes, a, st); break;
    case 4: err = launch_cooperative(rf_sampler_q4s8_kernel<4>, Layout<4>(w, H).bytes, a, st); break;
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
