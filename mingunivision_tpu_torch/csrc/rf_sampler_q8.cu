// Fused whole-sampler of the rectified-flow head over int8 tables: all Euler
// steps of one sample in ONE launch, in two dot modes.
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/rf_sampler.py
// (rf_sample_fused -> _sampler_q8, with _modulated_ln and _step_epilogue) in
// both of its modes: s8_dots = False (INT8_INT_DOTS off, the JAX package's
// default, the int8 quality tier) and s8_dots = True (INT8_INT_DOTS on; the
// port's RuntimeConfig.rf_int_dots). Per Euler step s and AdaLN block l (rows
// r < B, width w, SwiGLU hidden H):
//   xs   = LN(x) * ln_w + ln_b, modulated by (shift, scale) of mods[l, s],
//          rounded to the compute dtype
//   exact: g, u = xs @ Q12[:, :H] * s + b, xs @ Q12[:, H:] * s + b  (int8 ->
//          fp32, fp32 sums); h = silu(g) * u rounded to the compute dtype;
//          x += gate * ((h @ Q3) * s3 + b3)
//   S8:    xs quantized per row to s8 (intdot.quant_rows_s8); g, u = the s8 x
//          s8 -> s32 dots times the row scale, then * s + b; h = silu(g) * u
//          in fp32, re-quantized per row over each CH-column chunk (CH = 4096
//          of H = 8192, the JAX package's chunk); x += gate * (sum over the
//          chunks of (hq_c @ Q3_c) * sh_c, then * s3 + b3)
// then the int4 kernel's step epilogue (rf_sampler_common.cuh): the final
// layer, the CFG combine (1, 2 or 3 rows, optional channel renorm), the Euler
// update and input_proj of the next step. On the H100 the sample is bound by
// the int8 tables it streams: 906 MB per Euler step at the 16B-A3B width
// (w 3072, H 8192, 12 blocks: w12 (3072, 16384) + w3 (8192, 3072) a block),
// 14.5 GB per sample, 4.33 ms at 3.35 TB/s.
//
// Design: rf_sampler_q4.cu's persistent cooperative grid (one CTA per SM,
// grid-wide barriers between dependent phases; the task dots and the per-row
// quantization are rf_sampler_common.cuh's):
//   P1 (every CTA, redundantly)  load x (B x w fp32) into shared memory, LN,
//        modulate, round to the compute dtype into the activation buffer (S8:
//        then quantized per row into the s8 buffer);
//   P2 (32-column tasks over CTAs)  gate/up dots over w rows: a lane loads one
//        32-bit word (4 columns) of each of four consecutive rows; exact:
//        converts the bytes to fp32 and multiplies them with the activations
//        in fp32, 32 contraction splits per CTA, each adding its rounded
//        products in turn, summed by shuffles and over the warps in order;
//        S8: byte-transposes the words (__byte_perm) and feeds them to __dp4a
//        with four s8 activations, the integer sums exact in any order; h to
//        device memory;                                           -- barrier
//   P3 (every CTA)  h (B x H, from L2) into the activation buffer, which xs
//        no longer needs (S8: each row's chunks quantized into the s8 buffer);
//   P4 (32-column tasks)  down dots over H rows the same way (S8: chunk by
//        chunk, each descaled and added in order), the residual update of the
//        CTA's own columns of x;                                  -- barrier
// Data written by other CTAs is read with __ldcg (L2). The sampler is chaotic
// at its roundings, so every fp32 step is rounded as written (__f*_rn: no
// fused multiply-add) and the plain version (ops/kernels/rf_sampler.py,
// `_split_dot` for the exact mode) sums in this kernel's order: the two then
// agree to the bit.
#include "rf_sampler_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rf;

// Shared memory: x [R][w], latent and velocity [R][kLat], the activation
// buffer (exact: [R][max(w, H)], xs in P1-P2, h in P3-P4; S8: xs [R][w] fp32,
// with the s8 buffer [R][max(w, H)] bytes and the row scales [R][1 + H / ch]),
// LN stats, reduction scratch, and the per-warp partial sums of a task
// [kWarps][R][kTask][2] (fp32 or int32).
template <bool S8, int R>
struct Layout {
  size_t x, lat, vel, act, q, scl, stats, fscr, red, bytes;
  __host__ __device__ Layout(int w, int H, int ch) {
    const size_t wide = w > H ? w : H;
    size_t o = 0;
    x = o; o += align16((size_t)R * w * 4);
    lat = o; o += align16((size_t)R * kLat * 4);
    vel = o; o += align16((size_t)R * kLat * 4);
    act = o; o += align16((size_t)R * (S8 ? w : wide) * 4);
    q = o; o += S8 ? align16((size_t)R * wide) : 0;
    scl = o; o += S8 ? align16((size_t)R * (1 + H / ch) * 4) : 0;
    stats = o; o += align16(2 * R * 4);
    fscr = o; o += align16(32 * 2 * R * 4);
    red = o; o += (size_t)kWarps * R * kTask * 2 * 4;
    bytes = o;
  }
};

template <bool S8, int R>
__global__ void __launch_bounds__(kThreads) rf_sampler_q8_kernel(RFArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int w = a.w, H = a.H, C = a.C, B = a.B, L = a.L, S = a.S;
  const int CH = a.ch, HC = H / a.ch;
  const Layout<S8, R> lay(w, H, CH);
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + lay.x);
  float* lat = reinterpret_cast<float*>(smem + lay.lat);
  float* vel = reinterpret_cast<float*>(smem + lay.vel);
  float* act = reinterpret_cast<float*>(smem + lay.act);
  int8_t* qa = reinterpret_cast<int8_t*>(smem + lay.q);   // S8: xs, then h, as s8
  float* scl = reinterpret_cast<float*>(smem + lay.scl);  // S8: sx [R], then sh [R][HC]
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  float* fscr = reinterpret_cast<float*>(smem + lay.fscr);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  int* ired = reinterpret_cast<int*>(smem + lay.red);

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
      // P1: modulated LN in the compute dtype (S8: then quantized per row)
      row_stats<R>(xs, w, a.ln_eps, stats, fscr);
      const float* lw = a.lnw + (size_t)l * w;
      const float* lb = a.lnb + (size_t)l * w;
      for (int idx = threadIdx.x; idx < R * w; idx += kThreads) {
        const int r = idx / w, i = idx % w;
        const float d = __fmul_rn(__fsub_rn(xs[idx], stats[2 * r]), stats[2 * r + 1]);
        const float ln = __fadd_rn(__fmul_rn(d, lw[i]), lb[i]);
        act[idx] = to_compute(
            __fadd_rn(__fmul_rn(ln, __fadd_rn(1.0f, md[(size_t)r * 3 * w + w + i])), md[(size_t)r * 3 * w + i]),
            a.h_bf16);
      }
      __syncthreads();
      if constexpr (S8) {
        float sx[R];
        quant_rows<R>([&](int r, int i) { return act[r * w + i]; }, w, qa, w, sx, fscr);
        if (threadIdx.x == 0)
#pragma unroll
          for (int r = 0; r < R; ++r) scl[r] = sx[r];
        __syncthreads();
      }

      // P2: gate / up columns, h = silu(g) * u (exact: in the compute dtype)
      const int8_t* q12 = static_cast<const int8_t*>(a.q12) + (size_t)l * w * 2 * H;
      const float* s12 = a.s12 + (size_t)l * 2 * H;
      const float* b12 = a.b12 + (size_t)l * 2 * H;
      for (int task = blockIdx.x; task < H / kTask; task += gridDim.x) {
        const int j0 = task * kTask;
        const int8_t* const p[2] = {q12 + j0, q12 + H + j0};
        if constexpr (S8) task_dots_s8<R, 2>(p, w, 2 * (size_t)H, qa, w, ired);
        else task_dots_f32<R, 2>(p, w, 2 * (size_t)H, act, w, red);
        for (int idx = threadIdx.x; idx < B * kTask; idx += kThreads) {
          const int r = idx / kTask, c = idx % kTask, j = j0 + c;
          float d0, d1;
          if constexpr (S8) {
            d0 = __fmul_rn((float)ired[(r * kTask + c) * 2], scl[r]);
            d1 = __fmul_rn((float)ired[(r * kTask + c) * 2 + 1], scl[r]);
          } else {
            d0 = red[(r * kTask + c) * 2];
            d1 = red[(r * kTask + c) * 2 + 1];
          }
          const float g = __fadd_rn(__fmul_rn(d0, s12[j]), b12[j]);
          const float u = __fadd_rn(__fmul_rn(d1, s12[H + j]), b12[H + j]);
          const float hv = __fmul_rn(silu_exact(g), u);
          __stcg(a.hbuf + (size_t)r * H + j, S8 ? hv : to_compute(hv, a.h_bf16));
        }
        __syncthreads();
      }
      grid.sync();

      // P3: h into the activation buffer (S8: quantized per row over each CH-column chunk)
      if constexpr (S8) {
        for (int c = 0; c < HC; ++c) {
          float sh[R];
          quant_rows<R>([&](int r, int i) { return __ldcg(a.hbuf + (size_t)r * H + c * CH + i); }, CH, qa + c * CH,
                        H, sh, fscr);
          if (threadIdx.x == 0)
#pragma unroll
            for (int r = 0; r < R; ++r) scl[R + r * HC + c] = sh[r];
        }
      } else {
        for (int i = threadIdx.x; i < R * H; i += kThreads) act[i] = __ldcg(a.hbuf + i);
      }
      __syncthreads();

      // P4: down columns and the residual through the gate modulation
      const int8_t* q3 = static_cast<const int8_t*>(a.q3) + (size_t)l * H * w;
      const float* s3 = a.s3 + (size_t)l * w;
      const float* b3 = a.b3 + (size_t)l * w;
      for (int task = blockIdx.x; task < w / kTask; task += gridDim.x) {
        const int c0 = task * kTask;
        float po = 0.0f;  // thread idx < B * kTask holds (row idx / kTask, column idx % kTask)
        if constexpr (S8) {
          for (int c = 0; c < HC; ++c) {
            const int8_t* const p[1] = {q3 + (size_t)c * CH * w + c0};
            task_dots_s8<R, 1>(p, CH, (size_t)w, qa + c * CH, H, ired);
            if (threadIdx.x < B * kTask) {
              const int r = threadIdx.x / kTask, cc = threadIdx.x % kTask;
              po = __fadd_rn(po, __fmul_rn((float)ired[r * kTask + cc], scl[R + r * HC + c]));
            }
            __syncthreads();
          }
        } else {
          const int8_t* const p[1] = {q3 + c0};
          task_dots_f32<R, 1>(p, H, (size_t)w, act, H, red);
          if (threadIdx.x < B * kTask) po = red[threadIdx.x];
        }
        if (threadIdx.x < B * kTask) {
          const int r = threadIdx.x / kTask, c = threadIdx.x % kTask, j = c0 + c;
          const float y = __fadd_rn(__fmul_rn(po, s3[j]), b3[j]);
          __stcg(a.xcur + (size_t)r * w + j, __fadd_rn(xs[r * w + j], __fmul_rn(md[(size_t)r * 3 * w + 2 * w + j], y)));
        }
        __syncthreads();
      }
      grid.sync();
    }

    step_epilogue<R>(a, s, xs, lat, vel, stats, fscr);
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < B * C; i += kThreads) a.out[i] = lat[(i / C) * kLat + i % C];
  }
}

template <bool S8>
cudaError_t launch_rows(const RFArgs& a, cudaStream_t st) {
  switch (a.B) {
    case 1: return launch_cooperative(rf_sampler_q8_kernel<S8, 1>, Layout<S8, 1>(a.w, a.H, a.ch).bytes, a, st);
    case 2: return launch_cooperative(rf_sampler_q8_kernel<S8, 2>, Layout<S8, 2>(a.w, a.H, a.ch).bytes, a, st);
    case 3: return launch_cooperative(rf_sampler_q8_kernel<S8, 3>, Layout<S8, 3>(a.w, a.H, a.ch).bytes, a, st);
    case 4: return launch_cooperative(rf_sampler_q8_kernel<S8, 4>, Layout<S8, 4>(a.w, a.H, a.ch).bytes, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One Euler sample (S steps x L blocks) of B <= 4 CFG rows, the arguments of
// mu_rf_sampler_q4s8 with int8 block tables: q12 (L, w, 2H) and q3 (L, H, w)
// int8 with fp32 scales s12 (L, 2H) / s3 (L, w); s8_dots: 1 for s8 dots (h
// re-quantized per `chunk` columns, chunk a multiple of 4 dividing H), 0 for
// exact dequant. w and H multiples of 64, C <= 128 (the wrapper checks). One
// cooperative launch: one CTA per SM.
extern "C" int mu_rf_sampler_q8(const void* dts, const void* x0, const void* win, const void* binp, const void* lnw,
                                const void* lnb, const void* q12, const void* s12, const void* b12, const void* q3,
                                const void* s3, const void* b3, const void* mods, const void* fmods,
                                const void* wfin_t, const void* bfin, void* xcur, void* hbuf, void* out, int B,
                                int cfg_rows, int renorm, int S, int L, int w, int H, int C, int h_bf16, int s8_dots,
                                int chunk, float text_cfg, float image_cfg, float ln_eps, void* stream) {
  RFArgs a = rf::make_args(dts, x0, win, binp, lnw, lnb, q12, s12, b12, q3, s3, b3, mods, fmods, wfin_t, bfin, xcur,
                           hbuf, out, B, cfg_rows, renorm, S, L, w, H, C, h_bf16, text_cfg, image_cfg, ln_eps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s8_dots && (chunk <= 0 || chunk % 4 || H % chunk)) return (int)cudaErrorInvalidValue;
  a.ch = s8_dots ? chunk : H;
  const cudaError_t err = s8_dots ? launch_rows<true>(a, st) : launch_rows<false>(a, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
