// One Euler step of the rectified-flow head's residual stack: all L AdaLN
// SwiGLU blocks over linear int4 or int8 tables in ONE launch, in four bodies.
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/rf_mlp.py
// (rf_mlp_stack, one pallas_call per Euler step) in all four of its bodies:
// _kernel (int8, exact dequant), _kernel_q8_s8 (int8, s8 dots), _kernel_q4
// (int4, exact dequant) and _kernel_q4_s8 (int4, s8 dots). Per block l (rows
// r < B, width w, SwiGLU hidden H; x enters in the compute dtype, the running
// activation is fp32, the output is rounded back to the compute dtype by the
// wrapper):
//   xs = LN(x) * ln_w + ln_b, modulated by (shift, scale) of mods[l]
//   int8 exact: xs and h = silu(g) * u rounded to the compute dtype, the int8
//       bytes enter fp32 products as their exact values; the down product
//       per ch-row chunk (ch = the wrapper's CHUNK): acc += (h_c @ Q3_c) * s3;
//       x += gate * (acc + b3)
//   int8 S8: the fp32 xs quantized per row to s8, g, u = s8 dots * sx * s + b;
//       h in fp32, re-quantized per row over each ch-column chunk:
//       acc += ((hq_c @ Q3_c) * sh_c) * s3; x += gate * (acc + b3)
//   int4 exact: xs rounded to the compute dtype, both nibble planes converted
//       exactly, one dot per plane (g = lo-plane dot + hi-plane dot, then
//       * s + b); h rounded to the compute dtype; the down product summed in
//       kc = 512 packed-row chunks, each chunk's two plane dots added first;
//       x += gate * (po * s3 + b3)
//   int4 S8: the fp32 xs quantized to the s8 operand pair (intdot.
//       quant_rows_s8_pair), g, u through the two integer dots; h rounded to
//       the compute dtype, then quantized to the s8 pair over all of H; the
//       down dots in kc = 1024 packed-row chunks, each chunk's descaled sums
//       added as (po + d1 * sb1) + d2 * sb2 / 16; x += gate * ((po - corr) *
//       s3 + b3)
// On the H100 a launch is bound by the tables it reads once: 453 MB of packed
// int4 (906 MB of int8) at the 16B-A3B width (12 blocks of w12 (3072, 16384)
// and w3 (8192, 3072)), 0.135 ms (0.270 ms) at 3.35 TB/s.
//
// Design: the fused samplers' persistent cooperative grid (one CTA per SM,
// grid-wide barriers between dependent phases; rf_sampler_common.cuh's task
// dots, LN statistics and quantization), one Euler step instead of all:
//   P1 (every CTA, redundantly)  x (B x w fp32, the input at block 0, then
//        from L2) into shared memory, LN, modulate, the body's activation
//        operand (compute-dtype values, or s8);
//   P2 (32-column tasks over CTAs)  gate/up dots over the whole contraction,
//        h to device memory;                                      -- barrier
//   P3 (every CTA)  h from L2 into the body's down operand;
//   P4 (32-column tasks)  the down dots chunk by chunk, each chunk's sums
//        descaled and added in order, the residual update of the CTA's own
//        columns of x;                                             -- barrier
// The head is chaotic at its bf16 and s8 roundings, so every fp32 step is
// rounded as written (__f*_rn: no fused multiply-add), exp is taken in double
// (silu_exact) and the plain version (ops/kernels/rf_mlp.py) sums in this
// kernel's order: the two agree to the bit.
#include "rf_sampler_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rf;

struct StackArgs {
  const float* x;  // (B, w): the compute-dtype input as fp32
  const float *lnw, *lnb;
  const void* q12;
  const float *s12, *b12;
  const void* q3;
  const float *s3, *b3, *mods;  // mods (L, B, 3w): shift, scale, gate
  float *xcur, *hbuf;  // (B, w) the running activation (the output), (B, H) h
  int B, L, w, H, h_bf16;
  int ch;  // int8 bodies: the down product's row chunk (S8: h re-quantized over each ch columns)
  int kc;  // int4 bodies: the down product's packed-row chunk
  float ln_eps;
};

// Shared memory: x [R][w]; the activation buffer (exact bodies: [R][max(w,
// H)] fp32, xs in P1-P2, h in P3-P4; int8 S8: [R][max(w, H)] s8 with the row
// scales [R][1 + H / ch]; int4 S8: the s8 pairs of xs [R][w/2] x2 and of h
// [R][H/2] x2 with their stats); LN stats, reduction scratch, and the
// per-warp partial sums of a task [kWarps][R][kTask][4].
template <int BITS, bool S8, int R>
struct Layout {
  size_t x, act, q, scl, a1, a2, b1, b2, st, sth, stats, fscr, red, bytes;
  __host__ __device__ Layout(int w, int H, int ch) {
    const size_t wide = w > H ? w : H;
    size_t o = 0;
    x = o; o += align16((size_t)R * w * 4);
    act = o; o += S8 ? 0 : align16((size_t)R * wide * 4);
    q = o; o += (S8 && BITS == 8) ? align16((size_t)R * wide) : 0;
    scl = o; o += (S8 && BITS == 8) ? align16((size_t)R * (1 + H / ch) * 4) : 0;
    const bool pair = S8 && BITS == 4;
    a1 = o; o += pair ? align16((size_t)R * (w / 2)) : 0;
    a2 = o; o += pair ? align16((size_t)R * (w / 2)) : 0;
    b1 = o; o += pair ? align16((size_t)R * (H / 2)) : 0;
    b2 = o; o += pair ? align16((size_t)R * (H / 2)) : 0;
    st = o; o += align16(4 * R * 4);
    sth = o; o += align16(4 * R * 4);
    stats = o; o += align16(2 * R * 4);
    fscr = o; o += align16(32 * 2 * R * 4);
    red = o; o += (size_t)kWarps * R * kTask * 4 * 4;
    bytes = o;
  }
};

template <int BITS, bool S8, int R>
__global__ void __launch_bounds__(kThreads) rf_mlp_kernel(StackArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int w = a.w, H = a.H, B = a.B, L = a.L;
  const int wq = w / 2, Hh = H / 2, CH = a.ch, HC = H / a.ch;
  const Layout<BITS, S8, R> lay(w, H, CH);
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + lay.x);
  float* act = reinterpret_cast<float*>(smem + lay.act);
  int8_t* qa = reinterpret_cast<int8_t*>(smem + lay.q);
  float* scl = reinterpret_cast<float*>(smem + lay.scl);  // int8 S8: sx [R], then sh [R][HC]
  int8_t* a1 = reinterpret_cast<int8_t*>(smem + lay.a1);
  int8_t* a2 = reinterpret_cast<int8_t*>(smem + lay.a2);
  int8_t* b1 = reinterpret_cast<int8_t*>(smem + lay.b1);
  int8_t* b2 = reinterpret_cast<int8_t*>(smem + lay.b2);
  float* st = reinterpret_cast<float*>(smem + lay.st);
  float* sth = reinterpret_cast<float*>(smem + lay.sth);
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  float* fscr = reinterpret_cast<float*>(smem + lay.fscr);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  int* ired = reinterpret_cast<int*>(smem + lay.red);

  for (int i = threadIdx.x; i < R * w; i += kThreads) xs[i] = a.x[i];
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const float* md = a.mods + (size_t)l * B * 3 * w;  // [B][3w]: shift, scale, gate
    if (l > 0) {
      for (int i = threadIdx.x; i < R * w; i += kThreads) xs[i] = __ldcg(a.xcur + i);
      __syncthreads();
    }
    // P1: modulated LN (fp32), then the body's activation operand
    row_stats<R>(xs, w, a.ln_eps, stats, fscr);
    const float* lw = a.lnw + (size_t)l * w;
    const float* lb = a.lnb + (size_t)l * w;
    auto xmod = [&](int r, int i) {
      const float d = __fmul_rn(__fsub_rn(xs[r * w + i], stats[2 * r]), stats[2 * r + 1]);
      const float ln = __fadd_rn(__fmul_rn(d, lw[i]), lb[i]);
      return __fadd_rn(__fmul_rn(ln, __fadd_rn(1.0f, md[(size_t)r * 3 * w + w + i])), md[(size_t)r * 3 * w + i]);
    };
    if constexpr (S8 && BITS == 4) {
      quant_pair_rows<R>(xmod, B, w, a1, a2, st, fscr, reinterpret_cast<int*>(fscr));
    } else if constexpr (S8) {
      float sx[R];
      quant_rows<R>(xmod, w, qa, w, sx, fscr);
      if (threadIdx.x == 0)
#pragma unroll
        for (int r = 0; r < R; ++r) scl[r] = sx[r];
      __syncthreads();
    } else {
      for (int idx = threadIdx.x; idx < R * w; idx += kThreads) act[idx] = to_compute(xmod(idx / w, idx % w), a.h_bf16);
      __syncthreads();
    }

    // P2: gate / up columns, h = silu(g) * u (int8 S8: in fp32; else in the compute dtype)
    const float* s12 = a.s12 + (size_t)l * 2 * H;
    const float* b12 = a.b12 + (size_t)l * 2 * H;
    for (int task = blockIdx.x; task < H / kTask; task += gridDim.x) {
      const int j0 = task * kTask;
      if constexpr (BITS == 4) {
        const uint8_t* q12 = static_cast<const uint8_t*>(a.q12) + (size_t)l * wq * 2 * H;
        const uint8_t* const p[2] = {q12 + j0, q12 + H + j0};
        if constexpr (S8) task_dots_q4s8<R, 2>(p, wq, 2 * (size_t)H, a1, a2, wq, ired);
        else task_dots_q4f<R, 2>(p, wq, 2 * (size_t)H, act, act + wq, w, red);
      } else {
        const int8_t* q12 = static_cast<const int8_t*>(a.q12) + (size_t)l * w * 2 * H;
        const int8_t* const p[2] = {q12 + j0, q12 + H + j0};
        if constexpr (S8) task_dots_s8<R, 2>(p, w, 2 * (size_t)H, qa, w, ired);
        else task_dots_f32<R, 2>(p, w, 2 * (size_t)H, act, w, red);
      }
      for (int idx = threadIdx.x; idx < B * kTask; idx += kThreads) {
        const int r = idx / kTask, c = idx % kTask, j = j0 + c;
        float d0, d1;
        if constexpr (BITS == 4 && S8) {
          const int* d = ired + (r * kTask + c) * 4;
          d0 = mm4_epilogue(d[0], d[1], st + 4 * r);
          d1 = mm4_epilogue(d[2], d[3], st + 4 * r);
        } else if constexpr (BITS == 4) {
          const float* d = red + (r * kTask + c) * 4;
          d0 = __fadd_rn(d[0], d[1]);
          d1 = __fadd_rn(d[2], d[3]);
        } else if constexpr (S8) {
          d0 = __fmul_rn((float)ired[(r * kTask + c) * 2], scl[r]);
          d1 = __fmul_rn((float)ired[(r * kTask + c) * 2 + 1], scl[r]);
        } else {
          d0 = red[(r * kTask + c) * 2];
          d1 = red[(r * kTask + c) * 2 + 1];
        }
        const float g = __fadd_rn(__fmul_rn(d0, s12[j]), b12[j]);
        const float u = __fadd_rn(__fmul_rn(d1, s12[H + j]), b12[H + j]);
        const float hv = __fmul_rn(silu_exact(g), u);
        __stcg(a.hbuf + (size_t)r * H + j, (S8 && BITS == 8) ? hv : to_compute(hv, a.h_bf16));
      }
      __syncthreads();
    }
    grid.sync();

    // P3: h into the body's down operand
    if constexpr (S8 && BITS == 4) {
      quant_pair_rows<R>([&](int r, int i) { return __ldcg(a.hbuf + (size_t)r * H + i); }, B, H, b1, b2, sth, fscr,
                         reinterpret_cast<int*>(fscr));
    } else if constexpr (S8) {
      for (int c = 0; c < HC; ++c) {
        float sh[R];
        quant_rows<R>([&](int r, int i) { return __ldcg(a.hbuf + (size_t)r * H + c * CH + i); }, CH, qa + c * CH, H,
                      sh, fscr);
        if (threadIdx.x == 0)
#pragma unroll
          for (int r = 0; r < R; ++r) scl[R + r * HC + c] = sh[r];
      }
      __syncthreads();
    } else {
      for (int i = threadIdx.x; i < R * H; i += kThreads) act[i] = __ldcg(a.hbuf + i);
      __syncthreads();
    }

    // P4: down columns chunk by chunk, and the residual through the gate modulation
    const float* s3 = a.s3 + (size_t)l * w;
    const float* b3 = a.b3 + (size_t)l * w;
    const int own = threadIdx.x < B * kTask;  // the thread holding (row tid / kTask, column tid % kTask)
    const int r = threadIdx.x / kTask, c = threadIdx.x % kTask;
    for (int task = blockIdx.x; task < w / kTask; task += gridDim.x) {
      const int c0 = task * kTask, j = c0 + c;
      float acc = 0.0f, y = 0.0f;
      if constexpr (BITS == 4) {
        const uint8_t* q3 = static_cast<const uint8_t*>(a.q3) + (size_t)l * Hh * w;
        for (int k0 = 0; k0 < Hh; k0 += a.kc) {
          const uint8_t* const p[1] = {q3 + (size_t)k0 * w + c0};
          if constexpr (S8) {
            task_dots_q4s8<R, 1>(p, a.kc, (size_t)w, b1 + k0, b2 + k0, Hh, ired);
            if (own) {
              const int* d = ired + (r * kTask + c) * 4;
              acc = __fadd_rn(__fadd_rn(acc, __fmul_rn((float)d[0], sth[4 * r])),
                              __fmul_rn((float)d[1], __fmul_rn(sth[4 * r + 1], 0.0625f)));
            }
          } else {
            task_dots_q4f<R, 1>(p, a.kc, (size_t)w, act + k0, act + Hh + k0, H, red);
            if (own) {
              const float* d = red + (r * kTask + c) * 4;
              acc = __fadd_rn(acc, __fadd_rn(d[0], d[1]));
            }
          }
          __syncthreads();
        }
        if (own) {
          if constexpr (S8) acc = __fsub_rn(acc, sth[4 * r + 2]);
          y = __fadd_rn(__fmul_rn(acc, s3[j]), b3[j]);
        }
      } else {
        const int8_t* q3 = static_cast<const int8_t*>(a.q3) + (size_t)l * H * w;
        for (int cc = 0; cc < HC; ++cc) {
          const int8_t* const p[1] = {q3 + (size_t)cc * CH * w + c0};
          if constexpr (S8) {
            task_dots_s8<R, 1>(p, CH, (size_t)w, qa + cc * CH, H, ired);
            if (own) acc = __fadd_rn(acc, __fmul_rn(__fmul_rn((float)ired[r * kTask + c], scl[R + r * HC + cc]), s3[j]));
          } else {
            task_dots_f32<R, 1>(p, CH, (size_t)w, act + cc * CH, H, red);
            if (own) acc = __fadd_rn(acc, __fmul_rn(red[r * kTask + c], s3[j]));
          }
          __syncthreads();
        }
        if (own) y = __fadd_rn(acc, b3[j]);
      }
      if (own) __stcg(a.xcur + (size_t)r * w + j, __fadd_rn(xs[r * w + j], __fmul_rn(md[(size_t)r * 3 * w + 2 * w + j], y)));
    }
    grid.sync();
  }
}

template <int BITS, bool S8>
cudaError_t launch_rows(const StackArgs& a, cudaStream_t st) {
  switch (a.B) {
    case 1: return launch_cooperative(rf_mlp_kernel<BITS, S8, 1>, Layout<BITS, S8, 1>(a.w, a.H, a.ch).bytes, a, st);
    case 2: return launch_cooperative(rf_mlp_kernel<BITS, S8, 2>, Layout<BITS, S8, 2>(a.w, a.H, a.ch).bytes, a, st);
    case 3: return launch_cooperative(rf_mlp_kernel<BITS, S8, 3>, Layout<BITS, S8, 3>(a.w, a.H, a.ch).bytes, a, st);
    case 4: return launch_cooperative(rf_mlp_kernel<BITS, S8, 4>, Layout<BITS, S8, 4>(a.w, a.H, a.ch).bytes, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One Euler step of the residual stack over B <= 4 rows: x (B, w) fp32 holding
// compute-dtype values; lnw / lnb (L, w); q12 (L, w/2, 2H) / q3 (L, H/2, w)
// uint8 split-halves packed int4 (bits 4) or (L, w, 2H) / (L, H, w) int8
// (bits 8) with fp32 scales s12 (L, 2H) / s3 (L, w) and biases b12 / b3; mods
// (L, B, 3w) fp32; scratch hbuf (B, H) fp32; out xcur (B, w) fp32. s8: the
// integer-dot body; chunk: the int8 bodies' down row chunk (a multiple of 4
// dividing H), kc: the int4 bodies' packed-row chunk (a multiple of 4
// dividing H/2). w and H multiples of 64 (the wrapper checks). One
// cooperative launch: one CTA per SM.
extern "C" int mu_rf_mlp_stack(const void* x, const void* lnw, const void* lnb, const void* q12, const void* s12,
                               const void* b12, const void* q3, const void* s3, const void* b3, const void* mods,
                               void* xcur, void* hbuf, int B, int L, int w, int H, int h_bf16, int bits, int s8,
                               int chunk, int kc, float ln_eps, void* stream) {
  StackArgs a;
  a.x = static_cast<const float*>(x);
  a.lnw = static_cast<const float*>(lnw);
  a.lnb = static_cast<const float*>(lnb);
  a.q12 = q12;
  a.s12 = static_cast<const float*>(s12);
  a.b12 = static_cast<const float*>(b12);
  a.q3 = q3;
  a.s3 = static_cast<const float*>(s3);
  a.b3 = static_cast<const float*>(b3);
  a.mods = static_cast<const float*>(mods);
  a.xcur = static_cast<float*>(xcur);
  a.hbuf = static_cast<float*>(hbuf);
  a.B = B, a.L = L, a.w = w, a.H = H, a.h_bf16 = h_bf16, a.ln_eps = ln_eps;
  a.ch = bits == 8 ? chunk : H;
  a.kc = bits == 4 ? kc : H / 2;
  if (a.ch <= 0 || a.ch % 4 || H % a.ch || a.kc <= 0 || a.kc % 4 || (H / 2) % a.kc) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 4) err = s8 ? launch_rows<4, true>(a, st) : launch_rows<4, false>(a, st);
  else if (bits == 8) err = s8 ? launch_rows<8, true>(a, st) : launch_rows<8, false>(a, st);
  else err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
