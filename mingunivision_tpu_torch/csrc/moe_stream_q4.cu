// Decode-shape MoE over linear int4 tables: sum over routed experts of
// gate * (silu(x@W1[e] * s1) * (x@W3[e] * s3)) @ W2[e] * s2, the weights
// split-halves packed (utils/quantize.py), in two dot modes:
//   S8 = true   the activations quantized per row to the s8 operand pair
//               (ops/kernels/intdot.py quant_rows_s8_pair), two integer dots
//               per packed table, h = silu(g) * u in fp32 re-quantized per
//               row over ALL of m before the down dots;
//   S8 = false  exact dequant: each nibble (-8..7) converted to fp32 (exact),
//               products with x's bf16 values summed in fp32 per nibble plane
//               (x[:, :h/2] @ lo + x[:, h/2:] @ hi), h = silu(g) * u rounded
//               to bf16 before the down dots, the scales on the sums.
//
// Replaces the TPU kernels mingunivision_tpu/ops/kernels/moe_stream.py
// (moe_experts_stream -> _kernel_q4_s8, the default, and _kernel_q4, under
// moe_int_dots=False). On the H100 the op is bound by the bytes of packed
// weights: one expert is 3 x 1024 x 1408 B = 4.33 MB at the 16B-A3B shape, and
// a 2-row CFG decode step routes up to 12 experts per layer (52 MB, 15.5 us at
// 3.35 TB/s); the activations are a few KB. So the design reads every routed
// expert once, with coalesced 4-byte loads, and keeps the per-byte work cheap:
//
//   the wrapper builds, on the device, the unique routed experts (ascending
//   id) and per-expert gate rows (duplicates across rows summed);
//   phase A  grid (slot, 128-column tile of m): each block stages the rows of
//            x in shared memory (S8: quantized to the s8 pair a1 = x_lo -
//            x_hi/16, a2 = x_hi; exact: as fp32), then g and u: each warp
//            takes the 4-row groups warp, warp + 8, ... of the K/2 packed
//            rows, a lane loading one 32-bit word (4 columns) of each row of
//            the group. S8: the words are byte-transposed (__byte_perm) so
//            that each holds four contraction rows of one column, and fed to
//            __dp4a as (w & 0x0F0F0F0F) and (w ^ 0x80808080); exact: each
//            byte's two nibbles are converted and multiplied in fp32. The 8
//            warps' partial sums are added in order in shared memory; h goes
//            to device memory in fp32;
//   phase B  grid (slot, 128-column tile of h): each block stages its slot's
//            h rows (S8: re-quantized over all of m, which needs the whole
//            row, hence the phase boundary), then the down dots the same way;
//   phase C  out = sum over slots of gate * y, in ascending slot order
//            (deterministic, no atomics).
//
// S8: the integer sums are exact, so up to the fp32 epilogue the kernel
// computes what its plain version does. Slots past the number of unique
// experts (read from device memory, no host sync) exit at once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;  // output columns per block: 32 lanes x 4 bytes

template <bool S8>
struct Acc {
  typedef int T;
};
template <>
struct Acc<false> {
  typedef float T;
};

// Shared memory: the staged rows (S8: a1, a2 [R][n/2] s8; exact: [R][n] fp32),
// st [R][4], scratch, then the per-warp partial sums red [kWarps][R][kCols][NACC].
template <bool S8, int R, int NACC>
struct Smem {
  __host__ __device__ static size_t rows(int n) {
    return align16(S8 ? (size_t)2 * R * (n / 2) : (size_t)R * n * sizeof(float));
  }
  __host__ __device__ static size_t bytes(int n) {
    return rows(n) + align16(4 * R * sizeof(float)) + align16(64 * R * sizeof(float)) +
           (size_t)kWarps * R * kCols * NACC * 4;
  }
};

// Stage R rows of length n (lo half [0, n/2), hi half [n/2, n)): S8 quantizes
// them to the s8 pair into buf (a1 [R][n/2], then a2) with st; exact copies
// them into buf [R][n] as fp32. Rows >= nr are zero. `row(r, i)` gives element
// i of row r.
template <bool S8, int R, typename Row>
__device__ void stage_rows(Row row, int nr, int n, void* buf, float* st, float* fscratch) {
  if constexpr (S8) {
    int8_t* a1 = static_cast<int8_t*>(buf);
    quant_pair_rows<R>(row, nr, n, a1, a1 + R * (n / 2), st, fscratch, reinterpret_cast<int*>(fscratch));
  } else {
    float* xf = static_cast<float*>(buf);
    for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
      for (int r = 0; r < R; ++r) xf[r * n + i] = r < nr ? row(r, i) : 0.0f;
    __syncthreads();
  }
}

// The R-row dot products of one 128-column tile of NT packed (K/2, ncols)
// tables: acc[r][c][2q], acc[r][c][2q+1] are, for table q, the two integer
// dots (S8) or the low- and high-plane fp32 sums (exact) of column 4 * lane + c.
// Each warp takes the 4-row groups warp, warp + 8, ... of the kh = K/2 packed rows.
template <bool S8, int R, int NT>
__device__ __forceinline__ void q4_dots(const uint8_t* const (&p)[NT], int kh, size_t ld, const void* buf,
                                        typename Acc<S8>::T (&acc)[R][4][2 * NT]) {
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < kh / 4; g += kWarps) {
    const int i = 4 * g;
    uint32_t w[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) w[q][rr] = __ldg(reinterpret_cast<const uint32_t*>(p[q] + (size_t)(i + rr) * ld));
    if constexpr (S8) {
      const int8_t* a1 = static_cast<const int8_t*>(buf);
      const int8_t* a2 = a1 + R * kh;
      uint32_t t[NT][4];
#pragma unroll
      for (int q = 0; q < NT; ++q) transpose4x4(w[q], t[q]);
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
    } else {
      const float* xf = static_cast<const float*>(buf);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        float lo[NT][4], hi[NT][4];
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int b = (w[q][rr] >> (8 * c)) & 0xFF;
            lo[q][c] = (float)((b & 15) - 8);
            hi[q][c] = (float)((b >> 4) - 8);
          }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xl = xf[r * 2 * kh + i + rr], xh = xf[r * 2 * kh + kh + i + rr];
#pragma unroll
          for (int q = 0; q < NT; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[r][c][2 * q] = fmaf(xl, lo[q][c], acc[r][c][2 * q]);
              acc[r][c][2 * q + 1] = fmaf(xh, hi[q][c], acc[r][c][2 * q + 1]);
            }
        }
      }
    }
  }
}

// The warps' partial sums of one tile into red, then `emit(r, c, sums)` for each
// row r < nr and column c < valid_cols of the tile, with the NACC sums of all warps.
template <bool S8, int R, int NACC, typename Emit>
__device__ __forceinline__ void reduce_tile(typename Acc<S8>::T (&acc)[R][4][NACC], typename Acc<S8>::T* red, int nr,
                                            int valid_cols, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < NACC; ++k) red[((size_t)(warp * R + r) * kCols + 4 * lane + c) * NACC + k] = acc[r][c][k];
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx % kCols;
    if (c >= valid_cols) continue;
    typename Acc<S8>::T s[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) s[k] = 0;
    for (int wp = 0; wp < kWarps; ++wp)
#pragma unroll
      for (int k = 0; k < NACC; ++k) s[k] += red[((size_t)(wp * R + r) * kCols + c) * NACC + k];
    emit(r, c, s);
  }
  __syncthreads();
}

template <bool S8, int R>
__global__ void __launch_bounds__(kThreads) q4_up_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ q1, const float* __restrict__ s1,
    const uint8_t* __restrict__ q3, const float* __restrict__ s3, const int* __restrict__ slot_expert,
    const int* __restrict__ n_unique, float* __restrict__ hbuf, int n_rows, int h, int m) {
  typedef typename Acc<S8>::T T;
  typedef Smem<S8, R, 4> L;
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int hh = h / 2;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < m;  // m % 8 == 0: a word never straddles the edge

  extern __shared__ __align__(16) unsigned char smem[];
  void* buf = smem;
  float* st = reinterpret_cast<float*>(smem + L::rows(h));
  float* fscratch = st + 4 * R;
  T* red = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(fscratch) + align16(64 * R * sizeof(float)));

  const uint8_t* const p[2] = {q1 + (size_t)e * hh * m + (active ? col : 0), q3 + (size_t)e * hh * m + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const bf16* xr = x + (size_t)r0 * h;
    stage_rows<S8, R>([&](int r, int i) { return __bfloat162float(xr[(size_t)r * h + i]); }, nr, h, buf, st,
                      fscratch);
    T acc[R][4][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][c][k] = 0;
    if (active) q4_dots<S8, R, 2>(p, hh, m, buf, acc);
    reduce_tile<S8, R, 4>(acc, red, nr, m - col0, [&](int r, int c, const T(&s)[4]) {
      const size_t j = (size_t)e * m + col0 + c;
      float g, u;
      if constexpr (S8) {
        g = __fmul_rn(mm4_epilogue(s[0], s[1], st + 4 * r), s1[j]);
        u = __fmul_rn(mm4_epilogue(s[2], s[3], st + 4 * r), s3[j]);
      } else {
        g = __fmul_rn(__fadd_rn(s[0], s[1]), s1[j]);
        u = __fmul_rn(__fadd_rn(s[2], s[3]), s3[j]);
      }
      float hv = __fmul_rn(silu_exact(g), u);
      if constexpr (!S8) hv = __bfloat162float(__float2bfloat16(hv));  // the down dots' bf16 operand
      hbuf[((size_t)slot * n_rows + r0 + r) * m + col0 + c] = hv;
    });
  }
}

template <bool S8, int R>
__global__ void __launch_bounds__(kThreads) q4_down_kernel(
    const float* __restrict__ hbuf, const uint8_t* __restrict__ q2, const float* __restrict__ s2,
    const int* __restrict__ slot_expert, const int* __restrict__ n_unique, float* __restrict__ ybuf, int n_rows,
    int h, int m) {
  typedef typename Acc<S8>::T T;
  typedef Smem<S8, R, 2> L;
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int mh = m / 2;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < h;

  extern __shared__ __align__(16) unsigned char smem[];
  void* buf = smem;
  float* st = reinterpret_cast<float*>(smem + L::rows(m));
  float* fscratch = st + 4 * R;
  T* red = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(fscratch) + align16(64 * R * sizeof(float)));

  const uint8_t* const p[1] = {q2 + (size_t)e * mh * h + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const float* hr = hbuf + ((size_t)slot * n_rows + r0) * m;
    stage_rows<S8, R>([&](int r, int i) { return hr[(size_t)r * m + i]; }, nr, m, buf, st, fscratch);
    T acc[R][4][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c][0] = acc[r][c][1] = 0;
    if (active) q4_dots<S8, R, 1>(p, mh, h, buf, acc);
    reduce_tile<S8, R, 2>(acc, red, nr, h - col0, [&](int r, int c, const T(&s)[2]) {
      const float d = S8 ? mm4_epilogue(s[0], s[1], st + 4 * r) : __fadd_rn(s[0], s[1]);
      ybuf[((size_t)slot * n_rows + r0 + r) * h + col0 + c] = __fmul_rn(d, s2[(size_t)e * h + col0 + c]);
    });
  }
}

template <bool S8, int R>
cudaError_t launch_q4(const bf16* x, const uint8_t* q1, const float* s1, const uint8_t* q3, const float* s3,
                      const uint8_t* q2, const float* s2, const int* slot_expert, const int* n_unique,
                      const float* gates, float* hbuf, float* ybuf, bf16* out, int n_rows, int n_slots, int h, int m,
                      cudaStream_t stream) {
  const size_t up_smem = Smem<S8, R, 4>::bytes(h), down_smem = Smem<S8, R, 2>::bytes(m);
  cudaError_t err = allow_dynamic_smem(q4_up_kernel<S8, R>, up_smem);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(q4_down_kernel<S8, R>, down_smem);
  if (err != cudaSuccess) return err;
  q4_up_kernel<S8, R><<<dim3(n_slots, (m + kCols - 1) / kCols), kThreads, up_smem, stream>>>(
      x, q1, s1, q3, s3, slot_expert, n_unique, hbuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q4_down_kernel<S8, R><<<dim3(n_slots, (h + kCols - 1) / kCols), kThreads, down_smem, stream>>>(
      hbuf, q2, s2, slot_expert, n_unique, ybuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_slot_combine_kernel<<<dim3(n_rows, (h + 255) / 256), 256, 0, stream>>>(ybuf, gates, n_unique, out, n_rows, h);
  return cudaGetLastError();
}

template <bool S8>
cudaError_t launch_rows(const bf16* x, const uint8_t* q1, const float* s1, const uint8_t* q3, const float* s3,
                        const uint8_t* q2, const float* s2, const int* slot_expert, const int* n_unique,
                        const float* gates, float* hbuf, float* ybuf, bf16* out, int n_rows, int n_slots, int h,
                        int m, cudaStream_t stream) {
  if (n_rows <= 1)
    return launch_q4<S8, 1>(x, q1, s1, q3, s3, q2, s2, slot_expert, n_unique, gates, hbuf, ybuf, out, n_rows, n_slots,
                            h, m, stream);
  if (n_rows <= 2)
    return launch_q4<S8, 2>(x, q1, s1, q3, s3, q2, s2, slot_expert, n_unique, gates, hbuf, ybuf, out, n_rows, n_slots,
                            h, m, stream);
  return launch_q4<S8, 4>(x, q1, s1, q3, s3, q2, s2, slot_expert, n_unique, gates, hbuf, ybuf, out, n_rows, n_slots, h,
                          m, stream);
}

}  // namespace

// x (n_rows, h) bf16; q1/q3 (E, h/2, m) and q2 (E, m/2, h) uint8 split-halves
// packed int4 for ONE layer with fp32 scales s1/s3 (E, 1, m) and s2 (E, 1, h);
// slot_expert (n_slots,) int32 unique routed experts first; n_unique (1,)
// int32; gates (n_slots, n_rows) fp32; scratch hbuf (n_slots, n_rows, m) and
// ybuf (n_slots, n_rows, h) fp32; out (n_rows, h) bf16. s8_dots: 1 for s8
// integer dots, 0 for exact dequant. h and m must be multiples of 8 (the
// wrapper checks). Rows are taken up to four at a time.
extern "C" int mu_moe_stream_q4(const void* x, const void* q1, const void* s1, const void* q3, const void* s3,
                                const void* q2, const void* s2, const void* slot_expert, const void* n_unique,
                                const void* gates, void* hbuf, void* ybuf, void* out, int n_rows, int n_slots, int h,
                                int m, int s8_dots, void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t *a = static_cast<const uint8_t*>(q1), *b = static_cast<const uint8_t*>(q3),
                *c = static_cast<const uint8_t*>(q2);
  const float *sa = static_cast<const float*>(s1), *sb = static_cast<const float*>(s3),
              *sc = static_cast<const float*>(s2);
  const int *se = static_cast<const int*>(slot_expert), *nu = static_cast<const int*>(n_unique);
  const float* gt = static_cast<const float*>(gates);
  float *hb = static_cast<float*>(hbuf), *yb = static_cast<float*>(ybuf);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      s8_dots ? launch_rows<true>(xb, a, sa, b, sb, c, sc, se, nu, gt, hb, yb, o, n_rows, n_slots, h, m, st)
              : launch_rows<false>(xb, a, sa, b, sb, c, sc, se, nu, gt, hb, yb, o, n_rows, n_slots, h, m, st);
  return (int)err;
}
