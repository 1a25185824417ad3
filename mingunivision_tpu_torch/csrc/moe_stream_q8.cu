// Decode-shape MoE over int8 tables: sum over routed experts of
// gate * (silu(x@W1[e] * s1) * (x@W3[e] * s3)) @ W2[e] * s2, the weights int8
// per-output-channel (utils/quantize.py), in two dot modes:
//   S8 = true   the activations quantized per row to s8 (ops/kernels/intdot.py
//               quant_rows_s8: max|x| / 127 + 1e-12, round half to even), the
//               dots s8 x s8 -> s32, h = silu(g) * u in fp32 re-quantized per
//               row over ALL of m before the down dot;
//   S8 = false  exact dequant: each int8 weight converted to fp32 (exact),
//               products with x's bf16 values summed in fp32, h rounded to
//               bf16 before the down dot, s2 applied per expert.
//
// Replaces the TPU kernels mingunivision_tpu/ops/kernels/moe_stream.py
// (moe_experts_stream -> _kernel_q8_s8, the default, and _kernel_q8, under
// moe_int_dots=False). On the H100 the op is bound by the bytes of int8
// weights: one expert is 3 x 2048 x 1408 B = 8.65 MB at the 16B-A3B shape, and
// a 2-row CFG decode step routes up to 12 experts per layer (104 MB, 31 us at
// 3.35 TB/s); the activations are a few KB. So the design reads every routed
// expert once, with coalesced 4-byte loads (the int4 kernel's layout,
// moe_stream_q4.cu):
//
//   the wrapper builds, on the device, the unique routed experts (ascending
//   id) and per-expert gate rows (duplicates across rows summed);
//   phase A  grid (slot, 128-column tile of m): each block stages the rows of
//            x in shared memory (S8: quantized to s8; exact: as fp32), then g
//            and u: each warp takes the 4-row groups warp, warp + 8, ... of
//            the contraction; a lane loads one 32-bit word (4 columns) of each
//            of the group's 4 rows. S8: the words are byte-transposed
//            (__byte_perm) so that each holds four contraction rows of one
//            column, and fed to __dp4a; exact: each byte is converted and
//            multiplied in fp32. The 8 warps' partial sums are added in order
//            in shared memory; h goes to device memory in fp32;
//   phase B  grid (slot, 128-column tile of h): each block stages its slot's
//            h rows (S8: re-quantized over all of m, which needs the whole row,
//            hence the phase boundary), then the down dots the same way;
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

// Shared memory: the staged rows [R][n] (s8 or fp32), row scales [R], scratch
// [32][R], then the per-warp partial sums red [kWarps][R][kCols][NT] (int or fp32).
template <bool S8, int R, int NT>
struct Smem {
  __host__ __device__ static size_t rows(int n) { return align16((size_t)R * n * (S8 ? 1 : 4)); }
  __host__ __device__ static size_t bytes(int n) {
    return rows(n) + align16(R * 4) + align16(32 * R * 4) + (size_t)kWarps * R * kCols * NT * 4;
  }
};

template <bool S8>
struct Acc;
template <>
struct Acc<true> {
  typedef int T;
};
template <>
struct Acc<false> {
  typedef float T;
};

// Stage R rows of length n: S8 quantizes each row to s8 (intdot.quant_rows_s8)
// into xq [R][n] with its scale in sx[r]; exact copies them into xf [R][n].
// Rows >= nr are zero. `row(r, i)` gives element i of row r.
template <bool S8, int R, typename Row>
__device__ void stage_rows(Row row, int nr, int n, void* buf, float* sx, float* scratch) {
  if constexpr (S8) {
    int8_t* xq = static_cast<int8_t*>(buf);
    float mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) mx[r] = fmaxf(mx[r], fabsf(row(r, i)));
    block_allreduce<R>(mx, scratch, MaxOp<float>());
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = __fadd_rn(__fdiv_rn(mx[r], 127.0f), 1e-12f);
    for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
      for (int r = 0; r < R; ++r) xq[r * n + i] = r < nr ? (int8_t)(int)rintf(__fdiv_rn(row(r, i), sc[r])) : (int8_t)0;
    if (threadIdx.x == 0)
#pragma unroll
      for (int r = 0; r < R; ++r) sx[r] = sc[r];
  } else {
    float* xf = static_cast<float*>(buf);
    for (int i = threadIdx.x; i < n; i += kThreads)
#pragma unroll
      for (int r = 0; r < R; ++r) xf[r * n + i] = r < nr ? row(r, i) : 0.0f;
  }
  __syncthreads();
}

// The R-row dot products of one 128-column tile of NT int8 (K, ncols) tables,
// each warp over the 4-row groups warp, warp + 8, ... of K; acc[r][c][q] is
// column 4 * lane + c of table q.
template <bool S8, int R, int NT>
__device__ __forceinline__ void q8_dots(const int8_t* const (&p)[NT], int K, size_t ld, const void* buf,
                                        typename Acc<S8>::T (&acc)[R][4][NT]) {
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < K / 4; g += kWarps) {
    const int i = 4 * g;
    uint32_t w[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) w[q][rr] = __ldg(reinterpret_cast<const uint32_t*>(p[q] + (size_t)(i + rr) * ld));
    if constexpr (S8) {
      const int8_t* xq = static_cast<const int8_t*>(buf);
      uint32_t t[NT][4];
#pragma unroll
      for (int q = 0; q < NT; ++q) transpose4x4(w[q], t[q]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int x4 = *reinterpret_cast<const int*>(xq + r * K + i);
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c][q] = __dp4a(x4, (int)t[q][c], acc[r][c][q]);
      }
    } else {
      const float* xf = static_cast<const float*>(buf);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        float wf[NT][4];
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) wf[q][c] = (float)(int8_t)(w[q][rr] >> (8 * c));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = xf[r * K + i + rr];
#pragma unroll
          for (int q = 0; q < NT; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c][q] = fmaf(xv, wf[q][c], acc[r][c][q]);
        }
      }
    }
  }
}

// The warps' partial sums of one tile into red, then `emit(r, c, sums)` for each
// row r < nr and column c < ncols - col0 of the tile, with the NT sums of all warps.
template <bool S8, int R, int NT, typename Emit>
__device__ __forceinline__ void reduce_tile(typename Acc<S8>::T (&acc)[R][4][NT], typename Acc<S8>::T* red, int nr,
                                            int valid_cols, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NT; ++q) red[((size_t)(warp * R + r) * kCols + 4 * lane + c) * NT + q] = acc[r][c][q];
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx % kCols;
    if (c >= valid_cols) continue;
    typename Acc<S8>::T s[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) s[q] = 0;
    for (int wp = 0; wp < kWarps; ++wp)
#pragma unroll
      for (int q = 0; q < NT; ++q) s[q] += red[((size_t)(wp * R + r) * kCols + c) * NT + q];
    emit(r, c, s);
  }
  __syncthreads();
}

template <bool S8, int R>
__global__ void __launch_bounds__(kThreads) q8_up_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q1, const float* __restrict__ s1,
    const int8_t* __restrict__ q3, const float* __restrict__ s3, const int* __restrict__ slot_expert,
    const int* __restrict__ n_unique, float* __restrict__ hbuf, int n_rows, int h, int m) {
  typedef typename Acc<S8>::T T;
  typedef Smem<S8, R, 2> L;
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < m;  // m % 4 == 0: a word never straddles the edge

  extern __shared__ __align__(16) unsigned char smem[];
  void* buf = smem;
  float* sx = reinterpret_cast<float*>(smem + L::rows(h));
  float* scratch = sx + align16(R * 4) / 4;
  T* red = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(scratch) + align16(32 * R * 4));

  const int8_t* const p[2] = {q1 + (size_t)e * h * m + (active ? col : 0), q3 + (size_t)e * h * m + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const bf16* xr = x + (size_t)r0 * h;
    stage_rows<S8, R>([&](int r, int i) { return __bfloat162float(xr[(size_t)r * h + i]); }, nr, h, buf, sx, scratch);
    T acc[R][4][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c][0] = acc[r][c][1] = 0;
    if (active) q8_dots<S8, R, 2>(p, h, m, buf, acc);
    reduce_tile<S8, R, 2>(acc, red, nr, m - col0, [&](int r, int c, const T(&s)[2]) {
      const size_t j = (size_t)e * m + col0 + c;
      float g, u;
      if constexpr (S8) {
        g = __fmul_rn(__fmul_rn((float)s[0], sx[r]), s1[j]);
        u = __fmul_rn(__fmul_rn((float)s[1], sx[r]), s3[j]);
      } else {
        g = __fmul_rn(s[0], s1[j]);
        u = __fmul_rn(s[1], s3[j]);
      }
      float hv = __fmul_rn(silu_exact(g), u);
      if constexpr (!S8) hv = __bfloat162float(__float2bfloat16(hv));  // the down dot's bf16 operand
      hbuf[((size_t)slot * n_rows + r0 + r) * m + col0 + c] = hv;
    });
  }
}

template <bool S8, int R>
__global__ void __launch_bounds__(kThreads) q8_down_kernel(
    const float* __restrict__ hbuf, const int8_t* __restrict__ q2, const float* __restrict__ s2,
    const int* __restrict__ slot_expert, const int* __restrict__ n_unique, float* __restrict__ ybuf, int n_rows,
    int h, int m) {
  typedef typename Acc<S8>::T T;
  typedef Smem<S8, R, 1> L;
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < h;

  extern __shared__ __align__(16) unsigned char smem[];
  void* buf = smem;
  float* sx = reinterpret_cast<float*>(smem + L::rows(m));
  float* scratch = sx + align16(R * 4) / 4;
  T* red = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(scratch) + align16(32 * R * 4));

  const int8_t* const p[1] = {q2 + (size_t)e * m * h + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const float* hr = hbuf + ((size_t)slot * n_rows + r0) * m;
    stage_rows<S8, R>([&](int r, int i) { return hr[(size_t)r * m + i]; }, nr, m, buf, sx, scratch);
    T acc[R][4][1];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c][0] = 0;
    if (active) q8_dots<S8, R, 1>(p, m, h, buf, acc);
    reduce_tile<S8, R, 1>(acc, red, nr, h - col0, [&](int r, int c, const T(&s)[1]) {
      const float d = S8 ? __fmul_rn((float)s[0], sx[r]) : (float)s[0];
      ybuf[((size_t)slot * n_rows + r0 + r) * h + col0 + c] = __fmul_rn(d, s2[(size_t)e * h + col0 + c]);
    });
  }
}

template <bool S8, int R>
cudaError_t launch_q8(const bf16* x, const int8_t* q1, const float* s1, const int8_t* q3, const float* s3,
                      const int8_t* q2, const float* s2, const int* slot_expert, const int* n_unique,
                      const float* gates, float* hbuf, float* ybuf, bf16* out, int n_rows, int n_slots, int h, int m,
                      cudaStream_t stream) {
  const size_t up_smem = Smem<S8, R, 2>::bytes(h), down_smem = Smem<S8, R, 1>::bytes(m);
  cudaError_t err = allow_dynamic_smem(q8_up_kernel<S8, R>, up_smem);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(q8_down_kernel<S8, R>, down_smem);
  if (err != cudaSuccess) return err;
  q8_up_kernel<S8, R><<<dim3(n_slots, (m + kCols - 1) / kCols), kThreads, up_smem, stream>>>(
      x, q1, s1, q3, s3, slot_expert, n_unique, hbuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q8_down_kernel<S8, R><<<dim3(n_slots, (h + kCols - 1) / kCols), kThreads, down_smem, stream>>>(
      hbuf, q2, s2, slot_expert, n_unique, ybuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_slot_combine_kernel<<<dim3(n_rows, (h + 255) / 256), 256, 0, stream>>>(ybuf, gates, n_unique, out, n_rows, h);
  return cudaGetLastError();
}

template <bool S8>
cudaError_t launch_rows(const bf16* x, const int8_t* q1, const float* s1, const int8_t* q3, const float* s3,
                        const int8_t* q2, const float* s2, const int* slot_expert, const int* n_unique,
                        const float* gates, float* hbuf, float* ybuf, bf16* out, int n_rows, int n_slots, int h,
                        int m, cudaStream_t stream) {
  if (n_rows <= 1)
    return launch_q8<S8, 1>(x, q1, s1, q3, s3, q2, s2, slot_expert, n_unique, gates, hbuf, ybuf, out, n_rows, n_slots,
                            h, m, stream);
  if (n_rows <= 2)
    return launch_q8<S8, 2>(x, q1, s1, q3, s3, q2, s2, slot_expert, n_unique, gates, hbuf, ybuf, out, n_rows, n_slots,
                            h, m, stream);
  return launch_q8<S8, 4>(x, q1, s1, q3, s3, q2, s2, slot_expert, n_unique, gates, hbuf, ybuf, out, n_rows, n_slots, h,
                          m, stream);
}

}  // namespace

// x (n_rows, h) bf16; q1/q3 (E, h, m) and q2 (E, m, h) int8 for ONE layer with
// fp32 scales s1/s3 (E, 1, m) and s2 (E, 1, h); slot_expert (n_slots,) int32
// unique routed experts first; n_unique (1,) int32; gates (n_slots, n_rows)
// fp32; scratch hbuf (n_slots, n_rows, m) and ybuf (n_slots, n_rows, h) fp32;
// out (n_rows, h) bf16. s8_dots: 1 for s8 integer dots, 0 for exact dequant.
// h and m must be multiples of 8 (the wrapper checks). Rows are taken up to
// four at a time.
extern "C" int mu_moe_stream_q8(const void* x, const void* q1, const void* s1, const void* q3, const void* s3,
                                const void* q2, const void* s2, const void* slot_expert, const void* n_unique,
                                const void* gates, void* hbuf, void* ybuf, void* out, int n_rows, int n_slots, int h,
                                int m, int s8_dots, void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t *a = static_cast<const int8_t*>(q1), *b = static_cast<const int8_t*>(q3),
               *c = static_cast<const int8_t*>(q2);
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
