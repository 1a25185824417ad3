// Decode-shape MoE over linear int4 tables with s8 integer dots:
// sum over routed experts of gate * (silu(x@W1[e]) * (x@W3[e])) @ W2[e], the
// weights split-halves packed (utils/quantize.py) and the activations
// quantized per row to s8 (ops/kernels/intdot.py).
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/moe_stream.py
// (moe_experts_stream -> _kernel_q4_s8). On the H100 the op is bound by the
// bytes of packed weights: one expert is 3 x 1024 x 1408 B = 4.33 MB at the
// 16B-A3B shape, and a 2-row CFG decode step routes up to 12 experts per layer
// (52 MB, 15.5 us at 3.35 TB/s); the activations are a few KB. So the design
// reads every routed expert once, with coalesced 4-byte loads, and keeps the
// integer work cheap:
//
//   the wrapper builds, on the device, the unique routed experts (ascending
//   id) and per-expert gate rows (duplicates across rows summed);
//   phase A  grid (slot, 128-column tile of m): each block quantizes the rows
//            of x to the s8 pair (a1 = x_lo - x_hi/16, a2 = x_hi) in shared
//            memory, then g and u: the four packed rows of a 4-row group are
//            loaded as one 32-bit word per row, byte-transposed
//            (__byte_perm) so that each word holds four contraction rows of
//            one column, and fed to __dp4a as (w & 0x0F0F0F0F) and
//            (w ^ 0x80808080); the contraction is split over the 8 warps and
//            the int32 sums added exactly; h = silu(g) * u stays fp32;
//   phase B  grid (slot, 128-column tile of h): each block re-quantizes its
//            slot's h rows over all of m (the row maxima need the whole row,
//            hence the phase boundary), then the down dots the same way;
//   phase C  out = sum over slots of gate * y, in ascending slot order
//            (deterministic, no atomics).
//
// The integer sums are exact, so up to the fp32 epilogue the kernel computes
// what its plain version does. Slots past the number of unique experts (read
// from device memory, no host sync) exit at once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;  // output columns per block: 32 lanes x 4 bytes

// Shared memory: a1, a2 [R][n/2] s8, st [R][4], scratch, then the per-warp
// partial sums red [kWarps][R][kCols] of NACC ints each.
template <int R, int NACC>
struct Smem {
  static size_t bytes(int n) {
    return align16((size_t)2 * R * (n / 2)) + align16(4 * R * sizeof(float)) + align16(64 * R * sizeof(float)) +
           (size_t)kWarps * R * kCols * NACC * sizeof(int);
  }
};

// The R-row dot products of one 128-column tile of a packed (K/2, ncols)
// table: acc[r][c][2p], acc[r][c][2p+1] are the two integer dots of table p.
// Each warp takes the 4-row groups warp, warp + 8, ... of the K/2 packed rows.
template <int R, int NT>
__device__ __forceinline__ void q4_dots(const uint8_t* const (&p)[NT], int kh, size_t ld, const int8_t* a1,
                                        const int8_t* a2, int (&acc)[R][4][2 * NT]) {
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < kh / 4; g += kWarps) {
    const int i = 4 * g;
    uint32_t t[NT][4];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      uint32_t w[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) w[rr] = __ldg(reinterpret_cast<const uint32_t*>(p[q] + (size_t)(i + rr) * ld));
      transpose4x4(w, t[q]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int x1 = *reinterpret_cast<const int*>(a1 + r * kh + i);
      const int x2 = *reinterpret_cast<const int*>(a2 + r * kh + i);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c][2 * q] = __dp4a(x1, nib_lo(t[q][c]), acc[r][c][2 * q]);
          acc[r][c][2 * q + 1] = __dp4a(x2, nib_x80(t[q][c]), acc[r][c][2 * q + 1]);
        }
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads) q4_up_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ q1, const float* __restrict__ s1,
    const uint8_t* __restrict__ q3, const float* __restrict__ s3, const int* __restrict__ slot_expert,
    const int* __restrict__ n_unique, float* __restrict__ hbuf, int n_rows, int h, int m) {
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int hh = h / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < m;  // m % 8 == 0: a word never straddles the edge

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* a1 = reinterpret_cast<int8_t*>(smem);
  int8_t* a2 = a1 + R * hh;
  float* st = reinterpret_cast<float*>(smem + align16((size_t)2 * R * hh));
  float* fscratch = st + 4 * R;
  int* red = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(fscratch) + align16(64 * R * sizeof(float)));

  const uint8_t* const p[2] = {q1 + (size_t)e * hh * m + (active ? col : 0), q3 + (size_t)e * hh * m + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const bf16* xr = x + (size_t)r0 * h;
    quant_pair_rows<R>([&](int r, int i) { return __bfloat162float(xr[(size_t)r * h + i]); }, nr, h, a1, a2, st,
                       fscratch, reinterpret_cast<int*>(fscratch));
    int acc[R][4][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][c][k] = 0;
    if (active) q4_dots<R, 2>(p, hh, m, a1, a2, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<int4*>(red + ((size_t)(warp * R + r) * kCols + 4 * lane + c) * 4) =
            make_int4(acc[r][c][0], acc[r][c][1], acc[r][c][2], acc[r][c][3]);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * kCols; idx += kThreads) {
      const int r = idx / kCols, c = idx % kCols;
      if (col0 + c >= m) continue;
      int4 s = make_int4(0, 0, 0, 0);
      for (int w = 0; w < kWarps; ++w) {
        const int4 t = *reinterpret_cast<const int4*>(red + ((size_t)(w * R + r) * kCols + c) * 4);
        s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
      }
      const size_t j = (size_t)e * m + col0 + c;
      const float g = __fmul_rn(mm4_epilogue(s.x, s.y, st + 4 * r), s1[j]);
      const float u = __fmul_rn(mm4_epilogue(s.z, s.w, st + 4 * r), s3[j]);
      hbuf[((size_t)slot * n_rows + r0 + r) * m + col0 + c] = __fmul_rn(silu_exact(g), u);
    }
    __syncthreads();
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads) q4_down_kernel(
    const float* __restrict__ hbuf, const uint8_t* __restrict__ q2, const float* __restrict__ s2,
    const int* __restrict__ slot_expert, const int* __restrict__ n_unique, float* __restrict__ ybuf, int n_rows,
    int h, int m) {
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int mh = m / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + 4 * lane;
  const bool active = col < h;

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* b1 = reinterpret_cast<int8_t*>(smem);
  int8_t* b2 = b1 + R * mh;
  float* st = reinterpret_cast<float*>(smem + align16((size_t)2 * R * mh));
  float* fscratch = st + 4 * R;
  int* red = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(fscratch) + align16(64 * R * sizeof(float)));

  const uint8_t* const p[1] = {q2 + (size_t)e * mh * h + (active ? col : 0)};
  for (int r0 = 0; r0 < n_rows; r0 += R) {
    const int nr = min(R, n_rows - r0);
    const float* hr = hbuf + ((size_t)slot * n_rows + r0) * m;
    quant_pair_rows<R>([&](int r, int i) { return hr[(size_t)r * m + i]; }, nr, m, b1, b2, st, fscratch,
                       reinterpret_cast<int*>(fscratch));
    int acc[R][4][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c][0] = acc[r][c][1] = 0;
    if (active) q4_dots<R, 1>(p, mh, h, b1, b2, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<int2*>(red + ((size_t)(warp * R + r) * kCols + 4 * lane + c) * 2) =
            make_int2(acc[r][c][0], acc[r][c][1]);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * kCols; idx += kThreads) {
      const int r = idx / kCols, c = idx % kCols;
      if (col0 + c >= h) continue;
      int2 s = make_int2(0, 0);
      for (int w = 0; w < kWarps; ++w) {
        const int2 t = *reinterpret_cast<const int2*>(red + ((size_t)(w * R + r) * kCols + c) * 2);
        s.x += t.x; s.y += t.y;
      }
      ybuf[((size_t)slot * n_rows + r0 + r) * h + col0 + c] =
          __fmul_rn(mm4_epilogue(s.x, s.y, st + 4 * r), s2[(size_t)e * h + col0 + c]);
    }
    __syncthreads();
  }
}

template <int R>
cudaError_t launch_q4(const bf16* x, const uint8_t* q1, const float* s1, const uint8_t* q3, const float* s3,
                      const uint8_t* q2, const float* s2, const int* slot_expert, const int* n_unique,
                      const float* gates, float* hbuf, float* ybuf, bf16* out, int n_rows, int n_slots, int h, int m,
                      cudaStream_t stream) {
  const size_t up_smem = Smem<R, 4>::bytes(h), down_smem = Smem<R, 2>::bytes(m);
  cudaError_t err = allow_dynamic_smem(q4_up_kernel<R>, up_smem);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(q4_down_kernel<R>, down_smem);
  if (err != cudaSuccess) return err;
  q4_up_kernel<R><<<dim3(n_slots, (m + kCols - 1) / kCols), kThreads, up_smem, stream>>>(
      x, q1, s1, q3, s3, slot_expert, n_unique, hbuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q4_down_kernel<R><<<dim3(n_slots, (h + kCols - 1) / kCols), kThreads, down_smem, stream>>>(
      hbuf, q2, s2, slot_expert, n_unique, ybuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_slot_combine_kernel<<<dim3(n_rows, (h + 255) / 256), 256, 0, stream>>>(ybuf, gates, n_unique, out, n_rows, h);
  return cudaGetLastError();
}

}  // namespace

// x (n_rows, h) bf16; q1/q3 (E, h/2, m) and q2 (E, m/2, h) uint8 split-halves
// packed int4 for ONE layer with fp32 scales s1/s3 (E, 1, m) and s2 (E, 1, h);
// slot_expert (n_slots,) int32 unique routed experts first; n_unique (1,)
// int32; gates (n_slots, n_rows) fp32; scratch hbuf (n_slots, n_rows, m) and
// ybuf (n_slots, n_rows, h) fp32; out (n_rows, h) bf16. h and m must be
// multiples of 8 (the wrapper checks). Rows are taken four at a time.
extern "C" int mu_moe_stream_q4s8(const void* x, const void* q1, const void* s1, const void* q3, const void* s3,
                                  const void* q2, const void* s2, const void* slot_expert, const void* n_unique,
                                  const void* gates, void* hbuf, void* ybuf, void* out, int n_rows, int n_slots,
                                  int h, int m, void* stream) {
#define MU_Q4_ARGS                                                                                               \
  static_cast<const bf16*>(x), static_cast<const uint8_t*>(q1), static_cast<const float*>(s1),                   \
      static_cast<const uint8_t*>(q3), static_cast<const float*>(s3), static_cast<const uint8_t*>(q2),           \
      static_cast<const float*>(s2), static_cast<const int*>(slot_expert), static_cast<const int*>(n_unique),    \
      static_cast<const float*>(gates), static_cast<float*>(hbuf), static_cast<float*>(ybuf),                   \
      static_cast<bf16*>(out), n_rows, n_slots, h, m, static_cast<cudaStream_t>(stream)
  cudaError_t err;
  if (n_rows <= 1) {
    err = launch_q4<1>(MU_Q4_ARGS);
  } else if (n_rows <= 2) {
    err = launch_q4<2>(MU_Q4_ARGS);
  } else {
    err = launch_q4<4>(MU_Q4_ARGS);
  }
#undef MU_Q4_ARGS
  return (int)err;
}
