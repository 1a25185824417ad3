// Decode-shape MoE: sum over routed experts of gate * (silu(x@w1[e]) * (x@w3[e])) @ w2[e].
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/moe_stream.py
// (moe_experts_stream -> _kernel). On the H100 this op is bound by the bytes
// of expert weights it reads: at the bf16 16B-A3B shape one expert is
// 3 x 2048 x 1408 x 2 B = 17.3 MB, and a 2-row CFG decode step routes up to
// 12 experts per layer (about 208 MB per layer, 62 us at 3.35 TB/s); the
// activations are a few KB. The design therefore reads every routed expert's
// weights exactly once, and keeps enough blocks in flight to stream them:
//
//   the wrapper builds, on the device, the list of unique routed experts
//   (ascending id) and per-expert gate rows (duplicates across rows summed);
//   phase A  grid (slot, 64-column tile of m): h = silu(x@w1) * (x@w3) for
//            all token rows, stored in bf16 like the TPU kernel's h; 16-byte
//            weight loads, the contraction split over the block's threads;
//   phase B  grid (slot, 128-column tile of h): y[slot] = h[slot] @ w2[e] in fp32;
//   phase C  out = sum over slots of gate[slot] * y[slot], in ascending slot
//            order, so the result is deterministic (no atomics).
//
// The TPU kernel carries one fp32 accumulator across a sequential grid; blocks
// on Hopper run in parallel, so the cross-expert sum is the separate phase C.
// Tables are (E, h, m) / (E, m, h) row-major with the contraction on rows:
// threads of a warp take neighbouring columns, so every weight load is
// coalesced. Slots past the number of unique experts (read from device memory,
// no host sync) exit at once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 64;                 // phase B: bf16x2 column pairs per block (128 columns of h)
constexpr int kSplit = kThreads / kPairs;  // phase B: contraction splits inside a block

// Phase A tiling: 64 columns of m per block. Each thread loads VEC columns of
// one table row at once (16 bytes when ROWS <= 2) and keeps 2 * ROWS * VEC
// <= 32 running sums; the block's other threads split the contraction.
template <int ROWS>
struct UpShape {
  static constexpr int VEC = ROWS <= 2 ? 8 : 16 / ROWS;
  static constexpr int COLS = 64;
  static constexpr int CT = COLS / VEC;         // column threads
  static constexpr int SPLIT = kThreads / CT;   // contraction splits
};

template <int VEC> struct VecBits;
template <> struct VecBits<8> { typedef uint4 T; };
template <> struct VecBits<4> { typedef uint2 T; };
template <> struct VecBits<2> { typedef unsigned int T; };

template <int VEC>
__device__ __forceinline__ void load_bf16(const bf16* p, float (&out)[VEC]) {
  const typename VecBits<VEC>::T raw = *reinterpret_cast<const typename VecBits<VEC>::T*>(p);
  const bf162* pairs = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads) stream_up_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ w3,
    const int* __restrict__ slot_expert, const int* __restrict__ n_unique, bf16* __restrict__ hbuf,
    int n_rows, int h, int m) {
  typedef UpShape<ROWS> S;
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int ct = threadIdx.x % S::CT;
  const int split = threadIdx.x / S::CT;
  const int col0 = blockIdx.y * S::COLS;
  const int col = col0 + ct * S::VEC;
  const bool active = col < m;  // m is a multiple of 8, so a vector never straddles the edge

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                                                    // [ROWS][h]
  float2* red = reinterpret_cast<float2*>(smem + align16((size_t)ROWS * h * sizeof(bf16)));  // [SPLIT][ROWS][COLS]

  const bf16* p1 = w1 + (size_t)e * h * m + col;
  const bf16* p3 = w3 + (size_t)e * h * m + col;
  const int span = h / S::SPLIT;
  const int i0 = split * span;

  for (int r0 = 0; r0 < n_rows; r0 += ROWS) {
    const int nr = min(ROWS, n_rows - r0);
    for (int idx = threadIdx.x; idx < ROWS * h; idx += kThreads) {
      xs[idx] = (idx / h) < nr ? x[(size_t)r0 * h + idx] : __float2bfloat16(0.0f);
    }
    __syncthreads();

    float g[ROWS][S::VEC], u[ROWS][S::VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int v = 0; v < S::VEC; ++v) g[r][v] = u[r][v] = 0.0f;
    }
    if (active) {
#pragma unroll 2
      for (int i = i0; i < i0 + span; ++i) {
        float a[S::VEC], b[S::VEC];
        load_bf16<S::VEC>(p1 + (size_t)i * m, a);
        load_bf16<S::VEC>(p3 + (size_t)i * m, b);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv = __bfloat162float(xs[r * h + i]);
#pragma unroll
          for (int v = 0; v < S::VEC; ++v) {
            g[r][v] = fmaf(xv, a[v], g[r][v]);
            u[r][v] = fmaf(xv, b[v], u[r][v]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int v = 0; v < S::VEC; ++v)
        red[(split * ROWS + r) * S::COLS + ct * S::VEC + v] = make_float2(g[r][v], u[r][v]);
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < nr * S::COLS; idx += kThreads) {
      const int r = idx / S::COLS;
      const int c = idx % S::COLS;
      if (col0 + c >= m) continue;
      float2 s = make_float2(0.0f, 0.0f);
      for (int sp = 0; sp < S::SPLIT; ++sp) {
        const float2 t = red[(sp * ROWS + r) * S::COLS + c];
        s.x += t.x;
        s.y += t.y;
      }
      hbuf[((size_t)slot * n_rows + r0 + r) * m + col0 + c] = __float2bfloat16(silu_f32(s.x) * s.y);
    }
    __syncthreads();
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads) stream_down_kernel(
    const bf16* __restrict__ hbuf, const bf16* __restrict__ w2, const int* __restrict__ slot_expert,
    const int* __restrict__ n_unique, float* __restrict__ ybuf, int n_rows, int h, int m) {
  const int slot = blockIdx.x;
  if (slot >= n_unique[0]) return;
  const int e = slot_expert[slot];
  const int pair = threadIdx.x % kPairs;
  const int split = threadIdx.x / kPairs;
  const int col = (blockIdx.y * kPairs + pair) * 2;
  const bool active = col < h;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);                                   // [ROWS][m]
  float2* red = reinterpret_cast<float2*>(smem + align16((size_t)ROWS * m * sizeof(bf16)));  // [kSplit][ROWS][kPairs]

  const size_t stride = (size_t)h / 2;
  const bf162* p2 = reinterpret_cast<const bf162*>(w2 + (size_t)e * m * h) + col / 2;
  const int span = m / kSplit;
  const int j0 = split * span;

  for (int r0 = 0; r0 < n_rows; r0 += ROWS) {
    const int nr = min(ROWS, n_rows - r0);
    const bf16* src = hbuf + ((size_t)slot * n_rows + r0) * m;
    for (int idx = threadIdx.x; idx < ROWS * m; idx += kThreads) {
      hs[idx] = (idx / m) < nr ? src[idx] : __float2bfloat16(0.0f);
    }
    __syncthreads();

    float acc[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = 0.0f;
    if (active) {
#pragma unroll 4
      for (int j = j0; j < j0 + span; ++j) {
        const float2 w = __bfloat1622float2(p2[j * stride]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float hv = __bfloat162float(hs[r * m + j]);
          acc[r][0] = fmaf(hv, w.x, acc[r][0]);
          acc[r][1] = fmaf(hv, w.y, acc[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) red[(split * ROWS + r) * kPairs + pair] = make_float2(acc[r][0], acc[r][1]);
    __syncthreads();

    if (split == 0 && active) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nr) {
          float2 s = red[r * kPairs + pair];
#pragma unroll
          for (int sp = 1; sp < kSplit; ++sp) {
            const float2 t = red[(sp * ROWS + r) * kPairs + pair];
            s.x += t.x; s.y += t.y;
          }
          *reinterpret_cast<float2*>(ybuf + ((size_t)slot * n_rows + r0 + r) * h + col) = s;
        }
      }
    }
    __syncthreads();
  }
}

template <int ROWS>
cudaError_t launch_stream(const bf16* x, const bf16* w1, const bf16* w3, const bf16* w2, const int* slot_expert,
                          const int* n_unique, const float* gates, bf16* hbuf, float* ybuf, bf16* out, int n_rows,
                          int n_slots, int h, int m, cudaStream_t stream) {
  typedef UpShape<ROWS> S;
  const size_t up_smem = align16((size_t)ROWS * h * sizeof(bf16)) + (size_t)S::SPLIT * ROWS * S::COLS * sizeof(float2);
  const size_t down_smem = align16((size_t)ROWS * m * sizeof(bf16)) + (size_t)kSplit * ROWS * kPairs * sizeof(float2);
  cudaError_t err = allow_dynamic_smem(stream_up_kernel<ROWS>, up_smem);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(stream_down_kernel<ROWS>, down_smem);
  if (err != cudaSuccess) return err;

  const int cols_per_block = 2 * kPairs;
  dim3 up_grid(n_slots, (m + S::COLS - 1) / S::COLS);
  stream_up_kernel<ROWS><<<up_grid, kThreads, up_smem, stream>>>(x, w1, w3, slot_expert, n_unique, hbuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 down_grid(n_slots, (h + cols_per_block - 1) / cols_per_block);
  stream_down_kernel<ROWS><<<down_grid, kThreads, down_smem, stream>>>(hbuf, w2, slot_expert, n_unique, ybuf, n_rows, h, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 comb_grid(n_rows, (h + kThreads - 1) / kThreads);
  moe_slot_combine_kernel<<<comb_grid, kThreads, 0, stream>>>(ybuf, gates, n_unique, out, n_rows, h);
  return cudaGetLastError();
}

}  // namespace

// x (n_rows, h) bf16; w1/w3 (E, h, m) and w2 (E, m, h) bf16 for ONE layer;
// slot_expert (n_slots,) int32 unique routed experts first; n_unique (1,) int32;
// gates (n_slots, n_rows) fp32; scratch hbuf (n_slots, n_rows, m) bf16 and
// ybuf (n_slots, n_rows, h) fp32; out (n_rows, h) bf16. h must be a multiple
// of 32 and m of 8 (the wrapper checks).
extern "C" int mu_moe_stream_bf16(const void* x, const void* w1, const void* w3, const void* w2,
                                  const void* slot_expert, const void* n_unique, const void* gates, void* hbuf,
                                  void* ybuf, void* out, int n_rows, int n_slots, int h, int m, void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w3b = static_cast<const bf16*>(w3);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const int* se = static_cast<const int*>(slot_expert);
  const int* nu = static_cast<const int*>(n_unique);
  const float* gt = static_cast<const float*>(gates);
  bf16* hb = static_cast<bf16*>(hbuf);
  float* yb = static_cast<float*>(ybuf);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n_rows <= 1) {
    err = launch_stream<1>(xb, w1b, w3b, w2b, se, nu, gt, hb, yb, ob, n_rows, n_slots, h, m, st);
  } else if (n_rows <= 2) {
    err = launch_stream<2>(xb, w1b, w3b, w2b, se, nu, gt, hb, yb, ob, n_rows, n_slots, h, m, st);
  } else if (n_rows <= 4) {
    err = launch_stream<4>(xb, w1b, w3b, w2b, se, nu, gt, hb, yb, ob, n_rows, n_slots, h, m, st);
  } else {
    err = launch_stream<8>(xb, w1b, w3b, w2b, se, nu, gt, hb, yb, ob, n_rows, n_slots, h, m, st);
  }
  return (int)err;
}
