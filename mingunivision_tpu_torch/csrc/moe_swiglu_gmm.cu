// Prefill MoE: grouped SwiGLU over expert-sorted rows,
// ys[r] = (silu(x[tok[r]] @ w1[e]) * (x[tok[r]] @ w3[e])) @ w2[e] for the rows r of expert e.
//
// Replaces the TPU kernel mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py
// (swiglu_gmm -> _kernel, scheduled by megablox make_group_metadata and
// _get_store_mask). At the slice's prompt (128 tokens x top-6 = 768 rows over
// 64 experts) the op reads the whole 1.1 GB of a layer's expert tables once
// (330 us at 3.35 TB/s) and does 13 GFLOP, so it is bound by bytes first; at
// the understanding prompt's 1,152 tokens the same bytes and 120 GFLOP; at
// the train step's 12,288 rows (about 192 an expert) each table is read twice.
//
// Design: the wrapper builds the schedule on the device: tiles of at most 128
// rows (mu_swiglu_gmm_tile_rows) that start at each expert's first sorted row,
// so no tile straddles a group boundary and the store mask reduces to "row <
// group end". Each tile entry is (expert, first row, end row); a static upper
// bound of tiles is launched and empty entries exit at once (no host sync).
// The two launches (up, with silu * mul fused and the intermediate stored
// bf16; down) run swiglu_wgmma.cuh's body: wgmma bf16 products with fp32
// sums over a TMA-fed ring of the table tiles, x's rows gathered by token
// with cp.async, every table tile read once per 128-row tile. A kernel handed
// a longer tile traps.
#include "swiglu_wgmma.cuh"

// x (N, h) bf16 token rows; row_token (A,) int32 token of each expert-sorted
// row; w1/w3 (E, h, m) and w2 (E, m, h) bf16 for ONE layer; sched (n_tiles, 3)
// int32 (expert, first row, end row), empty entries have first == end, tiles
// of at most mu_swiglu_gmm_tile_rows() rows; scratch hbuf (A, m) bf16; out
// ys (A, h) bf16 in sorted row order. h and m multiples of 64 and every
// operand 16-byte aligned (the wrapper checks), else cudaErrorInvalidValue.
extern "C" int mu_swiglu_gmm_bf16(const void* x, const void* row_token, const void* w1, const void* w3,
                                  const void* w2, const void* sched, void* hbuf, void* ys, int n_tiles, int R, int E,
                                  int h, int m, void* stream) {
  return swg::launch_swiglu<swg::Tab::kBf16>(x, row_token, w1, nullptr, w3, nullptr, w2, nullptr, sched, hbuf, ys,
                                             n_tiles, R, E, h, m, static_cast<cudaStream_t>(stream));
}

// Rows per tile the kernels were compiled for; the wrapper builds its schedule with it.
extern "C" int mu_swiglu_gmm_tile_rows(void) { return swg::BM; }
