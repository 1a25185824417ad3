"""Prefill MoE: the CUDA grouped-SwiGLU kernels `csrc/moe_swiglu_gmm.cu` (bf16
tables), `csrc/moe_swiglu_gmm_q4.cu` (int4 tables, exact dequant) and
`csrc/moe_swiglu_gmm_q8.cu` (int8 tables, exact dequant), their group
schedule, and their plain versions.

Replaces the TPU kernels of mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py
(`moe_experts_swiglu_gmm` -> `swiglu_gmm` -> `_kernel` for bf16 tables,
`swiglu_gmm_quant` -> `_swiglu_gmm_q4_chunked` -> `_kernel_q4_chunked` for
linear int4 tables, `_swiglu_gmm_q8` -> `_kernel_q8_chunked` for int8 tables,
whose s8 variant the JAX package leaves off: INT_DOT_PREFILL_INT8 = False)
and the megablox `make_group_metadata` /
`_get_store_mask` schedule they relied on. What bounds
it on the H100 is the bytes of the expert tables (1.1 GB per layer at the
16B-A3B width when every expert is routed), then the 13 GFLOP of a 128-token
prompt. The schedule tiles each expert's sorted rows from the expert's first
row, so every block reads one expert's weight tile for at most the kernel's
tile rows, no tile straddles a group boundary, and the store mask is the
tile's row bound.
The tables are read as (E, h, m)/(E, m, h) layer views, never copied or cast;
int4 and int8 tables are converted in the kernels' load paths (a quarter and
a half of the bf16 bytes).

Both kernels read x through a row map (the token of each row) and a schedule
of (expert, first row, end row) tiles, so a dispatch is two steps: build the
row map and schedule, then `swiglu_gmm_rows` (check, launch, count). This
module's dispatch sorts the assignments by expert (`group_schedule`);
ops/kernels/moe_capacity.py places them sort-free into per-expert slots and
launches the same kernels through `swiglu_gmm_rows`.

`moe_experts_swiglu_gmm` dispatches on the table type. `swiglu_gmm_rows` runs
the plain version (`swiglu_rows_plain`) for CPU tensors only; for CUDA tensors
it launches its kernel or raises. The launch counts stay on
`moe_experts_swiglu_gmm` (bf16 tables), `moe_experts_swiglu_gmm_q4` and
`moe_experts_swiglu_gmm_q8`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.moe_stream import (
    check_q4_tables,
    check_q8_tables,
    check_tables,
    layer_tables,
    table_kind,
)


def group_schedule(topk_idx: torch.Tensor, num_experts: int, tile_rows: int):
    """Expert-sorted row order and the (expert, row-tile) schedule, on the device.

    Returns (order (A,) int64: flat assignment of each sorted row;
    row_token (A,) int32: its token; sched (n_tiles, 3) int32 rows of
    (expert, first row, end row)). n_tiles = ceil(A / tile_rows) + E is a
    static bound on sum_e ceil(size_e / tile_rows); unused entries are empty
    (first row == end row == 0), so no host sync is needed.
    """
    N, k = topk_idx.shape
    A = N * k
    E = num_experts
    dev = topk_idx.device
    flat = topk_idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    row_token = (order // k).to(torch.int32)
    sizes = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(0, flat, torch.ones_like(flat))
    ends = sizes.cumsum(0)
    starts = ends - sizes
    tiles = (sizes + tile_rows - 1) // tile_rows
    tile_end = tiles.cumsum(0)
    tile_start = tile_end - tiles
    t = torch.arange(-(-A // tile_rows) + E, device=dev)
    e = torch.searchsorted(tile_end, t, right=True).clamp_(max=E - 1)
    r0 = starts[e] + (t - tile_start[e]) * tile_rows
    r1 = torch.minimum(r0 + tile_rows, ends[e])
    valid = t < tile_end[-1]
    zero = torch.zeros_like(r0)
    sched = torch.stack([e, torch.where(valid, r0, zero), torch.where(valid, r1, zero)], dim=1)
    return order, row_token, sched.to(torch.int32).contiguous()


def _nibbles(q: torch.Tensor) -> torch.Tensor:
    """Packed split-halves int4 (n/2, cols) -> the unscaled weights (n, cols) fp32, exact."""
    return torch.cat([(q & 0xF).float() - 8.0, (q >> 4).float() - 8.0], dim=-2)


def swiglu_rows_plain(experts, xr, row_expert, num_experts: int, *, layer_idx=None):
    """Plain PyTorch of both kernels over explicit rows: ys[r] = expert
    row_expert[r] applied to xr[r]; rows whose expert is outside [0, E) give
    zeros. One expert at a time: fp32 g/u, a = silu(g) * u rounded to x's
    dtype, fp32 down product rounded to x's dtype per row (as the kernels
    store it). int4 and int8 tables (`_kernel_q4_chunked`,
    `_kernel_q8_chunked`): exact dequant with the scale applied to the fp32
    sums, g = (x @ nibbles) * s1, g = (x @ q) * s1 and so on."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    kind = table_kind("swiglu_rows_plain", experts)
    unscaled = {"int4": _nibbles, "int8": lambda q: q.float()}.get(kind)
    ys = torch.zeros_like(xr)
    for e in range(num_experts):
        sel = (row_expert == e).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        xe = xr[sel].float()
        if unscaled is not None:
            g = (xe @ unscaled(w1.q[e])) * w1.s[e]
            u = (xe @ unscaled(w3.q[e])) * w3.s[e]
            a = (F.silu(g) * u).to(xr.dtype).float()
            ys[sel] = ((a @ unscaled(w2.q[e])) * w2.s[e]).to(xr.dtype)
        else:
            a = (F.silu(xe @ w1[e].float()) * (xe @ w3[e].float())).to(xr.dtype).float()
            ys[sel] = (a @ w2[e].float()).to(xr.dtype)
    return ys


def combine_assignments(per, topk_w, dtype):
    """The gate-weighted fp32 sum of each token's k assignment rows: per (N * k, h) -> (N, h)."""
    N, k = topk_w.shape
    return (per.reshape(N, k, -1).float() * topk_w.float()[..., None]).sum(dim=1).to(dtype)


def moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """Plain version of `moe_experts_swiglu_gmm` for either table type: every
    assignment row through `swiglu_rows_plain`, then the gate-weighted fp32 combine."""
    k = topk_idx.shape[1]
    ys = swiglu_rows_plain(experts, x_flat.repeat_interleave(k, dim=0), topk_idx.reshape(-1), num_experts,
                           layer_idx=layer_idx)
    return combine_assignments(ys, topk_w, x_flat.dtype)


def moe_experts_swiglu_gmm_bf16_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """The plain version, over floating tables only."""
    if table_kind("moe_experts_swiglu_gmm_bf16_plain", experts) != "plain":
        raise ValueError("moe_experts_swiglu_gmm_bf16_plain: needs floating tables")
    return moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)


def moe_experts_swiglu_gmm_q4_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """The plain version, over linear int4 tables only."""
    if table_kind("moe_experts_swiglu_gmm_q4_plain", experts) != "int4":
        raise ValueError("moe_experts_swiglu_gmm_q4_plain: needs linear int4 tables")
    return moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)


def moe_experts_swiglu_gmm_q8_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """The plain version, over int8 tables only."""
    if table_kind("moe_experts_swiglu_gmm_q8_plain", experts) != "int8":
        raise ValueError("moe_experts_swiglu_gmm_q8_plain: needs int8 tables")
    return moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)


def tile_rows() -> int:
    """Rows per schedule tile the kernels were compiled for."""
    return build.load().mu_swiglu_gmm_tile_rows()


def swiglu_gmm_rows(experts, x_flat, row_token, row_expert, sched, num_experts: int, *, layer_idx=None):
    """Launch the grouped-SwiGLU kernel of the table type over a prepared
    schedule; returns ys (R, h) in x's dtype, row r holding expert(x[row_token[r]]).

    row_token (R,) int32: the token each row reads; sched (n_tiles, 3) int32
    (expert, first row, end row), empty tiles first == end; rows that no tile
    covers are left unwritten. row_expert (R,) (the expert of each row, outside
    [0, E) for rows no tile covers) is read by the CPU path only, which runs
    `swiglu_rows_plain` and has no use for `sched`."""
    if x_flat.device.type == "cpu":
        return swiglu_rows_plain(experts, x_flat[row_token.long()], row_expert, num_experts, layer_idx=layer_idx)
    w1, w3, w2 = layer_tables(experts, layer_idx)
    kind = table_kind("swiglu_gmm_rows", experts)
    name, check, wrapper = {"int4": ("mu_swiglu_gmm_q4", check_q4_tables, moe_experts_swiglu_gmm_q4),
                            "int8": ("mu_swiglu_gmm_q8", check_q8_tables, moe_experts_swiglu_gmm_q8)}.get(
        kind, ("mu_swiglu_gmm_bf16", check_tables, moe_experts_swiglu_gmm))
    E, h, m = check(wrapper.__name__, x_flat, w1, w3, w2)
    if E != num_experts or h % 64 or m % 64:
        raise ValueError(f"{wrapper.__name__}: needs {num_experts} experts and h, m multiples of 64 "
                         f"(E={E}, h={h}, m={m})")
    x = x_flat.contiguous()
    R = row_token.numel()
    hbuf = torch.empty((R, m), dtype=torch.bfloat16, device=x.device)
    ys = torch.empty((R, h), dtype=torch.bfloat16, device=x.device)
    if kind == "plain":
        tables = (w1.data_ptr(), w3.data_ptr(), w2.data_ptr())
    else:  # the quantized kernels take (q1, s1, q3, s3, q2, s2)
        tables = tuple(p for w in (w1, w3, w2) for p in (w.q.data_ptr(), w.s.data_ptr()))
    rc = getattr(build.load(), name)(
        x.data_ptr(), row_token.data_ptr(), *tables, sched.data_ptr(), hbuf.data_ptr(), ys.data_ptr(),
        sched.shape[0], h, m, build.stream_handle(x),
    )
    build.check(rc, name)
    wrapper.launches += 1
    return ys


def moe_experts_swiglu_gmm(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """Prefill-path MoE through the expert-sorted dispatch. x_flat (N, h);
    topk_idx/topk_w (N, k) -> (N, h). bf16 tables go to `csrc/moe_swiglu_gmm.cu`,
    linear int4 tables to `csrc/moe_swiglu_gmm_q4.cu`, int8 tables to
    `csrc/moe_swiglu_gmm_q8.cu`."""
    if x_flat.device.type == "cpu":
        return moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)
    order, row_token, sched = group_schedule(topk_idx, num_experts, tile_rows())
    ys = swiglu_gmm_rows(experts, x_flat, row_token, None, sched, num_experts, layer_idx=layer_idx)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return combine_assignments(ys.index_select(0, inv), topk_w, x_flat.dtype)


def moe_experts_swiglu_gmm_q4(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """`moe_experts_swiglu_gmm` for linear int4 tables only (the name that
    carries the int4 kernel's launch count)."""
    if table_kind("moe_experts_swiglu_gmm_q4", experts) != "int4":
        raise ValueError("moe_experts_swiglu_gmm_q4: needs linear int4 tables")
    return moe_experts_swiglu_gmm(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)


def moe_experts_swiglu_gmm_q8(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """`moe_experts_swiglu_gmm` for int8 tables only (the name that carries the
    int8 kernel's launch count)."""
    if table_kind("moe_experts_swiglu_gmm_q8", experts) != "int8":
        raise ValueError("moe_experts_swiglu_gmm_q8: needs int8 tables")
    return moe_experts_swiglu_gmm(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)


moe_experts_swiglu_gmm.launches = 0
moe_experts_swiglu_gmm_q4.launches = 0
moe_experts_swiglu_gmm_q8.launches = 0
