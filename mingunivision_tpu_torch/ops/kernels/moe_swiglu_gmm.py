"""Prefill MoE: the CUDA grouped-SwiGLU kernels `csrc/moe_swiglu_gmm.cu` (bf16
tables) and `csrc/moe_swiglu_gmm_q4.cu` (int4 tables, exact dequant), their
group schedule, and their plain versions.

Replaces the TPU kernels of mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py
(`moe_experts_swiglu_gmm` -> `swiglu_gmm` -> `_kernel` for bf16 tables,
`swiglu_gmm_quant` -> `_swiglu_gmm_q4_chunked` -> `_kernel_q4_chunked` for
linear int4 tables) and the megablox `make_group_metadata` /
`_get_store_mask` schedule they relied on. What bounds
it on the H100 is the bytes of the expert tables (1.1 GB per layer at the
16B-A3B width when every expert is routed), then the 13 GFLOP of a 128-token
prompt. The schedule tiles each expert's sorted rows from the expert's first
row, so every block reads one expert's weight tile for at most the kernel's
tile rows, no tile straddles a group boundary, and the store mask is the
tile's row bound.
The tables are read as (E, h, m)/(E, m, h) layer views, never copied or cast;
int4 tables are unpacked in the kernel's load path (a quarter of the bf16 bytes).

`moe_experts_swiglu_gmm` dispatches on the table type. Each wrapper runs its
plain version for CPU tensors only; for CUDA tensors it launches its kernel or
raises. The sort, the schedule, the un-sort and the fp32 combine are shared.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.moe_stream import check_q4_tables, check_tables, layer_tables, table_kind


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


def _combine(ys, order, topk_w, dtype):
    """Unsort the per-assignment rows and take the gate-weighted fp32 sum."""
    N, k = topk_w.shape
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    per = ys.index_select(0, inv).reshape(N, k, -1).float()
    return (per * topk_w.float()[..., None]).sum(dim=1).to(dtype)


def moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """Plain version of `moe_experts_swiglu_gmm`, dispatching on the table type."""
    if table_kind("moe_experts_swiglu_gmm_plain", experts) == "int4":
        return moe_experts_swiglu_gmm_q4_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)
    return moe_experts_swiglu_gmm_bf16_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)


def moe_experts_swiglu_gmm_bf16_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """Plain PyTorch, one expert at a time over its assignment rows: fp32 g/u,
    h rounded to x's dtype, fp32 down product rounded to x's dtype per row
    (as the kernel stores it), then the gate-weighted fp32 combine."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    N, k = topk_idx.shape
    flat = topk_idx.reshape(-1)
    xr = x_flat.repeat_interleave(k, dim=0)
    ys = torch.zeros_like(xr)
    for e in range(num_experts):
        sel = (flat == e).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        xe = xr[sel].float()
        a = (F.silu(xe @ w1[e].float()) * (xe @ w3[e].float())).to(x_flat.dtype).float()
        ys[sel] = (a @ w2[e].float()).to(x_flat.dtype)
    y = ys.float().reshape(N, k, -1) * topk_w.float()[..., None]
    return y.sum(dim=1).to(x_flat.dtype)


def moe_experts_swiglu_gmm(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """Prefill-path MoE. x_flat (N, h); topk_idx/topk_w (N, k) -> (N, h).
    Linear int4 tables go to `moe_experts_swiglu_gmm_q4`."""
    if table_kind("moe_experts_swiglu_gmm", experts) == "int4":
        return moe_experts_swiglu_gmm_q4(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)
    if x_flat.device.type == "cpu":
        return moe_experts_swiglu_gmm_bf16_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)
    w1, w3, w2 = layer_tables(experts, layer_idx)
    E, h, m = check_tables("moe_experts_swiglu_gmm", x_flat, w1, w3, w2)
    if E != num_experts or h % 64 or m % 64:
        raise ValueError(f"moe_experts_swiglu_gmm: needs {num_experts} experts and h, m multiples of 64 "
                         f"(E={E}, h={h}, m={m})")
    x = x_flat.contiguous()
    lib = build.load()
    order, row_token, sched = group_schedule(topk_idx, E, lib.mu_swiglu_gmm_tile_rows())
    A = order.numel()
    hbuf = torch.empty((A, m), dtype=torch.bfloat16, device=x.device)
    ys = torch.empty((A, h), dtype=torch.bfloat16, device=x.device)
    rc = lib.mu_swiglu_gmm_bf16(
        x.data_ptr(), row_token.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(), sched.data_ptr(),
        hbuf.data_ptr(), ys.data_ptr(), sched.shape[0], h, m, build.stream_handle(x),
    )
    build.check(rc, "mu_swiglu_gmm_bf16")
    moe_experts_swiglu_gmm.launches += 1
    return _combine(ys, order, topk_w, x.dtype)


moe_experts_swiglu_gmm.launches = 0


def _nibbles(q: torch.Tensor) -> torch.Tensor:
    """Packed split-halves int4 (n/2, cols) -> the unscaled weights (n, cols) fp32, exact."""
    return torch.cat([(q & 0xF).float() - 8.0, (q >> 4).float() - 8.0], dim=-2)


def moe_experts_swiglu_gmm_q4_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """Plain PyTorch of the int4 prefill kernel (`_kernel_q4_chunked`): exact
    dequant, operands in x's dtype, fp32 sums. Per expert over its rows:
    g = (x @ nibbles) * s1, u likewise with s3, a = silu(g) * u
    rounded to x's dtype, y = (a @ w2) * s2 rounded to x's dtype; then the
    gate-weighted fp32 combine."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    N, k = topk_idx.shape
    flat = topk_idx.reshape(-1)
    xr = x_flat.repeat_interleave(k, dim=0)
    ys = torch.zeros_like(xr)
    for e in range(num_experts):
        sel = (flat == e).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        xe = xr[sel].float()
        g = (xe @ _nibbles(w1.q[e])) * w1.s[e]
        u = (xe @ _nibbles(w3.q[e])) * w3.s[e]
        a = (F.silu(g) * u).to(x_flat.dtype).float()
        ys[sel] = ((a @ _nibbles(w2.q[e])) * w2.s[e]).to(x_flat.dtype)
    y = ys.float().reshape(N, k, -1) * topk_w.float()[..., None]
    return y.sum(dim=1).to(x_flat.dtype)


def moe_experts_swiglu_gmm_q4(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """Prefill-path MoE over linear int4 tables (the CUDA kernel
    `csrc/moe_swiglu_gmm_q4.cu`). x_flat (N, h) bf16 -> (N, h)."""
    if x_flat.device.type == "cpu":
        return moe_experts_swiglu_gmm_q4_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx)
    w1, w3, w2 = layer_tables(experts, layer_idx)
    E, h, m = check_q4_tables("moe_experts_swiglu_gmm_q4", x_flat, w1, w3, w2)
    if E != num_experts or h % 64 or m % 64:
        raise ValueError(f"moe_experts_swiglu_gmm_q4: needs {num_experts} experts and h, m multiples of 64 "
                         f"(E={E}, h={h}, m={m})")
    x = x_flat.contiguous()
    lib = build.load()
    order, row_token, sched = group_schedule(topk_idx, E, lib.mu_swiglu_gmm_tile_rows())
    A = order.numel()
    hbuf = torch.empty((A, m), dtype=torch.bfloat16, device=x.device)
    ys = torch.empty((A, h), dtype=torch.bfloat16, device=x.device)
    rc = lib.mu_swiglu_gmm_q4(
        x.data_ptr(), row_token.data_ptr(), w1.q.data_ptr(), w1.s.data_ptr(), w3.q.data_ptr(), w3.s.data_ptr(),
        w2.q.data_ptr(), w2.s.data_ptr(), sched.data_ptr(), hbuf.data_ptr(), ys.data_ptr(), sched.shape[0], h, m,
        build.stream_handle(x),
    )
    build.check(rc, "mu_swiglu_gmm_q4")
    moe_experts_swiglu_gmm_q4.launches += 1
    return _combine(ys, order, topk_w, x.dtype)


moe_experts_swiglu_gmm_q4.launches = 0
