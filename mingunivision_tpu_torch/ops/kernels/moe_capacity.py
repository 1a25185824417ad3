"""Capacity-dense prefill MoE dispatch: sort-free placement of the assignments
into per-expert slots, then the grouped-SwiGLU kernels of
ops/kernels/moe_swiglu_gmm.py over one group per expert.

Replaces mingunivision_tpu/ops/kernels/moe_capacity.py (`expert_rank`,
`capacity_src_map`, `moe_experts_capacity_gmm`, `moe_experts_capacity_gmm_exact`,
`default_capacity`): glue over the TPU grouped-SwiGLU kernels with uniform
groups (`swiglu_gmm` for bf16 tables, `swiglu_gmm_quant` for int4 and int8
ones, in either dot mode: `s8`, as the JAX package's `s8=` at `:160, 226,
257, 290-293`). Assignment a (token a // k, expert e) gets slot e * C + rank, where
rank counts the earlier assignments to e in original order; the kernels read
x through the slot -> token map and a schedule whose tiles start at each
expert's first slot and end at its load (at most the launched kernel's tile
rows, `tile_rows`), so no tile straddles two experts,
each routed expert's tables are read once per row tile, and no sort or
un-sort runs. Each assignment's output row is gathered back by its slot and
the gate-weighted combine is fp32.

The placement is exact only while every expert's load fits its C slots;
`moe_experts_capacity_gmm_exact` checks that (one device scalar read per call)
and otherwise runs the expert-sorted dispatch. `token_valid` keeps the padding
rows of a right-padded prompt, which all route to the same experts, out of
that count and out of the slots.

What bounds the dispatch on the H100 is what bounds the kernels it launches
(the expert tables' bytes, then the products' operations). Its plain version
is the kernels' plain version (`swiglu_rows_plain`) behind the same placement;
a CPU tensor takes it inside `swiglu_gmm_rows`, a CUDA tensor launches.
"""

from __future__ import annotations

import torch

from mingunivision_tpu_torch.ops.kernels.moe_stream import table_kind
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import (
    combine_assignments,
    moe_experts_swiglu_gmm,
    moe_experts_swiglu_gmm_plain,
    swiglu_gmm_rows,
    swiglu_rows_plain,
    tile_rows,
)


def default_capacity(num_tokens: int, top_k: int, num_experts: int, factor: float = 2.0) -> int:
    """Slots per expert: `factor` x the mean expert load, rounded up to 64, at least 128."""
    mean = num_tokens * top_k / num_experts
    return max(128, int(-(-factor * mean // 64)) * 64)


def expert_rank(flat_e: torch.Tensor, num_experts: int):
    """Rank of each assignment within its expert (stable, original order) and
    the per-expert totals, without a sort: an exclusive running count of the
    one-hot rows. An id outside [0, E) counts nowhere and ranks 0.

    Returns (rank (A,) int32, group_sizes (E,) int32)."""
    # (E, A) so that the running count scans the contiguous dimension
    onehot = torch.arange(num_experts, device=flat_e.device)[:, None] == flat_e.long()[None, :]
    counts = onehot.to(torch.int32).cumsum(dim=1, dtype=torch.int32)
    rank = ((counts - 1) * onehot).sum(dim=0, dtype=torch.int32)
    sizes = counts[:, -1] if flat_e.numel() else torch.zeros(num_experts, dtype=torch.int32, device=flat_e.device)
    return rank, sizes


def capacity_schedule(flat_e, rank, sizes, num_experts: int, capacity: int, tile: int):
    """The slot placement as the kernels read it. Returns (dst (A,) int64: the
    slot e * C + rank of each assignment, E * C for one dropped (rank >= C, or
    expert id outside [0, E)); row_expert (E * C,) int32: the slot's expert,
    -1 while empty; sched (E * ceil(C / tile), 3) int32 tiles (expert, first
    slot, end slot) over the occupied part of every expert's slots, an empty
    tile as (expert, 0, 0); ok (A,) bool: the assignment has a slot)."""
    E, C = num_experts, capacity
    dev = flat_e.device
    e = flat_e.long()
    ok = (rank < C) & (e >= 0) & (e < E)
    dst = torch.where(ok, e * C + rank, E * C)
    slots = torch.arange(E * C, device=dev)
    slot_e = slots // C
    used = torch.minimum(sizes.long(), torch.tensor(C, device=dev))  # (E,)
    row_expert = torch.where(slots % C < used[slot_e], slot_e, -1).to(torch.int32)
    tiles_per_e = -(-C // tile)
    t = torch.arange(E * tiles_per_e, device=dev)
    te = t // tiles_per_e
    r0 = te * C + (t % tiles_per_e) * tile
    r1 = torch.minimum(r0 + tile, te * C + used[te])
    empty = r0 >= r1
    zero = torch.zeros_like(r0)
    sched = torch.stack([te, torch.where(empty, zero, r0), torch.where(empty, zero, r1)], dim=1)
    return dst, row_expert, sched.to(torch.int32).contiguous(), ok


def _capacity_gmm(experts, x_flat, topk_idx, topk_w, num_experts, capacity, layer_idx, plain: bool, s8: bool):
    N, k = topk_idx.shape
    E, C = num_experts, capacity
    flat_e = topk_idx.reshape(-1)
    rank, sizes = expert_rank(flat_e, E)
    on_kernel = not plain and x_flat.device.type != "cpu"
    kind = table_kind("moe_experts_capacity_gmm", experts)
    # each kernel's own tile rows; the plain version reads row_expert, not the tiles
    tile = tile_rows(kind, s8 and kind != "plain") if on_kernel else C
    dst, row_expert, sched, ok = capacity_schedule(flat_e, rank, sizes, E, C, tile)
    token = torch.arange(N * k, device=x_flat.device) // k
    row_token = torch.zeros(E * C + 1, dtype=torch.int32, device=x_flat.device)
    row_token[dst] = token.to(torch.int32)  # the dropped ones all land on the spare last entry
    row_token = row_token[: E * C]
    if plain:
        ys = swiglu_rows_plain(experts, x_flat[row_token.long()], row_expert, E, layer_idx=layer_idx, s8=s8)
    else:
        ys = swiglu_gmm_rows(experts, x_flat, row_token, row_expert, sched, E, layer_idx=layer_idx, s8=s8)
    if on_kernel:
        moe_experts_capacity_gmm.launches += 1
    per = ys.index_select(0, dst.clamp(max=E * C - 1))
    per = torch.where(ok[:, None], per, torch.zeros((), dtype=per.dtype, device=per.device))
    return combine_assignments(per, topk_w, x_flat.dtype)


def moe_experts_capacity_gmm(experts, x_flat, topk_idx, topk_w, num_experts: int, capacity: int, *, layer_idx=None,
                             s8: bool = False):
    """Capacity-dense top-k MoE through the grouped-SwiGLU kernels. Exact iff
    every expert's load is at most `capacity`: an assignment ranked past it,
    or one whose expert id is `num_experts` (a padding row routed out of
    bounds), contributes zero. x_flat (N, h); topk_idx/topk_w (N, k) -> (N, h).
    bf16, linear int4 and int8 tables (the kernels of the expert-sorted
    dispatch, the quantized ones in the dot mode `s8`)."""
    return _capacity_gmm(experts, x_flat, topk_idx, topk_w, num_experts, capacity, layer_idx, plain=False, s8=s8)


# launches of the table type's kernel through the capacity schedule (each also counts on that kernel's wrapper)
moe_experts_capacity_gmm.launches = 0


def _capacity_gmm_exact(experts, x_flat, topk_idx, topk_w, num_experts, capacity, token_valid, layer_idx, plain: bool,
                        s8: bool):
    if token_valid is not None:
        v = token_valid.reshape(-1)[:, None]
        ti_cap = torch.where(v, topk_idx, num_experts)
        tw_cap = torch.where(v, topk_w, torch.zeros((), dtype=topk_w.dtype, device=topk_w.device))
    else:
        ti_cap, tw_cap = topk_idx, topk_w
    flat = ti_cap.reshape(-1).long()
    loads = torch.zeros(num_experts + 1, dtype=torch.int64, device=flat.device).index_add_(0, flat,
                                                                                            torch.ones_like(flat))
    if int(loads[:num_experts].max()) <= capacity:
        return _capacity_gmm(experts, x_flat, ti_cap, tw_cap, num_experts, capacity, layer_idx, plain, s8)
    if plain:
        return moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx, s8=s8)
    moe_experts_capacity_gmm_exact.fallbacks += 1
    return moe_experts_swiglu_gmm(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx, s8=s8)


def moe_experts_capacity_gmm_exact(experts, x_flat, topk_idx, topk_w, num_experts: int, capacity: int, *,
                                   token_valid=None, layer_idx=None, s8: bool = False):
    """`moe_experts_capacity_gmm` behind its exactness check: when any expert's
    load exceeds `capacity`, the expert-sorted dispatch runs instead (on the
    ORIGINAL routing, exact for any assignment set), and `fallbacks` counts it.
    The check reads one device scalar, so the call synchronises.

    token_valid: optional bool (N,) of real (non-padding) rows. The padding
    rows of a right-padded prompt share one embedding and route to the same
    top-k experts in every layer; with the mask their assignments are routed
    out of bounds (expert id E, weight 0): they do not count against the
    check, take no slot from a valid row, and give zeros, which callers
    discard anyway. s8: the dot mode of the quantized kernels."""
    return _capacity_gmm_exact(experts, x_flat, topk_idx, topk_w, num_experts, capacity, token_valid, layer_idx,
                               plain=False, s8=s8)


def moe_experts_capacity_gmm_exact_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, capacity: int, *,
                                         token_valid=None, layer_idx=None, s8: bool = False):
    """Plain version of `moe_experts_capacity_gmm_exact`: the same check and
    placement over the kernels' plain versions, on any device."""
    return _capacity_gmm_exact(experts, x_flat, topk_idx, topk_w, num_experts, capacity, token_valid, layer_idx,
                               plain=True, s8=s8)


moe_experts_capacity_gmm_exact.fallbacks = 0
