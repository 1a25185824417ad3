"""Prefill MoE: the CUDA grouped-SwiGLU kernels `csrc/moe_swiglu_gmm.cu` (bf16
tables), `csrc/moe_swiglu_gmm_q4.cu` (int4 tables) and
`csrc/moe_swiglu_gmm_q8.cu` (int8 tables), the quantized ones in both dot
modes (exact dequant, or per-row s8 activation dots: `s8=True`), their group
schedule, their plain versions, and the plain-dequant rows of NF4 tables.

Replaces the TPU kernels of mingunivision_tpu/ops/kernels/moe_swiglu_gmm.py
(`moe_experts_swiglu_gmm` -> `swiglu_gmm` -> `_kernel` for bf16 tables,
`swiglu_gmm_quant` -> `_swiglu_gmm_q4_chunked` -> `_kernel_q4_chunked` /
`_kernel_q4_chunked_s8` for linear int4 tables, `_swiglu_gmm_q8` ->
`_kernel_q8_chunked` / `_kernel_q8_chunked_s8` for int8 tables; the JAX
package turns the s8 variants on with INT_DOT_PREFILL_INT8 / _INT4 or
`s8=True`, the port with RuntimeConfig.moe_prefill_int_dots, passed down as
`s8`) and the megablox `make_group_metadata` / `_get_store_mask` schedule
they relied on. What bounds it on the H100 is the bytes of the expert tables
(1.1 GB per layer at the 16B-A3B width when every expert is routed), then the
13 G operations of a 128-token prompt. The schedule tiles each expert's
sorted rows from the expert's first row, so every block reads one expert's
weight tile for at most the kernel's tile rows, no tile straddles a group
boundary, and the store mask is the tile's row bound. The tables are read as
(E, h, m)/(E, m, h) layer views, never copied or cast; int4 and int8 tables
are converted to bf16 on chip (int4 in shared memory by the wgmma body's
producer, int8 in the consumers' registers as the transposed product's A:
a quarter and a half of the bf16 bytes), or enter the s8 dots as they lie.
The bf16 kernel and the exact modes of the int4 and int8 ones run one body,
`csrc/swiglu_wgmma.cuh`, at 128-row schedule tiles; the s8-dot and
full-block kernels at 32.

The kernels read x through a row map (the token of each row) and a schedule
of (expert, first row, end row) tiles, so a dispatch is two steps: build the
row map and schedule, then `swiglu_gmm_rows` (check, launch, count). This
module's dispatch sorts the assignments by expert (`group_schedule`);
ops/kernels/moe_capacity.py places them sort-free into per-expert slots and
launches the same kernels through `swiglu_gmm_rows`.

A third mode, `full_block`, replaces the full-expert-block kernel
`swiglu_gmm_quant(int4_chunked=False)` -> `_kernel_q` over int4 or int8 tables
(`csrc/moe_swiglu_gmm_q4.cu`'s `mu_swiglu_gmm_full`; launch counts on
`moe_experts_swiglu_gmm_q4_full` / `_q8_full`).

`moe_experts_swiglu_gmm_ad` is the differentiable entry of training (the
JAX package's custom_vjp of the same name): this module's bf16 kernel
forward, the backward through `moe_gmm.moe_experts_gmm`'s grouped matmuls.

`moe_experts_swiglu_gmm` dispatches on the table kind. `swiglu_gmm_rows` runs
the plain version (`swiglu_rows_plain`) for CPU tensors only; for CUDA tensors
it launches its kernel or raises. The launch counts stay on
`moe_experts_swiglu_gmm` (bf16 tables), `moe_experts_swiglu_gmm_q4` /
`_q4s8` and `moe_experts_swiglu_gmm_q8` / `_q8s8`. NF4 tables have no kernel
in the JAX package either (XLA dequant, `moe_experts_dense`): they take the
plain rows (`swiglu_rows_plain`, each routed expert's tables dequantized to
the compute dtype) on every device, chosen by the table kind.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.intdot import (
    int_dot,
    mm4_s8,
    mm8_s8,
    quant_rows_s8,
    quant_rows_s8_pair,
    silu_exact,
    split_bytes,
)
from mingunivision_tpu_torch.ops.kernels.moe_stream import (
    check_q4_tables,
    check_q8_tables,
    check_tables,
    layer_tables,
    nibbles,
    table_kind,
)
from mingunivision_tpu_torch.utils.quantize import dequant_weight

SEG = 64  # the int4 s8 kernels' down-table segment: rows re-quantized together, one nibble plane each


def q4_seg(m: int) -> int:
    """The int4 s8 down-table segment for intermediate width m: SEG rows (the
    kernel's and the JAX package's); a width whose half is no multiple of SEG,
    which neither kernel takes, is re-quantized one nibble plane at a time."""
    return SEG if (m // 2) % SEG == 0 else m // 2


def pick_chunk_q8(m: int) -> int:
    """The int8 s8 kernels' m-chunk (the JAX package's `_pick_chunk(m, h, 1)`):
    a = silu(g) * u is re-quantized per row over each chunk of this many columns."""
    return next((c for c in (512, 384, 256, 128) if m % c == 0), 128)


def group_schedule(topk_idx: torch.Tensor, num_experts: int, tile_rows: int):
    """Expert-sorted row order and the (expert, row-tile) schedule, on the device.

    Returns (order (A,) int64: flat assignment of each sorted row;
    row_token (A,) int32: its token; sched (n_tiles, 3) int32 rows of
    (expert, first row, end row)). n_tiles = ceil(A / tile_rows) + E is a
    static bound on sum_e ceil(size_e / tile_rows); unused entries are empty
    (first row == end row == 0), so no host sync is needed.
    """
    N, k = topk_idx.shape
    flat = topk_idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    row_token = (order // k).to(torch.int32)
    sizes = torch.zeros(num_experts, dtype=torch.int64, device=flat.device).index_add_(0, flat, torch.ones_like(flat))
    return order, row_token, tile_schedule(sizes, N * k, tile_rows)


def tile_schedule(sizes: torch.Tensor, rows: int, tile_rows: int) -> torch.Tensor:
    """The (group, row-tile) schedule of `rows` group-sorted rows whose E groups
    have `sizes` (E,) rows each (rows past `rows` are dropped), on the device:
    (n_tiles, 3) int32 rows of (group, first row, end row), tiles of at most
    `tile_rows` rows starting at each group's first row. n_tiles =
    ceil(rows / tile_rows) + E is a static bound; unused entries are empty
    (first row == end row == 0), so no host sync is needed."""
    E = sizes.shape[0]
    sizes = sizes.long()
    cum = sizes.cumsum(0)
    ends = cum.clamp(max=rows)  # rows past `rows` belong to no tile
    starts = (cum - sizes).clamp(max=rows)
    sizes = ends - starts
    tiles = (sizes + tile_rows - 1) // tile_rows
    tile_end = tiles.cumsum(0)
    tile_start = tile_end - tiles
    t = torch.arange(-(-rows // tile_rows) + E, device=sizes.device)
    e = torch.searchsorted(tile_end, t, right=True).clamp_(max=E - 1)
    r0 = starts[e] + (t - tile_start[e]) * tile_rows
    r1 = torch.minimum(r0 + tile_rows, ends[e])
    valid = t < tile_end[-1]
    zero = torch.zeros_like(r0)
    sched = torch.stack([e, torch.where(valid, r0, zero), torch.where(valid, r1, zero)], dim=1)
    return sched.to(torch.int32).contiguous()


def _rows_q8s8(w1, w3, w2, e, xe, dtype):
    """Rows xe (R, h) through int8 expert e with s8 dots (`_kernel_q8_chunked_s8`):
    x quantized per row, g/u integer dots times the row and column scales,
    a = silu(g) * u re-quantized per row over each `pick_chunk_q8` chunk, the
    chunks' descaled down dots added in order, s2 at the end."""
    xq, sx = quant_rows_s8(xe)
    g = mm8_s8(w1.q[e], xq, sx) * w1.s[e]
    u = mm8_s8(w3.q[e], xq, sx) * w3.s[e]
    a = silu_exact(g) * u
    m = a.shape[-1]
    chunk = pick_chunk_q8(m)
    acc = torch.zeros((xe.shape[0], w2.q.shape[-1]), dtype=torch.float32, device=xe.device)
    for c0 in range(0, m, chunk):
        aq, sa = quant_rows_s8(a[:, c0 : c0 + chunk])
        acc = acc + mm8_s8(w2.q[e][c0 : c0 + chunk], aq, sa)
    return (acc * w2.s[e]).to(dtype)


def _rows_q4s8(w1, w3, w2, e, xe, dtype):
    """Rows xe (R, h) through int4 expert e with s8 dots (`_kernel_q4_chunked_s8`):
    x's split halves quantized per row to the s8 pair, g/u through the two-dot
    identity, a = silu(g) * u re-quantized per row over each `q4_seg`-row
    segment of the down table (each inside one nibble plane), lo plane sa * (aq . m - 8 *
    sum(aq)), hi plane sa * (aq . bx - aq . m) / 16, added in order, s2 at the end."""
    dh = w1.q.shape[-2]
    a1, a2, sa1, sa2, corr = quant_rows_s8_pair(xe[:, :dh], xe[:, dh:])
    g = mm4_s8(w1.q[e], a1, a2, sa1, sa2, corr) * w1.s[e]
    u = mm4_s8(w3.q[e], a1, a2, sa1, sa2, corr) * w3.s[e]
    a = silu_exact(g) * u
    m = a.shape[-1]
    mh = m // 2
    mlo, bx = split_bytes(w2.q[e])
    seg = q4_seg(m)
    acc = torch.zeros((xe.shape[0], w2.q.shape[-1]), dtype=torch.float32, device=xe.device)
    for s0 in range(0, m, seg):
        aq, sa = quant_rows_s8(a[:, s0 : s0 + seg])
        p0 = s0 % mh
        d_m = int_dot(aq, mlo[p0 : p0 + seg])
        if s0 < mh:
            acc = acc + (d_m - 8.0 * aq.float().sum(dim=-1, keepdim=True)) * sa
        else:
            acc = acc + (int_dot(aq, bx[p0 : p0 + seg]) - d_m) * (sa * (1.0 / 16.0))
    return (acc * w2.s[e]).to(dtype)


def swiglu_rows_plain(experts, xr, row_expert, num_experts: int, *, layer_idx=None, s8: bool = False):
    """Plain PyTorch of the kernels over explicit rows: ys[r] = expert
    row_expert[r] applied to xr[r]; rows whose expert is outside [0, E) give
    zeros. One expert at a time, each row's output rounded to x's dtype (as
    the kernels store it). bf16 tables: fp32 g/u, a = silu(g) * u rounded to
    x's dtype, fp32 down product. int4 and int8 tables, exact dequant
    (`_kernel_q4_chunked`, `_kernel_q8_chunked`): the same with the scale
    applied to the fp32 sums, g = (x @ nibbles) * s1, g = (x @ q) * s1 and so
    on; with `s8`, the s8-dot kernels (`_rows_q4s8`, `_rows_q8s8`). NF4
    tables: the same as bf16 over each expert's tables dequantized to x's
    dtype (the JAX package's `moe_experts_dense`; `s8` is not read)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    kind = table_kind("swiglu_rows_plain", experts)
    unscaled = {"int4": nibbles, "int8": lambda q: q.float()}.get(kind)
    s8_rows = {"int4": _rows_q4s8, "int8": _rows_q8s8}.get(kind) if s8 else None
    ys = torch.zeros_like(xr)
    for e in range(num_experts):
        sel = (row_expert == e).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        xe = xr[sel].float()
        if s8_rows is not None:
            ys[sel] = s8_rows(w1, w3, w2, e, xe, xr.dtype)
        elif unscaled is not None:
            g = (xe @ unscaled(w1.q[e])) * w1.s[e]
            u = (xe @ unscaled(w3.q[e])) * w3.s[e]
            a = (F.silu(g) * u).to(xr.dtype).float()
            ys[sel] = ((a @ unscaled(w2.q[e])) * w2.s[e]).to(xr.dtype)
        else:
            t1, t3, t2 = (dequant_weight(w[e], xr.dtype).float() for w in (w1, w3, w2))
            a = (F.silu(xe @ t1) * (xe @ t3)).to(xr.dtype).float()
            ys[sel] = (a @ t2).to(xr.dtype)
    return ys


def combine_assignments(per, topk_w, dtype):
    """The gate-weighted fp32 sum of each token's k assignment rows: per (N * k, h) -> (N, h)."""
    N, k = topk_w.shape
    return (per.reshape(N, k, -1).float() * topk_w.float()[..., None]).sum(dim=1).to(dtype)


def moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None,
                                 s8: bool = False):
    """Plain version of `moe_experts_swiglu_gmm` for every table kind: every
    assignment row through `swiglu_rows_plain`, then the gate-weighted fp32 combine."""
    k = topk_idx.shape[1]
    ys = swiglu_rows_plain(experts, x_flat.repeat_interleave(k, dim=0), topk_idx.reshape(-1), num_experts,
                           layer_idx=layer_idx, s8=s8)
    return combine_assignments(ys, topk_w, x_flat.dtype)


def _plain_of_kind(kind: str, op: str, experts, x_flat, topk_idx, topk_w, num_experts, layer_idx, s8=False):
    if table_kind(op, experts) != kind:
        raise ValueError(f"{op}: needs {kind} tables")
    return moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx, s8=s8)


def moe_experts_swiglu_gmm_bf16_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """The plain version, over floating tables only."""
    return _plain_of_kind("plain", "moe_experts_swiglu_gmm_bf16_plain", experts, x_flat, topk_idx, topk_w,
                          num_experts, layer_idx)


def moe_experts_swiglu_gmm_q4_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None,
                                    s8: bool = False):
    """The plain version, over linear int4 tables only."""
    return _plain_of_kind("int4", "moe_experts_swiglu_gmm_q4_plain", experts, x_flat, topk_idx, topk_w,
                          num_experts, layer_idx, s8)


def moe_experts_swiglu_gmm_q8_plain(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None,
                                    s8: bool = False):
    """The plain version, over int8 tables only."""
    return _plain_of_kind("int8", "moe_experts_swiglu_gmm_q8_plain", experts, x_flat, topk_idx, topk_w,
                          num_experts, layer_idx, s8)


def tile_rows(kind: str = "plain", s8: bool = False, full_block: bool = False) -> int:
    """Rows per schedule tile of the kernel that `swiglu_gmm_rows` launches for
    the table kind (`table_kind`), dot mode and block mode, as the library that
    launches it reports: 128 for bf16 tables and for int4 and int8 ones with
    exact dequant (the wgmma body), 32 for the s8-dot and full-block kernels
    (a kernel handed a longer tile traps)."""
    lib = build.load()
    if full_block:
        return lib.mu_swiglu_gmm_full_tile_rows()
    if kind == "int4":
        return lib.mu_swiglu_gmm_q4_tile_rows(int(s8))
    if kind == "int8":
        return lib.mu_swiglu_gmm_q8_tile_rows(int(s8))
    return lib.mu_swiglu_gmm_tile_rows()


def sorted_schedule(experts, topk_idx, num_experts: int, *, s8: bool = False, full_block: bool = False):
    """`group_schedule` at the tile rows of the kernel the expert-sorted
    dispatch launches for these tables in this mode (`tile_rows`)."""
    kind = table_kind("sorted_schedule", experts)
    return group_schedule(topk_idx, num_experts, tile_rows(kind, s8 and kind != "plain", full_block))


def swiglu_gmm_rows(experts, x_flat, row_token, row_expert, sched, num_experts: int, *, layer_idx=None,
                    s8: bool = False, full_block: bool = False):
    """Launch the grouped-SwiGLU kernel of the table kind (and, for quantized
    tables, of the dot mode `s8`, or with `full_block` the full-expert-block
    mode) over a prepared schedule; returns ys (R, h) in x's dtype, row r
    holding expert(x[row_token[r]]).

    row_token (R,) int32: the token each row reads; sched (n_tiles, 3) int32
    (expert, first row, end row), empty tiles first == end; rows that no tile
    covers are left unwritten. row_expert (R,) (the expert of each row, outside
    [0, E) for rows no tile covers) is read by the plain path only, which runs
    `swiglu_rows_plain` and has no use for `sched`: the path of CPU tensors
    and of NF4 tables."""
    kind = table_kind("swiglu_gmm_rows", experts)
    if full_block:
        _check_full_block("swiglu_gmm_rows", kind, s8)
    if x_flat.device.type == "cpu" or kind == "nf4":
        return swiglu_rows_plain(experts, x_flat[row_token.long()], row_expert, num_experts, layer_idx=layer_idx,
                                 s8=s8)
    if full_block:
        return _full_block_rows(experts, x_flat, row_token, sched, num_experts, kind, layer_idx)
    w1, w3, w2 = layer_tables(experts, layer_idx)
    s8 = s8 and kind != "plain"
    name, check, wrapper = {
        ("int4", False): ("mu_swiglu_gmm_q4", check_q4_tables, moe_experts_swiglu_gmm_q4),
        ("int4", True): ("mu_swiglu_gmm_q4", check_q4_tables, moe_experts_swiglu_gmm_q4s8),
        ("int8", False): ("mu_swiglu_gmm_q8", check_q8_tables, moe_experts_swiglu_gmm_q8),
        ("int8", True): ("mu_swiglu_gmm_q8", check_q8_tables, moe_experts_swiglu_gmm_q8s8),
    }.get((kind, s8), ("mu_swiglu_gmm_bf16", check_tables, moe_experts_swiglu_gmm))
    E, h, m = check(wrapper.__name__, x_flat, w1, w3, w2)
    if E != num_experts or h % 64 or m % 64 or (kind == "int4" and s8 and (m // 2) % SEG):
        raise ValueError(f"{wrapper.__name__}: needs {num_experts} experts, h and m multiples of 64 "
                         f"(and m / 2 of {SEG} for s8 dots over int4 tables) (E={E}, h={h}, m={m})")
    x = x_flat.contiguous()
    R, N, dev = row_token.numel(), x.shape[0], x.device
    hbuf = torch.empty((R, m), dtype=torch.float32 if s8 else torch.bfloat16, device=dev)
    ys = torch.empty((R, h), dtype=torch.bfloat16, device=dev)
    if kind == "plain":
        tables = (w1.data_ptr(), w3.data_ptr(), w2.data_ptr())
        extra, ints = (), ()
    else:  # the quantized kernels take (q1, s1, q3, s3, q2, s2) and their s8 scratch
        tables = tuple(p for w in (w1, w3, w2) for p in (w.q.data_ptr(), w.s.data_ptr()))
        if kind == "int8":
            chunk = pick_chunk_q8(m)
            scratch = (((N, h), torch.int8), ((N,), torch.float32), ((R, m), torch.int8),
                       ((R, m // chunk), torch.float32)) if s8 else ()
            ints = (N, int(s8), chunk)
            n_ptrs = 4
        else:
            scratch = (((N, h // 2), torch.int8), ((N, h // 2), torch.int8), ((N, 4), torch.float32),
                       ((R, m), torch.int8), ((R, m // SEG), torch.float32), ((R, m // SEG), torch.int32)) if s8 else ()
            ints = (N, int(s8))
            n_ptrs = 6
        bufs = [torch.empty(shape, dtype=dtype, device=dev) for shape, dtype in scratch]
        extra = tuple(b.data_ptr() for b in bufs) if s8 else (0,) * n_ptrs
    rc = getattr(build.load(), name)(  # R and E: the wgmma body's tensor maps span the rows and the E tables
        x.data_ptr(), row_token.data_ptr(), *tables, sched.data_ptr(), hbuf.data_ptr(), ys.data_ptr(), *extra,
        sched.shape[0], R, E, h, m, *ints, build.stream_handle(x),
    )
    build.check(rc, name)
    wrapper.launches += 1
    return ys


def _check_full_block(op: str, kind: str, s8: bool) -> None:
    if kind not in ("int4", "int8") or s8:
        raise ValueError(f"{op}: the full-block mode takes int4 or int8 tables and exact dequant "
                         f"(got {kind} tables, s8={s8})")


def _full_block_rows(experts, x_flat, row_token, sched, num_experts, kind, layer_idx):
    """One launch of the full-expert-block kernel (`csrc/moe_swiglu_gmm_q4.cu`,
    `mu_swiglu_gmm_full`) over int4 or int8 tables; returns ys (R, h) bf16."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    check, wrapper = (check_q4_tables, moe_experts_swiglu_gmm_q4_full) if kind == "int4" else \
        (check_q8_tables, moe_experts_swiglu_gmm_q8_full)
    E, h, m = check(wrapper.__name__, x_flat, w1, w3, w2)
    if E != num_experts or h % 64 or m % 64:
        raise ValueError(f"{wrapper.__name__}: needs {num_experts} experts, h and m multiples of 64 "
                         f"(E={E}, h={h}, m={m})")
    x = x_flat.contiguous()
    ys = torch.empty((row_token.numel(), h), dtype=torch.bfloat16, device=x.device)
    rc = build.load().mu_swiglu_gmm_full(
        x.data_ptr(), row_token.data_ptr(), *(p for w in (w1, w3, w2) for p in (w.q.data_ptr(), w.s.data_ptr())),
        sched.data_ptr(), ys.data_ptr(), sched.shape[0], h, m, 4 if kind == "int4" else 8, build.stream_handle(x))
    build.check(rc, "mu_swiglu_gmm_full")
    wrapper.launches += 1
    return ys


def moe_experts_swiglu_gmm(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None, s8: bool = False,
                           full_block: bool = False):
    """Prefill-path MoE through the expert-sorted dispatch. x_flat (N, h);
    topk_idx/topk_w (N, k) -> (N, h). bf16 tables go to `csrc/moe_swiglu_gmm.cu`,
    linear int4 tables to `csrc/moe_swiglu_gmm_q4.cu`, int8 tables to
    `csrc/moe_swiglu_gmm_q8.cu` (with `s8`: their s8-dot mode), NF4 tables to
    the plain rows on every device. `full_block`: int4 and int8 tables through
    the full-expert-block mode instead (the JAX package's
    swiglu_gmm_quant(int4_chunked=False) -> `_kernel_q`, an explicit argument
    that no entry point passes, as there), whose plain version is the exact
    rows of `swiglu_rows_plain`: g and u over all of m in fp32, a = silu(g) * u
    rounded once, the down product over all of m, s2 at the end."""
    if full_block:
        _check_full_block("moe_experts_swiglu_gmm", table_kind("moe_experts_swiglu_gmm", experts), s8)
    if x_flat.device.type == "cpu" or table_kind("moe_experts_swiglu_gmm", experts) == "nf4":
        return moe_experts_swiglu_gmm_plain(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx,
                                            s8=s8)
    order, row_token, sched = sorted_schedule(experts, topk_idx, num_experts, s8=s8, full_block=full_block)
    ys = swiglu_gmm_rows(experts, x_flat, row_token, None, sched, num_experts, layer_idx=layer_idx, s8=s8,
                         full_block=full_block)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return combine_assignments(ys.index_select(0, inv), topk_w, x_flat.dtype)


def swiglu_gmm_ad_forward(experts, x_flat, topk_idx, topk_w, num_experts: int):
    """The forward of the differentiable entry: `moe_experts_swiglu_gmm` over one
    layer's tables, under a name of its own, so that a caller can route or watch
    this call alone (its plain version is `moe_experts_swiglu_gmm_plain`)."""
    return moe_experts_swiglu_gmm(experts, x_flat, topk_idx, topk_w, num_experts)


class _SwigluGmmAD(torch.autograd.Function):
    """The fused prefill MoE with a gradient (the JAX package's custom_vjp
    `moe_experts_swiglu_gmm_ad`): the forward is `swiglu_gmm_ad_forward` (the
    fused kernel on bf16 tables, row 2), the backward recomputes the layer
    through `moe_gmm.moe_experts_gmm` and differentiates that (its grouped
    matmuls' VJP: `gmm` with the rhs transposed and `tgmm`). Both are looked up
    in their modules at each call."""

    @staticmethod
    def forward(ctx, w1, w3, w2, x_flat, topk_idx, topk_w, num_experts):
        ctx.save_for_backward(w1, w3, w2, x_flat, topk_idx, topk_w)
        ctx.num_experts = num_experts
        experts = {"gate_proj": w1, "up_proj": w3, "down_proj": w2}
        return swiglu_gmm_ad_forward(experts, x_flat, topk_idx, topk_w, num_experts)

    @staticmethod
    def backward(ctx, grad):
        from mingunivision_tpu_torch.ops.kernels import moe_gmm

        w1, w3, w2, x_flat, topk_idx, topk_w = ctx.saved_tensors
        need = [ctx.needs_input_grad[i] for i in (0, 1, 2, 3, 5)]
        ins = [t.detach().requires_grad_(n) for t, n in zip((w1, w3, w2, x_flat, topk_w), need)]
        with torch.enable_grad():
            y = moe_gmm.moe_experts_gmm({"gate_proj": ins[0], "up_proj": ins[1], "down_proj": ins[2]}, ins[3],
                                        topk_idx, ins[4], ctx.num_experts)
            wanted = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wanted, grad) if wanted else ())
        gw1, gw3, gw2, gx, gw = (next(got) if n else None for n in need)
        return gw1, gw3, gw2, gx, None, gw, None


def moe_experts_swiglu_gmm_ad(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """The differentiable prefill MoE of training over floating tables
    (`_SwigluGmmAD`): the layer's tables (views of depth-stacked ones with
    `layer_idx`), x_flat (N, h), topk_idx (N, k), topk_w (N, k) -> (N, h).
    Gradients reach the tables, x and topk_w; none reaches topk_idx."""
    if table_kind("moe_experts_swiglu_gmm_ad", experts) != "plain":
        raise ValueError("moe_experts_swiglu_gmm_ad: needs floating tables (quantized ones are not trained)")
    w1, w3, w2 = layer_tables(experts, layer_idx)
    return _SwigluGmmAD.apply(w1, w3, w2, x_flat, topk_idx, topk_w, num_experts)


def _of_kind(kind: str, op: str, experts, x_flat, topk_idx, topk_w, num_experts, layer_idx, s8, full_block=False):
    if table_kind(op, experts) != kind:
        raise ValueError(f"{op}: needs {kind} tables")
    return moe_experts_swiglu_gmm(experts, x_flat, topk_idx, topk_w, num_experts, layer_idx=layer_idx, s8=s8,
                                  full_block=full_block)


def moe_experts_swiglu_gmm_q4(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """`moe_experts_swiglu_gmm` for linear int4 tables, exact dequant (the name
    that carries that kernel's launch count)."""
    return _of_kind("int4", "moe_experts_swiglu_gmm_q4", experts, x_flat, topk_idx, topk_w, num_experts, layer_idx,
                    False)


def moe_experts_swiglu_gmm_q4s8(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """`moe_experts_swiglu_gmm` for linear int4 tables, s8 dots (the name that
    carries that kernel's launch count)."""
    return _of_kind("int4", "moe_experts_swiglu_gmm_q4s8", experts, x_flat, topk_idx, topk_w, num_experts, layer_idx,
                    True)


def moe_experts_swiglu_gmm_q8(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """`moe_experts_swiglu_gmm` for int8 tables, exact dequant (the name that
    carries that kernel's launch count)."""
    return _of_kind("int8", "moe_experts_swiglu_gmm_q8", experts, x_flat, topk_idx, topk_w, num_experts, layer_idx,
                    False)


def moe_experts_swiglu_gmm_q8s8(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """`moe_experts_swiglu_gmm` for int8 tables, s8 dots (the name that carries
    that kernel's launch count)."""
    return _of_kind("int8", "moe_experts_swiglu_gmm_q8s8", experts, x_flat, topk_idx, topk_w, num_experts, layer_idx,
                    True)


def moe_experts_swiglu_gmm_q4_full(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """`moe_experts_swiglu_gmm` for linear int4 tables in the full-expert-block
    mode (the name that carries that kernel's launch count)."""
    return _of_kind("int4", "moe_experts_swiglu_gmm_q4_full", experts, x_flat, topk_idx, topk_w, num_experts,
                    layer_idx, False, full_block=True)


def moe_experts_swiglu_gmm_q8_full(experts, x_flat, topk_idx, topk_w, num_experts: int, *, layer_idx=None):
    """`moe_experts_swiglu_gmm` for int8 tables in the full-expert-block mode
    (the name that carries that kernel's launch count)."""
    return _of_kind("int8", "moe_experts_swiglu_gmm_q8_full", experts, x_flat, topk_idx, topk_w, num_experts,
                    layer_idx, False, full_block=True)


moe_experts_swiglu_gmm.launches = 0
moe_experts_swiglu_gmm_q4_full.launches = 0
moe_experts_swiglu_gmm_q8_full.launches = 0
moe_experts_swiglu_gmm_q4.launches = 0
moe_experts_swiglu_gmm_q4s8.launches = 0
moe_experts_swiglu_gmm_q8.launches = 0
moe_experts_swiglu_gmm_q8s8.launches = 0
