"""Decode-shape MoE: the CUDA kernels `csrc/moe_stream.cu` (bf16 tables),
`csrc/moe_stream_q4.cu` (int4 tables) and `csrc/moe_stream_q8.cu` (int8
tables), each quantized one in both dot modes (s8 integer dots or exact
dequant), their plain versions, and the plain-dequant entry of NF4 tables.

Replaces the TPU kernels of mingunivision_tpu/ops/kernels/moe_stream.py
(`moe_experts_stream` -> `_kernel` for bf16 tables, `_kernel_q4_s8` and
`_kernel_q4` for linear int4 tables, `_kernel_q8_s8` and `_kernel_q8` for
int8 tables). What bounds them on the H100 is the bytes of expert weights: a
2-row CFG decode step reads up to 12 routed experts per layer, 17.3 MB each
in bf16, 8.65 MB in int8 and 4.33 MB in int4. Each kernel reads each routed
expert once and sums the experts' contributions in a deterministic order.
The bf16 kernel, both int4 modes and the int8 s8-dot mode build the
unique-expert list in each block from the top-k ids and stream weight tiles
through a shared-memory ring into the tensor cores (mma.sync: bf16 products,
s8 integer dots, or bf16 products of int4 nibbles converted in registers),
two launches per call and no other device op, their scratch in a workspace
kept per device and stream, the layer's tables reached by address; the int8
exact wrapper builds the list and the per-expert gate rows here
(`expert_slots`, on the device, with no host sync) and its kernel streams the
tables with coalesced loads. See the sources for the launch layouts.

`moe_experts_stream` dispatches on the table kind (`table_kind`) and, for
linear int4 and int8 tables, on the dot mode its caller passes (`int_dots`:
s8 integer dots, the default, as the JAX package's INT_DOT_STREAM /
INT_DOT_STREAM_INT8; False: exact dequant). Each wrapper runs its plain
version for CPU tensors only; for CUDA tensors it launches its kernel or
raises. NF4 tables (the "int4-nf4" tier) have no kernel in the JAX package
either, which runs them by XLA dequant (`moe_experts_gather` on the CPU,
`moe_experts_dense` on the TPU): they take `moe_experts_nf4`, plain dequant of
the routed experts on every device, chosen by the table kind. Shard-grouped
int4 tables are not ported and raise.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.intdot import mm4_s8, mm8_s8, quant_rows_s8, quant_rows_s8_pair, silu_exact
from mingunivision_tpu_torch.utils.quantize import (
    QuantizedArray,
    dequant_weight,
    is_int4_linear,
    is_int8_linear,
    is_nf4,
    take_weight,
)


def layer_tables(experts, layer_idx):
    """The (E, ...) tables of one layer: depth-stacked (L, E, ...) tables need
    `layer_idx` (a zero-copy view), unstacked ones take none. A stacked table
    without a layer index raises: its depth would be read as its experts."""
    w1, w3, w2 = experts["gate_proj"], experts["up_proj"], experts["down_proj"]
    if layer_idx is not None:
        w1, w3, w2 = w1[layer_idx], w3[layer_idx], w2[layer_idx]
    elif len(w1.shape) == 4:
        raise ValueError(f"depth-stacked expert tables {tuple(w1.shape)} need a layer index")
    return w1, w3, w2


def table_kind(op: str, experts) -> str:
    """"int4" for linear single-group int4 tables, "int8" for int8 tables,
    "nf4" for NF4 tables, "plain" for tensors; raises on any other quantized
    table (shard-grouped linear int4)."""
    w = experts["gate_proj"]
    tables = [experts[n] for n in ("gate_proj", "up_proj", "down_proj")]
    for kind, test in (("int4", is_int4_linear), ("int8", is_int8_linear), ("nf4", is_nf4)):
        if all(test(t) for t in tables):
            return kind
    if isinstance(w, QuantizedArray):
        raise NotImplementedError(f"{op}: only linear int4 and int8 tables with groups=1 and NF4 tables are "
                                  f"ported, got {w!r}")
    return "plain"


def _decode_impl(op: str, experts, int_dots: bool, plain: bool):
    """The decode-MoE function of the table kind and dot mode: the wrapper, or
    with `plain` its plain version."""
    kind = table_kind(op, experts)
    if kind == "nf4":
        return moe_experts_nf4
    return _DECODE_IMPLS[(kind, int_dots or kind == "plain")][0 if plain else 1]


def expert_gates(topk_idx, topk_w, num_experts: int):
    """Per-expert gate rows (E, N) fp32, duplicate assignments summed, and the
    presence mask (E,): the dedup of the TPU kernel, on the device."""
    onehot = topk_idx[:, :, None] == torch.arange(num_experts, device=topk_idx.device)  # (N, k, E)
    gates_e = (onehot * topk_w.float()[:, :, None]).sum(dim=1).t()  # (E, N)
    return gates_e, onehot.any(dim=1).any(dim=0)


def moe_experts_stream_plain(experts, x_flat, topk_idx, topk_w, *, layer_idx=None, int_dots: bool = True):
    """Plain version of `moe_experts_stream`, dispatching on the table kind and dot mode."""
    fn = _decode_impl("moe_experts_stream_plain", experts, int_dots, plain=True)
    return fn(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)


def moe_experts_stream_bf16_plain(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Plain PyTorch: per (token, expert) assignment silu(x@w1)*(x@w3) rounded to
    x's dtype, @ w2 in fp32, gate-weighted fp32 sum. x_flat (N, h) -> (N, h)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    N, k = topk_idx.shape
    flat = topk_idx.reshape(-1).long()
    xr = x_flat.repeat_interleave(k, dim=0).float()[:, None, :]  # (A, 1, h)
    g = torch.bmm(xr, w1[flat].float())[:, 0]
    u = torch.bmm(xr, w3[flat].float())[:, 0]
    a = (F.silu(g) * u).to(x_flat.dtype).float()
    y = torch.bmm(a[:, None, :], w2[flat].float())[:, 0]  # (A, h)
    y = y.reshape(N, k, -1) * topk_w.float()[..., None]
    return y.sum(dim=1).to(x_flat.dtype)


def check_tables(op: str, x_flat, w1, w3, w2):
    """What both MoE kernels need: contiguous bf16 (E, h, m)/(E, m, h) tables
    and bf16 (N, h) rows, all on one device. Returns (E, h, m)."""
    E, h, m = w1.shape
    for name, w, shape in (("gate_proj", w1, (E, h, m)), ("up_proj", w3, (E, h, m)), ("down_proj", w2, (E, m, h))):
        if w.dtype != torch.bfloat16 or w.device != x_flat.device or tuple(w.shape) != shape or not w.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous bf16 {shape} table on {x_flat.device}")
    if x_flat.dtype != torch.bfloat16 or x_flat.dim() != 2 or x_flat.shape[-1] != h:
        raise ValueError(f"{op}: x must be bf16 (N, {h}), got {x_flat.dtype} {tuple(x_flat.shape)}")
    return E, h, m


ROWS_PER_LAUNCH = 64  # csrc/moe_decode.cuh's kMaxRows: more rows take one pair of launches per 64
Q4_ROWS_PER_LAUNCH = 32  # csrc/moe_stream_q4.cu's kMaxRowsExact: the exact mode's bf16 rows sit in shared memory
MAX_TOP_K = 8  # its kMaxK: the top-k ids of the rows are read into shared memory
MAX_EXPERTS = 1024  # its kMaxE: the routed experts are a bit set in shared memory
COL_TILE_DOWN = 128  # csrc/moe_stream.cu's kDownCols: a ticket per column tile of h
# the quantized two-launch kernels (moe_decode.cuh's `ring`: both int4 modes, the int8 s8 mode)
RING_COL_TILE_DOWN = 256  # columns of h per down block, a ticket each (h in whole tiles)
RING_M_ALIGN = 128  # m: whole up tiles (128 columns, or 64 column pairs) and whole stages of 64 (packed) rows
RING_MAX_WIDTH = 2048  # the limit on h and m: the rows' operands sit in shared memory


def row_chunks(N: int, rows: int = ROWS_PER_LAUNCH):
    """(first row, rows) of each launch pair of the two-launch decode kernels: `rows` at a time."""
    return ((r0, min(rows, N - r0)) for r0 in range(0, N, rows))


def rows_pad(n: int) -> int:
    """The rows the bf16 kernel pads its h workspace to: 8 per n-tile, 1, 2, 4
    or 8 n-tiles (csrc/moe_stream.cu's `mu_moe_stream_rows_pad`)."""
    tiles = -(-n // 8)
    return 8 * (tiles if tiles <= 2 else 4 if tiles <= 4 else 8)


@functools.lru_cache(maxsize=256)
def workspace_sizes(N: int, k: int, E: int, h: int, m: int) -> tuple[int, int, int]:
    """The workspace one launch pair of the bf16 kernel needs for N <=
    ROWS_PER_LAUNCH rows routed top-k over E experts of (h, m) tables, with
    min(N k, E) slots: (bf16 h values, slot x m x rows_pad(N); fp32 per-slot
    down products, slot x N x h; int32 tickets, one per 128-column tile of h)."""
    slots = min(N * k, E)
    return slots * m * rows_pad(N), slots * N * h, -(-h // COL_TILE_DOWN)


_workspaces: dict = {}  # (device index, stream) -> (bf16 h, fp32 down products, int32 tickets), grown on demand
_q4s8_workspaces: dict = {}  # (device index, stream) -> (fp32 h / down products, s8 h, int32 tickets)
_q4_workspaces: dict = {}  # (device index, stream) -> (fp32 down products, bf16 h, int32 tickets)
_q8s8_workspaces: dict = {}  # (device index, stream) -> (fp32 h / down products, s8 h, int32 tickets)


def _grown(store: dict, key, sizes: tuple[int, int, int], dtypes: tuple, device):
    """The buffers `store` keeps under `key`, each at least its size long:
    allocated where missing or too short (the last, the tickets, as zeros)."""
    bufs = list(store.get(key, (None,) * len(sizes)))
    for i, (n, dtype) in enumerate(zip(sizes, dtypes)):
        if bufs[i] is None or bufs[i].numel() < n:
            bufs[i] = (torch.zeros if i == len(sizes) - 1 else torch.empty)(n, dtype=dtype, device=device)
    store[key] = tuple(bufs)
    return store[key]


def _workspace(sizes: tuple[int, int, int], device, stream: int):
    """The bf16 kernel's buffers for launches on `stream`, at least `sizes`
    (`workspace_sizes`) long: kept per device and stream (launches on one
    stream run in order, so they can share them), grown when a call needs
    more. The tickets start at zero and every launch leaves them at zero."""
    return _grown(_workspaces, (device.index, stream), sizes, (torch.bfloat16, torch.float32, torch.int32), device)


@functools.lru_cache(maxsize=256)
def q4s8_workspace_sizes(N: int, k: int, E: int, h: int, m: int) -> tuple[int, int, int]:
    """The workspace one launch pair of the int4 kernel's s8 mode needs for N
    <= ROWS_PER_LAUNCH rows routed top-k over E experts of (h, m) tables, with
    S = min(N k, E) slots: (fp32, S x N x max(h, m + m / 64): the up launch's h
    and its tiles' two row maxima (a tile is 128 columns of m), then the down
    launch's products; bytes, S x rows_pad(N) x (m + 16): each slot's h
    quantized to the s8 pair with each row's scales; int32 tickets, one per
    256-column tile of h, then one per slot)."""
    slots = min(N * k, E)
    return slots * N * max(h, m + m // 64), slots * rows_pad(N) * (m + 16), h // RING_COL_TILE_DOWN + slots


def _q4s8_workspace(sizes: tuple[int, int, int], device, stream: int):
    """The int4 s8-mode kernel's buffers, kept as `_workspace` keeps the bf16 kernel's."""
    return _grown(_q4s8_workspaces, (device.index, stream), sizes, (torch.float32, torch.int8, torch.int32), device)


@functools.lru_cache(maxsize=256)
def q4_workspace_sizes(N: int, k: int, E: int, h: int, m: int) -> tuple[int, int, int]:
    """The workspace one launch pair of the int4 kernel's exact mode needs for
    N <= Q4_ROWS_PER_LAUNCH rows routed top-k over E experts of (h, m) tables,
    with S = min(N k, E) slots: (fp32, S x N x h: the down launch's products;
    bf16, S x N x m: the up launch's h; int32 tickets, one per 256-column tile
    of h)."""
    slots = min(N * k, E)
    return slots * N * h, slots * N * m, h // RING_COL_TILE_DOWN


def _q4_workspace(sizes: tuple[int, int, int], device, stream: int):
    """The int4 exact-mode kernel's buffers, kept as `_workspace` keeps the bf16 kernel's."""
    return _grown(_q4_workspaces, (device.index, stream), sizes, (torch.float32, torch.bfloat16, torch.int32), device)


@functools.lru_cache(maxsize=256)
def q8s8_workspace_sizes(N: int, k: int, E: int, h: int, m: int) -> tuple[int, int, int]:
    """The workspace one launch pair of the int8 kernel's s8 mode needs for N
    <= ROWS_PER_LAUNCH rows routed top-k over E experts of (h, m) tables, with
    S = min(N k, E) slots: (fp32, S x N x max(h, m + m / 128): the up launch's
    h and its tiles' row maxima (a tile is 128 columns of m), then the down
    launch's products; bytes, S x rows_pad(N) x (m + 16): each slot's h
    quantized to s8 with each row's scale; int32 tickets, one per 256-column
    tile of h, then one per slot)."""
    slots = min(N * k, E)
    return slots * N * max(h, m + m // 128), slots * rows_pad(N) * (m + 16), h // RING_COL_TILE_DOWN + slots


def _q8s8_workspace(sizes: tuple[int, int, int], device, stream: int):
    """The int8 s8-mode kernel's buffers, kept as `_workspace` keeps the bf16 kernel's."""
    return _grown(_q8s8_workspaces, (device.index, stream), sizes, (torch.float32, torch.int8, torch.int32), device)


def _layer_pointer(op: str, name: str, w, layer_idx, shape: tuple, dev: int, dtype=torch.bfloat16) -> int:
    """The device address of `w`'s (E, a, b) table of layer `layer_idx` (of
    `w` itself without one), checked as the kernel reads it: `dtype` on
    device `dev`, of `shape`, contiguous, 16-byte aligned. Computed from the
    stacked table's strides, so a call makes no view."""
    if not isinstance(w, torch.Tensor) or w.dtype is not dtype or w.get_device() != dev:
        raise ValueError(f"{op}: {name} must be a contiguous {dtype} {shape} table on the rows' device")
    dims, strides, ptr = w.shape, w.stride(), w.data_ptr()
    if layer_idx is None:
        if len(dims) == 4:
            raise ValueError(f"depth-stacked expert tables {tuple(dims)} need a layer index")
    else:
        layer = layer_idx if type(layer_idx) is int else int(layer_idx)
        if len(dims) != 4 or not -dims[0] <= layer < dims[0]:
            raise ValueError(f"{op}: {name} {tuple(dims)} has no layer {layer} of a stacked (L, E, ...) table")
        ptr += (layer % dims[0]) * strides[0] * w.element_size()
        dims, strides = dims[1:], strides[1:]
    if dims != shape or strides != (shape[1] * shape[2], shape[2], 1):
        raise ValueError(f"{op}: {name} must be a contiguous {dtype} {shape} table, got {tuple(dims)} strided "
                         f"{strides}")
    if ptr % 16:
        raise ValueError(f"{op}: {name} must be 16-byte aligned")
    return ptr


def _check_routing(op: str, x_flat, topk_idx, topk_w, E: int, dev: int) -> None:
    """The (N, k) top-k ids (int32 or int64) and gates (bf16 or fp32) the
    kernels read in each block, on the rows' device: k <= MAX_TOP_K of at most
    MAX_EXPERTS experts."""
    N, k = x_flat.shape[0], topk_idx.shape[-1]
    for name, t, dtypes in (("topk_idx", topk_idx, (torch.int32, torch.int64)),
                            ("topk_w", topk_w, (torch.bfloat16, torch.float32))):
        if t.dtype not in dtypes or t.get_device() != dev or t.shape != (N, k):
            raise ValueError(f"{op}: {name} must be ({N}, {k}) of {dtypes} on {x_flat.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 0 < k <= MAX_TOP_K or E > MAX_EXPERTS:
        raise ValueError(f"{op}: needs 1 <= k <= {MAX_TOP_K} and at most {MAX_EXPERTS} experts (k={k}, E={E})")


def check_stream_inputs(experts, x_flat, topk_idx, topk_w, layer_idx=None):
    """What the bf16 kernel takes (the wrapper's checks, callable on any
    device): contiguous bf16 (E, h, m) / (E, m, h) tables (one layer's, or a
    stacked table's layer `layer_idx`), 16-byte aligned, with h a multiple of
    32 and at most 8192, m a multiple of 8, E <= MAX_EXPERTS; bf16 (N, h)
    rows; (N, k) int32 or int64 ids and bf16 or fp32 gates, k <= MAX_TOP_K;
    one device. Raises ValueError on anything else. Returns (x, the three
    tables' addresses, ids, gates, (E, h, m)), x, ids and gates contiguous and
    x 16-byte aligned."""
    op = "moe_experts_stream"
    w1 = experts["gate_proj"]
    E, h, m = w1.shape[-3:]
    dev = x_flat.get_device()
    ptrs = (_layer_pointer(op, "gate_proj", w1, layer_idx, (E, h, m), dev),
            _layer_pointer(op, "up_proj", experts["up_proj"], layer_idx, (E, h, m), dev),
            _layer_pointer(op, "down_proj", experts["down_proj"], layer_idx, (E, m, h), dev))
    if x_flat.dtype is not torch.bfloat16 or x_flat.dim() != 2 or x_flat.shape[-1] != h:
        raise ValueError(f"{op}: x must be bf16 (N, {h}), got {x_flat.dtype} {tuple(x_flat.shape)}")
    if h % 32 or m % 8 or h > 8192:
        raise ValueError(f"{op}: needs h % 32 == 0, m % 8 == 0 and h <= 8192 (h={h}, m={m})")
    _check_routing(op, x_flat, topk_idx, topk_w, E, dev)
    x = x_flat
    if not x.is_contiguous() or x.data_ptr() % 16:  # the kernel copies x by 16-byte pieces
        x = x.clone(memory_format=torch.contiguous_format)
    return x, ptrs, topk_idx.contiguous(), topk_w.contiguous(), (E, h, m)


def moe_experts_stream(experts, x_flat, topk_idx, topk_w, *, layer_idx=None, int_dots: bool = True):
    """Decode-path MoE. x_flat (N, h); topk_idx/topk_w (N, k) -> (N, h).

    `experts` hold (E, h, m)/(E, m, h) tables, or depth-stacked (L, E, ...)
    tables with `layer_idx`; linear int4 tables go to `moe_experts_stream_q4s8`
    (int_dots) or `moe_experts_stream_q4` (exact dequant), int8 tables to
    `moe_experts_stream_q8s8` or `moe_experts_stream_q8`, NF4 tables to
    `moe_experts_nf4`; bf16 tables launch `csrc/moe_stream.cu` here: two
    launches per ROWS_PER_LAUNCH rows, the expert list built in the kernel,
    no other device op but the output's allocation. The thousands of calls
    per image keep the host's part small: the tables' layer is reached by
    address, not by a view."""
    if not isinstance(experts["gate_proj"], torch.Tensor):
        return _decode_impl("moe_experts_stream", experts, int_dots, plain=False)(
            experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    if x_flat.device.type == "cpu":
        return moe_experts_stream_bf16_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    x, (p1, p3, p2), idx, gates, (E, h, m) = check_stream_inputs(experts, x_flat, topk_idx, topk_w, layer_idx)
    N, k = idx.shape
    out = torch.empty((N, h), dtype=torch.bfloat16, device=x.device)
    stream = build.stream_handle(x)
    lib = build.load()
    xp, ip, gp, op = x.data_ptr(), idx.data_ptr(), gates.data_ptr(), out.data_ptr()
    for r0, n in row_chunks(N):
        hbuf, ypart, tickets = _workspace(workspace_sizes(n, k, E, h, m), x.device, stream)
        rc = lib.mu_moe_stream_bf16(
            xp + r0 * h * 2, p1, p3, p2, ip + r0 * k * idx.element_size(), gp + r0 * k * gates.element_size(),
            hbuf.data_ptr(), ypart.data_ptr(), tickets.data_ptr(), op + r0 * h * 2, n, k, E, h, m,
            int(idx.dtype is torch.int64), int(gates.dtype is torch.float32), stream,
        )
        build.check(rc, "mu_moe_stream_bf16")
        moe_experts_stream.launches += 1
    return out


moe_experts_stream.launches = 0


def expert_slots(topk_idx, topk_w, num_experts: int):
    """The unique-expert list (ascending ids first, min(A, E) slots), each
    slot's gate row (slots, N) fp32 and the number of unique experts (1,)
    int32: built on the device, with no host sync."""
    N, k = topk_idx.shape
    gates_e, present = expert_gates(topk_idx, topk_w, num_experts)
    order = torch.argsort((~present).to(torch.int32), stable=True)
    n_slots = min(N * k, num_experts)
    slot_expert = order[:n_slots].to(torch.int32).contiguous()
    gates = gates_e.index_select(0, order[:n_slots]).contiguous()
    return slot_expert, gates, present.sum(dtype=torch.int32).reshape(1)


def moe_experts_stream_q4s8_plain(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Plain PyTorch of the int4 decode kernel (`_kernel_q4_s8`): the rows of x
    quantized once to the s8 operand pair; per routed expert (ascending id)
    g, u = the two integer dots times the column scales, h = silu(g) * u in
    fp32, re-quantized per row over all of m, the down dots times the column
    scale, and the gate-weighted fp32 sum. x_flat (N, h) -> (N, h)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    dh, mh = w1.q.shape[-2], w2.q.shape[-2]
    x = x_flat.float()
    a1, a2, sa1, sa2, corr = quant_rows_s8_pair(x[:, :dh], x[:, dh:])
    gates_e, present = expert_gates(topk_idx, topk_w, w1.q.shape[0])
    acc = torch.zeros_like(x)
    for e in present.nonzero().flatten().tolist():
        g = mm4_s8(w1.q[e], a1, a2, sa1, sa2, corr) * w1.s[e]
        u = mm4_s8(w3.q[e], a1, a2, sa1, sa2, corr) * w3.s[e]
        hh = silu_exact(g) * u
        b1, b2, sb1, sb2, corrh = quant_rows_s8_pair(hh[:, :mh], hh[:, mh:])
        acc += gates_e[e][:, None] * (mm4_s8(w2.q[e], b1, b2, sb1, sb2, corrh) * w2.s[e])
    return acc.to(x_flat.dtype)


def nibbles(q: torch.Tensor) -> torch.Tensor:
    """Packed split-halves int4 (n/2, cols) -> the unscaled weights (n, cols) fp32, exact."""
    return torch.cat([(q & 0xF).float() - 8.0, (q >> 4).float() - 8.0], dim=-2)


def moe_experts_stream_q4_plain(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Plain PyTorch of the int4 decode kernel with exact dequant (`_kernel_q4`):
    per routed expert (ascending id) g, u = x @ nibbles (values -8..7, fp32
    sums) times the column scales, h = silu(g) * u rounded to x's dtype, the
    down dot times its column scale, and the gate-weighted fp32 sum.
    x_flat (N, h) -> (N, h)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    x = x_flat.float()
    gates_e, present = expert_gates(topk_idx, topk_w, w1.q.shape[0])
    acc = torch.zeros_like(x)
    for e in present.nonzero().flatten().tolist():
        g = (x @ nibbles(w1.q[e])) * w1.s[e]
        u = (x @ nibbles(w3.q[e])) * w3.s[e]
        hh = (silu_exact(g) * u).to(x_flat.dtype).float()
        acc += gates_e[e][:, None] * ((hh @ nibbles(w2.q[e])) * w2.s[e])
    return acc.to(x_flat.dtype)


def moe_experts_nf4(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Decode-path MoE over NF4 tables, plain dequant on every device (the
    function of the JAX package's `moe_experts_gather`, which runs NF4 decode
    there; no TPU kernel exists for the codebook): the unique routed experts'
    tables dequantized to x's dtype, g/u as fp32 sums, a = silu(g) * u rounded
    to x's dtype, the down product in fp32, and each token's k assignments
    weighted and summed in fp32. The route is chosen by the table kind.
    x_flat (N, h) -> (N, h)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    N, k = topk_idx.shape
    unique, inv = torch.unique(topk_idx.reshape(-1), return_inverse=True)
    dtype = x_flat.dtype

    def tables(w):  # (U, in, out) fp32 holding x-dtype values
        return dequant_weight(take_weight(w, unique), dtype).float()

    x = x_flat.float()
    a = (F.silu(torch.matmul(x, tables(w1))) * torch.matmul(x, tables(w3))).to(dtype).float()  # (U, N, m)
    y = torch.matmul(a, tables(w2))  # (U, N, h): every unique expert on every row
    token = torch.arange(N, device=x.device).repeat_interleave(k)
    per = y[inv, token].reshape(N, k, -1) * topk_w.float()[..., None]
    return per.sum(dim=1).to(dtype)


def check_q4_tables(op: str, x_flat, w1, w3, w2):
    """What the int4 prefill MoE kernels need: contiguous uint8 (E, h/2,
    m)/(E, m/2, h) packed tables with contiguous fp32 (E, 1, m)/(E, 1, h)
    scales and bf16 (N, h) rows, all on one device. Returns (E, h, m)."""
    E, hh, m = w1.q.shape
    h = 2 * hh
    expect = (("gate_proj", w1, (E, hh, m), (E, 1, m)), ("up_proj", w3, (E, hh, m), (E, 1, m)),
              ("down_proj", w2, (E, m // 2, h), (E, 1, h)))
    for name, w, qshape, sshape in expect:
        for t, shape, dtype in ((w.q, qshape, torch.uint8), (w.s, sshape, torch.float32)):
            if t.dtype != dtype or t.device != x_flat.device or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"{op}: {name} must be contiguous {dtype} {shape} on {x_flat.device}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
    if x_flat.dtype != torch.bfloat16 or x_flat.dim() != 2 or x_flat.shape[-1] != h:
        raise ValueError(f"{op}: x must be bf16 (N, {h}), got {x_flat.dtype} {tuple(x_flat.shape)}")
    return E, h, m


def _check_ring_inputs(op: str, bits: int, experts, x_flat, topk_idx, topk_w, layer_idx):
    """What the quantized two-launch kernels take (moe_decode.cuh's `ring`):
    linear tables of `bits` (4: split-halves packed uint8 (E, h/2, m) / (E,
    m/2, h) bytes; 8: int8 (E, h, m) / (E, m, h)) with fp32 (E, 1, m) / (E, 1,
    h) scales (one layer's, or a stacked table's layer `layer_idx`),
    contiguous and 16-byte aligned, h a multiple of RING_COL_TILE_DOWN and m of
    RING_M_ALIGN, each at most RING_MAX_WIDTH; bf16 (N, h) rows; the routing as
    `check_stream_inputs` takes it; one device. Raises ValueError on anything
    else. Returns (x, the six addresses q1, s1, q3, s3, q2, s2, ids, gates,
    (E, h, m)), x, ids and gates contiguous and x 16-byte aligned."""
    tables = [experts[n] for n in ("gate_proj", "up_proj", "down_proj")]
    linear, pack, dtype = (is_int4_linear, 2, torch.uint8) if bits == 4 else (is_int8_linear, 1, torch.int8)
    if not all(linear(t) for t in tables):
        raise ValueError(f"{op}: needs linear int{bits} tables in one group, got {tables[0]!r}")
    E, rows, m = tables[0].q.shape[-3:]
    h = pack * rows
    dev = x_flat.get_device()
    ptrs = []
    for name, w, qshape, sshape in (("gate_proj", tables[0], (E, rows, m), (E, 1, m)),
                                    ("up_proj", tables[1], (E, rows, m), (E, 1, m)),
                                    ("down_proj", tables[2], (E, m // pack, h), (E, 1, h))):
        ptrs.append(_layer_pointer(op, f"{name}.q", w.q, layer_idx, qshape, dev, dtype))
        ptrs.append(_layer_pointer(op, f"{name}.s", w.s, layer_idx, sshape, dev, torch.float32))
    if x_flat.dtype is not torch.bfloat16 or x_flat.dim() != 2 or x_flat.shape[-1] != h:
        raise ValueError(f"{op}: x must be bf16 (N, {h}), got {x_flat.dtype} {tuple(x_flat.shape)}")
    if h % RING_COL_TILE_DOWN or m % RING_M_ALIGN or h > RING_MAX_WIDTH or m > RING_MAX_WIDTH:
        raise ValueError(f"{op}: needs h a multiple of {RING_COL_TILE_DOWN} and m of {RING_M_ALIGN}, each at most "
                         f"{RING_MAX_WIDTH} (h={h}, m={m})")
    _check_routing(op, x_flat, topk_idx, topk_w, E, dev)
    x = x_flat
    if not x.is_contiguous() or x.data_ptr() % 16:  # the kernel reads x by 16-byte pieces
        x = x.clone(memory_format=torch.contiguous_format)
    return x, tuple(ptrs), topk_idx.contiguous(), topk_w.contiguous(), (E, h, m)


def check_q4s8_inputs(experts, x_flat, topk_idx, topk_w, layer_idx=None, op: str = "moe_experts_stream_q4s8"):
    """What the int4 kernel takes in both dot modes (`_check_ring_inputs` on
    int4 tables; shard-grouped tables, packed per contraction group, raise),
    callable on any device."""
    return _check_ring_inputs(op, 4, experts, x_flat, topk_idx, topk_w, layer_idx)


def check_q8s8_inputs(experts, x_flat, topk_idx, topk_w, layer_idx=None):
    """What the int8 kernel's s8 mode takes (`_check_ring_inputs` on int8
    tables), callable on any device."""
    return _check_ring_inputs("moe_experts_stream_q8s8", 8, experts, x_flat, topk_idx, topk_w, layer_idx)


def _launch_pairs(name: str, counter, workspace, sizes, rows: int, checked):
    """Launches the two-launch kernel `name` on the checked inputs (x, the six
    table addresses, ids, gates, (E, h, m)), `rows` rows a launch pair, each
    pair on its workspace `workspace(sizes(n, k, E, h, m), device, stream)`
    and counted on `counter.launches`. Returns the (N, h) bf16 output, the
    call's one allocation."""
    x, ptrs, idx, gates, (E, h, m) = checked
    N, k = idx.shape
    out = torch.empty((N, h), dtype=torch.bfloat16, device=x.device)
    stream = build.stream_handle(x)
    fn = getattr(build.load(), name)
    xp, ip, gp, op = x.data_ptr(), idx.data_ptr(), gates.data_ptr(), out.data_ptr()
    for r0, n in row_chunks(N, rows):
        a, b, tickets = workspace(sizes(n, k, E, h, m), x.device, stream)
        rc = fn(xp + r0 * h * 2, *ptrs, ip + r0 * k * idx.element_size(), gp + r0 * k * gates.element_size(),
                a.data_ptr(), b.data_ptr(), tickets.data_ptr(), op + r0 * h * 2, n, k, E, h, m,
                int(idx.dtype is torch.int64), int(gates.dtype is torch.float32), stream)
        build.check(rc, name)
        counter.launches += 1
    return out


def moe_experts_stream_q4s8(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Decode-path MoE over linear int4 tables with s8 integer dots (the CUDA
    kernel `csrc/moe_stream_q4.cu`, `mu_moe_stream_q4s8`): two launches per
    ROWS_PER_LAUNCH rows, the expert list built in the kernel, no other device
    op but the output's allocation, the layer's six tensors reached by
    address. x_flat (N, h) bf16 -> (N, h)."""
    if x_flat.device.type == "cpu":
        return moe_experts_stream_q4s8_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    return _launch_pairs("mu_moe_stream_q4s8", moe_experts_stream_q4s8, _q4s8_workspace, q4s8_workspace_sizes,
                         ROWS_PER_LAUNCH, check_q4s8_inputs(experts, x_flat, topk_idx, topk_w, layer_idx))


def moe_experts_stream_q4(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Decode-path MoE over linear int4 tables with exact dequant (the CUDA
    kernel `csrc/moe_stream_q4.cu`, `mu_moe_stream_q4`): the s8 mode's design
    with bf16 products of the nibbles, two launches per Q4_ROWS_PER_LAUNCH
    rows, no other device op but the output's allocation, the layer's six
    tensors reached by address. x_flat (N, h) bf16 -> (N, h)."""
    if x_flat.device.type == "cpu":
        return moe_experts_stream_q4_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    checked = check_q4s8_inputs(experts, x_flat, topk_idx, topk_w, layer_idx, op="moe_experts_stream_q4")
    return _launch_pairs("mu_moe_stream_q4", moe_experts_stream_q4, _q4_workspace, q4_workspace_sizes,
                         Q4_ROWS_PER_LAUNCH, checked)


moe_experts_stream_q4.launches = 0
moe_experts_stream_q4s8.launches = 0


def moe_experts_stream_q8s8_plain(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Plain PyTorch of the int8 decode kernel with s8 dots (`_kernel_q8_s8`):
    the rows of x quantized once to s8; per routed expert (ascending id)
    g, u = the integer dots times the row and column scales, h = silu(g) * u in
    fp32, re-quantized per row over all of m, the down dot times its row and
    column scales, and the gate-weighted fp32 sum. x_flat (N, h) -> (N, h)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    xq, sx = quant_rows_s8(x_flat)
    gates_e, present = expert_gates(topk_idx, topk_w, w1.q.shape[0])
    acc = torch.zeros(x_flat.shape, dtype=torch.float32, device=x_flat.device)
    for e in present.nonzero().flatten().tolist():
        g = mm8_s8(w1.q[e], xq, sx) * w1.s[e]
        u = mm8_s8(w3.q[e], xq, sx) * w3.s[e]
        hq, sh = quant_rows_s8(silu_exact(g) * u)
        acc += gates_e[e][:, None] * (mm8_s8(w2.q[e], hq, sh) * w2.s[e])
    return acc.to(x_flat.dtype)


def moe_experts_stream_q8_plain(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Plain PyTorch of the int8 decode kernel with exact dequant (`_kernel_q8`):
    per routed expert (ascending id) g, u = x @ q (int8 values, fp32 sums) times
    the column scales, h = silu(g) * u rounded to x's dtype, the down dot times
    its column scale, and the gate-weighted fp32 sum. x_flat (N, h) -> (N, h)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    x = x_flat.float()
    gates_e, present = expert_gates(topk_idx, topk_w, w1.q.shape[0])
    acc = torch.zeros_like(x)
    for e in present.nonzero().flatten().tolist():
        g = (x @ w1.q[e].float()) * w1.s[e]
        u = (x @ w3.q[e].float()) * w3.s[e]
        hh = (silu_exact(g) * u).to(x_flat.dtype).float()
        acc += gates_e[e][:, None] * ((hh @ w2.q[e].float()) * w2.s[e])
    return acc.to(x_flat.dtype)


def check_q8_tables(op: str, x_flat, w1, w3, w2):
    """What the int8 MoE kernels need: contiguous int8 (E, h, m)/(E, m, h)
    tables with contiguous fp32 (E, 1, m)/(E, 1, h) scales and bf16 (N, h)
    rows, all on one device. Returns (E, h, m)."""
    E, h, m = w1.q.shape
    expect = (("gate_proj", w1, (E, h, m), (E, 1, m)), ("up_proj", w3, (E, h, m), (E, 1, m)),
              ("down_proj", w2, (E, m, h), (E, 1, h)))
    for name, w, qshape, sshape in expect:
        for t, shape, dtype in ((w.q, qshape, torch.int8), (w.s, sshape, torch.float32)):
            if t.dtype != dtype or t.device != x_flat.device or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"{op}: {name} must be contiguous {dtype} {shape} on {x_flat.device}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
    if x_flat.dtype != torch.bfloat16 or x_flat.dim() != 2 or x_flat.shape[-1] != h:
        raise ValueError(f"{op}: x must be bf16 (N, {h}), got {x_flat.dtype} {tuple(x_flat.shape)}")
    return E, h, m


def _launch_q8(op: str, experts, x_flat, topk_idx, topk_w, layer_idx):
    """One launch of `csrc/moe_stream_q8.cu`'s exact mode over the expert list
    built here (`expert_slots`)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    E, h, m = check_q8_tables(op, x_flat, w1, w3, w2)
    if h % 8 or m % 8:
        raise ValueError(f"{op}: needs h and m multiples of 8 (h={h}, m={m})")
    x = x_flat.contiguous()
    N = x.shape[0]
    slot_expert, gates, n_unique = expert_slots(topk_idx, topk_w, E)
    n_slots = slot_expert.numel()
    hbuf = torch.empty((n_slots, N, m), dtype=torch.float32, device=x.device)
    ybuf = torch.empty((n_slots, N, h), dtype=torch.float32, device=x.device)
    out = torch.empty((N, h), dtype=torch.bfloat16, device=x.device)
    rc = build.load().mu_moe_stream_q8(
        x.data_ptr(), w1.q.data_ptr(), w1.s.data_ptr(), w3.q.data_ptr(), w3.s.data_ptr(), w2.q.data_ptr(),
        w2.s.data_ptr(), slot_expert.data_ptr(), n_unique.data_ptr(), gates.data_ptr(), hbuf.data_ptr(),
        ybuf.data_ptr(), out.data_ptr(), N, n_slots, h, m, build.stream_handle(x),
    )
    build.check(rc, "mu_moe_stream_q8")
    return out


def moe_experts_stream_q8s8(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Decode-path MoE over int8 tables with s8 integer dots (the CUDA kernel
    `csrc/moe_stream_q8.cu`, `mu_moe_stream_q8s8`): the int4 s8 mode's design,
    two launches per ROWS_PER_LAUNCH rows, the expert list built in the
    kernel, no other device op but the output's allocation, the layer's six
    tensors reached by address. x_flat (N, h) bf16 -> (N, h)."""
    if x_flat.device.type == "cpu":
        return moe_experts_stream_q8s8_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    return _launch_pairs("mu_moe_stream_q8s8", moe_experts_stream_q8s8, _q8s8_workspace, q8s8_workspace_sizes,
                         ROWS_PER_LAUNCH, check_q8s8_inputs(experts, x_flat, topk_idx, topk_w, layer_idx))


def moe_experts_stream_q8(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Decode-path MoE over int8 tables with exact dequant (the CUDA kernel
    `csrc/moe_stream_q8.cu`, `mu_moe_stream_q8`). x_flat (N, h) bf16 -> (N, h)."""
    if x_flat.device.type == "cpu":
        return moe_experts_stream_q8_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    out = _launch_q8("moe_experts_stream_q8", experts, x_flat, topk_idx, topk_w, layer_idx)
    moe_experts_stream_q8.launches += 1
    return out


moe_experts_stream_q8s8.launches = 0
moe_experts_stream_q8.launches = 0

# (table kind, integer dots) -> (plain version, wrapper); built once, not at every call
_DECODE_IMPLS = {
    ("plain", True): (moe_experts_stream_bf16_plain, moe_experts_stream),
    ("int4", True): (moe_experts_stream_q4s8_plain, moe_experts_stream_q4s8),
    ("int4", False): (moe_experts_stream_q4_plain, moe_experts_stream_q4),
    ("int8", True): (moe_experts_stream_q8s8_plain, moe_experts_stream_q8s8),
    ("int8", False): (moe_experts_stream_q8_plain, moe_experts_stream_q8),
}
