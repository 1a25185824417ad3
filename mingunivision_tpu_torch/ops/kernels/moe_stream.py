"""Decode-shape MoE: the CUDA kernels `csrc/moe_stream.cu` (bf16 tables),
`csrc/moe_stream_q4.cu` (int4 tables, s8 integer dots) and
`csrc/moe_stream_q8.cu` (int8 tables, s8 integer dots or exact dequant), and
their plain versions.

Replaces the TPU kernels of mingunivision_tpu/ops/kernels/moe_stream.py
(`moe_experts_stream` -> `_kernel` for bf16 tables, `_kernel_q4_s8` for
linear int4 tables, `_kernel_q8_s8` and `_kernel_q8` for int8 tables). What
bounds them on the H100 is the bytes of expert weights: a 2-row CFG decode
step reads up to 12 routed experts per layer, 17.3 MB each in bf16, 8.65 MB
in int8 and 4.33 MB in int4. Each kernel reads each routed expert
once (the unique-expert list and the per-expert gate rows are built here, on
the device, with no host sync), streams the tables with coalesced loads, and
sums the experts' contributions in a separate deterministic pass. See the
sources for the launch layouts.

`moe_experts_stream` dispatches on the table type and, for quantized tables,
on the dot mode its caller passes (`int_dots`: s8 integer dots, the default,
as the JAX package's INT_DOT_STREAM_INT8; False: exact dequant, which is
ported for int8 tables only). Each wrapper runs its plain version for CPU
tensors only; for CUDA tensors it launches its kernel or raises. Other
quantized tables (NF4, shard-grouped int4) are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.intdot import mm4_s8, mm8_s8, quant_rows_s8, quant_rows_s8_pair, silu_exact
from mingunivision_tpu_torch.utils.quantize import QuantizedArray, is_int4_linear, is_int8_linear


def layer_tables(experts, layer_idx):
    w1, w3, w2 = experts["gate_proj"], experts["up_proj"], experts["down_proj"]
    if layer_idx is not None:  # depth-stacked (L, E, ...) tables: zero-copy layer view
        w1, w3, w2 = w1[layer_idx], w3[layer_idx], w2[layer_idx]
    return w1, w3, w2


def table_kind(op: str, experts) -> str:
    """"int4" for linear single-group int4 tables, "int8" for int8 tables,
    "plain" for tensors; raises on any other quantized table."""
    w = experts["gate_proj"]
    tables = [experts[n] for n in ("gate_proj", "up_proj", "down_proj")]
    if all(is_int4_linear(t) for t in tables):
        return "int4"
    if all(is_int8_linear(t) for t in tables):
        return "int8"
    if isinstance(w, QuantizedArray):
        raise NotImplementedError(f"{op}: only linear int4 and int8 tables with groups=1 are ported, got {w!r}")
    return "plain"


def _quant_impl(op: str, kind: str, int_dots: bool, int4, int8, int8_exact):
    """The function of a quantized table kind and dot mode (None for "plain")."""
    if kind == "int4":
        if not int_dots:
            raise NotImplementedError(f"{op}: exact-dequant int4 tables (int_dots=False) are not ported")
        return int4
    if kind == "int8":
        return int8 if int_dots else int8_exact
    return None


def require_dot_mode(experts, int_dots: bool) -> None:
    """Raise NotImplementedError unless the decode MoE can run `experts` in the
    dot mode `int_dots` (exact dequant is ported for int8 tables only; the
    s8 dots run on every table type the kernels take)."""
    if not int_dots:
        op = "moe_experts_stream"
        _quant_impl(op, table_kind(op, experts), int_dots, None, None, None)


def expert_gates(topk_idx, topk_w, num_experts: int):
    """Per-expert gate rows (E, N) fp32, duplicate assignments summed, and the
    presence mask (E,): the dedup of the TPU kernel, on the device."""
    onehot = topk_idx[:, :, None] == torch.arange(num_experts, device=topk_idx.device)  # (N, k, E)
    gates_e = (onehot * topk_w.float()[:, :, None]).sum(dim=1).t()  # (E, N)
    return gates_e, onehot.any(dim=1).any(dim=0)


def moe_experts_stream_plain(experts, x_flat, topk_idx, topk_w, *, layer_idx=None, int_dots: bool = True):
    """Plain version of `moe_experts_stream`, dispatching on the table type and dot mode."""
    op = "moe_experts_stream_plain"
    fn = _quant_impl(op, table_kind(op, experts), int_dots, moe_experts_stream_q4s8_plain,
                     moe_experts_stream_q8s8_plain, moe_experts_stream_q8_plain) or moe_experts_stream_bf16_plain
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


def moe_experts_stream(experts, x_flat, topk_idx, topk_w, *, layer_idx=None, int_dots: bool = True):
    """Decode-path MoE. x_flat (N, h); topk_idx/topk_w (N, k) -> (N, h).

    `experts` hold (E, h, m)/(E, m, h) tables, or depth-stacked (L, E, ...)
    tables with `layer_idx`; linear int4 tables go to `moe_experts_stream_q4s8`,
    int8 tables to `moe_experts_stream_q8s8` (int_dots) or
    `moe_experts_stream_q8` (exact dequant)."""
    op = "moe_experts_stream"
    fn = _quant_impl(op, table_kind(op, experts), int_dots, moe_experts_stream_q4s8, moe_experts_stream_q8s8,
                     moe_experts_stream_q8)
    if fn is not None:
        return fn(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    if x_flat.device.type == "cpu":
        return moe_experts_stream_bf16_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    w1, w3, w2 = layer_tables(experts, layer_idx)
    E, h, m = check_tables("moe_experts_stream", x_flat, w1, w3, w2)
    if h % 32 or m % 8 or h > 8192:
        raise ValueError(f"moe_experts_stream: needs h % 32 == 0, m % 8 == 0 and h <= 8192 (h={h}, m={m})")
    x = x_flat.contiguous()
    dev = x.device
    N = x.shape[0]
    slot_expert, gates, n_unique = expert_slots(topk_idx, topk_w, E)
    n_slots = slot_expert.numel()
    hbuf = torch.empty((n_slots, N, m), dtype=torch.bfloat16, device=dev)
    ybuf = torch.empty((n_slots, N, h), dtype=torch.float32, device=dev)
    out = torch.empty((N, h), dtype=torch.bfloat16, device=dev)
    rc = build.load().mu_moe_stream_bf16(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(), slot_expert.data_ptr(), n_unique.data_ptr(),
        gates.data_ptr(), hbuf.data_ptr(), ybuf.data_ptr(), out.data_ptr(), N, n_slots, h, m, build.stream_handle(x),
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


def check_q4_tables(op: str, x_flat, w1, w3, w2):
    """What the int4 MoE kernels need: contiguous uint8 (E, h/2, m)/(E, m/2, h)
    packed tables with contiguous fp32 (E, 1, m)/(E, 1, h) scales and bf16
    (N, h) rows, all on one device. Returns (E, h, m)."""
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


def moe_experts_stream_q4s8(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Decode-path MoE over linear int4 tables with s8 integer dots (the CUDA
    kernel `csrc/moe_stream_q4.cu`). x_flat (N, h) bf16 -> (N, h)."""
    if x_flat.device.type == "cpu":
        return moe_experts_stream_q4s8_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    w1, w3, w2 = layer_tables(experts, layer_idx)
    E, h, m = check_q4_tables("moe_experts_stream_q4s8", x_flat, w1, w3, w2)
    if h % 8 or m % 8:
        raise ValueError(f"moe_experts_stream_q4s8: needs h and m multiples of 8 (h={h}, m={m})")
    x = x_flat.contiguous()
    N = x.shape[0]
    slot_expert, gates, n_unique = expert_slots(topk_idx, topk_w, E)
    n_slots = slot_expert.numel()
    hbuf = torch.empty((n_slots, N, m), dtype=torch.float32, device=x.device)
    ybuf = torch.empty((n_slots, N, h), dtype=torch.float32, device=x.device)
    out = torch.empty((N, h), dtype=torch.bfloat16, device=x.device)
    rc = build.load().mu_moe_stream_q4s8(
        x.data_ptr(), w1.q.data_ptr(), w1.s.data_ptr(), w3.q.data_ptr(), w3.s.data_ptr(), w2.q.data_ptr(),
        w2.s.data_ptr(), slot_expert.data_ptr(), n_unique.data_ptr(), gates.data_ptr(), hbuf.data_ptr(),
        ybuf.data_ptr(), out.data_ptr(), N, n_slots, h, m, build.stream_handle(x),
    )
    build.check(rc, "mu_moe_stream_q4s8")
    moe_experts_stream_q4s8.launches += 1
    return out


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


def _launch_q8(op: str, experts, x_flat, topk_idx, topk_w, layer_idx, s8_dots: bool):
    """One launch of `csrc/moe_stream_q8.cu` in the given dot mode."""
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
        ybuf.data_ptr(), out.data_ptr(), N, n_slots, h, m, int(s8_dots), build.stream_handle(x),
    )
    build.check(rc, "mu_moe_stream_q8")
    return out


def moe_experts_stream_q8s8(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Decode-path MoE over int8 tables with s8 integer dots (the CUDA kernel
    `csrc/moe_stream_q8.cu`, S8). x_flat (N, h) bf16 -> (N, h)."""
    if x_flat.device.type == "cpu":
        return moe_experts_stream_q8s8_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    out = _launch_q8("moe_experts_stream_q8s8", experts, x_flat, topk_idx, topk_w, layer_idx, s8_dots=True)
    moe_experts_stream_q8s8.launches += 1
    return out


def moe_experts_stream_q8(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Decode-path MoE over int8 tables with exact dequant (the CUDA kernel
    `csrc/moe_stream_q8.cu`, not S8). x_flat (N, h) bf16 -> (N, h)."""
    if x_flat.device.type == "cpu":
        return moe_experts_stream_q8_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    out = _launch_q8("moe_experts_stream_q8", experts, x_flat, topk_idx, topk_w, layer_idx, s8_dots=False)
    moe_experts_stream_q8.launches += 1
    return out


moe_experts_stream_q8s8.launches = 0
moe_experts_stream_q8.launches = 0
