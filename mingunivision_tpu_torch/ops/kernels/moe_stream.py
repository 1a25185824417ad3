"""Decode-shape MoE: the CUDA kernel `csrc/moe_stream.cu` and its plain version.

Replaces the TPU kernel mingunivision_tpu/ops/kernels/moe_stream.py
(`moe_experts_stream` -> `_kernel`, bf16 tables). What bounds it on the H100
is the bytes of expert weights: a 2-row CFG decode step reads up to 12 routed
experts of 17.3 MB per layer. The kernel reads each routed expert once (the
unique-expert list and the per-expert gate rows are built here, on the device,
with no host sync), streams the tables with coalesced loads along m / h, and
sums the experts' contributions in a separate deterministic pass. See the
source for the launch layout.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build


def layer_tables(experts, layer_idx):
    w1, w3, w2 = experts["gate_proj"], experts["up_proj"], experts["down_proj"]
    if layer_idx is not None:  # depth-stacked (L, E, ...) tables: zero-copy layer view
        w1, w3, w2 = w1[layer_idx], w3[layer_idx], w2[layer_idx]
    return w1, w3, w2


def moe_experts_stream_plain(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
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


def moe_experts_stream(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """Decode-path MoE. x_flat (N, h); topk_idx/topk_w (N, k) -> (N, h).

    `experts` hold (E, h, m)/(E, m, h) tables, or depth-stacked (L, E, ...)
    tables with `layer_idx`."""
    if x_flat.device.type == "cpu":
        return moe_experts_stream_plain(experts, x_flat, topk_idx, topk_w, layer_idx=layer_idx)
    w1, w3, w2 = layer_tables(experts, layer_idx)
    E, h, m = check_tables("moe_experts_stream", x_flat, w1, w3, w2)
    if h % 32 or m % 8 or h > 8192:
        raise ValueError(f"moe_experts_stream: needs h % 32 == 0, m % 8 == 0 and h <= 8192 (h={h}, m={m})")
    x = x_flat.contiguous()
    dev = x.device
    N, k = topk_idx.shape
    A = N * k
    # per-expert gate rows (duplicate assignments summed) and the unique-expert
    # list, ascending ids first: built on the device, no host sync
    onehot = topk_idx[:, :, None] == torch.arange(E, device=dev)  # (N, k, E)
    gates_e = (onehot * topk_w.float()[:, :, None]).sum(dim=1).t()  # (E, N)
    present = onehot.any(dim=1).any(dim=0)
    order = torch.argsort((~present).to(torch.int32), stable=True)
    n_slots = min(A, E)
    slot_expert = order[:n_slots].to(torch.int32).contiguous()
    gates = gates_e.index_select(0, order[:n_slots]).contiguous()
    n_unique = present.sum(dtype=torch.int32).reshape(1)

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
