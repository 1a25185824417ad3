"""Gathered-expert matmul: the CUDA kernel `csrc/expert_matmul.cu`, the
decode-MoE dispatch built on it, and their plain versions.

Replaces the TPU kernel mingunivision_tpu/ops/kernels/expert_matmul.py
(`gathered_expert_matmul` -> `_kernel`, and `moe_experts_gather_pallas`, its
drop-in for the XLA decode dispatch `bailing_moe.moe_experts_gather`): row a
of x times the (h, N) slab of expert ids[a], without materialising the
gathered slabs. What bounds it on the H100 is the bytes of the slabs, each
distinct (expert, table) slab read once; the kernel, like the TPU one, reads a
slab once per assignment, so rows that share experts cost up to k times that
(see the source for the launch layout).

No entry point of the JAX package reaches this kernel (its decode MoE is the
stream kernel, `moe_stream.py`), and none of the port does: it is held against
its plain version and against the decode-MoE kernel on the same inputs by
`chip_smoke.py`. The wrappers run their plain versions for CPU tensors only;
for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.moe_stream import layer_tables
from mingunivision_tpu_torch.utils.quantize import QuantizedArray, dequant_weight, take_weight


def gathered_expert_matmul_plain(x_rows, expert_w, ids):
    """x_rows (A, h) @ expert_w[ids] (A, h, N) in fp32, rounded once to x's dtype."""
    w = expert_w.index_select(0, ids.long()).float()
    return torch.bmm(x_rows.float()[:, None, :], w)[:, 0].to(x_rows.dtype)


def gathered_expert_matmul(x_rows, expert_w, ids):
    """x_rows (A, h); expert_w (E, h, N); ids (A,) int32 -> (A, N) in x's
    dtype: row a times expert_w[ids[a]], fp32 sums. The ids are never read on
    the host (no device sync); an id outside [0, E) gives a NaN row on the card."""
    if x_rows.device.type == "cpu":
        return gathered_expert_matmul_plain(x_rows, expert_w, ids)
    if isinstance(expert_w, QuantizedArray):
        raise ValueError("gathered_expert_matmul: the kernel takes bf16 tables, got a quantized one")
    E, h, N = expert_w.shape
    if x_rows.dim() != 2 or x_rows.shape[1] != h:
        raise ValueError(f"gathered_expert_matmul: x must be (A, {h}), got {tuple(x_rows.shape)}")
    A = x_rows.shape[0]
    for name, t in (("x_rows", x_rows), ("expert_w", expert_w)):
        if t.dtype != torch.bfloat16 or t.device != x_rows.device or not t.is_contiguous():
            raise ValueError(f"gathered_expert_matmul: {name} must be a contiguous bf16 tensor on {x_rows.device}")
    if ids.dtype != torch.int32 or ids.device != x_rows.device or tuple(ids.shape) != (A,):
        raise ValueError(f"gathered_expert_matmul: ids must be int32 ({A},) on {x_rows.device}, got {ids.dtype} "
                         f"{tuple(ids.shape)} on {ids.device}")
    if N % 8:
        raise ValueError(f"gathered_expert_matmul: N={N} must be a multiple of 8 (16-byte rows)")
    ids = ids.contiguous()
    out = torch.empty((A, N), dtype=x_rows.dtype, device=x_rows.device)
    rc = build.load().mu_gathered_expert_matmul(x_rows.data_ptr(), expert_w.data_ptr(), ids.data_ptr(),
                                                out.data_ptr(), A, E, h, N, build.stream_handle(x_rows))
    build.check(rc, "mu_gathered_expert_matmul")
    gathered_expert_matmul.launches += 1
    return out


gathered_expert_matmul.launches = 0


def moe_experts_gather_plain(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """The port's copy of the JAX package's `bailing_moe.moe_experts_gather`:
    each assignment's gathered (dequantized) tables, g and u as fp32 sums,
    a = silu(g) * u rounded to x's dtype, the down product in fp32, the k
    assignments of a token weighted and summed in fp32. x_flat (N, h) -> (N, h)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    N, k = topk_idx.shape
    flat = topk_idx.reshape(-1).long()
    xr = x_flat.repeat_interleave(k, dim=0)
    dtype = x_flat.dtype

    def gathered(w):  # (A, in, out) fp32 holding x-dtype values
        return dequant_weight(take_weight(w, flat), dtype).float()

    g = torch.bmm(xr.float()[:, None, :], gathered(w1))[:, 0]
    u = torch.bmm(xr.float()[:, None, :], gathered(w3))[:, 0]
    a = (F.silu(g) * u).to(dtype).float()
    y = torch.bmm(a[:, None, :], gathered(w2))[:, 0]
    return (y.reshape(N, k, -1) * topk_w.float()[..., None]).sum(dim=1).to(dtype)


def moe_experts_gather_kernel(experts, x_flat, topk_idx, topk_w, *, layer_idx=None):
    """The decode MoE through three gathered-expert matmuls (the counterpart
    of the JAX package's `moe_experts_gather_pallas`): x repeated k times, g
    and u by the kernel, a = silu(g) * u in fp32 rounded to x's dtype (plain
    PyTorch, as XLA glue in the JAX package), the down product by the kernel,
    the k assignments weighted and summed in fp32. Depth-stacked (L, E, ...)
    tables need `layer_idx` (`moe_stream.layer_tables`). x_flat (N, h) -> (N, h)."""
    w1, w3, w2 = layer_tables(experts, layer_idx)
    N, k = topk_idx.shape
    ids = topk_idx.reshape(-1).to(torch.int32)
    xr = x_flat.repeat_interleave(k, dim=0)
    g = gathered_expert_matmul(xr, w1, ids)
    u = gathered_expert_matmul(xr, w3, ids)
    a = (F.silu(g.float()) * u.float()).to(x_flat.dtype)
    y = gathered_expert_matmul(a, w2, ids)
    return (y.reshape(N, k, -1).float() * topk_w.float()[..., None]).sum(dim=1).to(x_flat.dtype)
