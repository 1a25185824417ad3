"""Flash attention for first-round prefill and for the ViT decoders: the CUDA
kernel `csrc/flash_attention.cu`, its two wrappers, their plain versions and
the static gates.

Replaces mingunivision_tpu/ops/kernels/flash.py (`flash_prefill_attention`
and `flash_vit_attention`, both over the Pallas flash-attention kernel that
ships with JAX). The function is softmax(Q K^T * scale) V over a full
sequence whose fresh keys are the whole context, with the (rows, keys) scores
kept out of device memory. On the H100 it is bound by its operations (4 * D
per allowed query-key pair; q, k, v and the output each move once), so the
kernel keeps both products on the tensor cores (`mma.sync` bf16, fp32
accumulators) and the online-softmax state in registers; see the source note.

The gates follow the JAX package's TPU dispatch on every device (the port's
CPU path is the plain version of the same function, not another path).

Each wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from mingunivision_tpu_torch.ops.attention import mha
from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.linear import current_fp32_precision

_KERNEL_HEAD_DIMS = (64, 128)
_TILE = 64  # the kernel's query and key tile


def flash_usable(T: int) -> bool:
    """Static gate of the prefill kernel: tile-friendly lengths from 512 up."""
    return T >= 512 and T % 128 == 0


def flash_vit_usable(N: int, dtype) -> bool:
    """Gate of the ViT kernel: tile-aligned N from 512 up, and a numerics tier
    the kernel's bf16 products cannot degrade: bf16 inputs always qualify,
    fp32 inputs only inside `fp32_matmul_precision("default")` (at "high" /
    "highest" it would break those tiers' fp32 guarantee)."""
    if not (N >= 512 and N % 128 == 0):
        return False
    if dtype == torch.bfloat16:
        return True
    return dtype == torch.float32 and current_fp32_precision() == "default"


def _prefill_mask(valid_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) bool -> (B, 1, T, T): key j <= row i and valid[i] == valid[j]."""
    T = valid_mask.shape[1]
    pos = torch.arange(T, device=valid_mask.device)
    causal = pos[None, :] <= pos[:, None]
    same = valid_mask[:, :, None] == valid_mask[:, None, :]
    return (causal[None] & same)[:, None]


def flash_prefill_attention_plain(q, k, v, valid_mask, *, scale: float):
    """Plain PyTorch of `flash_prefill_attention`: fp32 scores, the same mask
    rule, probabilities rounded to v's type, output rounded to q's type."""
    return mha(q, k, v, scale=scale, mask=_prefill_mask(valid_mask.bool()))


def flash_prefill_attention(q, k, v, valid_mask, *, scale: float):
    """q (B, T, Hq, D); k/v (B, T, Hkv, D); valid_mask bool (B, T) -> (B, T, Hq, D).

    Row i attends to key j iff j <= i and valid[i] == valid[j]: causal within
    the valid prefix of a right-padded prompt. Padding rows are DEFINED by the
    same rule (they attend to the padding keys at or before them, as the
    segment ids of the TPU kernel make them); callers ignore them.
    """
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, valid_mask, scale=scale)
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_prefill_attention: needs bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape or valid_mask.shape != (B, T):
        raise ValueError(f"flash_prefill_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"valid {tuple(valid_mask.shape)}")
    if D not in _KERNEL_HEAD_DIMS or T % _TILE or Hq % Hkv:
        raise ValueError(f"flash_prefill_attention: needs head_dim in {_KERNEL_HEAD_DIMS}, T a multiple of {_TILE} "
                         f"and Hq a multiple of Hkv (D={D}, T={T}, Hq={Hq}, Hkv={Hkv})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    valid = valid_mask.to(torch.bool).contiguous()
    out = torch.empty_like(q)
    rc = build.load().mu_flash_prefill_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
                                            B, T, Hq, Hkv, D, float(scale), build.stream_handle(q))
    build.check(rc, "mu_flash_prefill_bf16")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0


def flash_vit_attention_plain(q, k, v, *, scale: float):
    """Plain PyTorch of `flash_vit_attention`, head-major in and out; fp32
    inputs go through bf16 as in the kernel's wrapper."""
    dt = q.dtype
    if dt == torch.float32:
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)
    return out.transpose(1, 2).to(dt)


def flash_vit_attention(q, k, v, *, scale: float):
    """Non-causal full-sequence ViT attention, HEAD-MAJOR (B, H, N, D) in and
    out. fp32 inputs (the "default" tier, see `flash_vit_usable`) are cast to
    bf16 for the kernel, whose products are bf16 either way, and the output is
    cast back."""
    if q.device.type == "cpu":
        return flash_vit_attention_plain(q, k, v, scale=scale)
    dt = q.dtype
    if dt == torch.float32:
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    B, H, N, D = q.shape
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_vit_attention: needs bf16 or fp32 q/k/v, got {dt}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_vit_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in _KERNEL_HEAD_DIMS or N % _TILE:
        raise ValueError(f"flash_vit_attention: needs head_dim in {_KERNEL_HEAD_DIMS} and N a multiple of {_TILE} "
                         f"(D={D}, N={N})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    rc = build.load().mu_flash_vit_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N, D,
                                        float(scale), build.stream_handle(q))
    build.check(rc, "mu_flash_vit_bf16")
    flash_vit_attention.launches += 1
    return out.to(dt)


flash_vit_attention.launches = 0
