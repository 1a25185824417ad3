"""One-token GQA decode attention: the CUDA kernel `csrc/decode_attention.cu`
and its plain version.

Replaces the TPU kernel mingunivision_tpu/ops/kernels/decode_attention.py
(`pallas_decode_attention` -> `_decode_attn_kernel`, head-major cache). What
bounds it on the H100 is the bytes of K and V it reads; the kernel reads them
only at positions the mask allows and skips 256-position tiles with none, with
an fp32 online softmax per (row, kv-head) block and GQA kept grouped.

Fully masked rows: the kernel returns zeros (l clamped at 1e-30); the plain
version, like the JAX XLA path, returns the mean of V. The main path never
builds one (the current token is always allowed).

The wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from mingunivision_tpu_torch.ops.attention import mha
from mingunivision_tpu_torch.ops.kernels import build


def decode_attention_plain(q, k_cache, v_cache, mask, *, scale=None):
    """q (B, 1, Hq, D); head-major k/v (B, Hkv, S, D); mask bool (B, S)."""
    return mha(q, k_cache, v_cache, scale=scale, mask=mask[:, None, None, :], kv_head_major=True)


def decode_attention(q, k_cache, v_cache, mask, *, scale=None):
    """Single-token attention over the head-major cache -> (B, 1, Hq, D)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, mask, scale=scale)
    B, T, Hq, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    if T != 1 or Hq % Hkv or Hq // Hkv > 8 or D not in (64, 128, 256):
        raise ValueError(f"decode_attention: unsupported q {tuple(q.shape)} for cache {tuple(k_cache.shape)}")
    q = q.contiguous()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous bf16 tensor on {q.device}")
    if tuple(v_cache.shape) != (B, Hkv, S, D) or tuple(k_cache.shape) != (B, Hkv, S, D):
        raise ValueError("decode_attention: k/v caches must be (B, Hkv, S, D)")
    if mask.dtype != torch.bool or mask.device != q.device or tuple(mask.shape) != (B, S):
        raise ValueError(f"decode_attention: mask must be bool (B, S), got {mask.dtype} {tuple(mask.shape)}")
    mask = mask.contiguous()
    out = torch.empty_like(q)
    rc = build.load().mu_decode_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, Hkv, Hq // Hkv, S, D, float(D**-0.5 if scale is None else scale), build.stream_handle(q),
    )
    build.check(rc, "mu_decode_attention_bf16")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
