"""One-token GQA decode attention: the CUDA kernel `csrc/decode_attention.cu`
and its plain version.

Replaces the TPU kernel mingunivision_tpu/ops/kernels/decode_attention.py
(`pallas_decode_attention` -> `_decode_attn_kernel`, head-major cache). What
bounds it on the H100 is the bytes of K and V at the allowed positions, which
at decode are so few that its latency sets its time: the kernel splits each
(row, kv head) over SPLIT_TILE-position tiles, one block each; a tile
with no allowed position exits at once, the others load only their allowed
rows, write an fp32 partial (m, l, acc) to a workspace kept per device and
stream (`_workspace`) and raise their split's flag, and the last block of
each (row, kv head) merges the flagged partials by log-sum-exp: one launch
per call. GQA stays grouped.

Fully masked rows: the kernel returns zeros (l clamped at 1e-30); the plain
version, like the JAX XLA path, returns the mean of V. The main path never
builds one (the current token is always allowed).

The wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from mingunivision_tpu_torch.ops.attention import mha
from mingunivision_tpu_torch.ops.kernels import build

SPLIT_TILE = 64  # positions per split: csrc/decode_attention.cu's kTileS (`mu_decode_attention_tile`)


@functools.lru_cache(maxsize=256)
def workspace_sizes(B: int, Hkv: int, S: int, G: int, D: int) -> tuple[int, int]:
    """The workspace a launch needs over a (B, Hkv, S) cache for G query heads
    per kv head of width D, cut into ceil(S / SPLIT_TILE) splits per (row, kv
    head): (fp32 values, each split's m and l per head and its G x D sum;
    int32 counters, a ticket per (row, kv head) and a flag per split of each)."""
    n_split = -(-S // SPLIT_TILE)
    return B * Hkv * n_split * G * (D + 2), B * Hkv * (1 + n_split)


_workspaces: dict = {}  # (device index, stream) -> (fp32 partials, int32 counters), grown when a call needs more


def _workspace(sizes: tuple[int, int], device, stream: int):
    """The partials' and counters' buffers for launches on `stream`, at least
    `sizes` (`workspace_sizes`) long: kept per device and stream (launches on
    one stream run in order, so they can share them), grown when a call needs
    more. The counters start at zero and every launch leaves them at zero; a
    partial is read only where its flag is up."""
    key = (device.index, stream)
    part, counters = _workspaces.get(key, (None, None))
    if part is None or part.numel() < sizes[0]:
        part = torch.empty(sizes[0], dtype=torch.float32, device=device)
    if counters is None or counters.numel() < sizes[1]:
        counters = torch.zeros(sizes[1], dtype=torch.int32, device=device)
    _workspaces[key] = (part, counters)
    return part, counters


def decode_attention_plain(q, k_cache, v_cache, mask, *, scale=None):
    """q (B, 1, Hq, D); head-major k/v (B, Hkv, S, D); mask bool (B, S)."""
    return mha(q, k_cache, v_cache, scale=scale, mask=mask[:, None, None, :], kv_head_major=True)


def decode_attention(q, k_cache, v_cache, mask, *, scale=None):
    """Single-token attention over the head-major cache -> (B, 1, Hq, D)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, mask, scale=scale)
    B, T, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if T != 1 or Hq % Hkv or Hq // Hkv > 8 or D not in (64, 128, 256):
        raise ValueError(f"decode_attention: unsupported q {tuple(q.shape)} for cache {tuple(k_cache.shape)}")
    if not q.is_contiguous():
        q = q.contiguous()
    dev = q.get_device()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype is not torch.bfloat16 or t.get_device() != dev or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous bf16 tensor on {q.device}")
    if v_cache.shape != (B, Hkv, S, D) or k_cache.shape != (B, Hkv, S, D):
        raise ValueError("decode_attention: k/v caches must be (B, Hkv, S, D)")
    if mask.dtype is not torch.bool or mask.get_device() != dev or mask.shape != (B, S):
        raise ValueError(f"decode_attention: mask must be bool (B, S), got {mask.dtype} {tuple(mask.shape)}")
    k_ptr, v_ptr = k_cache.data_ptr(), v_cache.data_ptr()
    if k_ptr % 16 or v_ptr % 16:
        raise ValueError("decode_attention: k/v caches must be 16-byte aligned")
    if not mask.is_contiguous():
        mask = mask.contiguous()
    out = torch.empty_like(q)
    G = Hq // Hkv
    stream = build.stream_handle(q)
    part, counters = _workspace(workspace_sizes(B, Hkv, S, G, D), q.device, stream)
    rc = build.load().mu_decode_attention_bf16(
        q.data_ptr(), k_ptr, v_ptr, mask.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(),
        B, Hkv, G, S, D, float(D**-0.5 if scale is None else scale), stream,
    )
    build.check(rc, "mu_decode_attention_bf16")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
