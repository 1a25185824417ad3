"""Attention in plain PyTorch (counterpart of mingunivision_tpu/ops/attention.py).

Queries are (batch, seq, heads, head_dim). GQA contracts queries reshaped to
(B, Hkv, G, T, D) against un-repeated KV. Scores and softmax are fp32; the
probabilities are rounded to V's dtype before the PV product, as in the JAX
package. `mha` over a head-major cache with a (B, S) mask is also the plain
version of the decode-attention kernel (ops/kernels/decode_attention.py).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    kv_head_major: bool = False,
) -> torch.Tensor:
    """q (B, T, Hq, D); k/v (B, S, Hkv, D), or (B, Hkv, S, D) with
    `kv_head_major`; mask bool broadcastable to (B, 1, T, S), True = attend.
    Returns (B, T, Hq, D) in q's dtype."""
    B, T, Hq, D = q.shape
    if not kv_head_major:
        k = k.transpose(1, 2)
        v = v.transpose(1, 2)
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D**-0.5

    qg = q.reshape(B, T, Hkv, G, D).permute(0, 2, 3, 1, 4).float()  # (B, Hkv, G, T, D)
    scores = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale  # (B, Hkv, G, T, S)
    if mask is not None:
        m = torch.broadcast_to(mask, (B, 1, T, S))[:, :, None]  # (B, 1, 1, T, S)
        scores = scores.masked_fill(~m, NEG_INF)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()[:, :, None])  # (B, Hkv, G, T, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


def cached_decode_attention(q, k_cache, v_cache, cache_len: int, *, scale=None):
    """Single-step attention over a preallocated head-major cache
    (B, Hkv, Smax, D). q (B, 1, Hq, D); cache_len: valid positions INCLUDING
    the current step."""
    valid = torch.arange(k_cache.shape[2], device=q.device) < cache_len
    return mha(q, k_cache, v_cache, scale=scale, mask=valid, kv_head_major=True)
