"""1-D rotary position embeddings (counterpart of mingunivision_tpu/ops/rope.py).

Text-to-image positions are flat, where the 3-D MRoPE of the reference reduces
exactly to 1-D RoPE; MRoPE comes with the understanding path.
"""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions int (..., L) -> (cos, sin) fp32 of shape (..., L, dim)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q (B, T, Hq, D), k (B, T, Hk, D); cos/sin (B, T, D) fp32. Math in fp32."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]

    def rot(x):
        xf = x.float()
        return (xf * cos + rotate_half(xf) * sin).to(x.dtype)

    return rot(q), rot(k)
