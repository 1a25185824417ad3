"""Rotary position embeddings: 1-D, 3-D multimodal (MRoPE) and the scaling
family (counterpart of mingunivision_tpu/ops/rope.py).

The session drives flat positions, where MRoPE (per-plane tables interleaved
in `mrope_section * 2` chunks, plane i % 3) reduces exactly to 1-D RoPE.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions int (..., L) -> (cos, sin) fp32 of shape (..., L, dim)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def mrope_cos_sin(positions: torch.Tensor, dim: int, theta: float, sections: Sequence[int]):
    """positions int (3, B, L), the (t, h, w) planes -> (cos, sin) (B, L, dim):
    chunk i of `sections` doubled comes from plane i % 3."""
    cos3, sin3 = rope_cos_sin(positions, dim, theta)  # (3, B, L, dim)
    secs = list(sections) * 2
    cos_parts = [c[i % 3] for i, c in enumerate(cos3.split(secs, dim=-1))]
    sin_parts = [c[i % 3] for i, c in enumerate(sin3.split(secs, dim=-1))]
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def linear_scaled_cos_sin(positions, dim: int, theta: float, scaling_factor: float):
    """Linear RoPE scaling: positions divided by the factor."""
    return rope_cos_sin(positions.float() / scaling_factor, dim, theta)


def dynamic_ntk_theta(seq_len: int, dim: int, theta: float, scaling_factor: float,
                      max_position_embeddings: int) -> float:
    """Dynamic-NTK base: past the trained length the base grows so that the
    longest wavelength covers the new window."""
    if seq_len <= max_position_embeddings:
        return theta
    alpha = scaling_factor * seq_len / max_position_embeddings - (scaling_factor - 1)
    return theta * alpha ** (dim / (dim - 2))


def _yarn_find_correction_dim(num_rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_cos_sin(positions, dim: int, theta: float, scaling_factor: float, *,
                 original_max_position_embeddings: int = 4096, beta_fast: float = 32.0, beta_slow: float = 1.0,
                 mscale: float = 1.0, mscale_all_dim: float = 0.0):
    """YaRN scaling: per-dimension blend of scaled and unscaled frequencies over
    a linear ramp between the beta_fast / beta_slow correction dims, with the
    attention-temperature mscale folded into cos / sin."""
    half = dim // 2
    dev = positions.device
    pos_freqs = theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim)
    low = math.floor(_yarn_find_correction_dim(beta_fast, dim, theta, original_max_position_embeddings))
    high = math.ceil(_yarn_find_correction_dim(beta_slow, dim, theta, original_max_position_embeddings))
    low, high = max(low, 0), min(high, half - 1)
    ramp = ((torch.arange(half, dtype=torch.float32, device=dev) - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
    extrapolate = 1.0 - ramp  # 1 -> keep the frequency (high), 0 -> interpolate
    inv_freq = (1.0 / (scaling_factor * pos_freqs)) * (1 - extrapolate) + (1.0 / pos_freqs) * extrapolate
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    m = float(yarn_get_mscale(scaling_factor, mscale) / yarn_get_mscale(scaling_factor, mscale_all_dim))
    return emb.cos() * m, emb.sin() * m


def scaled_rope_cos_sin(positions, dim: int, theta: float, *, scaling_type: str = "none", scaling_factor: float = 1.0,
                        seq_len: int = 0, max_position_embeddings: int = 32768, **yarn_kwargs):
    """Dispatch over the reference's RoPE scaling family (config rope_scaling)."""
    if scaling_type in ("none", None) or scaling_factor in (None, 1.0) and scaling_type not in ("yarn",):
        if scaling_type == "dynamic":
            theta = dynamic_ntk_theta(seq_len, dim, theta, scaling_factor or 1.0, max_position_embeddings)
        return rope_cos_sin(positions, dim, theta)
    if scaling_type == "linear":
        return linear_scaled_cos_sin(positions, dim, theta, scaling_factor)
    if scaling_type == "dynamic":
        return rope_cos_sin(positions, dim, dynamic_ntk_theta(seq_len, dim, theta, scaling_factor,
                                                              max_position_embeddings))
    if scaling_type == "yarn":
        return yarn_cos_sin(positions, dim, theta, scaling_factor, **yarn_kwargs)
    raise ValueError(f"unknown rope scaling {scaling_type}")


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
