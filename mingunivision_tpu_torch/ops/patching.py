"""Patch layout ops (counterpart of mingunivision_tpu/ops/patching.py)."""

from __future__ import annotations

import math

import torch


def unpatchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, L, p*p*3) -> (B, 3, H, W) for square L; per-patch layout (p, q, c)."""
    B, L, _ = x.shape
    p = patch_size
    h = w = math.isqrt(L)
    if h * w != L:
        raise ValueError(f"unpatchify needs a square token count, got {L}")
    x = x.reshape(B, h, w, p, p, 3).permute(0, 5, 1, 3, 2, 4)  # n c h p w q
    return x.reshape(B, 3, h * p, w * p)


def expand_sem_to_pix_tokens(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """(B, hw, r*r*C) -> (B, hw*r*r, C): einops "b (h w) (x y c) -> b (h x w y) c"."""
    B, L, D = x.shape
    h = w = math.isqrt(L)
    if h * w != L:
        raise ValueError(f"expand_sem_to_pix_tokens needs a square token count, got {L}")
    r = ratio
    x = x.reshape(B, h, w, r, r, D // (r * r)).permute(0, 1, 3, 2, 4, 5)  # b h x w y c
    return x.reshape(B, h * r * w * r, D // (r * r))
