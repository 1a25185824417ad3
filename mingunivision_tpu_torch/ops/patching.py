"""Patch layout ops and the bicubic resize of positional embeddings
(counterpart of mingunivision_tpu/ops/patching.py)."""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, L, p*p*3); per-patch layout (p, q, c)."""
    B, C, H, W = imgs.shape
    p = patch_size
    h, w = H // p, W // p
    x = imgs.reshape(B, C, h, p, w, p).permute(0, 2, 4, 3, 5, 1)  # n h w p q c
    return x.reshape(B, h * w, p * p * C)


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


# ---------------------------------------------------------------------------
# bicubic interpolation in torch's convention, as explicit weight matrices
# ---------------------------------------------------------------------------


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch's cubic convolution kernel (a = -0.75; PIL uses a = -0.5)."""
    t = np.abs(t)
    out = np.zeros_like(t)
    m1 = t <= 1
    out[m1] = ((a + 2) * t[m1] - (a + 3)) * t[m1] * t[m1] + 1
    m2 = (t > 1) & (t < 2)
    out[m2] = (((t[m2] - 5) * t[m2] + 8) * t[m2] - 4) * a
    return out


@lru_cache(maxsize=64)
def _bicubic_weight_matrix(in_size: int, out_size: int, scale: Optional[float]) -> np.ndarray:
    """Dense (out, in) interpolation matrix for one axis, fp32.

    F.interpolate(mode="bicubic", align_corners=False): src = (dst + 0.5) /
    scale - 0.5 with scale = out / in, unless a scale_factor was given, which
    torch then uses for the coordinates (that is how the reference's
    interpolate_offset = 0.1 takes effect). Border indices clamp; no antialiasing.
    """
    s = scale if scale is not None else out_size / in_size
    x = (np.arange(out_size, dtype=np.float64) + 0.5) / s - 0.5
    i0 = np.floor(x).astype(np.int64)
    t = x - i0
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for k in range(-1, 3):
        np.add.at(W, (np.arange(out_size), np.clip(i0 + k, 0, in_size - 1)), _cubic_kernel(t - k))
    return W.astype(np.float32)


def bicubic_resize_torch(x: torch.Tensor, out_hw, scale_hw=None) -> torch.Tensor:
    """Bicubic resize of (..., H, W) in torch's convention, as two fp32 matrix
    products; `scale_hw`: optional explicit (sh, sw) scale factors."""
    H, W = x.shape[-2], x.shape[-1]
    sh, sw = scale_hw if scale_hw is not None else (None, None)
    Mh = torch.from_numpy(_bicubic_weight_matrix(H, out_hw[0], sh)).to(x.device)
    Mw = torch.from_numpy(_bicubic_weight_matrix(W, out_hw[1], sw)).to(x.device)
    y = torch.matmul(Mh, x.float())  # (..., oh, W)
    return torch.matmul(y, Mw.t()).to(x.dtype)  # (..., oh, ow)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_size: int, new_grid: int, *, offset: float = 0.1,
                          cls_last: bool = True) -> torch.Tensor:
    """Resize a ViT positional-embedding table (1, N+1, D) to a new grid; the
    CLS position is LAST (the encoder appends CLS after the patch tokens).
    Returns (1, new_grid**2 + 1, D). fp32 math, cast back. With `offset` the
    coordinates use scale (new_grid + offset) / grid_size, as the reference."""
    if new_grid == grid_size:
        return pos_embed
    pe = pos_embed.float()
    patch_pe, cls_pe = (pe[:, :-1], pe[:, -1:]) if cls_last else (pe[:, 1:], pe[:, :1])
    D = patch_pe.shape[-1]
    grid = patch_pe.reshape(1, grid_size, grid_size, D).permute(0, 3, 1, 2)  # (1, D, M, M)
    s = float(new_grid + offset) / grid_size
    out = bicubic_resize_torch(grid, (new_grid, new_grid), scale_hw=(s, s) if offset else None)
    out = out.permute(0, 2, 3, 1).reshape(1, new_grid * new_grid, D)
    parts = [out, cls_pe] if cls_last else [cls_pe, out]
    return torch.cat(parts, dim=1).to(pos_embed.dtype)
