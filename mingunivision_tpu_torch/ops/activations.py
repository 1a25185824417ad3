"""Activations (counterpart of mingunivision_tpu/ops/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf GELU (torch `nn.GELU()` default)."""
    return F.gelu(x)


def swiglu(x12: torch.Tensor) -> torch.Tensor:
    """silu(x1) * x2 on a fused last dim x12 = [x1; x2]."""
    x1, x2 = x12.chunk(2, dim=-1)
    return F.silu(x1) * x2


def swiglu_hidden_dim(hidden_features: int) -> int:
    """SwiGLUFFNFused hidden sizing: round8(2/3 * hidden)."""
    return (int(hidden_features * 2 / 3) + 7) // 8 * 8
