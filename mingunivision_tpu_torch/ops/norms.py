"""Normalization primitives (counterpart of mingunivision_tpu/ops/norms.py).

Both norms compute statistics in fp32 and cast back to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; fp32 internals; optional affine."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """T5-style RMSNorm: fp32 variance, `(weight * x_normed).to(in_dtype)`."""
    return F.rms_norm(x.float(), (x.shape[-1],), weight.float(), eps).to(x.dtype)
