"""Dense layers over `(in, out)`-layout weights (counterpart of
mingunivision_tpu/ops/linear.py).

fp32 means true fp32 here: `fp32_matmul_precision("high")` and "highest" turn
TF32 off for both matmuls (`torch.backends.cuda.matmul.allow_tf32`) and
convolutions (`torch.backends.cudnn.allow_tf32`); "default" allows TF32, the
card's single-pass reduced-precision mode.

A quantized weight (`utils/quantize.QuantizedArray`) is dequantized to x's
dtype before the product, as the JAX package's XLA path does.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.utils.quantize import dequant_weight

_ALLOW_TF32 = {"default": True, "high": False, "highest": False}
# the fp32 tier in force: what the innermost `fp32_matmul_precision` block set
_FP32_PRECISION = contextvars.ContextVar("fp32_precision", default="highest")


def current_fp32_precision() -> str:
    """The fp32 matmul tier in force: "highest" outside any `fp32_matmul_precision` block."""
    return _FP32_PRECISION.get()


@contextlib.contextmanager
def fp32_matmul_precision(name: str):
    """Set the fp32 matmul mode for the block, restoring the previous one after."""
    allow = _ALLOW_TF32[name]
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    token = _FP32_PRECISION.set(name)
    try:
        yield
    finally:
        _FP32_PRECISION.reset(token)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def dense(x: torch.Tensor, params: dict) -> torch.Tensor:
    """x @ w (+ b) in x's dtype, one fused GEMM. Weights are `(in, out)`, plain or quantized."""
    b = params.get("b")
    return F.linear(x, dequant_weight(params["w"], x.dtype).t(), None if b is None else b.to(x.dtype))
