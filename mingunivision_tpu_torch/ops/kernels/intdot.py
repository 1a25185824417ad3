"""Integer-dot arithmetic of the int4/int8 kernels, in plain PyTorch
(counterpart of mingunivision_tpu/ops/kernels/intdot.py).

The quantized kernels quantize their ACTIVATIONS per row to s8 and multiply
them with the weight bytes in integer dots, then descale the fp32 result. For
a split-halves packed int4 byte b = lo' | hi' << 4 (offset-binary nibbles,
weights lo' - 8 and hi' - 8):

    x_lo @ W_lo + x_hi @ W_hi
      = (x_lo - x_hi/16) @ (b & 15) + (x_hi @ s8(b ^ 0x80)) / 16 - 8 * rowsum(x_lo)

so each logical product is two integer dots on the packed bytes as they lie.
These helpers are the shared arithmetic of the kernels' plain versions and
follow the JAX formulation exactly: `corr` from the ROUNDED operands, +1e-12
on the scales, round half to even (`torch.round`, as `jnp.round`). The integer
dots are exact (float64 sums of integers), as the int32 sums of the kernels,
and every division is correctly rounded on every device (`div_exact`).
"""

from __future__ import annotations

import torch


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. PyTorch's CUDA division by a
    Python number multiplies by the number's rounded reciprocal instead, which
    misses the quotient in the last place (for d = 3072, a third of fp32 x);
    a divisor tensor on x's device takes the true division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product a (..., K) @ b (K, N) of small integer operands,
    as fp32 (the rounding of an int32 result converted to fp32)."""
    return torch.matmul(a.double(), b.double()).float()


def quant_rows_s8_pair(lo: torch.Tensor, hi: torch.Tensor):
    """Per-row s8 quantization of the split-halves two-dot operands.
    Returns (a1 s8, a2 s8, sa1 (N, 1), sa2 (N, 1), corr (N, 1)), fp32 scales."""
    lo32, hi32 = lo.float(), hi.float()
    c1 = lo32 - hi32 * (1.0 / 16.0)
    sa1 = div_exact(c1.abs().amax(dim=-1, keepdim=True), 127.0) + 1e-12
    sa2 = div_exact(hi32.abs().amax(dim=-1, keepdim=True), 127.0) + 1e-12
    a1r = torch.round(c1 / sa1)
    a2r = torch.round(hi32 / sa2)
    corr = 8.0 * (a1r.sum(dim=-1, keepdim=True) * sa1 + a2r.sum(dim=-1, keepdim=True) * (sa2 * (1.0 / 16.0)))
    return a1r.to(torch.int8), a2r.to(torch.int8), sa1, sa2, corr


def split_bytes(q_u8: torch.Tensor):
    """Packed int4 bytes -> (b & 15, s8(b ^ 0x80)) as int8: the two integer-dot operands."""
    bx = (q_u8 ^ 0x80).view(torch.int8)
    return bx & 0xF, bx


def mm4_s8(q_u8: torch.Tensor, a1, a2, sa1, sa2, corr) -> torch.Tensor:
    """The two integer dots and the fp32 epilogue for quant_rows_s8_pair operands:
    x @ dequant-without-scale(q), q (K/2, N) packed bytes -> (rows, N) fp32."""
    m, bx = split_bytes(q_u8)
    d1 = int_dot(a1, m)
    d2 = int_dot(a2, bx)
    return d1 * sa1 + d2 * (sa2 * (1.0 / 16.0)) - corr


def silu_exact(g: torch.Tensor) -> torch.Tensor:
    """silu of fp32 g as the CUDA kernels compute it: g / (1 + exp(-g)) with the
    exp taken in double and rounded to fp32, so that the kernels' and the plain
    versions' fp32 exps (which differ in the last place) never enter. The s8
    re-quantization of silu(g) * u makes the int4 paths sensitive to one ulp
    of its row maximum."""
    return g / (1.0 + torch.exp(-g.double()).float())


def quant_rows_s8(x: torch.Tensor):
    """Per-row s8 quantization for int8-weight dots. Returns (x_s8, sx (N, 1))."""
    x32 = x.float()
    sx = div_exact(x32.abs().amax(dim=-1, keepdim=True), 127.0) + 1e-12
    return torch.round(x32 / sx).to(torch.int8), sx


def mm8_s8(q_s8: torch.Tensor, x_s8: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """x @ W for int8 weights through one integer dot, descaled per row (the
    caller applies the per-column weight scale)."""
    return int_dot(x_s8, q_s8) * sx
