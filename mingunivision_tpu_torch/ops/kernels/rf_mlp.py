"""Per-step residual stack of the rectified-flow head over linear int4 or int8
tables: one Euler step of all 12 AdaLN SwiGLU blocks in one launch of the
fused samplers' persistent body, in four bodies, and their plain versions.

Replaces the TPU kernel mingunivision_tpu/ops/kernels/rf_mlp.py
(`rf_mlp_stack`: one pallas_call per Euler step over all 12 AdaLN SwiGLU
blocks; `_kernel` for int8 tables, `_kernel_q8_s8` for int8 tables with s8
dots, the JAX package's INT8_INT_DOTS, `_kernel_q4` for int4 tables with exact
dequant, `_kernel_q4_s8` for int4 tables with s8 dots, its INT4_UNPACK_MODE
"s8"; here the `int_dots` argument, from RuntimeConfig.rf_int_dots and
rf_int4_int_dots). The JAX package's other int4 unpack modes ("i32", "i16",
"i8", "alg", "mxu") feed a TPU's matrix unit the same dequantized product,
so the port's exact int4 body stands for all of them. What bounds a launch on
the H100 is the bytes of the tables: 453 MB of packed int4 (906 MB of int8)
at the 16B-A3B width, read once per Euler step.

The kernels are the stack mode of the fused samplers (`csrc/rf_sampler_q4.cu`
for the int4 s8 body, `csrc/rf_sampler_q8.cu` for the other three; their body
is `csrc/rf_persistent.cuh`): a persistent cooperative grid, a producer warp
keeping a TMA ring of weight stages full across the 24 grid barriers of the
step, stream-K units of s8 tensor-core products whose integer partials add
into each tile's accumulators, the tile's last contributor running its
epilogue; x comes in from the caller and leaves after the last block. They
read the samplers' workspace, kept per device and stream.

Arithmetic, as the TPU kernels: x enters in the compute dtype and leaves
rounded to it after the last block; the running activation is fp32. The s8
bodies: the int8 one quantizes the fp32 modulated LN output per row,
re-quantizes h per row over each CHUNK (2,048) columns and adds each chunk's
descaled down sum times s3 in order; the int4 one quantizes to the s8 operand
pair and sums its down dots in KC_Q4S8 (1,024) packed-row pieces. The exact
bodies take each dot exact before one rounding (`rf_sampler._digit_dot`: each
activation row, rounded to the compute dtype, on its own fixed point as four
s8 digits whose integer dots with the table combine into the exact sum): the
int8 one is the int8 sampler's exact block (`rf_sampler._mlp_q8`), the int4
one the same over both nibble planes of the packed tables, the low plane
meeting the first half of the contraction and the high plane the second, in
one exact sum a column. The JAX kernels' chunking of these sums only bounds
VMEM; exact sums change nothing but their last rounding. The head is chaotic at
its bf16 and s8 roundings, so each plain version gives its kernel's bits
(exact integer dots; `_block_sum` through `rf_sampler._modulated_ln`;
`intdot.silu_exact`); against the TPU kernels they differ by float
reassociation only.

`rf_mlp_stack` runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel (one launch per group of at most MAX_ROWS rows: the
rows never mix) or raises.
"""

from __future__ import annotations

import torch

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.intdot import (
    int_dot,
    mm4_s8,
    mm8_s8,
    quant_rows_s8,
    quant_rows_s8_pair,
    silu_exact,
    split_bytes,
)
from mingunivision_tpu_torch.ops.kernels.rf_sampler import (
    MAX_ROWS,
    _digit_dot,
    _mlp_q8,
    _modulated_ln,
    _sampler_workspace,
    block_operands,
    fitting_chunk,
    q4_workspace_sizes,
    q8_workspace_sizes,
)
from mingunivision_tpu_torch.utils.quantize import is_int4_linear, is_int8_linear

CHUNK = 2048  # the JAX package's rf_mlp_stack(chunk=2048): the int8 s8 body's columns of h quantized together
KC_Q4S8 = 1024  # packed w3 rows per down piece of `_kernel_q4_s8`


def stack_bits(blocks):
    """4 or 8 for linear int4 or int8 w12 / w3 tables of equal bits, else None."""
    w12, w3 = blocks["mlp"]["w12"]["w"], blocks["mlp"]["w3"]["w"]
    for bits, is_linear in ((4, is_int4_linear), (8, is_int8_linear)):
        if is_linear(w12) and is_linear(w3):
            return bits
    return None


def rf_mlp_supported(blocks) -> bool:
    """Linear int4 or int8 w12 / w3 of equal bits with the JAX package's
    alignment (w and H multiples of 128; at int4 their halves), as its
    `rf_mlp_supported`; NF4 tables answer False."""
    bits = stack_bits(blocks)
    if bits is None:
        return False
    w, H = _width(blocks, bits)
    if bits == 4:
        return (w // 2) % 128 == 0 and (H // 2) % 128 == 0
    return w % 128 == 0 and H % 128 == 0


def _width(blocks, bits):
    L, wq, h2 = blocks["mlp"]["w12"]["w"].q.shape
    return (2 * wq if bits == 4 else wq), h2 // 2


def _planes(q: torch.Tensor) -> torch.Tensor:
    """Split-halves packed int4 bytes (K/2, N) -> the integer table (K, N) of
    their weights: the low nibble plane (b & 15) - 8 for the first K/2 rows,
    the high plane (b >> 4) - 8 for the rest (int16)."""
    q = q.to(torch.int16)
    return torch.cat([(q & 0xF) - 8, (q >> 4) - 8], dim=0)


def _block_q8(o, l, xs, H, cdt, _):
    """`_kernel` with every dot exact before one rounding: the int8 sampler's
    exact block (`rf_sampler._mlp_q8`)."""
    return _mlp_q8(o, l, xs, H, cdt)


def _block_q8s8(o, l, xs, H, cdt, ch):
    """`_kernel_q8_s8`: the fp32 modulated LN output quantized per row to s8,
    integer gate/up dots; h in fp32, re-quantized per row over each ch-column
    chunk, each chunk's descaled down dot times s3 added in order; b3 once."""
    xq, sx = quant_rows_s8(xs)
    q = o["q12"][l]
    g = mm8_s8(q[:, :H], xq, sx) * o["s12"][l, :H] + o["b12"][l, :H]
    u = mm8_s8(q[:, H:], xq, sx) * o["s12"][l, H:] + o["b12"][l, H:]
    hf = silu_exact(g) * u
    acc = torch.zeros((xs.shape[0], o["q3"].shape[-1]), dtype=torch.float32, device=xs.device)
    for c0 in range(0, H, ch):
        hq, sh = quant_rows_s8(hf[:, c0 : c0 + ch])
        acc = acc + mm8_s8(o["q3"][l][c0 : c0 + ch], hq, sh) * o["s3"][l]
    return acc + o["b3"][l]


def _block_q4(o, l, xs, H, cdt, _):
    """`_kernel_q4` with every dot exact before one rounding: the
    compute-dtype activations' digit dots with both nibble planes of the
    packed tables in one sum a column (`_planes`); h rounded to the compute
    dtype; s3 and b3 after the down sum."""
    xa = xs.to(cdt).float()
    gu = _digit_dot(xa, _planes(o["q12"][l]))
    g = gu[:, :H] * o["s12"][l, :H] + o["b12"][l, :H]
    u = gu[:, H:] * o["s12"][l, H:] + o["b12"][l, H:]
    hf = (silu_exact(g) * u).to(cdt).float()
    return _digit_dot(hf, _planes(o["q3"][l])) * o["s3"][l] + o["b3"][l]


def _block_q4s8(o, l, xs, H, cdt, kc):
    """`_kernel_q4_s8`: the fp32 modulated LN output quantized to the s8
    operand pair, integer gate/up dots; h rounded to the compute dtype and
    quantized to the s8 pair over all of H; the down dots over kc-row chunks,
    each chunk's descaled sums added as (po + d1 * sb1) + d2 * sb2 / 16; then
    the correction, s3 and b3."""
    wq, Hh = o["q12"].shape[1], H // 2
    a1, a2, sa1, sa2, corr = quant_rows_s8_pair(xs[:, :wq], xs[:, wq:])
    q = o["q12"][l]
    g = mm4_s8(q[:, :H], a1, a2, sa1, sa2, corr) * o["s12"][l, :H] + o["b12"][l, :H]
    u = mm4_s8(q[:, H:], a1, a2, sa1, sa2, corr) * o["s12"][l, H:] + o["b12"][l, H:]
    hf = (silu_exact(g) * u).to(cdt).float()
    b1, b2, sb1, sb2, corrh = quant_rows_s8_pair(hf[:, :Hh], hf[:, Hh:])
    m, bx = split_bytes(o["q3"][l])
    po = torch.zeros((xs.shape[0], o["q3"].shape[-1]), dtype=torch.float32, device=xs.device)
    for k0 in range(0, Hh, kc):
        po = (po + int_dot(b1[:, k0 : k0 + kc], m[k0 : k0 + kc]) * sb1
              + int_dot(b2[:, k0 : k0 + kc], bx[k0 : k0 + kc]) * (sb2 * (1.0 / 16.0)))
    return (po - corrh) * o["s3"][l] + o["b3"][l]


def _tiling(H: int, chunk: int):
    """(the int8 s8 body's columns of h quantized together, the int4 s8
    body's packed-row down pieces): the JAX package's CH and KC. Its cap of CH
    at 2048 for int4 tables only tiles the gate/up columns, which changes no
    sum; the exact bodies' chunks only bound the TPU kernels' VMEM."""
    return fitting_chunk(H, chunk), fitting_chunk(H // 2, KC_Q4S8)


def rf_mlp_stack_plain(blocks, x, mods, *, ln_eps: float = 1e-6, chunk: int = CHUNK, int_dots: bool):
    """Plain PyTorch of the stack in the body of the table type and dot mode
    (`int_dots`: s8 dots): x (B, w) in the compute dtype, mods (L, B, 3w)
    (shift, scale, gate) -> (B, w) in x's dtype."""
    bits = stack_bits(blocks)
    if bits is None:
        raise ValueError("rf_mlp_stack_plain: needs linear int4 or int8 w12 / w3 tables of equal bits")
    o = block_operands(blocks)
    L = o["q12"].shape[0]
    w, H = _width(blocks, bits)
    ch, kc = _tiling(H, chunk)
    body, arg = {(8, False): (_block_q8, None), (8, True): (_block_q8s8, ch), (4, False): (_block_q4, None),
                 (4, True): (_block_q4s8, kc)}[(bits, bool(int_dots))]
    cdt = x.dtype
    xcur = x.float()
    for l in range(L):
        md = mods[l].float()
        xs = _modulated_ln(xcur, o["lnw"][l], o["lnb"][l], md, w, float(ln_eps))
        xcur = xcur + md[:, 2 * w :] * body(o, l, xs, H, cdt, arg)
    return xcur.to(cdt)


def rf_mlp_stack(blocks, x, mods, *, ln_eps: float = 1e-6, chunk: int = CHUNK, int_dots: bool, grid: int = 0):
    """One Euler step of the residual stack (see the module docstring): x (B,
    w) in the compute dtype (bf16 or fp32), mods (L, B, 3w) -> (B, w) in x's
    dtype. CPU tensors run the plain version; CUDA tensors launch the kernel
    of the table type and dot mode once per group of MAX_ROWS rows. `grid`:
    the kernel's CTAs (0: one per SM), for tests of its unit partition."""
    if x.device.type == "cpu":
        return rf_mlp_stack_plain(blocks, x, mods, ln_eps=ln_eps, chunk=chunk, int_dots=int_dots)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rf_mlp_stack: compute dtype {x.dtype} is not built")
    bits = stack_bits(blocks)
    if bits is None:
        raise ValueError("rf_mlp_stack: needs linear int4 or int8 w12 / w3 tables of equal bits")
    o = {k: v.contiguous() for k, v in block_operands(blocks).items()}
    L = o["q12"].shape[0]
    w, H = _width(blocks, bits)
    B = x.shape[0]
    align = 128 if bits == 4 else 64  # int4: whole 64-row stages of packed rows
    if w % align or H % align:
        raise ValueError(f"rf_mlp_stack: width and hidden must be multiples of {align} (w={w}, H={H})")
    dtype, shapes = (torch.uint8, ((L, w // 2, 2 * H), (L, H // 2, w))) if bits == 4 else \
        (torch.int8, ((L, w, 2 * H), (L, H, w)))
    if (tuple(o["q12"].shape), tuple(o["q3"].shape)) != shapes or o["q12"].dtype != dtype or o["q3"].dtype != dtype:
        raise ValueError(f"rf_mlp_stack: w12/w3 must be {dtype} {shapes[0]} / {shapes[1]} tables")
    if tuple(mods.shape) != (L, B, 3 * w) or tuple(x.shape) != (B, w):
        raise ValueError(f"rf_mlp_stack: x must be (B, {w}) and mods ({L}, B, {3 * w})")
    for name, t in list(o.items()) + [("mods", mods)]:
        if t.device != x.device:
            raise ValueError(f"rf_mlp_stack: {name} is on {t.device}, not {x.device}")
    ch, kc = _tiling(H, chunk)
    s8 = bool(int_dots)
    counter = {(4, True): rf_mlp_stack_q4s8, (4, False): rf_mlp_stack_q4, (8, True): rf_mlp_stack_q8s8,
               (8, False): rf_mlp_stack_q8}[(bits, s8)]
    lib = build.load()
    stream = build.stream_handle(x)
    if bits == 4 and s8:
        fws, iws = _sampler_workspace(q4_workspace_sizes(w, H, kc), x.device, stream)
    else:
        fws, iws = _sampler_workspace(q8_workspace_sizes(w, H, H // ch if s8 else 1), x.device, stream)
    tables = (o["lnw"].data_ptr(), o["lnb"].data_ptr(), o["q12"].data_ptr(), o["s12"].data_ptr(),
              o["b12"].data_ptr(), o["q3"].data_ptr(), o["s3"].data_ptr(), o["b3"].data_ptr())
    outs = []
    for r0 in range(0, B, MAX_ROWS):
        rows = slice(r0, min(r0 + MAX_ROWS, B))
        xg = x[rows].float().contiguous()
        mg = mods[:, rows].float().contiguous()
        R = xg.shape[0]
        out = torch.empty((R, w), dtype=torch.float32, device=x.device)
        head = (xg.data_ptr(), *tables, mg.data_ptr(), out.data_ptr(), fws.data_ptr(), iws.data_ptr(), R, L, w, H,
                int(x.dtype == torch.bfloat16))
        if bits == 4 and s8:
            rc, name = lib.mu_rf_stack_q4s8(*head, kc, grid, float(ln_eps), stream), "mu_rf_stack_q4s8"
        else:
            rc, name = lib.mu_rf_stack_q8(*head, bits, int(s8), ch, grid, float(ln_eps), stream), "mu_rf_stack_q8"
        build.check(rc, name)
        counter.launches += 1  # one per kernel launch
        outs.append(out)
    return (outs[0] if len(outs) == 1 else torch.cat(outs)).to(x.dtype)


def rf_mlp_stack_q4s8(blocks, x, mods, *, ln_eps: float = 1e-6, chunk: int = CHUNK):
    """`rf_mlp_stack` over int4 tables with s8 dots (`_kernel_q4_s8`; the name that carries its launch count)."""
    return _of_bits(4, True, "rf_mlp_stack_q4s8", blocks, x, mods, ln_eps, chunk)


def rf_mlp_stack_q4(blocks, x, mods, *, ln_eps: float = 1e-6, chunk: int = CHUNK):
    """`rf_mlp_stack` over int4 tables, exact dequant (`_kernel_q4`; the name that carries its launch count)."""
    return _of_bits(4, False, "rf_mlp_stack_q4", blocks, x, mods, ln_eps, chunk)


def rf_mlp_stack_q8s8(blocks, x, mods, *, ln_eps: float = 1e-6, chunk: int = CHUNK):
    """`rf_mlp_stack` over int8 tables with s8 dots (`_kernel_q8_s8`; the name that carries its launch count)."""
    return _of_bits(8, True, "rf_mlp_stack_q8s8", blocks, x, mods, ln_eps, chunk)


def rf_mlp_stack_q8(blocks, x, mods, *, ln_eps: float = 1e-6, chunk: int = CHUNK):
    """`rf_mlp_stack` over int8 tables, exact dequant (`_kernel`; the name that carries its launch count)."""
    return _of_bits(8, False, "rf_mlp_stack_q8", blocks, x, mods, ln_eps, chunk)


def _of_bits(bits, int_dots, op, blocks, x, mods, ln_eps, chunk):
    if stack_bits(blocks) != bits:
        raise ValueError(f"{op}: needs int{bits} tables")
    return rf_mlp_stack(blocks, x, mods, ln_eps=ln_eps, chunk=chunk, int_dots=int_dots)


rf_mlp_stack_q4s8.launches = 0
rf_mlp_stack_q4.launches = 0
rf_mlp_stack_q8s8.launches = 0
rf_mlp_stack_q8.launches = 0
