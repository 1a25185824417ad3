"""Fused whole-sampler of the rectified-flow head over linear int4 or int8
tables: the CUDA kernels `csrc/rf_sampler_q4.cu` and `csrc/rf_sampler_q8.cu`
(the latter in both dot modes) and their plain versions.

Replaces the TPU kernel mingunivision_tpu/ops/kernels/rf_sampler.py
(`rf_sample_fused` -> `_sampler_q4_s8` for int4 tables, `_sampler_q8` for
int8 ones with s8_dots = False, the JAX package's default, or True, its
INT8_INT_DOTS, here the `s8_dots` argument; both with `_modulated_ln` and
`_step_epilogue`; and, with schedule="pipelined", `_sampler_q4_s8_pipelined`:
the int4 sample with w3 streamed in `down_chunk`-row pieces whose descaled
sums add in order, an explicit argument that `rf_sample` never passes, as in
the JAX package): every Euler step of one sample, each over the 12 AdaLN
SwiGLU blocks, then the final layer, the CFG combine (optional channel
renorm) and the Euler update, in ONE launch, with the latent kept on chip.
What bounds it on the H100 is the bytes of the MLP tables: 453 MB of packed
int4 (906 MB of int8) per Euler step at the 16B-A3B width (w12 (3072, 16384),
w3 (8192, 3072) per block), 7.25 GB (14.5 GB) over 16 steps. Both kernels
are one body (`csrc/rf_persistent.cuh`): a persistent cooperative grid whose
blocks' phases depend on each other, so grid-wide barriers stand in for the
TPU's sequential grid; a producer warp keeps a TMA ring of weight stages full
across the barriers, and both phases split stream-K over the CTAs
(`run_first`), their integer partials added into each tile's accumulators
and the tile's last contributor running its epilogue. They read a workspace
kept per device and stream (`q4_workspace_sizes`, `q8_workspace_sizes`) and
operands converted once per head (`_kernel_operands`), so a call allocates
its output only.

Arithmetic, as the TPU kernels. int4: the modulated LN output and the SwiGLU
hidden state are quantized per row to the s8 operand pair (`intdot.py`), the
weights enter two integer dots each, the hidden state is rounded to the
compute dtype before its quantization. int8 (exact dequant): the modulated
LN output and the hidden state are rounded to the compute dtype, the int8
weights enter the products as their exact values, the scales and biases are
applied to the fp32 sums. int8 with s8 dots: the modulated LN output, rounded
to the compute dtype, quantized per row to s8, the gate/up dots integer, the
hidden state kept in fp32 and quantized per row over each CHUNK-column
chunk for the down dots, whose descaled chunk sums add in order. All: the running activation and the latent stay
fp32, and input_proj / final linear take compute-dtype operands with fp32 sums.

The samplers are chaotic at their roundings (the s8 ones at the quantization
boundaries, the exact int8 one at its bf16 roundings of the modulated LN
output and of the hidden state): one element that rounds the other way moves
the sample measurably after 16 steps (on the card a plain version with
PyTorch's fp32 matrix products lay 1.4e-2 of the sample's maximum from the
first int8 kernel; PERF.md, `chip_smoke.py --phases rf_sensitivity`). So each
plain version gives its kernel's bits, on the card and on the CPU: its LN and
final-layer reductions in the kernel's order over 256 threads, its
sequential input_proj, correctly rounded divisions and 1/sqrt
(`intdot.div_exact`), exp in double (`intdot.silu_exact`), and every dot
exact before one rounding: the integer dots of the s8 modes, and the exact
int8 mode's digit dots (`_digit_dot`): each activation row on a fixed point
of its own, written as four s8 digits whose integer dots with the table
combine into the exact sum, rounded once to fp32. An exact sum is the same in
any order, so neither the kernels' split of the contraction nor their
arrival order enters. Against the TPU kernels they differ by float
reassociation only.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel of the table type or raises.
"""

from __future__ import annotations

import numbers
import weakref

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.moe_stream import _grown
from mingunivision_tpu_torch.ops.kernels.intdot import (
    div_exact,
    int_dot,
    mm4_s8,
    mm8_s8,
    quant_rows_s8,
    quant_rows_s8_pair,
    silu_exact,
    split_bytes,
)
from mingunivision_tpu_torch.utils.quantize import QuantizedArray, dequant_weight, is_int4_linear, is_int8_linear

MAX_ROWS = 4  # rows one launch holds (3 CFG rows for an edit, 2 for text-to-image); more go in groups
THREADS = 256  # the kernel's block: the plain version sums in its order
CHUNK = 4096  # the int8 s8 sampler's down chunk (the JAX package's rf_sample_fused(chunk=4096))
DOWN_CHUNK = 1024  # the int4 sampler's pipelined schedule: packed w3 rows per piece (rf_sample_fused(down_chunk=))
SCHEDULES = ("block", "pipelined")
# the int4 kernel's units: stages of STAGE packed rows; up tiles of UP_PAIRS column pairs, down tiles of
# DOWN_COLS columns (csrc/rf_sampler_q4.cu)
STAGE, UP_PAIRS, DOWN_COLS = 64, 64, 256


def fitting_chunk(n: int, c: int) -> int:
    """c (at most n), or its largest halving that divides n: how the JAX
    package's RF kernels cut a dimension of n into chunks of about c."""
    c = min(c, n)
    while n % c:
        c //= 2
    return c


def down_chunk(H: int) -> int:
    """The columns of h re-quantized together by the int8 s8 sampler (the JAX package's CH)."""
    return fitting_chunk(H, CHUNK)


def table_bits(params):
    """4 or 8 for linear int4 or int8 res_blocks tables (w12 and w3 alike), else None."""
    mlp = params["res_blocks"]["mlp"]
    w12, w3 = mlp["w12"]["w"], mlp["w3"]["w"]
    for bits, is_linear in ((4, is_int4_linear), (8, is_int8_linear)):
        if is_linear(w12) and is_linear(w3):
            return bits
    return None


def rf_sampler_supported(params, B: int, cfg_rows: int) -> bool:
    """Linear int4 or int8 res_blocks tables and a block-major CFG layout of B rows."""
    return table_bits(params) is not None and cfg_rows in (1, 2, 3) and B % cfg_rows == 0


def _warp_tree(v):
    """Lane 0's result of the kernel's warp reduction (xor shuffles 16, 8, 4, 2,
    1) over the last dim of 32 lanes."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o : 2 * o]
    return v[..., 0]


def _block_sum(v):
    """Row sums of v (R, n), (R, 1), in the kernel's order: each of its 256
    threads adds its strided elements in turn, each warp combines its lanes by
    the shuffle tree, and the 8 warp sums are added in order."""
    R, n = v.shape
    p = F.pad(v, (0, (-n) % THREADS)).view(R, -1, THREADS)
    acc = p[:, 0]
    for j in range(1, p.shape[1]):
        acc = acc + p[:, j]
    warps = _warp_tree(acc.view(R, THREADS // 32, 32))
    total = warps[:, 0]
    for k in range(1, warps.shape[1]):
        total = total + warps[:, k]
    return total[:, None]


def _modulated_ln(x, lnw, lnb, mods, w: int, eps: float):
    mu = div_exact(_block_sum(x), w)
    d = x - mu
    rstd = 1.0 / torch.sqrt(div_exact(_block_sum(d * d), w) + eps)
    ln = d * rstd
    if lnw is not None:
        ln = ln * lnw + lnb
    return ln * (1.0 + mods[:, w : 2 * w]) + mods[:, :w]


def _seq_dot(a, b):
    """a (R, K) @ b (K, N) as the kernel's threads sum it: k in order, one rounding per product and sum."""
    acc = a[:, :1] * b[0]
    for c in range(1, a.shape[1]):
        acc = acc + a[:, c : c + 1] * b[c]
    return acc


def _final_linear(xm, wfin):
    """xm (R, w) @ wfin (w, C) as the kernel's warps sum it: lane l adds k = l, l + 32, ... in
    order, then the shuffle tree."""
    R, w = xm.shape
    xv, wv = xm.view(R, w // 32, 32, 1), wfin.view(w // 32, 32, -1)
    acc = xv[:, 0] * wv[0]
    for j in range(1, w // 32):
        acc = acc + xv[:, j] * wv[j]
    return _warp_tree(acc.transpose(1, 2))


def _norm(a):
    """Per-row L2 norm with the squares summed in order, as the kernel's one thread does."""
    return torch.sqrt(_seq_dot(a * a, torch.ones((a.shape[1], 1), dtype=a.dtype, device=a.device)))


def image_scales(scale, n: int) -> list:
    """A guidance scale as n host floats, one per image: a number applies to
    every image; a host sequence or an (n,) tensor gives one each (a tensor
    on the card is read back, one sync: pass host values on a hot path)."""
    if isinstance(scale, torch.Tensor):
        scale = scale.reshape(-1).tolist() if scale.dim() else float(scale)
    if isinstance(scale, numbers.Real):
        return [float(scale)] * n
    scale = [float(s) for s in scale]
    if len(scale) != n:
        raise ValueError(f"{len(scale)} guidance scales for {n} images")
    return scale


def scale_rows(scale, n: int, device):
    """A guidance scale as the CFG combine takes it: a number as it is, per-image
    values as an (n, 1) fp32 tensor on `device` (broadcast over each image's row)."""
    if isinstance(scale, numbers.Real):
        return scale
    if isinstance(scale, torch.Tensor) and scale.dim() == 0:
        return float(scale)
    rows = torch.as_tensor(scale, dtype=torch.float32).reshape(-1).to(device)
    if rows.numel() != n:
        raise ValueError(f"{rows.numel()} guidance scales for {n} images")
    return rows[:, None]


def cfg_combine(v, cfg_rows: int, text_cfg, image_cfg, renorm_channel: bool):
    """Guided velocity of every row from the block-major rows [cond | uncond (|
    text_uncond)]; the scales are numbers or one per image (`scale_rows`)."""
    if cfg_rows == 1:
        return v
    n = v.shape[0] // cfg_rows
    text_cfg, image_cfg = scale_rows(text_cfg, n, v.device), scale_rows(image_cfg, n, v.device)
    if cfg_rows == 3:
        v_c, v_u, v_tu = v[:n], v[n : 2 * n], v[2 * n :]
        vg = v_u + image_cfg * (v_tu - v_u) + text_cfg * (v_c - v_tu)
    else:
        v_c, v_u = v[:n], v[n:]
        vg = v_u + text_cfg * (v_c - v_u)
    if renorm_channel:
        vg = vg * (_norm(v_c) / _norm(vg) + 1e-8).clamp(0.0, 1.0)
    return vg.repeat(cfg_rows, 1)


def block_operands(blocks):
    """The res_blocks' operands as the kernels read them (the samplers and the
    per-step stack): packed or int8 tables, fp32 scales, biases and LN
    affines, (L, ...) each."""
    w12, w3 = blocks["mlp"]["w12"]["w"], blocks["mlp"]["w3"]["w"]
    L, h2 = w12.q.shape[0], w12.q.shape[2]
    return dict(lnw=blocks["in_ln"]["w"].float(), lnb=blocks["in_ln"]["b"].float(),
                q12=w12.q, s12=w12.s.float().reshape(L, h2), b12=blocks["mlp"]["w12"]["b"].float().reshape(L, h2),
                q3=w3.q, s3=w3.s.float().reshape(L, -1), b3=blocks["mlp"]["w3"]["b"].float().reshape(L, -1))


def _operands(params, compute_dtype):
    """The sampler's operands as the kernel reads them: fp32 tensors (the
    projections hold compute-dtype values), packed tables and their scales."""
    ip, fl = params["input_proj"], params["final_layer"]["linear"]
    dev = params["res_blocks"]["mlp"]["w12"]["w"].q.device

    def bias(p, n):
        b = p.get("b")
        return torch.zeros(n, device=dev) if b is None else b.float()

    return dict(
        win=dequant_weight(ip["w"], compute_dtype).float(), binp=bias(ip, ip["w"].shape[-1]),
        wfin=dequant_weight(fl["w"], compute_dtype).float(), bfin=bias(fl, fl["w"].shape[-1]),
        **block_operands(params["res_blocks"]),
    )


def _mlp_q4(o, l, xs, H, compute_dtype, kc=None):
    """One block's SwiGLU over int4 tables, as `_sampler_q4_s8` (see the module
    docstring); with `kc`, as `_sampler_q4_s8_pipelined`: the down dots over
    kc-row pieces of packed w3, each piece's descaled sums d1 * sb1 + d2 *
    sb2 / 16 added in order before the correction."""
    wq = o["q12"].shape[1]
    a1, a2, sa1, sa2, corr = quant_rows_s8_pair(xs[:, :wq], xs[:, wq:])
    q = o["q12"][l]
    g = mm4_s8(q[:, :H], a1, a2, sa1, sa2, corr) * o["s12"][l, :H] + o["b12"][l, :H]
    u = mm4_s8(q[:, H:], a1, a2, sa1, sa2, corr) * o["s12"][l, H:] + o["b12"][l, H:]
    hf = (silu_exact(g) * u).to(compute_dtype).float()
    b1, b2, sb1, sb2, corrh = quant_rows_s8_pair(hf[:, : H // 2], hf[:, H // 2 :])
    if kc is None:
        return mm4_s8(o["q3"][l], b1, b2, sb1, sb2, corrh) * o["s3"][l] + o["b3"][l]
    m, bx = split_bytes(o["q3"][l])
    acc = torch.zeros((xs.shape[0], o["q3"].shape[-1]), dtype=torch.float32, device=xs.device)
    for k0 in range(0, H // 2, kc):
        acc = acc + (int_dot(b1[:, k0 : k0 + kc], m[k0 : k0 + kc]) * sb1
                     + int_dot(b2[:, k0 : k0 + kc], bx[k0 : k0 + kc]) * (sb2 * (1.0 / 16.0)))
    return (acc - corrh) * o["s3"][l] + o["b3"][l]


DIGITS, FIX = 4, 30  # the exact int8 sampler's s8 digits an activation and its fixed point (csrc/rf_sampler_q8.cu)


def _pow2(n):
    """2.0 ** n as float64, exactly (n an integer tensor within the normal range), built from its bits."""
    return ((n.long() + 1023) << 52).view(torch.float64)


def fixed_point(x):
    """Each row of x (R, K) fp32 on its own fixed point: (E, X), E (R, 1) the
    exponent of the row's largest |x| (frexp: max |x| = m 2^E, m in [0.5, 1);
    0 for a row of zeros), X = rint(x * 2^(FIX - E)) int64, |X| < 2^FIX
    (exact for every bf16 value within 2^-22 of the row's largest)."""
    e = torch.frexp(x.abs().amax(-1, keepdim=True)).exponent.long()
    return e, torch.round(x.double() * _pow2(FIX - e)).long()


def digits(X):
    """The DIGITS balanced base-256 s8 digits of int64 X (|X| < 2^FIX), lowest
    first: X = sum d_i 256^i, each d_i in [-128, 127] -> (DIGITS, *X.shape)."""
    out = []
    for _ in range(DIGITS - 1):
        d = ((X + 128) & 255) - 128
        out.append(d)
        X = (X - d) >> 8
    return torch.stack(out + [X])


def _digit_dot(x, q):
    """x (R, K) @ q (K, N) as the exact int8 sampler computes it: x (rounded
    to the compute dtype) on its rows' fixed points (`fixed_point`), as four
    s8 digits (`digits`) whose dots with the integer table q are exact
    integers (below 2^27; here float64 sums of small integers), combined into
    the exact sum S of X @ q (below 2^52), rounded once: fp32(S * 2^(E - FIX)).
    The same in any contraction order and on any split of it -> (R, N) fp32."""
    e, X = fixed_point(x)
    d = torch.matmul(digits(X).double(), q.double())  # (DIGITS, R, N)
    S = d[0] + 256.0 * d[1] + 65536.0 * d[2] + 16777216.0 * d[3]
    return (S * _pow2(e - FIX)).float()


def _mlp_q8s8(o, l, xs, H, compute_dtype):
    """One block's SwiGLU over int8 tables, as `_sampler_q8` with s8_dots=True."""
    xq, sx = quant_rows_s8(xs.to(compute_dtype).float())
    q = o["q12"][l]
    g = mm8_s8(q[:, :H], xq, sx) * o["s12"][l, :H] + o["b12"][l, :H]
    u = mm8_s8(q[:, H:], xq, sx) * o["s12"][l, H:] + o["b12"][l, H:]
    hf = silu_exact(g) * u
    ch = down_chunk(H)
    acc = torch.zeros((xs.shape[0], o["q3"].shape[-1]), dtype=torch.float32, device=xs.device)
    for c0 in range(0, H, ch):
        hq, sh = quant_rows_s8(hf[:, c0 : c0 + ch])
        acc = acc + mm8_s8(o["q3"][l][c0 : c0 + ch], hq, sh)
    return acc * o["s3"][l] + o["b3"][l]


def _mlp_q8(o, l, xs, H, compute_dtype):
    """One block's SwiGLU over int8 tables, as `_sampler_q8` with
    s8_dots=False, its dots exact before one rounding (`_digit_dot`)."""
    xs = xs.to(compute_dtype).float()
    gu = _digit_dot(xs, o["q12"][l])
    g = gu[:, :H] * o["s12"][l, :H] + o["b12"][l, :H]
    u = gu[:, H:] * o["s12"][l, H:] + o["b12"][l, H:]
    hf = (silu_exact(g) * u).to(compute_dtype).float()
    return _digit_dot(hf, o["q3"][l]) * o["s3"][l] + o["b3"][l]


def rf_sample_fused_plain(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows: int,
                          renorm_channel: bool, compute_dtype=torch.bfloat16, s8_dots: bool = False,
                          schedule: str = "block", down_chunk: int = DOWN_CHUNK):
    """Plain PyTorch of `_sampler_q4_s8` (int4 tables; with schedule
    "pipelined", `_sampler_q4_s8_pipelined` with `down_chunk` packed w3 rows
    per piece) or `_sampler_q8` (int8 tables, in the dot mode `s8_dots`;
    `schedule` is read for int4 tables only): noise (B, C) fp32 (CFG rows
    tiled), block_mods (L, S, B, 3w), final_mods (S, B, 2w), dts (S,);
    text_cfg / image_cfg numbers or one per image (`cfg_combine`) -> (B, C) fp32."""
    bits = table_bits(params)
    if bits is None:
        raise ValueError("rf_sample_fused_plain: needs linear int4 or int8 res_blocks tables")
    if schedule not in SCHEDULES:
        raise ValueError(f"rf_sample_fused_plain: schedule {schedule!r} is not one of {SCHEDULES}")
    o = _operands(params, compute_dtype)
    L, h2 = o["q12"].shape[0], o["q12"].shape[2]
    w, H = o["win"].shape[1], h2 // 2
    if bits == 8:
        mlp = _mlp_q8s8 if s8_dots else _mlp_q8
    elif schedule == "pipelined":  # the JAX package's KC: packed w3 rows per piece
        kc = fitting_chunk(H // 2, down_chunk)
        mlp = lambda *a: _mlp_q4(*a, kc=kc)  # noqa: E731
    else:
        mlp = _mlp_q4
    mods, fmods = block_mods.float(), final_mods.float()
    eps = float(cfg.ln_eps)
    xlat = noise.float()
    for s in range(dts.shape[0]):
        xcur = _seq_dot(xlat.to(compute_dtype).float(), o["win"]) + o["binp"]
        for l in range(L):
            md = mods[l, s]
            xs = _modulated_ln(xcur, o["lnw"][l], o["lnb"][l], md, w, eps)
            xcur = xcur + md[:, 2 * w :] * mlp(o, l, xs, H, compute_dtype)
        xs = _modulated_ln(xcur, None, None, fmods[s], w, eps).to(compute_dtype).float()
        v = _final_linear(xs, o["wfin"]) + o["bfin"]
        xlat = xlat + dts[s] * cfg_combine(v, cfg_rows, text_cfg, image_cfg, renorm_channel)
    return xlat


def rf_sample_fused_q8_plain(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows: int,
                             renorm_channel: bool, compute_dtype=torch.bfloat16, s8_dots: bool = False):
    """The plain version over int8 tables only (`_sampler_q8`)."""
    if table_bits(params) != 8:
        raise ValueError("rf_sample_fused_q8_plain: needs int8 res_blocks tables")
    return rf_sample_fused_plain(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg,
                                 cfg_rows=cfg_rows, renorm_channel=renorm_channel, compute_dtype=compute_dtype,
                                 s8_dots=s8_dots)


def q4_units(w: int, H: int) -> tuple[int, int, int, int]:
    """(up tiles, stages of an up tile, down tiles, stages of a down tile) of
    the int4 kernel at width w and hidden H: an up tile is UP_PAIRS column
    pairs of w12 over its w / 2 packed rows, a down tile DOWN_COLS columns of
    w3 over its H / 2; a stage is STAGE packed rows (the last one padded)."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    return cdiv(H // 2, UP_PAIRS), cdiv(w // 2, STAGE), cdiv(w, DOWN_COLS), cdiv(H // 2, STAGE)


def run_first(c: int, units: int, grid: int) -> int:
    """The first unit of CTA c's run: the kernel's CTAs take contiguous runs
    [run_first(c), run_first(c + 1)) of the tile-major units, within one unit
    of each other in length."""
    return c * units // grid


def q4_workspace_sizes(w: int, H: int, kc: int) -> tuple[int, int]:
    """(fp32, int32) elements of the int4 kernel's workspace for width w,
    hidden H and the pipelined schedule's kc packed rows a piece (0: the
    block schedule), at MAX_ROWS rows. fp32: h (H a row) and three buffers of
    x (w a row: a block's input and output, input_proj's). int32 (the
    library's `mu_rf_sampler_q4s8_workspace`): each up tile's two dots'
    accumulators (DOWN_COLS columns a row), each down tile's per piece, two
    buffers of each down tile's sums of h's operands, the tiles' tickets,
    two buffers of h's row maxima, the barrier's arrival and exit counts."""
    Tu, _, Td, _ = q4_units(w, H)
    pieces = (H // 2) // kc if kc and kc != H // 2 else 1
    acc = 2 * MAX_ROWS * DOWN_COLS
    return (MAX_ROWS * (H + 3 * w),
            Tu * acc + pieces * Td * acc + 2 * Td * MAX_ROWS * 2 + Tu + Td + 2 * MAX_ROWS * 2 + 2)


UP_COLS = 128  # the int8 kernel's up tile: h columns, their gate and up columns its four 64-column boxes


def q8_units(w: int, H: int) -> tuple[int, int, int, int]:
    """(up tiles, stages of an up tile, down tiles, stages of a down tile) of
    the int8 kernel at width w and hidden H: an up tile is UP_COLS columns of
    h (their gate and up columns of w12) over w rows, a down tile DOWN_COLS
    columns of w3 over its H rows; a stage is STAGE rows."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    return cdiv(H, UP_COLS), w // STAGE, cdiv(w, DOWN_COLS), H // STAGE


def q8_workspace_sizes(w: int, H: int, pieces: int) -> tuple[int, int]:
    """(fp32, int32) elements of the int8 kernel's workspace for width w,
    hidden H and h in `pieces` chunks (the s8 mode's H / CH; the exact mode:
    1), at MAX_ROWS rows. fp32: as `q4_workspace_sizes`. int32 words (the
    library's `mu_rf_sampler_q8_workspace`): each up tile's int64
    accumulators (DOWN_COLS columns a row: gate and up), each down tile's per
    piece, the tiles' tickets, two buffers of h's row maxima per piece, the
    barrier's two counts."""
    Tu, _, Td, _ = q8_units(w, H)
    return (MAX_ROWS * (H + 3 * w),
            2 * (Tu + pieces * Td) * MAX_ROWS * DOWN_COLS + Tu + Td + 2 * MAX_ROWS * pieces + 2)


_sampler_workspaces: dict = {}  # (device index, stream) -> (fp32, int32 zeros), grown on demand


def _sampler_workspace(sizes: tuple[int, int], device, stream: int):
    """The fused samplers' buffers for launches on `stream`, at least `sizes`
    long: kept per device and stream (launches on one stream run in order,
    so the int4 and int8 kernels share them), grown when a call needs more.
    The int32 part starts at zero and every launch leaves it at zero."""
    return _grown(_sampler_workspaces, (device.index, stream), sizes, (torch.float32, torch.int32), device)


_operand_cache: dict = {}  # (device, compute dtype) -> (the sources' weak references and versions, operands)


def _source_tensors(params):
    """The tensors the kernels' converted operands come from (the tables themselves are read as they are)."""
    out = []
    for leaf in (params["input_proj"], params["final_layer"]["linear"], params["res_blocks"]["in_ln"],
                 params["res_blocks"]["mlp"]["w12"], params["res_blocks"]["mlp"]["w3"]):
        for v in leaf.values():
            if isinstance(v, QuantizedArray):
                out += [v.q, v.s]
            elif isinstance(v, torch.Tensor):
                out.append(v)
    return out


def _kernel_operands(params, compute_dtype):
    """`_operands` as the CUDA kernels take them (contiguous, wfin also
    transposed), converted once per head and compute dtype: kept, without the
    tables, for as long as every source tensor is alive and unchanged (the
    last head used per device and dtype), so a call allocates none of them."""
    tables = {k: params["res_blocks"]["mlp"][k]["w"].q for k in ("w12", "w3")}
    key = (tables["w12"].device, compute_dtype)
    sources = _source_tensors(params)
    kept = _operand_cache.get(key)
    if kept is None or len(kept[0]) != len(sources) or any(
            ref() is not t or t._version != v for (ref, v), t in zip(kept[0], sources)):
        o = {k: v.contiguous() for k, v in _operands(params, compute_dtype).items() if k not in ("q12", "q3")}
        o["wfin_t"] = o["wfin"].t().contiguous()  # (C, w): the kernel's warps read it along w
        o["win_c"], o["wfin_t_c"] = o["win"].to(compute_dtype), o["wfin_t"].to(compute_dtype)  # exact
        kept = ([(weakref.ref(t), t._version) for t in sources], o)
        _operand_cache[key] = kept
    return {**kept[1], "q12": tables["w12"].contiguous(), "q3": tables["w3"].contiguous()}


def rf_sample_fused(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows: int,
                    renorm_channel: bool, compute_dtype=torch.bfloat16, s8_dots: bool = False,
                    schedule: str = "block", down_chunk: int = DOWN_CHUNK):
    """The whole Euler sample (see the module docstring): one launch of the
    table type's CUDA kernel (int8 tables: in the dot mode `s8_dots`, which
    int4 tables do not read: their sampler always takes s8 dots; int4 tables:
    in the `schedule`, "pipelined" with `down_chunk`, which int8 tables do not
    read) per group of images whose CFG rows fit its MAX_ROWS (each
    image's block-major rows {i, n + i, 2n + i} gathered, the results
    scattered back: the rows of different images never mix, so the groups
    give the ungrouped result). `text_cfg` / `image_cfg` are numbers or one
    per image (`image_scales`); a launch takes two scales by value, so the
    groups are formed from images with equal scale pairs. Arguments as
    `rf_sample_fused_plain`; returns (B, C) fp32."""
    B = noise.shape[0]
    if cfg_rows not in (1, 2, 3) or B % cfg_rows:
        raise ValueError(f"rf_sample_fused: {B} rows do not split into cfg_rows={cfg_rows}")
    if schedule not in SCHEDULES:
        raise ValueError(f"rf_sample_fused: schedule {schedule!r} is not one of {SCHEDULES}")
    kw = dict(cfg_rows=cfg_rows, renorm_channel=renorm_channel, compute_dtype=compute_dtype, s8_dots=s8_dots,
              schedule=schedule, down_chunk=down_chunk)
    n = B // cfg_rows
    per = max(1, MAX_ROWS // cfg_rows)  # images per launch
    pairs = list(zip(image_scales(text_cfg, n), image_scales(image_cfg, n)))
    groups: dict = {}  # (text_cfg, image_cfg) -> its images, in order
    for i, pair in enumerate(pairs):
        groups.setdefault(pair, []).append(i)
    if len(groups) == 1 and n <= per:
        return _rf_sample_group(params, cfg, noise, block_mods, final_mods, dts, *pairs[0], **kw)
    out = torch.empty((B, noise.shape[1]), dtype=torch.float32, device=noise.device)
    for (tcfg, icfg), images in groups.items():
        for i0 in range(0, len(images), per):
            idx = torch.tensor(images[i0 : i0 + per], device=noise.device)
            rows = (torch.arange(cfg_rows, device=noise.device)[:, None] * n + idx[None, :]).reshape(-1)
            out[rows] = _rf_sample_group(params, cfg, noise[rows], block_mods[:, :, rows], final_mods[:, rows], dts,
                                         tcfg, icfg, **kw)
    return out


def _rf_sample_group(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows: int,
                     renorm_channel: bool, compute_dtype, s8_dots: bool, schedule: str, down_chunk: int, grid: int = 0):
    """One launch of the table type's CUDA kernel over at most MAX_ROWS
    block-major rows (the plain version for CPU tensors). `grid`: the
    kernel's CTAs (0: one per SM), for tests of its unit partition."""
    if noise.device.type == "cpu":
        return rf_sample_fused_plain(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg,
                                     cfg_rows=cfg_rows, renorm_channel=renorm_channel, compute_dtype=compute_dtype,
                                     s8_dots=s8_dots, schedule=schedule, down_chunk=down_chunk)
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rf_sample_fused: compute dtype {compute_dtype} is not built")
    bits = table_bits(params)
    if bits is None:
        raise ValueError("rf_sample_fused: needs linear int4 or int8 res_blocks tables")
    o = _kernel_operands(params, compute_dtype)
    L, h2 = o["q12"].shape[0], o["q12"].shape[2]
    w, H = o["win"].shape[1], h2 // 2
    B, C = noise.shape
    S = dts.shape[0]
    dev = noise.device
    if B > MAX_ROWS or w % 64 or H % 64 or C > 128:
        raise ValueError(f"rf_sample_fused: needs at most {MAX_ROWS} rows per launch, width and "
                         f"hidden multiples of 64 and at most 128 channels (B={B}, w={w}, H={H}, C={C})")
    dtype, shapes = (torch.uint8, ((L, w // 2, h2), (L, H // 2, w))) if bits == 4 else \
        (torch.int8, ((L, w, h2), (L, H, w)))
    if (tuple(o["q12"].shape), tuple(o["q3"].shape)) != shapes or o["q12"].dtype != dtype or o["q3"].dtype != dtype:
        raise ValueError(f"rf_sample_fused: w12/w3 must be {dtype} {shapes[0]} / {shapes[1]} tables")
    # the kernels read bf16 modulations and projections as they are where the compute dtype is bf16; fp32 otherwise
    bf16_in = compute_dtype == block_mods.dtype == final_mods.dtype == torch.bfloat16
    mdt = torch.bfloat16 if bf16_in else torch.float32
    tensors = dict(dts=dts.float(), x0=noise.float(), mods=block_mods.to(mdt), fmods=final_mods.to(mdt))
    tensors = {k: v.contiguous() for k, v in tensors.items()}
    if tuple(tensors["mods"].shape) != (L, S, B, 3 * w) or tuple(tensors["fmods"].shape) != (S, B, 2 * w):
        raise ValueError("rf_sample_fused: modulations must be (L, S, B, 3w) and (S, B, 2w)")
    for name, t in list(o.items()) + list(tensors.items()):
        if t.device != dev:
            raise ValueError(f"rf_sample_fused: {name} is on {t.device}, not {dev}")
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    win, wfin_t = (o["win_c"], o["wfin_t_c"]) if bf16_in else (o["win"], o["wfin_t"])
    head = (tensors["dts"].data_ptr(), tensors["x0"].data_ptr(), win.data_ptr(), o["binp"].data_ptr(),
            o["lnw"].data_ptr(), o["lnb"].data_ptr(), o["q12"].data_ptr(), o["s12"].data_ptr(), o["b12"].data_ptr(),
            o["q3"].data_ptr(), o["s3"].data_ptr(), o["b3"].data_ptr(), tensors["mods"].data_ptr(),
            tensors["fmods"].data_ptr(), wfin_t.data_ptr(), o["bfin"].data_ptr())
    common = (B, cfg_rows, int(renorm_channel), S, L, w, H, C, int(compute_dtype == torch.bfloat16), int(bf16_in))
    scales = (float(text_cfg), float(image_cfg), float(cfg.ln_eps), build.stream_handle(noise))
    if bits == 8:  # the int8 kernel's dot mode and down chunk (the exact mode: one piece)
        ch = fitting_chunk(H, CHUNK) if s8_dots else H
        fws, iws = _sampler_workspace(q8_workspace_sizes(w, H, H // ch), dev, build.stream_handle(noise))
        name = "mu_rf_sampler_q8"
        rc = build.load().mu_rf_sampler_q8(*head, fws.data_ptr(), iws.data_ptr(), out.data_ptr(), *common,
                                           int(s8_dots), ch, grid, *scales)
        counter = rf_sample_fused_q8s8 if s8_dots else rf_sample_fused_q8
    else:  # the int4 kernel's down pieces (0: the block schedule)
        kc = fitting_chunk(H // 2, down_chunk) if schedule == "pipelined" else 0
        if kc and kc % STAGE and kc != H // 2:
            raise ValueError(f"rf_sample_fused: the pipelined schedule's pieces of {kc} packed w3 rows are not "
                             f"whole {STAGE}-row stages")
        fws, iws = _sampler_workspace(q4_workspace_sizes(w, H, kc), dev, build.stream_handle(noise))
        name = "mu_rf_sampler_q4s8"
        rc = build.load().mu_rf_sampler_q4s8(*head, fws.data_ptr(), iws.data_ptr(), out.data_ptr(), *common, kc,
                                             grid, *scales)
        counter = rf_sample_fused_q4_pipelined if schedule == "pipelined" else rf_sample_fused
    build.check(rc, name)
    counter.launches += 1  # one per kernel launch
    return out


def rf_sample_fused_q8(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows: int,
                       renorm_channel: bool, compute_dtype=torch.bfloat16):
    """`rf_sample_fused` for int8 tables only, exact dequant (the name that
    carries that kernel's launch count; `rf_sample_fused` carries the int4
    kernel's)."""
    if table_bits(params) != 8:
        raise ValueError("rf_sample_fused_q8: needs int8 res_blocks tables")
    return rf_sample_fused(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, cfg_rows=cfg_rows,
                           renorm_channel=renorm_channel, compute_dtype=compute_dtype)


def rf_sample_fused_q8s8(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows: int,
                         renorm_channel: bool, compute_dtype=torch.bfloat16):
    """`rf_sample_fused` for int8 tables only, s8 dots (the name that carries
    that kernel's launch count)."""
    if table_bits(params) != 8:
        raise ValueError("rf_sample_fused_q8s8: needs int8 res_blocks tables")
    return rf_sample_fused(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, cfg_rows=cfg_rows,
                           renorm_channel=renorm_channel, compute_dtype=compute_dtype, s8_dots=True)


def rf_sample_fused_q4_pipelined(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *,
                                 cfg_rows: int, renorm_channel: bool, compute_dtype=torch.bfloat16,
                                 down_chunk: int = DOWN_CHUNK):
    """`rf_sample_fused` for int4 tables only, in the pipelined schedule (the
    name that carries that kernel's launch count)."""
    if table_bits(params) != 4:
        raise ValueError("rf_sample_fused_q4_pipelined: needs int4 res_blocks tables")
    return rf_sample_fused(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, cfg_rows=cfg_rows,
                           renorm_channel=renorm_channel, compute_dtype=compute_dtype, schedule="pipelined",
                           down_chunk=down_chunk)


rf_sample_fused.launches = 0
rf_sample_fused_q4_pipelined.launches = 0
rf_sample_fused_q8.launches = 0
rf_sample_fused_q8s8.launches = 0
