"""Fused whole-sampler of the rectified-flow head over linear int4 tables: the
CUDA kernel `csrc/rf_sampler_q4.cu` and its plain version.

Replaces the TPU kernel mingunivision_tpu/ops/kernels/rf_sampler.py
(`rf_sample_fused` -> `_sampler_q4_s8`, with `_modulated_ln` and
`_step_epilogue`): every Euler step of one sample, each over the 12 AdaLN
SwiGLU blocks, then the final layer, the CFG combine (optional channel
renorm) and the Euler update, in ONE launch, with the latent kept on chip.
What bounds it on the H100 is the bytes of the MLP tables: 453 MB of packed
int4 per Euler step at the 16B-A3B width (w12 (1536, 16384), w3 (4096, 3072)
per block), 7.25 GB over 16 steps. The kernel is a persistent cooperative
grid: the blocks' phases depend on each other, so grid-wide barriers stand in
for the TPU's sequential grid (see the source).

Arithmetic, as the TPU kernel: the modulated LN output and the SwiGLU hidden
state are quantized per row to the s8 operand pair (`intdot.py`), the weights
enter two integer dots each, the hidden state is rounded to the compute dtype
before its quantization, the running activation and the latent stay fp32,
and input_proj / final linear take compute-dtype operands with fp32 sums.

The sampler is chaotic at the s8 rounding boundaries: one quantized element
that rounds the other way moves the sample measurably after 16 steps. So the
plain version sums in the kernel's order (its LN and final-layer reductions
over 256 threads, its sequential input_proj, one exact integer sum per down
dot, correctly rounded divisions and 1/sqrt: `intdot.div_exact`, exp in
double: `intdot.silu_exact`), and the two agree to the bit on the card and on
the CPU; against the TPU kernel they differ by float reassociation only.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.kernels import build
from mingunivision_tpu_torch.ops.kernels.intdot import div_exact, mm4_s8, quant_rows_s8_pair, silu_exact
from mingunivision_tpu_torch.utils.quantize import dequant_weight, is_int4_linear

MAX_ROWS = 4  # CFG rows the kernel holds (3 for an edit, 2 for text-to-image)
THREADS = 256  # the kernel's block: the plain version sums in its order


def rf_sampler_supported(params, B: int, cfg_rows: int) -> bool:
    """Linear int4 res_blocks tables and a block-major CFG layout of B rows."""
    mlp = params["res_blocks"]["mlp"]
    return is_int4_linear(mlp["w12"]["w"]) and is_int4_linear(mlp["w3"]["w"]) and cfg_rows in (1, 2, 3) \
        and B % cfg_rows == 0


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


def cfg_combine(v, cfg_rows: int, text_cfg: float, image_cfg: float, renorm_channel: bool):
    """Guided velocity of every row from the block-major rows [cond | uncond (| text_uncond)]."""
    if cfg_rows == 1:
        return v
    n = v.shape[0] // cfg_rows
    if cfg_rows == 3:
        v_c, v_u, v_tu = v[:n], v[n : 2 * n], v[2 * n :]
        vg = v_u + image_cfg * (v_tu - v_u) + text_cfg * (v_c - v_tu)
    else:
        v_c, v_u = v[:n], v[n:]
        vg = v_u + text_cfg * (v_c - v_u)
    if renorm_channel:
        vg = vg * (_norm(v_c) / _norm(vg) + 1e-8).clamp(0.0, 1.0)
    return vg.repeat(cfg_rows, 1)


def _operands(params, compute_dtype):
    """The sampler's operands as the kernel reads them: fp32 tensors (the
    projections hold compute-dtype values), packed tables and their scales."""
    blocks = params["res_blocks"]
    w12, w3 = blocks["mlp"]["w12"]["w"], blocks["mlp"]["w3"]["w"]
    L, wq, h2 = w12.q.shape
    ip, fl = params["input_proj"], params["final_layer"]["linear"]

    def bias(p, n):
        b = p.get("b")
        return torch.zeros(n, device=w12.q.device) if b is None else b.float()

    return dict(
        win=dequant_weight(ip["w"], compute_dtype).float(), binp=bias(ip, 2 * wq),
        wfin=dequant_weight(fl["w"], compute_dtype).float(), bfin=bias(fl, fl["w"].shape[-1]),
        lnw=blocks["in_ln"]["w"].float(), lnb=blocks["in_ln"]["b"].float(),
        q12=w12.q, s12=w12.s.float().reshape(L, h2), b12=blocks["mlp"]["w12"]["b"].float().reshape(L, h2),
        q3=w3.q, s3=w3.s.float().reshape(L, -1), b3=blocks["mlp"]["w3"]["b"].float().reshape(L, -1),
    )


def rf_sample_fused_plain(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows: int,
                          renorm_channel: bool, compute_dtype=torch.bfloat16):
    """Plain PyTorch of `_sampler_q4_s8`: noise (B, C) fp32 (CFG rows tiled),
    block_mods (L, S, B, 3w), final_mods (S, B, 2w), dts (S,) -> (B, C) fp32."""
    o = _operands(params, compute_dtype)
    L, wq, h2 = o["q12"].shape
    w, H = 2 * wq, h2 // 2
    Hh = H // 2
    mods, fmods = block_mods.float(), final_mods.float()
    eps = float(cfg.ln_eps)
    xlat = noise.float()
    for s in range(dts.shape[0]):
        xcur = _seq_dot(xlat.to(compute_dtype).float(), o["win"]) + o["binp"]
        for l in range(L):
            md = mods[l, s]
            xs = _modulated_ln(xcur, o["lnw"][l], o["lnb"][l], md, w, eps)
            a1, a2, sa1, sa2, corr = quant_rows_s8_pair(xs[:, :wq], xs[:, wq:])
            q = o["q12"][l]
            g = mm4_s8(q[:, :H], a1, a2, sa1, sa2, corr) * o["s12"][l, :H] + o["b12"][l, :H]
            u = mm4_s8(q[:, H:], a1, a2, sa1, sa2, corr) * o["s12"][l, H:] + o["b12"][l, H:]
            hf = (silu_exact(g) * u).to(compute_dtype).float()
            b1, b2, sb1, sb2, corrh = quant_rows_s8_pair(hf[:, :Hh], hf[:, Hh:])
            po = mm4_s8(o["q3"][l], b1, b2, sb1, sb2, corrh) * o["s3"][l] + o["b3"][l]
            xcur = xcur + md[:, 2 * w :] * po
        xs = _modulated_ln(xcur, None, None, fmods[s], w, eps).to(compute_dtype).float()
        v = _final_linear(xs, o["wfin"]) + o["bfin"]
        xlat = xlat + dts[s] * cfg_combine(v, cfg_rows, text_cfg, image_cfg, renorm_channel)
    return xlat


def rf_sample_fused(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg, *, cfg_rows: int,
                    renorm_channel: bool, compute_dtype=torch.bfloat16):
    """One launch of the CUDA kernel for the whole Euler sample (see the module
    docstring). Arguments as `rf_sample_fused_plain`; returns (B, C) fp32."""
    if noise.device.type == "cpu":
        return rf_sample_fused_plain(params, cfg, noise, block_mods, final_mods, dts, text_cfg, image_cfg,
                                     cfg_rows=cfg_rows, renorm_channel=renorm_channel, compute_dtype=compute_dtype)
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rf_sample_fused: compute dtype {compute_dtype} is not built")
    o = {k: v.contiguous() for k, v in _operands(params, compute_dtype).items()}
    L, wq, h2 = o["q12"].shape
    w, H = 2 * wq, h2 // 2
    B, C = noise.shape
    S = dts.shape[0]
    dev = noise.device
    if B > MAX_ROWS or cfg_rows not in (1, 2, 3) or B % cfg_rows or w % 64 or H % 64 or C > 128:
        raise ValueError(f"rf_sample_fused: needs at most {MAX_ROWS} rows split into 1-3 CFG rows, width and "
                         f"hidden multiples of 64 and at most 128 channels (B={B}, w={w}, H={H}, C={C})")
    if tuple(o["q3"].shape) != (L, H // 2, w) or o["q12"].dtype != torch.uint8 or o["q3"].dtype != torch.uint8:
        raise ValueError("rf_sample_fused: w12/w3 must be packed uint8 (L, w/2, 2H) / (L, H/2, w) tables")
    tensors = dict(dts=dts.float(), x0=noise.float(), mods=block_mods.float(), fmods=final_mods.float())
    tensors = {k: v.contiguous() for k, v in tensors.items()}
    if tuple(tensors["mods"].shape) != (L, S, B, 3 * w) or tuple(tensors["fmods"].shape) != (S, B, 2 * w):
        raise ValueError("rf_sample_fused: modulations must be (L, S, B, 3w) and (S, B, 2w)")
    for name, t in list(o.items()) + list(tensors.items()):
        if t.device != dev:
            raise ValueError(f"rf_sample_fused: {name} is on {t.device}, not {dev}")
    wfin_t = o["wfin"].t().contiguous()  # (C, w): the kernel's warps read it along w
    xcur = torch.empty((B, w), dtype=torch.float32, device=dev)
    hbuf = torch.empty((B, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    rc = build.load().mu_rf_sampler_q4s8(
        tensors["dts"].data_ptr(), tensors["x0"].data_ptr(), o["win"].data_ptr(), o["binp"].data_ptr(),
        o["lnw"].data_ptr(), o["lnb"].data_ptr(), o["q12"].data_ptr(), o["s12"].data_ptr(), o["b12"].data_ptr(),
        o["q3"].data_ptr(), o["s3"].data_ptr(), o["b3"].data_ptr(), tensors["mods"].data_ptr(),
        tensors["fmods"].data_ptr(), wfin_t.data_ptr(), o["bfin"].data_ptr(), xcur.data_ptr(), hbuf.data_ptr(),
        out.data_ptr(), B, cfg_rows, int(renorm_channel), S, L, w, H, C, int(compute_dtype == torch.bfloat16),
        float(text_cfg), float(image_cfg), float(cfg.ln_eps), build.stream_handle(noise),
    )
    build.check(rc, "mu_rf_sampler_q4s8")
    rf_sample_fused.launches += 1
    return out


rf_sample_fused.launches = 0
