"""Rectified-flow head: AdaLN SwiGLU-MLP velocity field + Euler ODE sampler
(counterpart of mingunivision_tpu/models/rf_head.py).

Linear int4 and int8 res_blocks tables take the fused whole-sampler
(`ops/kernels/rf_sampler.py`: the CUDA kernel on the card, its plain version
on the CPU), as the JAX package's TPU path does (int8 tables in the dot mode
`int_dots`). With `fused=False` (RuntimeConfig.rf_fused_sampler, the JAX
package's FUSED_SAMPLER) they run the Euler steps as a Python loop whose
velocity field takes the per-step stack kernel (`ops/kernels/rf_mlp.py`, one
launch per step over all blocks; int8 tables in the dot mode `int_dots`, int4
ones in `int4_int_dots`), chosen by the tables' kind where the JAX package
chooses by the device. Other tiers (bf16, NF4) run the Euler loop with every
block through `dense`, a quantized head's tables dequantized once per sample:
the JAX package has no kernel for NF4 tables either, so that loop is their
route, not a fallback.
Randomness is explicit: the caller passes `noise` (one row per image, or one
per CFG row). Training's velocity field is `rf_net_apply`, plain PyTorch over
floating tables.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.activations import swiglu
from mingunivision_tpu_torch.ops.kernels.rf_mlp import rf_mlp_stack, rf_mlp_supported, stack_bits
from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused, rf_sampler_supported, scale_rows
from mingunivision_tpu_torch.ops.linear import dense
from mingunivision_tpu_torch.ops.norms import layer_norm
from mingunivision_tpu_torch.utils.pytree import layer_view
from mingunivision_tpu_torch.utils.quantize import QuantizedArray, dequant_weight


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos, sin] order. t (B,) -> (B, dim) fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([args.cos(), args.sin()], dim=-1)


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


def _cond_embedding(params, cfg, t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y = time_embed(t * 1000) + cond_embed(z); t (B,), z (B, z) -> (B, w) in z's dtype."""
    temb = timestep_embedding(t * 1000.0, cfg.freq_embed_size).to(z.dtype)
    temb = dense(F.silu(dense(temb, params["time_embed"]["fc1"]).float()).to(z.dtype), params["time_embed"]["fc2"])
    return temb + dense(z, params["cond_embed"])


def rf_net_apply(params, cfg, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Velocity field of training, plain differentiable PyTorch over floating
    tables (the JAX package's `rf_net_apply`: the modulations computed per
    block, the blocks as a loop). x (B, C_target), t (B,), z (B, z_channels)."""
    y = _cond_embedding(params, cfg, t, z)
    h = dense(x, params["input_proj"])
    sy = F.silu(y.float()).to(h.dtype)
    for d in range(cfg.depth):
        blk = layer_view(params["res_blocks"], d)
        shift, scale, gate = dense(sy, blk["adaLN"]).chunk(3, dim=-1)
        hh = _modulate(layer_norm(h, blk["in_ln"]["w"], blk["in_ln"]["b"], eps=cfg.ln_eps), shift, scale)
        h = h + gate * dense(swiglu(dense(hh, blk["mlp"]["w12"])), blk["mlp"]["w3"])
    shift, scale = dense(sy, params["final_layer"]["adaLN"]).chunk(2, dim=-1)
    h = _modulate(layer_norm(h, eps=cfg.ln_eps), shift, scale)
    return dense(h, params["final_layer"]["linear"])


def precompute_modulations(params, cfg, ts: torch.Tensor, z: torch.Tensor):
    """AdaLN modulations of every Euler step in one pass (they depend on (t, z)
    only). ts (S,) fp32; z (B, z). Returns (block_mods (depth, S, B, 3w),
    final_mods (S, B, 2w))."""
    S, B = ts.shape[0], z.shape[0]
    temb = timestep_embedding(ts * 1000.0, cfg.freq_embed_size).to(z.dtype)  # (S, f)
    temb = dense(F.silu(dense(temb, params["time_embed"]["fc1"]).float()).to(z.dtype), params["time_embed"]["fc2"])
    y = temb[:, None, :] + dense(z, params["cond_embed"])[None]  # (S, B, w)
    sy = F.silu(y.float()).to(z.dtype).reshape(S * B, -1)
    blocks = params["res_blocks"]["adaLN"]
    block_mods = torch.stack(
        [dense(sy, {"w": blocks["w"][d], "b": blocks["b"][d]}).reshape(S, B, -1) for d in range(cfg.depth)]
    )
    final_mods = dense(sy, params["final_layer"]["adaLN"]).reshape(S, B, -1)
    return block_mods, final_mods


def rf_net_apply_premod(params, cfg, x, block_mods_i, final_mods_i, *, int_dots: bool = False,
                        int4_int_dots: bool = True):
    """Velocity field with precomputed modulations. x (B, C);
    block_mods_i (depth, B, 3w); final_mods_i (B, 2w). Linear int4 / int8
    res_blocks tables take the per-step stack kernel (`rf_mlp_stack`) in the
    dot mode `int4_int_dots` / `int_dots`, others the loop over the blocks."""
    h = dense(x, params["input_proj"])
    rb = params["res_blocks"]
    if rf_mlp_supported(rb):
        h = rf_mlp_stack(rb, h, block_mods_i, ln_eps=cfg.ln_eps,
                         int_dots=int4_int_dots if stack_bits(rb) == 4 else int_dots)
    else:
        for d in range(cfg.depth):
            shift, scale, gate = block_mods_i[d].to(h.dtype).chunk(3, dim=-1)
            hh = _modulate(layer_norm(h, rb["in_ln"]["w"][d], rb["in_ln"]["b"][d], eps=cfg.ln_eps), shift, scale)
            w12 = {"w": rb["mlp"]["w12"]["w"][d], "b": rb["mlp"]["w12"]["b"][d]}
            w3 = {"w": rb["mlp"]["w3"]["w"][d], "b": rb["mlp"]["w3"]["b"][d]}
            h = h + gate * dense(swiglu(dense(hh, w12)), w3)
    shift, scale = final_mods_i.to(h.dtype).chunk(2, dim=-1)
    h = _modulate(layer_norm(h, eps=cfg.ln_eps), shift, scale)
    return dense(h, params["final_layer"]["linear"])


def _dequantized_blocks(params, dtype):
    """`params` with quantized res-block MLP tables dequantized to `dtype` once,
    as one table per block, for the Euler loop's steps to share: the values
    `dense` would dequantize at every step, read once per sample."""
    mlp = params["res_blocks"]["mlp"]
    if not any(isinstance(leaf["w"], QuantizedArray) for leaf in mlp.values()):
        return params
    tables = {name: {"w": [dequant_weight(leaf["w"][d], dtype) for d in range(leaf["w"].shape[0])], "b": leaf["b"]}
              for name, leaf in mlp.items()}
    return {**params, "res_blocks": {**params["res_blocks"], "mlp": tables}}


def _time_grid(cfg, time_shifting_factor: Optional[float], device=None):
    """(ts (S,), dts (S,)) fp32 of the Euler schedule, optionally time-shifted."""
    steps = cfg.num_sampling_steps
    if time_shifting_factor:
        a = float(time_shifting_factor)
        ts = torch.linspace(0.0, 1.0, steps + 1, device=device)
        ts = 1.0 - ts / (ts + a - a * ts)
        return ts[:-1], ts[:-1] - ts[1:]
    ts = torch.linspace(1.0, 0.0, steps + 1, device=device)[:-1]
    return ts, torch.full((steps,), 1.0 / steps, device=device)


def _channel_renorm(v, v_c):
    scale = (torch.linalg.vector_norm(v_c, dim=-1, keepdim=True) / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
             + 1e-8).clamp(0.0, 1.0)
    return v * scale


def rf_sample(
    params,
    cfg,
    z: torch.Tensor,
    *,
    noise: torch.Tensor,
    temperature: float = 1.0,
    text_cfg=1.0,
    image_cfg=1.0,
    cfg_renorm_type: Optional[str] = None,
    time_shifting_factor: Optional[float] = None,
    cfg_rows: int = 1,
    int_dots: bool = False,
    fused: bool = True,
    int4_int_dots: bool = True,
) -> torch.Tensor:
    """Euler-ODE sampling of a continuous latent conditioned on z (B, z_channels).

    B = cfg_rows * n_images laid out BLOCK-major: [conds | unconds (| text_unconds)].
    `noise` (n_images or B, C) is tiled across the CFG rows and scaled by
    `temperature`. cfg_rows in (1, 2, 3): 2 combines v_u + text_cfg*(v_c - v_u),
    3 combines v_u + image_cfg*(v_tu - v_u) + text_cfg*(v_c - v_tu); "channel"
    renorm caps |v| at |v_c| per row. text_cfg / image_cfg are numbers, or one
    per image (a host sequence or an (n_images,) tensor): the Euler loop
    broadcasts them over each image's rows; the fused sampler launches once
    per group of images with equal scales. int_dots: s8 dots over int8 tables
    (RuntimeConfig.rf_int_dots); fused: the fused whole-sample kernel over
    quantized linear tables, else the Euler steps through the per-step stack
    (RuntimeConfig.rf_fused_sampler); int4_int_dots: s8 dots in the per-step
    int4 stack (RuntimeConfig.rf_int4_int_dots). Returns (B, C) in z's dtype;
    every row holds its image's guided sample.
    """
    B = z.shape[0]
    dtype = z.dtype
    if cfg_rows not in (1, 2, 3) or B % cfg_rows:
        raise ValueError(f"batch {B} does not split into cfg_rows={cfg_rows}")
    noise = noise.float()
    if noise.shape[0] != B:
        if B % noise.shape[0]:
            raise ValueError(f"noise rows {noise.shape[0]} don't tile batch {B}")
        noise = noise.repeat(B // noise.shape[0], 1)
    x = noise * temperature

    ts, dts = _time_grid(cfg, time_shifting_factor, device=z.device)
    block_mods, final_mods = precompute_modulations(params, cfg, ts, z)
    if fused and cfg_renorm_type in (None, "channel") and rf_sampler_supported(params, B, cfg_rows):
        out = rf_sample_fused(params, cfg, x, block_mods, final_mods, dts, text_cfg, image_cfg, cfg_rows=cfg_rows,
                              renorm_channel=cfg_renorm_type == "channel",
                              compute_dtype=dtype if dtype != torch.float32 else torch.bfloat16, s8_dots=int_dots)
        return out.to(dtype)
    n = B // cfg_rows
    text_cfg, image_cfg = scale_rows(text_cfg, n, z.device), scale_rows(image_cfg, n, z.device)
    if not rf_mlp_supported(params["res_blocks"]):
        params = _dequantized_blocks(params, dtype)
    for i in range(cfg.num_sampling_steps):
        combined = x[:n].repeat(cfg_rows, 1) if cfg_rows > 1 else x
        v_all = rf_net_apply_premod(params, cfg, combined.to(dtype), block_mods[:, i], final_mods[i],
                                    int_dots=int_dots, int4_int_dots=int4_int_dots).float()
        if cfg_rows == 3:
            v_c, v_u, v_tu = v_all.chunk(3, dim=0)
            v = v_u + image_cfg * (v_tu - v_u) + text_cfg * (v_c - v_tu)
        elif cfg_rows == 2:
            v_c, v_u = v_all.chunk(2, dim=0)
            v = v_u + text_cfg * (v_c - v_u)
        else:
            v = v_all
        if cfg_rows > 1:
            if cfg_renorm_type == "channel":
                v = _channel_renorm(v, v_c)
            v = v.repeat(cfg_rows, 1)
        x = x + v * dts[i]
    return x.to(dtype)


def vis_head_apply(params, x, eps: float = 1e-6):
    """vis_head: Linear + LayerNorm ("linear2-norm")."""
    return layer_norm(dense(x, params["linear"]), params["norm"]["w"], params["norm"]["b"], eps=eps)
