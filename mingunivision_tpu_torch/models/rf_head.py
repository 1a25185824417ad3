"""Rectified-flow head: AdaLN SwiGLU-MLP velocity field + Euler ODE sampler
(counterpart of mingunivision_tpu/models/rf_head.py).

Linear int4 res_blocks tables take the fused whole-sampler
(`ops/kernels/rf_sampler.py`: the CUDA kernel on the card, its plain version
on the CPU), as the JAX package's TPU path does; other tiers run the Euler
steps as a Python loop, dequantizing any quantized weight in `dense`.
Randomness is explicit: the caller passes `noise` (one row per image, or one
per CFG row).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.activations import swiglu
from mingunivision_tpu_torch.ops.kernels.rf_sampler import rf_sample_fused, rf_sampler_supported
from mingunivision_tpu_torch.ops.linear import dense
from mingunivision_tpu_torch.ops.norms import layer_norm


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos, sin] order. t (B,) -> (B, dim) fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([args.cos(), args.sin()], dim=-1)


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


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


def rf_net_apply_premod(params, cfg, x, block_mods_i, final_mods_i):
    """Velocity field with precomputed modulations. x (B, C);
    block_mods_i (depth, B, 3w); final_mods_i (B, 2w)."""
    h = dense(x, params["input_proj"])
    rb = params["res_blocks"]
    for d in range(cfg.depth):
        shift, scale, gate = block_mods_i[d].to(h.dtype).chunk(3, dim=-1)
        hh = _modulate(layer_norm(h, rb["in_ln"]["w"][d], rb["in_ln"]["b"][d], eps=cfg.ln_eps), shift, scale)
        w12 = {"w": rb["mlp"]["w12"]["w"][d], "b": rb["mlp"]["w12"]["b"][d]}
        w3 = {"w": rb["mlp"]["w3"]["w"][d], "b": rb["mlp"]["w3"]["b"][d]}
        h = h + gate * dense(swiglu(dense(hh, w12)), w3)
    shift, scale = final_mods_i.to(h.dtype).chunk(2, dim=-1)
    h = _modulate(layer_norm(h, eps=cfg.ln_eps), shift, scale)
    return dense(h, params["final_layer"]["linear"])


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
    text_cfg: float = 1.0,
    image_cfg: float = 1.0,
    cfg_renorm_type: Optional[str] = None,
    time_shifting_factor: Optional[float] = None,
    cfg_rows: int = 1,
) -> torch.Tensor:
    """Euler-ODE sampling of a continuous latent conditioned on z (B, z_channels).

    B = cfg_rows * n_images laid out BLOCK-major: [conds | unconds (| text_unconds)].
    `noise` (n_images or B, C) is tiled across the CFG rows and scaled by
    `temperature`. cfg_rows in (1, 2, 3): 2 combines v_u + text_cfg*(v_c - v_u),
    3 combines v_u + image_cfg*(v_tu - v_u) + text_cfg*(v_c - v_tu); "channel"
    renorm caps |v| at |v_c| per row. Returns (B, C) in z's dtype; every row
    holds its image's guided sample.
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
    if cfg_renorm_type in (None, "channel") and rf_sampler_supported(params, B, cfg_rows):
        out = rf_sample_fused(params, cfg, x, block_mods, final_mods, dts, text_cfg, image_cfg, cfg_rows=cfg_rows,
                              renorm_channel=cfg_renorm_type == "channel",
                              compute_dtype=dtype if dtype != torch.float32 else torch.bfloat16)
        return out.to(dtype)
    n = B // cfg_rows
    for i in range(cfg.num_sampling_steps):
        combined = x[:n].repeat(cfg_rows, 1) if cfg_rows > 1 else x
        v_all = rf_net_apply_premod(params, cfg, combined.to(dtype), block_mods[:, i], final_mods[i]).float()
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
