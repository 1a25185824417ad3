"""MingTok-Vision decoders (counterpart of mingunivision_tpu/models/mingtok.py):
the KV-cached semantic decoder (32-d latents -> 1024-d features) and the pixel
decoder (features -> RGB). The low-level encoder comes with the understanding
and editing paths.
"""

from __future__ import annotations

import torch

from mingunivision_tpu_torch.models.vit import ViTCache, run_blocks, run_blocks_cached
from mingunivision_tpu_torch.ops.linear import dense, fp32_matmul_precision
from mingunivision_tpu_torch.ops.norms import layer_norm
from mingunivision_tpu_torch.ops.patching import expand_sem_to_pix_tokens, unpatchify


def _sem_in_proj(params, cfg, x):
    """in_proj + tile shortcut: each latent channel repeated embed/in_dim times."""
    return dense(x, params["in_proj"]) + x.repeat_interleave(cfg.embed_dim // cfg.in_dim, dim=-1)


def semantic_decoder_step(params, cfg, latents, cache: ViTCache, *, compute_dtype=torch.bfloat16):
    """Cached decode of T new latent tokens (B, T, in_dim); returns
    ({"x_norm_patchtokens": (B, T, D)}, cache advanced by T)."""
    x = _sem_in_proj(params, cfg, latents.to(compute_dtype))
    x, cache = run_blocks_cached(params["blocks"], x, cache, num_heads=cfg.num_heads, ffn_layer=cfg.ffn_layer,
                                 ln_eps=cfg.ln_eps)
    return {"x_norm_patchtokens": layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps=cfg.ln_eps)}, cache


def make_semdec_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> ViTCache:
    return ViTCache.create(cfg.depth, batch, max_len, cfg.num_heads, cfg.embed_dim // cfg.num_heads, dtype, device)


def mingtok_feature_decoder(params, cfg, latents, cache: ViTCache, *, compute_dtype=torch.bfloat16):
    """Standardised latents -> semantic features, incremental with the cache
    (un-standardises by latent * scaling_factor + mean first)."""
    x = latents * cfg.scaling_factor + cfg.mean
    return semantic_decoder_step(params["semantic_decoder"], cfg.semantic_decoder, x, cache,
                                 compute_dtype=compute_dtype)


def _check_fp32_tier(cfg):
    # the reduced "default"/"bf16" tiers run ViT flash attention in the JAX
    # package, a kernel not ported yet
    if cfg.matmul_precision not in ("high", "highest"):
        raise NotImplementedError(f"pixel decoder tier {cfg.matmul_precision!r}: only 'high'/'highest' are ported")


def pixel_decoder_apply(params, cfg, tokens):
    """tokens (B, L, D) -> patch pixels (B, L, p*p*3), at true fp32 (TF32 off)."""
    _check_fp32_tier(cfg)
    with fp32_matmul_precision(cfg.matmul_precision):
        x = run_blocks(params["blocks"], tokens.float(), depth=cfg.depth, num_heads=cfg.num_heads,
                       ffn_layer=cfg.ffn_layer, ln_eps=cfg.ln_eps)
        x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps=cfg.ln_eps)
        return dense(x, params["head"])


def mingtok_pixel_decoder(params, cfg, features):
    """Semantic features (B, N, 1024) -> RGB image (B, 3, H, W) in [-1, 1], fp32:
    sem_to_pix linear, 2x2 spatial expand, pixel decoder, unpatchify, clamp."""
    pix = cfg.pixel_decoder
    ratio = cfg.semantic_decoder.patch_size // pix.patch_size
    _check_fp32_tier(pix)
    with fp32_matmul_precision(pix.matmul_precision):
        x = dense(features.float(), params["sem_to_pix"])
    x = pixel_decoder_apply(params["pixel_decoder"], pix, expand_sem_to_pix_tokens(x, ratio))
    return unpatchify(x, pix.patch_size).clamp(-1.0, 1.0)
