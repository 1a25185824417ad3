"""MingTok-Vision, the three-part continuous visual tokenizer (counterpart of
mingunivision_tpu/models/mingtok.py):

  low-level encoder (bidirectional ViT, 512 px / patch 32 -> 32-d latents)
  -> semantic decoder (causal ViT, 32 -> 1024-d features, KV-cached)
  -> pixel decoder   (bidirectional ViT, 1024-d -> RGB patches)

The encoder and the semantic decoder compute in bf16; the pixel decoder runs
at its `matmul_precision` tier: "high"/"highest" true fp32, "default" fp32
activations with TF32 products and the flash kernel, "bf16" the whole block
stack in bf16 (norm internals fp32) with the flash kernel.
"""

from __future__ import annotations

import torch

from mingunivision_tpu_torch.models.vit import ViTCache, patch_embed_apply, run_blocks, run_blocks_cached
from mingunivision_tpu_torch.ops.activations import gelu_exact
from mingunivision_tpu_torch.ops.linear import dense, fp32_matmul_precision
from mingunivision_tpu_torch.ops.norms import layer_norm
from mingunivision_tpu_torch.ops.patching import expand_sem_to_pix_tokens, interpolate_pos_embed, unpatchify


def encoder_apply(params, cfg, images, *, compute_dtype=torch.bfloat16):
    """images (B, 3, H, W) -> latents (B, h*w + 1, out_dim), CLS last."""
    B, _, H, _ = images.shape
    x = patch_embed_apply(params["patch_embed"], images.to(compute_dtype), cfg.patch_size)
    cls = params["cls_token"].to(compute_dtype).expand(B, 1, cfg.embed_dim)
    x = torch.cat([x, cls], dim=1)  # CLS AFTER the patches, as the reference
    pe = interpolate_pos_embed(params["pos_embed"].float(), cfg.grid_size, H // cfg.patch_size,
                               offset=cfg.interpolate_offset)
    x = x + pe.to(compute_dtype)
    x = run_blocks(params["blocks"], x, depth=cfg.depth, num_heads=cfg.num_heads, ffn_layer=cfg.ffn_layer,
                   ln_eps=cfg.ln_eps)
    # out layer: channel-mean shortcut + norm -> GELU -> proj
    shortcut = x.reshape(*x.shape[:-1], cfg.out_dim, cfg.embed_dim // cfg.out_dim).mean(-1)
    y = layer_norm(x, params["out_norm"]["w"], params["out_norm"]["b"], eps=cfg.ln_eps)
    return shortcut + dense(gelu_exact(y), params["out_proj"])


def _sem_in_proj(params, cfg, x):
    """in_proj + tile shortcut: each latent channel repeated embed/in_dim times."""
    return dense(x, params["in_proj"]) + x.repeat_interleave(cfg.embed_dim // cfg.in_dim, dim=-1)


def semantic_decoder_apply(params, cfg, latents, *, compute_dtype=torch.bfloat16, split_cls: bool = True):
    """Full-sequence (non-cached) causal semantic decode of latents (B, N, in_dim):
    {"x_norm_patchtokens": (B, N-1, D), "x_norm_clstoken": (B, D)} when
    `split_cls` and N > 1, else the whole normed sequence."""
    x = _sem_in_proj(params, cfg, latents.to(compute_dtype))
    x = run_blocks(params["blocks"], x, depth=cfg.depth, num_heads=cfg.num_heads, ffn_layer=cfg.ffn_layer,
                   is_causal=True, ln_eps=cfg.ln_eps)
    x_norm = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps=cfg.ln_eps)
    if split_cls and cfg.with_cls_token and x_norm.shape[1] > 1:
        return {"x_norm_patchtokens": x_norm[:, :-1], "x_norm_clstoken": x_norm[:, -1]}
    return {"x_norm_patchtokens": x_norm}


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


def mingtok_encode(params, cfg, images, *, compute_dtype=torch.bfloat16):
    """Images -> {"x_norm_patchtokens": (B, N, 1024) semantic features,
    "latent": (B, N+1, 32) standardised as (latent - mean) / scaling_factor}."""
    latent = encoder_apply(params["encoder"], cfg.encoder, images, compute_dtype=compute_dtype)
    feats = semantic_decoder_apply(params["semantic_decoder"], cfg.semantic_decoder, latent,
                                   compute_dtype=compute_dtype)
    return {"x_norm_patchtokens": feats["x_norm_patchtokens"], "latent": (latent - cfg.mean) / cfg.scaling_factor}


def pixel_decoder_apply(params, cfg, tokens):
    """tokens (B, L, D) -> patch pixels (B, L, p*p*3) fp32, at the tier
    `cfg.matmul_precision` (see the module note)."""
    kw = dict(depth=cfg.depth, num_heads=cfg.num_heads, ffn_layer=cfg.ffn_layer, ln_eps=cfg.ln_eps)
    if cfg.matmul_precision == "bf16":
        x = run_blocks(params["blocks"], tokens.to(torch.bfloat16), **kw)
        x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps=cfg.ln_eps)
        return dense(x, params["head"]).float()
    with fp32_matmul_precision(cfg.matmul_precision):
        x = run_blocks(params["blocks"], tokens.float(), **kw)
        x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps=cfg.ln_eps)
        return dense(x, params["head"])


def mingtok_pixel_decoder(params, cfg, features):
    """Semantic features (B, N, 1024) -> RGB image (B, 3, H, W) in [-1, 1], fp32:
    sem_to_pix linear, 2x2 spatial expand, pixel decoder, unpatchify, clamp."""
    pix = cfg.pixel_decoder
    ratio = cfg.semantic_decoder.patch_size // pix.patch_size
    if pix.matmul_precision == "bf16":
        x = dense(features.to(torch.bfloat16), params["sem_to_pix"]).float()
    else:
        with fp32_matmul_precision(pix.matmul_precision):
            x = dense(features.float(), params["sem_to_pix"])
    x = pixel_decoder_apply(params["pixel_decoder"], pix, expand_sem_to_pix_tokens(x, ratio))
    return unpatchify(x, pix.patch_size).clamp(-1.0, 1.0)


def mingtok_enc_dec(params, cfg, images, *, compute_dtype=torch.bfloat16):
    """Full reconstruction: encode -> pixel decode."""
    feats = mingtok_encode(params, cfg, images, compute_dtype=compute_dtype)
    return mingtok_pixel_decoder(params, cfg, feats["x_norm_patchtokens"])
