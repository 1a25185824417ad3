"""MingTok-Vision, the three-part continuous visual tokenizer (counterpart of
mingunivision_tpu/models/mingtok.py):

  low-level encoder (bidirectional ViT, 512 px / patch 32 -> 32-d latents)
  -> semantic decoder (causal ViT, 32 -> 1024-d features, KV-cached)
  -> pixel decoder   (bidirectional ViT, 1024-d -> RGB patches)

The encoder and the semantic decoder compute in bf16; the pixel decoder runs
at its `matmul_precision` tier: "high"/"highest" true fp32, "default" fp32
activations with TF32 products and the flash kernel, "bf16" the whole block
stack in bf16 (norm internals fp32) with the flash kernel.

`remat=True` (encoder, semantic decoder, pixel decoder, `mingtok_encode`)
recomputes each ViT block in the backward, as the JAX package's `remat`;
`pixel_reconstruction_loss` is the pixel decoder's training loss.
"""

from __future__ import annotations

import math

import torch

from mingunivision_tpu_torch.models.vit import (
    ViTCache,
    patch_embed_apply,
    run_blocks,
    run_blocks_cached,
    run_blocks_cached_rows,
)
from mingunivision_tpu_torch.ops.activations import gelu_exact
from mingunivision_tpu_torch.ops.linear import dense, fp32_matmul_precision
from mingunivision_tpu_torch.ops.norms import layer_norm
from mingunivision_tpu_torch.ops.patching import expand_sem_to_pix_tokens, interpolate_pos_embed, patchify, unpatchify


def encoder_apply(params, cfg, images, *, compute_dtype=torch.bfloat16, remat: bool = False):
    """images (B, 3, H, W) -> latents (B, h*w + 1, out_dim), CLS last."""
    B, _, H, _ = images.shape
    x = patch_embed_apply(params["patch_embed"], images.to(compute_dtype), cfg.patch_size)
    cls = params["cls_token"].to(compute_dtype).expand(B, 1, cfg.embed_dim)
    x = torch.cat([x, cls], dim=1)  # CLS AFTER the patches, as the reference
    pe = interpolate_pos_embed(params["pos_embed"].float(), cfg.grid_size, H // cfg.patch_size,
                               offset=cfg.interpolate_offset)
    x = x + pe.to(compute_dtype)
    x = run_blocks(params["blocks"], x, depth=cfg.depth, num_heads=cfg.num_heads, ffn_layer=cfg.ffn_layer,
                   ln_eps=cfg.ln_eps, remat=remat)
    # out layer: channel-mean shortcut + norm -> GELU -> proj
    shortcut = x.reshape(*x.shape[:-1], cfg.out_dim, cfg.embed_dim // cfg.out_dim).mean(-1)
    y = layer_norm(x, params["out_norm"]["w"], params["out_norm"]["b"], eps=cfg.ln_eps)
    return shortcut + dense(gelu_exact(y), params["out_proj"])


def _sem_in_proj(params, cfg, x):
    """in_proj + tile shortcut: each latent channel repeated embed/in_dim times."""
    return dense(x, params["in_proj"]) + x.repeat_interleave(cfg.embed_dim // cfg.in_dim, dim=-1)


def semantic_decoder_apply(params, cfg, latents, *, compute_dtype=torch.bfloat16, split_cls: bool = True,
                           remat: bool = False):
    """Full-sequence (non-cached) causal semantic decode of latents (B, N, in_dim):
    {"x_norm_patchtokens": (B, N-1, D), "x_norm_clstoken": (B, D)} when
    `split_cls` and N > 1, else the whole normed sequence."""
    x = _sem_in_proj(params, cfg, latents.to(compute_dtype))
    x = run_blocks(params["blocks"], x, depth=cfg.depth, num_heads=cfg.num_heads, ffn_layer=cfg.ffn_layer,
                   is_causal=True, ln_eps=cfg.ln_eps, remat=remat)
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


def mingtok_feature_decoder_rows(params, cfg, latents, k, v, write_pos, *, compute_dtype=torch.bfloat16):
    """`mingtok_feature_decoder` with PER-ROW cache positions (pool decode):
    latents (B, 1, z); k/v the stacked semantic-decoder caches (depth, B, H,
    max_len, D), written IN PLACE; write_pos (B,) row b's token index in its
    own sequence. Returns {"x_norm_patchtokens": (B, 1, D)}."""
    sd = cfg.semantic_decoder
    x = latents * cfg.scaling_factor + cfg.mean
    p = params["semantic_decoder"]
    x = _sem_in_proj(p, sd, x.to(compute_dtype))
    x = run_blocks_cached_rows(p["blocks"], x, k, v, write_pos, num_heads=sd.num_heads, ffn_layer=sd.ffn_layer,
                               ln_eps=sd.ln_eps)
    return {"x_norm_patchtokens": layer_norm(x, p["norm"]["w"], p["norm"]["b"], eps=sd.ln_eps)}


def mingtok_encode(params, cfg, images, *, compute_dtype=torch.bfloat16, remat: bool = False):
    """Images -> {"x_norm_patchtokens": (B, N, 1024) semantic features,
    "latent": (B, N+1, 32) standardised as (latent - mean) / scaling_factor}."""
    latent = encoder_apply(params["encoder"], cfg.encoder, images, compute_dtype=compute_dtype, remat=remat)
    feats = semantic_decoder_apply(params["semantic_decoder"], cfg.semantic_decoder, latent,
                                   compute_dtype=compute_dtype, remat=remat)
    return {"x_norm_patchtokens": feats["x_norm_patchtokens"], "latent": (latent - cfg.mean) / cfg.scaling_factor}


def pixel_decoder_apply(params, cfg, tokens, *, remat: bool = False):
    """tokens (B, L, D) -> patch pixels (B, L, p*p*3) fp32, at the tier
    `cfg.matmul_precision` (see the module note)."""
    kw = dict(depth=cfg.depth, num_heads=cfg.num_heads, ffn_layer=cfg.ffn_layer, ln_eps=cfg.ln_eps, remat=remat)
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


def pixel_reconstruction_loss(pred_patches, target_images, cfg, mask=None):
    """The pixel decoder's training loss (the JAX package's, after the
    reference's vision_transformer.py:529-562). pred_patches (B, L, p*p*3) raw
    head output; target_images (B, 3, H, W); mask: optional bool (B, hw_mask)
    of MASKED patches, the loss taken over the others, upsampled to the pixel
    decoder's grid. cfg.pixel_decoder.loss_type: "L2" (with norm_pix_loss the
    targets standardised per patch), "L1" (the prediction min-max scaled to
    [-1, 1] over the batch), "L1-tanh", "L1-plain". fp32."""
    p = cfg.pixel_decoder.patch_size
    target = patchify(target_images.float(), p)
    pred = pred_patches.float()
    lt = cfg.pixel_decoder.loss_type
    if lt == "L2":
        if cfg.pixel_decoder.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        loss = (pred - target).square()
    elif lt == "L1":
        pred = 2.0 * (pred - pred.min()) / (pred.max() - pred.min() + 1e-12) - 1.0
        loss = (pred - target).abs()
    elif lt == "L1-tanh":
        loss = (torch.tanh(pred) - target).abs()
    elif lt == "L1-plain":
        loss = (pred - target).abs()
    else:
        raise NotImplementedError(lt)
    loss = loss.mean(dim=-1)  # (B, L) per patch
    if mask is None:
        return loss.mean()
    B, hw_mask = mask.shape
    rep = math.isqrt(loss.shape[1] // hw_mask)
    side = math.isqrt(hw_mask)
    keep = (~mask.bool()).reshape(B, side, 1, side, 1).expand(B, side, rep, side, rep).reshape(B, -1).to(loss.dtype)
    return (loss * keep).sum() / keep.sum().clamp_min(1.0)
