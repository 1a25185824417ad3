"""Prefill, text decode and the autoregressive image loop (counterpart of
mingunivision_tpu/engine/generate.py).

Python loops take the place of the JAX package's jitted `while_loop` /
`fori_loop`. Caches and mask buffers are updated IN PLACE; cache lengths are
host ints, so a step needs no device-to-host copy except where the host must
read a sampled token.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from mingunivision_tpu_torch.engine.sampler import sample_token
from mingunivision_tpu_torch.models.bailing_moe import LLMCache, bailing_forward, compute_logits, embed_tokens
from mingunivision_tpu_torch.models.mingtok import make_semdec_cache, mingtok_feature_decoder, mingtok_pixel_decoder
from mingunivision_tpu_torch.models.rf_head import rf_sample, vis_head_apply
from mingunivision_tpu_torch.ops.activations import gelu_exact
from mingunivision_tpu_torch.ops.linear import dense


def linear_proj_apply(params, x):
    """linear_proj: semantic feature -> LLM embedding (Linear, then GELU+Linear)."""
    y = dense(x, params["layers"][0])
    for layer in params["layers"][1:]:
        y = dense(gelu_exact(y), layer)
    return y


def scatter_image_embeds(inputs_embeds, input_ids, image_embeds, image_patch_token: int):
    """Place the i-th image feature at the i-th image-patch position (a
    masked scatter). image_embeds (N_feat, h), flattened in order. Returns
    (embeds (B, T, h), is_patch bool (B, T))."""
    B, T, h = inputs_embeds.shape
    is_patch = input_ids.reshape(-1) == image_patch_token
    order = (is_patch.long().cumsum(0) - 1).clamp(0, image_embeds.shape[0] - 1)
    gathered = image_embeds.index_select(0, order).to(inputs_embeds.dtype)
    out = torch.where(is_patch[:, None], gathered, inputs_embeds.reshape(-1, h))
    return out.reshape(B, T, h), is_patch.reshape(B, T)


def prefill(params, cfg, inputs_embeds, cache: LLMCache, attn_mask, image_mask=None, *, use_flash: bool = False):
    """Run the right-padded prompt through the stack. attn_mask bool (1, Smax)
    is True exactly at the valid prompt positions [cache.length, cache.length + T_valid).
    use_flash: first-round prefill through the flash-attention kernel.

    Returns (logits (B, V) of the last valid position, cache whose length is
    rolled back to right after the last valid prompt token)."""
    B, T, _ = inputs_embeds.shape
    start = cache.length
    # positions: cumsum over the mask (masked history shifts positions)
    positions = (attn_mask.long().cumsum(dim=1) - 1)[:, start : start + T].clamp(min=0)
    hidden, cache = bailing_forward(params, cfg, inputs_embeds, cache, attn_mask, positions=positions,
                                    image_mask=image_mask, use_flash=use_flash)
    last_idx = attn_mask[:, start : start + T].long().sum(dim=1) - 1  # (B,)
    last_hidden = hidden.gather(1, last_idx[:, None, None].expand(B, 1, hidden.shape[-1]))
    logits = compute_logits(params, cfg, last_hidden)[:, 0]
    return logits, LLMCache(cache.k, cache.v, start + int(last_idx[0]) + 1)


@dataclasses.dataclass
class DecodeResult:
    tokens: List[int]  # the newly sampled tokens (not including the first token)
    cache: LLMCache
    mask: torch.Tensor
    hidden: torch.Tensor  # (len(tokens), h) fp32 last-layer hidden per sampled token


def decode_text(params, cfg, first_token: int, cache: LLMCache, mask, generator=None, *, max_steps: int,
                do_sample: bool = False, temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0):
    """Feed `first_token` and keep sampling until EOS / image-start / max_steps.
    `mask` (1, Smax) is updated IN PLACE."""
    tokens: List[int] = []
    hiddens = []
    cur = int(first_token)
    dev = mask.device
    for _ in range(max_steps):
        mask[:, cache.length] = True
        pos = mask.long().sum(dim=1, keepdim=True) - 1
        embeds = embed_tokens(params, torch.tensor([[cur]], device=dev)).to(cache.k.dtype)
        hidden, cache = bailing_forward(params, cfg, embeds, cache, mask, positions=pos)
        logits = compute_logits(params, cfg, hidden)[:, -1]
        cur = int(sample_token(logits, generator, do_sample=do_sample, temperature=temperature, top_k=top_k,
                               top_p=top_p)[0])
        tokens.append(cur)
        hiddens.append(hidden[0, -1:].float())
        if cur in (cfg.eos_token_id, cfg.image_start_token):
            break
    hidden = torch.cat(hiddens) if hiddens else torch.zeros((0, cfg.hidden_size), device=dev)
    return DecodeResult(tokens, cache, mask, hidden)


@dataclasses.dataclass
class ImageGenResult:
    sem_tokens: torch.Tensor  # (1, 256, feature_dim)
    last_hidden: torch.Tensor  # (1, 1, h) hidden state of the cond row after the trailing LLM step
    cache: LLMCache  # CFG-row cache (caller truncates to row 0)
    mask: torch.Tensor  # (cfg_rows, Smax) grown attention masks


def _cfg_at(gen_cfg, i: int):
    if gen_cfg.cfg_schedule == "constant":
        return gen_cfg.text_cfg, gen_cfg.image_cfg
    if gen_cfg.cfg_schedule == "linear":
        frac = (256.0 - i) / 256.0
    elif gen_cfg.cfg_schedule == "linear-reverse":
        frac = i / 255.0
    else:
        raise NotImplementedError(gen_cfg.cfg_schedule)
    return 1.0 + (gen_cfg.text_cfg - 1.0) * frac, 1.0 + (gen_cfg.image_cfg - 1.0) * frac


def generate_image_tokens(params, llm_cfg, mingtok_cfg, rf_cfg, gen_cfg, image_start_embed, cache: LLMCache,
                          row_masks, generator: Optional[torch.Generator] = None) -> ImageGenResult:
    """The AR image loop. Per token: LLM step over the CFG rows -> vis_head ->
    rectified-flow Euler sample -> MingTok semantic-decoder step -> linear_proj
    -> next LLM input; every row's mask grows by one. A trailing LLM step gives
    the hidden state for the next text token.

    The CFG rows are [cond, uncond (, text_uncond)], one per row of
    `row_masks` (cfg_rows, Smax); `cache` is already expanded to them and is
    written IN PLACE. The RF noise of each token is drawn from `generator`."""
    R = row_masks.shape[0]
    n_tokens = gen_cfg.num_image_tokens
    dev = image_start_embed.device
    sem_dtype = image_start_embed.dtype
    sem_cache = make_semdec_cache(mingtok_cfg.semantic_decoder, 1, n_tokens + 1, dtype=sem_dtype, device=dev)
    sem_tokens = torch.zeros((1, n_tokens, mingtok_cfg.feature_dim), dtype=sem_dtype, device=dev)
    embeds = image_start_embed.expand(R, 1, -1)
    masks = row_masks.bool().clone()

    def llm_step(embeds, cache):
        masks[:, cache.length] = True  # the position the current embeds occupy, in every row
        pos = masks.long().sum(dim=1, keepdim=True) - 1
        return bailing_forward(params["llm"], llm_cfg, embeds, cache, masks, positions=pos)

    for i in range(n_tokens):
        hidden, cache = llm_step(embeds, cache)
        z = vis_head_apply(params["vis_head"], hidden[:, -1])
        tcfg, icfg = _cfg_at(gen_cfg, i)
        noise = torch.randn((1, rf_cfg.target_channels), generator=generator, device=dev)
        latent = rf_sample(params["rf_head"], rf_cfg, z, noise=noise, temperature=gen_cfg.temperature,
                           text_cfg=tcfg, image_cfg=icfg, cfg_renorm_type=gen_cfg.cfg_renorm_type,
                           time_shifting_factor=gen_cfg.time_shifting_factor, cfg_rows=R)
        sem_out, sem_cache = mingtok_feature_decoder(params["mingtok"], mingtok_cfg, latent[:1, None, :], sem_cache,
                                                     compute_dtype=sem_dtype)
        sem = sem_out["x_norm_patchtokens"]  # (1, 1, feat)
        sem_tokens[:, i] = sem[:, 0].to(sem_tokens.dtype)
        nxt = linear_proj_apply(params["linear_proj"], sem).to(embeds.dtype)
        embeds = nxt.expand(R, 1, -1)  # the same next input in every CFG row
    hidden, cache = llm_step(embeds, cache)
    return ImageGenResult(sem_tokens, hidden[:1, -1:], cache, masks)


def pixel_decode(mingtok_params, mingtok_cfg, sem_tokens):
    """The full semantic-token sequence -> (n, 3, 512, 512) image."""
    return mingtok_pixel_decoder(mingtok_params, mingtok_cfg, sem_tokens.float())
