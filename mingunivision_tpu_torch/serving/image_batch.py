"""Cross-request batched text-to-image: N different prompts in one AR loop
(counterpart of mingunivision_tpu/serving/image_batch.py, the barrier batcher).

The image loop's decode steps read the weights once for all rows, so
co-scheduled requests share them. The N requests are laid out in the
BLOCK-major CFG rows `engine.generate.generate_image_tokens(n_images=N)`
takes:

  - every prompt right-pads to one shared 64-multiple bucket, so all prefix
    caches end at the same position (the loop's shared write offset);
  - one batched prefill builds the N prefix caches, tiled over 3 CFG rows:
    [cond_0..N | uncond_0..N | text_uncond_0..N]; a request without a distinct
    text-uncond row reuses its uncond mask (v_tu == v_u then reduces the
    3-way guidance to the 2-way one);
  - image i draws its RF noise from a generator seeded `seed + i`.

Requests start together and leave together; engine/image_pool.py admits them
into free slots while others are mid-loop.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mingunivision_tpu_torch.engine.generate import generate_image_tokens, pixel_decode, prefill
from mingunivision_tpu_torch.models.bailing_moe import LLMCache, embed_tokens
from mingunivision_tpu_torch.processing.processor import request_masks

BUCKET = 64  # prompts right-pad to a multiple of this


def _bucket(n: int, step: int = BUCKET) -> int:
    return -(-n // step) * step


def batched_image_generation(params, cfg, runtime, requests: List[dict], seed: int = 0, igen=None,
                             image_start_token: Optional[int] = None, device=None) -> np.ndarray:
    """requests: processor-output dicts with `input_ids` (1, T_i),
    `attention_mask` and optional `uncond_attention_mask` /
    `text_uncond_attention_mask`. Image i's RF noise comes from a generator
    seeded `seed + i`, so image i does not depend on the other requests of the
    batch. The kernels and dot modes follow `runtime` as in the session.
    Returns images (N, 3, H, W) float32 in [-1, 1]."""
    igen = igen or cfg.image_gen
    llm_cfg = cfg.llm
    dev = torch.device(device) if device is not None else params["llm"]["norm"]["w"].device
    start_tok = int(image_start_token if image_start_token is not None else llm_cfg.image_start_token)
    dtype = torch.float32 if runtime.compute_dtype == "float32" else torch.bfloat16
    n = len(requests)
    Smax = runtime.max_seq_len
    parsed = [request_masks(r) for r in requests]
    bucket = _bucket(max(ids.shape[1] for ids, *_ in parsed))
    if bucket + igen.num_image_tokens + 2 > Smax:
        raise ValueError("prompts + image tokens exceed max_seq_len")

    ids_pad = np.zeros((n, bucket), np.int64)
    masks = np.zeros((3, n, Smax), bool)  # [cond | uncond | text_uncond] blocks, a row per request
    for i, (ids, *rows) in enumerate(parsed):
        T = ids.shape[1]
        ids_pad[i, :T] = ids[0]
        for block, m in enumerate(rows):
            masks[block, i, :T] = m[0]
    masks = torch.as_tensor(masks, device=dev)

    # ONE batched prefill of the n prompts: every CFG row of image i shares its
    # prompt's KV, only the masks differ
    int_dots = runtime.moe_int_dots
    cache = LLMCache.create(llm_cfg, n, Smax, dtype, dev)
    embeds = embed_tokens(params["llm"], torch.as_tensor(ids_pad, device=dev)).to(dtype)
    _, cache = prefill(params["llm"], llm_cfg, embeds, cache, masks[0], int_dots=int_dots,
                       prefill_int_dots=getattr(runtime, "moe_prefill_int_dots", False))
    # the loop writes at the shared bucket offset (pad positions hold KV no row mask allows)
    cache = LLMCache(cache.k.repeat(1, 3, 1, 1, 1), cache.v.repeat(1, 3, 1, 1, 1), bucket)
    del embeds

    start_embed = embed_tokens(params["llm"], torch.tensor([[start_tok]], device=dev)).to(dtype)
    generators = [torch.Generator(device=dev).manual_seed(seed + i) for i in range(n)]
    result = generate_image_tokens(params, llm_cfg, cfg.mingtok, cfg.rf_head, igen, start_embed, cache,
                                   masks.reshape(3 * n, Smax), generators=generators, cfg_rows=3, n_images=n,
                                   int_dots=int_dots, rf_int_dots=getattr(runtime, "rf_int_dots", False),
                                   rf_fused=getattr(runtime, "rf_fused_sampler", True),
                                   rf_int4_int_dots=getattr(runtime, "rf_int4_int_dots", True))
    return pixel_decode(params["mingtok"], cfg.mingtok, result.sem_tokens).float().cpu().numpy()
