"""Host-side multi-round session (counterpart of mingunivision_tpu/engine/session.py).

Owns the KV cache and the three persisted attention-mask buffers across
rounds, with the reference's PAST_MODE KEEP/DROP semantics, fixed-size device
buffers and a 128-token prompt bucket for prefill. Image inputs (understanding
and editing) go through the MingTok encoder and `linear_proj` and are
scattered over the prompt's image-patch positions; a first-round prompt whose
bucket passes `flash_usable` prefills through the flash-attention kernel.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import List, Optional

import numpy as np
import torch

from mingunivision_tpu_torch.config import GenerationConfig, ImageGenConfig
from mingunivision_tpu_torch.engine.generate import (
    decode_text,
    generate_image_tokens,
    linear_proj_apply,
    pixel_decode,
    prefill,
    scatter_image_embeds,
)
from mingunivision_tpu_torch.engine.sampler import sample_token
from mingunivision_tpu_torch.models.bailing_moe import LLMCache, compute_logits, embed_tokens
from mingunivision_tpu_torch.models.mingtok import mingtok_encode
from mingunivision_tpu_torch.ops.kernels.flash import flash_usable

PROMPT_BUCKET = 128  # prompts are right-padded to multiples of this for prefill


def _bucket(n: int) -> int:
    return max(PROMPT_BUCKET, -(-n // PROMPT_BUCKET) * PROMPT_BUCKET)


@dataclasses.dataclass
class RoundOutput:
    token_ids: List[int]
    images: List[np.ndarray]  # each (3, H, W) fp32 in [-1, 1]


class MingUniVisionSession:
    """One conversation on one device: the KV cache and persisted masks across rounds.

    The weight tier follows `params`: a tree from `utils/convert.py`, plain or
    quantized (`quantize_mm_params_inplace`: int4, NF4, int8, or the mixed
    tier); over quantized tables `runtime.moe_int_dots` picks the decode MoE's
    dot mode (exact dequant when False), `runtime.moe_prefill_int_dots` the
    prefill MoE's (s8 dots when True) and `runtime.rf_int_dots` the int8 RF
    head's (s8 dots when True); `runtime.rf_fused_sampler` False runs the RF
    head's Euler steps through the per-step stack kernel, whose int4 dot mode
    is `runtime.rf_int4_int_dots`. `timings` holds the last round's
    milliseconds (host clock around synchronised work): `encode_ms` (image
    inputs only), `prefill_ms` with `prefill_tokens` (the padded prompt) and
    `use_flash`, `text_decode_ms` with `text_tokens` (the decoded text steps),
    `image_loop_ms` / `pixel_decode_ms`, the CFG row count and `n_images`.

    `generate(n_images=)` makes that many variants of the image in one loop
    (block-major CFG rows). Variant 0 draws its RF noise from the session's
    generator, as a single image does; variant i > 0 from a generator seeded
    by a hash of the session generator's state before the loop and i, so the
    variants of a round differ and repeat with the session's seed."""

    def __init__(self, params, cfg, runtime, seed: int = 0, device=None):
        self.params = params
        self.cfg = cfg
        self.runtime = runtime
        # a runtime without these fields (the JAX package's RuntimeConfig, whose
        # switches are module flags) keeps their defaults
        self.prefill_int_dots = getattr(runtime, "moe_prefill_int_dots", False)
        self.rf_int_dots = getattr(runtime, "rf_int_dots", False)
        self.rf_fused = getattr(runtime, "rf_fused_sampler", True)
        self.rf_int4_int_dots = getattr(runtime, "rf_int4_int_dots", True)
        self.device = torch.device(device) if device is not None else params["llm"]["norm"]["w"].device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._dtype = torch.bfloat16 if runtime.compute_dtype == "bfloat16" else torch.float32
        self.timings: dict = {}
        self.reset_inner_state()

    def reset_inner_state(self):
        S = self.runtime.max_seq_len
        self.cache: Optional[LLMCache] = None
        self._last_token: Optional[int] = None
        self.mask = torch.zeros((1, S), dtype=torch.bool, device=self.device)
        self.uncond_mask = torch.zeros_like(self.mask)
        self.text_uncond_mask = torch.zeros_like(self.mask)
        self.seq_len = 0  # mirror of cache.length

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def extract_image_features(self, pixel_values):
        """pixel_values (B, 3, H, W) -> flattened (B * N, hidden) projected
        features: MingTok at the compute dtype -> x_norm_patchtokens -> fp32 ->
        linear_proj."""
        images = torch.as_tensor(np.asarray(pixel_values), device=self.device)
        feats = mingtok_encode(self.params["mingtok"], self.cfg.mingtok, images, compute_dtype=self._dtype)
        proj = linear_proj_apply(self.params["linear_proj"], feats["x_norm_patchtokens"].float())
        return proj.reshape(-1, proj.shape[-1])

    def generate(
        self,
        input_ids,  # (1, T) tokens of the NEW turn only
        attention_mask,  # (1, T)
        uncond_attention_mask=None,
        text_uncond_attention_mask=None,
        pixel_values=None,
        generation: Optional[GenerationConfig] = None,
        image_gen: Optional[ImageGenConfig] = None,
        n_images: int = 1,
    ) -> RoundOutput:
        """One round. n_images: the variants each image phase makes (every
        image is returned, `RoundOutput.images`); the conversation goes on
        from variant 0's row."""
        if n_images < 1:
            raise ValueError(f"n_images must be at least 1, got {n_images}")
        gen = generation or GenerationConfig()
        igen = image_gen or self.cfg.image_gen
        llm_cfg = self.cfg.llm
        if self.cache is None:
            self.cache = LLMCache.create(llm_cfg, 1, self.runtime.max_seq_len, self._dtype, self.device)

        ids = np.asarray(input_ids)
        T = ids.shape[1]
        start = self.seq_len
        if start + T + gen.max_new_tokens + (self.cfg.image_gen.num_image_tokens + 1) * 2 > self.runtime.max_seq_len:
            raise ValueError("sequence would exceed max_seq_len; raise RuntimeConfig.max_seq_len")

        def as_mask(m, default):
            return default if m is None else torch.as_tensor(np.asarray(m).astype(bool), device=self.device)

        am = as_mask(attention_mask, None)
        self.mask[:, start : start + T] = am
        self.uncond_mask[:, start : start + T] = as_mask(uncond_attention_mask, am)
        self.text_uncond_mask[:, start : start + T] = as_mask(text_uncond_attention_mask, am)

        T_pad = _bucket(T)
        ids_pad = torch.zeros((1, T_pad), dtype=torch.long, device=self.device)
        ids_pad[:, :T] = torch.as_tensor(ids, device=self.device)
        embeds = embed_tokens(self.params["llm"], ids_pad).to(self._dtype)
        self.timings = {}
        image_mask = None
        if pixel_values is not None:
            self._sync()
            t0 = time.perf_counter()
            feats = self.extract_image_features(pixel_values)
            embeds, image_mask = scatter_image_embeds(embeds, ids_pad, feats, llm_cfg.image_patch_token)
            self._sync()
            self.timings["encode_ms"] = (time.perf_counter() - t0) * 1e3

        # a first-round prefill (empty cache) can take the flash kernel: the fresh keys are the whole context
        use_flash = start == 0 and flash_usable(T_pad)
        self._sync()
        t0 = time.perf_counter()
        logits, self.cache = prefill(self.params["llm"], llm_cfg, embeds, self.cache, self.mask, image_mask=image_mask,
                                     use_flash=use_flash, int_dots=self.runtime.moe_int_dots,
                                     prefill_int_dots=self.prefill_int_dots)
        cur = int(sample_token(logits, self.generator, do_sample=gen.do_sample, temperature=gen.temperature,
                               top_k=gen.top_k, top_p=gen.top_p)[0])
        self.timings.update(prefill_ms=(time.perf_counter() - t0) * 1e3, prefill_tokens=T_pad, use_flash=use_flash,
                            text_decode_ms=0.0, text_tokens=0)
        self.seq_len = self.cache.length
        prompt_end = self.seq_len
        cond_prompt_mask = self.mask.clone()  # snapshot for PAST_MODE bookkeeping

        out_tokens: List[int] = []
        images: List[np.ndarray] = []
        hidden_chunks = []
        budget = gen.max_new_tokens
        while budget > 0:
            out_tokens.append(cur)
            budget -= 1
            if cur == llm_cfg.eos_token_id:
                break
            if cur == llm_cfg.image_start_token:
                cur, new_images = self._run_image_phase(cur, prompt_end, igen, n_images=n_images)
                images.extend(new_images)
                continue
            if budget <= 0:
                break
            self._sync()
            t0 = time.perf_counter()
            res = decode_text(self.params["llm"], llm_cfg, cur, self.cache, self.mask, self.generator,
                              max_steps=budget, do_sample=gen.do_sample, temperature=gen.temperature,
                              top_k=gen.top_k, top_p=gen.top_p, int_dots=self.runtime.moe_int_dots)
            self.timings["text_decode_ms"] += (time.perf_counter() - t0) * 1e3  # each step ends in a token read
            self.timings["text_tokens"] += len(res.tokens)
            self.cache, self.mask = res.cache, res.mask
            self.seq_len = self.cache.length
            if not res.tokens:
                break
            hidden_chunks.append(res.hidden)
            # all but the last are plain text; the last is eos/image-start/cutoff
            out_tokens.extend(res.tokens[:-1])
            budget -= len(res.tokens) - 1
            cur = res.tokens[-1]

        self._last_token, self._prompt_end = cur, prompt_end  # what continue_decode resumes from
        # persisted-mask bookkeeping for the next round
        if self.runtime.past_mode != "KEEP":  # DROP (default)
            self.uncond_mask = cond_prompt_mask
        self._keep_text_uncond_mask(prompt_end)
        self.seq_len = self.cache.length
        self.last_hidden_states = (
            torch.cat(hidden_chunks).cpu().numpy() if hidden_chunks else np.zeros((0, llm_cfg.hidden_size), np.float32)
        )
        return RoundOutput(out_tokens, images)

    def _keep_text_uncond_mask(self, prompt_end: int):
        """The text-uncond mask follows the cond mask past the prompt (KEEP) or everywhere (DROP)."""
        if self.runtime.past_mode == "KEEP":
            pos = torch.arange(self.runtime.max_seq_len, device=self.device)[None, :]
            self.text_uncond_mask = torch.where(pos < prompt_end, self.text_uncond_mask, self.mask)
        else:
            self.text_uncond_mask = self.mask.clone()

    def continue_decode(self, max_new_tokens: int, generation: Optional[GenerationConfig] = None) -> RoundOutput:
        """Resume decoding where the last round stopped (streaming chunks): feed
        the last token of the round, already reported, and decode on, as the
        JAX session does: a chunk of n reports at most n - 1 new tokens. Valid
        after a round that ended on its token budget, not on <eos>."""
        gen = generation or GenerationConfig(max_new_tokens=max_new_tokens)
        if self._last_token is None:
            raise RuntimeError("no round to continue")
        llm_cfg = self.cfg.llm
        cur = self._last_token
        out_tokens: List[int] = []
        images: List[np.ndarray] = []
        budget = max_new_tokens
        reported = True  # the previous round reported its last token
        while budget > 0:
            if not reported:
                out_tokens.append(cur)
            reported = False
            budget -= 1
            if cur == llm_cfg.eos_token_id:
                break
            if cur == llm_cfg.image_start_token:
                cur, new_images = self._run_image_phase(cur, self._prompt_end, self.cfg.image_gen)
                images.extend(new_images)
                continue
            if budget <= 0:
                break
            res = decode_text(self.params["llm"], llm_cfg, cur, self.cache, self.mask, self.generator,
                              max_steps=budget, do_sample=gen.do_sample, temperature=gen.temperature,
                              top_k=gen.top_k, top_p=gen.top_p, int_dots=self.runtime.moe_int_dots)
            self.cache, self.mask = res.cache, res.mask
            self.seq_len = self.cache.length
            if not res.tokens:
                break
            out_tokens.extend(res.tokens[:-1])
            budget -= len(res.tokens) - 1
            cur = res.tokens[-1]
        self._last_token = cur
        self.seq_len = self.cache.length
        self._keep_text_uncond_mask(self._prompt_end)  # a streamed round is one round in chunks
        return RoundOutput(out_tokens, images)

    def _variant_generators(self, n_images: int) -> list:
        """The RF noise generators of an image phase's variants: the session's
        own for variant 0, for variant i a new one seeded by the SHA-256 of the
        session generator's state and i (read on the host: no device sync)."""
        state = self.generator.get_state().numpy().tobytes()
        gens = [self.generator]
        for i in range(1, n_images):
            seed = int.from_bytes(hashlib.sha256(state + i.to_bytes(4, "little")).digest()[:8], "little")
            gens.append(torch.Generator(device=self.device).manual_seed(seed))
        return gens

    def _run_image_phase(self, image_start_token: int, prompt_end: int, igen: ImageGenConfig, n_images: int = 1):
        """The 256-token AR image loop for `n_images` variants and their pixel
        decode; returns (the next text token, the images, each (3, H, W)). The
        conversation continues from variant 0's cond row."""
        llm_cfg = self.cfg.llm
        pos = torch.arange(self.runtime.max_seq_len, device=self.device)[None, :]
        cond = self.mask
        uncond = torch.where(pos < prompt_end, self.uncond_mask, cond)
        text_uncond = torch.where(pos < prompt_end, self.text_uncond_mask, cond)
        # the text-uncond row only when non-empty and different from the uncond row
        has_text_row = bool((text_uncond != uncond).any()) and bool(text_uncond.any())
        rows = [cond, uncond] + ([text_uncond] if has_text_row else [])
        cfg_rows = len(rows)
        # BLOCK-major: [conds x n | unconds x n (| text_unconds x n)]; the batch-1 cache repeats to that layout
        row_masks = torch.cat([r for kind in rows for r in [kind] * n_images])

        cache_r = self.cache.repeat_rows(cfg_rows * n_images)
        start_embed = embed_tokens(self.params["llm"], torch.tensor([[image_start_token]], device=self.device))
        self._sync()
        t0 = time.perf_counter()
        result = generate_image_tokens(self.params, llm_cfg, self.cfg.mingtok, self.cfg.rf_head, igen,
                                       start_embed.to(self._dtype), cache_r, row_masks,
                                       generators=self._variant_generators(n_images), cfg_rows=cfg_rows,
                                       n_images=n_images, int_dots=self.runtime.moe_int_dots,
                                       rf_int_dots=self.rf_int_dots, rf_fused=self.rf_fused,
                                       rf_int4_int_dots=self.rf_int4_int_dots)
        self._sync()
        t1 = time.perf_counter()
        self.cache = result.cache.first_row()
        self.mask = result.mask[0:1].clone()
        self.seq_len = self.cache.length

        imgs = pixel_decode(self.params["mingtok"], self.cfg.mingtok, result.sem_tokens).float().cpu().numpy()
        t2 = time.perf_counter()
        self.timings.update(cfg_rows=cfg_rows, n_images=n_images, image_loop_ms=(t1 - t0) * 1e3,
                            pixel_decode_ms=(t2 - t1) * 1e3)

        logits = compute_logits(self.params["llm"], llm_cfg, result.last_hidden[:1])[:, -1]
        return int(sample_token(logits, self.generator)[0]), list(imgs)
