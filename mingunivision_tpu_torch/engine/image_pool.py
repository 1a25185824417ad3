"""Continuous-batching text-to-image (counterpart of
mingunivision_tpu/engine/image_pool.py): a fixed pool of image slots over one
block-major CFG cache with PER-SLOT iteration counters, so new requests are
admitted into free slots while other slots are mid-loop
(serving/image_batch.py admits only between whole loops).

  - Rows stay BLOCK-major, [conds 0..n | unconds 0..n | text_unconds 0..n]:
    the layout `rf_sample`'s guidance takes. A request without a distinct
    text-uncond row reuses its uncond mask.
  - The LLM step is `engine.batch_engine.pooled_forward` (per-row KV write
    positions and masks: the decode-attention kernel, the decode MoE over all
    3n rows); the semantic decoder steps through
    `models.mingtok.mingtok_feature_decoder_rows`.
  - The RF sample runs over the ACTIVE slots' rows, with per-slot guidance
    scales (kept as host floats, so the fused sampler forms its groups with
    no device sync) and per-slot noise, which
    each slot draws from its own generator, seeded by its request, and which
    is scaled by the slot's temperature. A slot's image is that of a run alone
    in a pool of the same width with the same seed, whatever else is
    scheduled beside it.

The port runs eagerly: `step()` runs `chunk` micro-steps between host
scheduling points (`chunk` schedules; it does not change the numbers). The
state's tensors are updated IN PLACE; the host keeps mirrors of each slot's
activity, iteration and scales, so scheduling never reads the device, and a
step reads back only finished images.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from mingunivision_tpu_torch.engine.batch_engine import PREFILL_BUCKET, pooled_forward
from mingunivision_tpu_torch.engine.generate import cfg_at, image_noise, linear_proj_apply, pixel_decode, prefill
from mingunivision_tpu_torch.models.bailing_moe import LLMCache, embed_tokens
from mingunivision_tpu_torch.models.mingtok import mingtok_feature_decoder_rows
from mingunivision_tpu_torch.models.rf_head import rf_sample, vis_head_apply
from mingunivision_tpu_torch.processing.processor import request_masks


@dataclasses.dataclass
class ImagePoolState:
    k: torch.Tensor  # (L, 3n, Hkv, S, D) head-major, BLOCK-major CFG rows
    v: torch.Tensor
    masks: torch.Tensor  # (3n, S) bool: per-row attention masks
    lengths: torch.Tensor  # (n,) int64: per-slot KV write offset (its 3 rows share it)
    iters: torch.Tensor  # (n,) int64: AR token index, 0..num_image_tokens + 1
    active: torch.Tensor  # (n,) bool
    embeds: torch.Tensor  # (3n, 1, h) next LLM input per row
    sem_tokens: torch.Tensor  # (n, num_image_tokens, feat)
    sem_k: torch.Tensor  # (depth, n, H, num_image_tokens + 1, D) semantic-decoder cache
    sem_v: torch.Tensor
    last_hidden: torch.Tensor  # (n, h) fp32: the trailing step's cond-row hidden state

    @classmethod
    def create(cls, cfg, slots: int, max_len: int, dtype=torch.bfloat16, device=None) -> "ImagePoolState":
        llm, sd = cfg.llm, cfg.mingtok.semantic_decoder
        n_tok = cfg.image_gen.num_image_tokens
        kv = (llm.num_hidden_layers, 3 * slots, llm.num_key_value_heads, max_len, llm.head_dim)
        sem_kv = (sd.depth, slots, sd.num_heads, n_tok + 1, sd.embed_dim // sd.num_heads)

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(zeros(kv), zeros(kv), zeros((3 * slots, max_len), torch.bool), zeros(slots, torch.long),
                   zeros(slots, torch.long), zeros(slots, torch.bool), zeros((3 * slots, 1, llm.hidden_size)),
                   zeros((slots, n_tok, cfg.mingtok.feature_dim)), zeros(sem_kv), zeros(sem_kv),
                   zeros((slots, llm.hidden_size), torch.float32))


def _cfg_at_rows(gen_cfg, iters, text_cfg, image_cfg):
    """`generate.cfg_at` per slot: the scales of each slot's iteration under
    the schedule from its base scales (host sequences) -> two lists."""
    pairs = [cfg_at(gen_cfg, i, t, g) for i, t, g in zip(iters, text_cfg, image_cfg)]
    return [t for t, _ in pairs], [g for _, g in pairs]


def _admit(state: ImagePoolState, slot: int, cache_k, cache_v, masks3, length: int, start_embed):
    """Splice a prefilled request into pool slot `slot` IN PLACE. cache_k/v:
    (L, 1, Hkv, S, D) prefilled rows; masks3: (3, S) cond / uncond /
    text-uncond row masks. The slot's semantic cache, tokens and trailing
    hidden state are zeroed."""
    n = state.iters.shape[0]
    idx3 = [slot, n + slot, 2 * n + slot]
    state.k[:, idx3] = cache_k[:, :1]
    state.v[:, idx3] = cache_v[:, :1]
    state.masks[idx3] = masks3
    state.lengths[slot] = length
    state.iters[slot] = 0
    state.active[slot] = True
    state.embeds[idx3] = start_embed.reshape(1, 1, -1).to(state.embeds.dtype)
    for t in (state.sem_tokens, state.last_hidden):
        t[slot] = 0
    for t in (state.sem_k, state.sem_v):
        t[:, slot] = 0


@dataclasses.dataclass
class ImageRequest:
    request_id: int
    done: bool = False
    sem_tokens: Optional[np.ndarray] = None  # (num_image_tokens, feat)
    image: Optional[np.ndarray] = None  # (3, H, W) float32 in [-1, 1]
    last_hidden: Optional[np.ndarray] = None  # (h,) fp32


class ImagePoolEngine:
    """Host scheduler over the pool's micro-steps (the T2I continuous batcher).

    add_request() admits a processor-output dict into a free slot at any time,
    also while other slots are mid-loop; step() advances every active slot by
    `chunk` micro-steps and finishes the images completed in them (their
    pixels decoded together). Per-request text_cfg / image_cfg / temperature
    are per-slot values. The kernels and dot modes follow `runtime` as in the
    session (RuntimeConfig.moe_int_dots, rf_int_dots, rf_fused_sampler,
    rf_int4_int_dots). `micro_steps` counts the micro-steps run."""

    def __init__(self, params, cfg, runtime, *, slots: int = 4, chunk: int = 32, decode_pixels: bool = True,
                 image_start_token: Optional[int] = None, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError("a sharded image pool (mesh=) is not ported to the PyTorch package yet "
                                      "(ROADMAP.md Queue 1.8)")
        self.params = params
        self.cfg = cfg
        self.runtime = runtime
        self.slots = slots
        self.chunk = chunk
        self.decode_pixels = decode_pixels
        self.device = torch.device(device) if device is not None else params["llm"]["norm"]["w"].device
        self.dtype = torch.float32 if runtime.compute_dtype == "float32" else torch.bfloat16
        self.int_dots = runtime.moe_int_dots
        self.prefill_int_dots = getattr(runtime, "moe_prefill_int_dots", False)
        self.rf_kw = dict(int_dots=getattr(runtime, "rf_int_dots", False),
                          fused=getattr(runtime, "rf_fused_sampler", True),
                          int4_int_dots=getattr(runtime, "rf_int4_int_dots", True))
        self.state = ImagePoolState.create(cfg, slots, runtime.max_seq_len, self.dtype, self.device)
        start_tok = int(image_start_token if image_start_token is not None else cfg.llm.image_start_token)
        self.start_embed = embed_tokens(params["llm"], torch.tensor([[start_tok]], device=self.device))
        # host mirrors of the per-slot state, and each slot's noise generator
        self._active = [False] * slots
        self._iters = [0] * slots
        self._scales = [(1.0, 1.0, 1.0)] * slots  # (text_cfg, image_cfg, temperature)
        self._generators: List[Optional[torch.Generator]] = [None] * slots
        self.slot_req: Dict[int, ImageRequest] = {}
        self._next_id = 0
        self.micro_steps = 0

    # -- admission --------------------------------------------------------

    def has_free_slot(self) -> bool:
        return self._free_slot() is not None

    def _free_slot(self) -> Optional[int]:
        for b in range(self.slots):
            if not self._active[b] and b not in self.slot_req:
                return b
        return None

    def add_request(self, request: dict, seed: int, *, text_cfg: Optional[float] = None,
                    image_cfg: Optional[float] = None, temperature: Optional[float] = None) -> Optional[ImageRequest]:
        """Admit one request (a processor-output dict: `input_ids`,
        `attention_mask`, optional `uncond_attention_mask` /
        `text_uncond_attention_mask`); None if the pool is full. `seed` seeds
        THIS request's RF noise generator: its image is that of a run alone
        with the same seed, whatever is scheduled beside it."""
        slot = self._free_slot()
        if slot is None:
            return None
        igen = self.cfg.image_gen
        Smax = self.runtime.max_seq_len
        ids, am, um, tm = request_masks(request)
        T = ids.shape[1]
        if T + igen.num_image_tokens + 2 > Smax:
            raise ValueError("prompt + image tokens exceed max_seq_len")

        # bucketed one-row prefill; its cache lives only until it is spliced in
        Tb = min(Smax, -(-T // PREFILL_BUCKET) * PREFILL_BUCKET)
        ids_pad = torch.zeros((1, Tb), dtype=torch.long, device=self.device)
        ids_pad[0, :T] = torch.as_tensor(ids[0], device=self.device)
        cache1 = LLMCache.create(self.cfg.llm, 1, Smax, self.dtype, self.device)
        mask1 = torch.zeros((1, Smax), dtype=torch.bool, device=self.device)
        mask1[:, :T] = torch.as_tensor(am, device=self.device)
        embeds = embed_tokens(self.params["llm"], ids_pad).to(self.dtype)
        _, cache1 = prefill(self.params["llm"], self.cfg.llm, embeds, cache1, mask1, int_dots=self.int_dots,
                            prefill_int_dots=self.prefill_int_dots)
        masks3 = np.zeros((3, Smax), bool)
        for r, m in enumerate((am, um, tm)):
            masks3[r, :T] = m[0]
        scales = (float(igen.text_cfg if text_cfg is None else text_cfg),
                  float(igen.image_cfg if image_cfg is None else image_cfg),
                  float(igen.temperature if temperature is None else temperature))
        _admit(self.state, slot, cache1.k, cache1.v, torch.as_tensor(masks3, device=self.device), cache1.length,
               self.start_embed)
        del cache1, embeds
        self._active[slot], self._iters[slot], self._scales[slot] = True, 0, scales
        self._generators[slot] = torch.Generator(device=self.device).manual_seed(int(seed))
        req = ImageRequest(self._next_id)
        self._next_id += 1
        self.slot_req[slot] = req
        return req

    # -- stepping ---------------------------------------------------------

    def _micro(self):
        """One AR micro-step for every active slot: the per-token program of
        `generate_image_tokens` at the slot's own positions, cfg schedule and
        noise. The trailing LLM step (iteration == num_image_tokens) stores the
        cond row's hidden state and deactivates the slot."""
        st, n = self.state, self.slots
        act = [s for s in range(n) if self._active[s]]
        if not act:
            return
        n_tok = self.cfg.image_gen.num_image_tokens
        rf_cfg, dev = self.cfg.rf_head, self.device
        row_active = st.active.repeat(3)  # (3n,) block-major
        row_len = st.lengths.repeat(3)
        rows3 = torch.arange(3 * n, device=dev)
        st.masks[rows3, row_len] |= row_active  # the position each active row's input occupies
        positions = st.masks.long().sum(dim=1, keepdim=True) - 1
        hidden, _, _ = pooled_forward(self.params["llm"], self.cfg.llm, st.embeds, st.k, st.v, st.masks, row_len,
                                      row_active, positions, int_dots=self.int_dots,
                                      prefill_int_dots=self.prefill_int_dots)
        z = vis_head_apply(self.params["vis_head"], hidden[:, -1])  # (3n, z)

        # the RF sample over the active slots' rows, block-major among themselves
        m = len(act)
        rows = torch.tensor([b * n + s for b in range(3) for s in act], device=dev)
        tcfg, icfg = _cfg_at_rows(self.cfg.image_gen, [self._iters[s] for s in act],
                                  [self._scales[s][0] for s in act], [self._scales[s][1] for s in act])
        temps = torch.tensor([self._scales[s][2] for s in act], device=dev)[:, None]
        noise = image_noise([self._generators[s] for s in act], rf_cfg.target_channels, dev) * temps
        gen = self.cfg.image_gen
        sampled = rf_sample(self.params["rf_head"], rf_cfg, z[rows], noise=noise, text_cfg=tcfg, image_cfg=icfg,
                            cfg_renorm_type=gen.cfg_renorm_type, time_shifting_factor=gen.time_shifting_factor,
                            cfg_rows=3, **self.rf_kw)
        latent = torch.zeros((n, rf_cfg.target_channels), dtype=sampled.dtype, device=dev)
        latent[act] = sampled[:m]  # the cond block: each slot's guided sample

        # an inactive slot's index may sit past its cache: it writes at the last position, which it never reads
        sem_pos = st.iters.clamp(max=n_tok)
        sem = mingtok_feature_decoder_rows(self.params["mingtok"], self.cfg.mingtok, latent[:, None, :], st.sem_k,
                                           st.sem_v, sem_pos, compute_dtype=st.embeds.dtype)["x_norm_patchtokens"]
        for s in act:
            i = self._iters[s]
            if i < n_tok:
                st.sem_tokens[s, i] = sem[s, 0].to(st.sem_tokens.dtype)
            else:  # the trailing step
                st.last_hidden[s] = hidden[s, -1].float()
        nxt = linear_proj_apply(self.params["linear_proj"], sem).to(st.embeds.dtype)
        st.embeds.copy_(torch.where(row_active[:, None, None], nxt.repeat(3, 1, 1), st.embeds))

        st.lengths += st.active
        st.iters += st.active
        st.active &= st.iters <= n_tok
        for s in act:
            self._iters[s] += 1
            self._active[s] = self._iters[s] <= n_tok
        self.micro_steps += 1

    def step(self) -> List[ImageRequest]:
        """`chunk` micro-steps for all active slots; returns the requests they
        finished (sem_tokens, image, last_hidden filled in)."""
        if not self.slot_req:
            return []
        for _ in range(self.chunk):
            self._micro()
        n_tok = self.cfg.image_gen.num_image_tokens
        done_slots = [s for s in self.slot_req if not self._active[s] and self._iters[s] == n_tok + 1]
        if not done_slots:
            return []
        sem = self.state.sem_tokens[done_slots].float()
        hid = self.state.last_hidden[done_slots].cpu().numpy()
        imgs = None
        if self.decode_pixels:
            imgs = pixel_decode(self.params["mingtok"], self.cfg.mingtok, sem).float().cpu().numpy()
        sem = sem.cpu().numpy()
        out = []
        for j, s in enumerate(done_slots):
            req = self.slot_req.pop(s)
            req.sem_tokens, req.last_hidden = sem[j], hid[j]
            if imgs is not None:
                req.image = imgs[j]
            req.done = True
            self._generators[s] = None
            out.append(req)
        return out

    def run_until_idle(self, max_chunks: int = 1000) -> List[ImageRequest]:
        done: List[ImageRequest] = []
        for _ in range(max_chunks):
            if not self.slot_req:
                break
            done.extend(self.step())
        return done
