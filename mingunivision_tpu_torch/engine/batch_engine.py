"""Continuous-batching text generation over a dense KV pool (counterpart of
mingunivision_tpu/engine/batch_engine.py).

A fixed pool of slots shares one batched head-major KV cache with PER-SLOT
lengths; every decode step advances all active slots in one forward, so the
weights are read once per step whatever the batch. Requests are admitted
into free slots (a bucketed one-row prefill straight into the slot's rows of
the pool) and a finished slot is free at once. The pool reserves `max_len`
positions per slot; engine/paged.py keeps KV in pages instead.

The pool and the per-slot state are updated IN PLACE. The host keeps mirrors
of `active` and `lengths`, so admission never reads device state; a step
reads back only its sampled tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from mingunivision_tpu_torch.engine.generate import prefill
from mingunivision_tpu_torch.engine.sampler import sample_token, sample_token_per_slot
from mingunivision_tpu_torch.models.bailing_moe import LLMCache, compute_logits, embed_tokens, moe_block_apply
from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention
from mingunivision_tpu_torch.ops.linear import dense
from mingunivision_tpu_torch.ops.norms import rms_norm
from mingunivision_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from mingunivision_tpu_torch.utils.pytree import layer_view

PREFILL_BUCKET = 64  # admission prompts right-pad to multiples of this


@dataclasses.dataclass
class SamplingState:
    """Per-slot sampling parameters as device tensors: a pool of greedy and
    sampled requests with different temperature / top-k / top-p shares one
    decode step."""

    do_sample: torch.Tensor  # (B,) bool
    temperature: torch.Tensor  # (B,) fp32
    top_k: torch.Tensor  # (B,) int64, 0 = off
    top_p: torch.Tensor  # (B,) fp32, 1.0 = off

    @classmethod
    def create(cls, slots: int, device=None) -> "SamplingState":
        return cls(torch.zeros(slots, dtype=torch.bool, device=device), torch.ones(slots, device=device),
                   torch.zeros(slots, dtype=torch.long, device=device), torch.ones(slots, device=device))

    def set_slot(self, slot: int, *, do_sample=False, temperature=1.0, top_k=0, top_p=1.0):
        """Write one slot's parameters in place."""
        self.do_sample[slot] = bool(do_sample)
        self.temperature[slot] = float(temperature)
        self.top_k[slot] = int(top_k)
        self.top_p[slot] = float(top_p)


@dataclasses.dataclass
class BatchState:
    k: torch.Tensor  # (L, B, Hkv, S, D) head-major, as LLMCache
    v: torch.Tensor
    mask: torch.Tensor  # (B, S) bool: the valid positions of each slot
    lengths: torch.Tensor  # (B,) int64: tokens in cache per slot
    cur: torch.Tensor  # (B,) int64: the next token to feed
    active: torch.Tensor  # (B,) bool
    sampling: SamplingState

    @classmethod
    def create(cls, cfg, slots: int, max_len: int, dtype=torch.bfloat16, device=None) -> "BatchState":
        cache = LLMCache.create(cfg, slots, max_len, dtype, device)
        zeros = lambda dt: torch.zeros(slots, dtype=dt, device=device)  # noqa: E731
        return cls(cache.k, cache.v, torch.zeros((slots, max_len), dtype=torch.bool, device=device),
                   zeros(torch.long), zeros(torch.long), zeros(torch.bool), SamplingState.create(slots, device))


def pooled_layers(params, cfg, x, positions, attend, int_dots: bool = True, prefill_int_dots: bool = False):
    """The decoder stack for ONE new token per pool row, each row at its own
    position: x (B, 1, h) embeds; positions (B, 1) RoPE positions;
    attend(layer, q, k_new, v_new) writes the rows' new K/V into the layer's
    pool and returns the attention output (B, 1, Hq, D); int_dots /
    prefill_int_dots: the decode and prefill MoE's dot modes over quantized
    tables (a pool of more than 48 rows takes the prefill MoE). Returns the
    final rms-normed hidden
    state (B, 1, h), as `bailing_forward` does."""
    B = x.shape[0]
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    cos, sin = rope_cos_sin(positions, D, cfg.rope_theta)
    layers = params["layers"]
    experts = layers["mlp"]["experts"]
    per_layer = {**layers, "mlp": {k: v for k, v in layers["mlp"].items() if k != "experts"}}
    h = x
    for l in range(cfg.num_hidden_layers):
        p = layer_view(per_layer, l)
        hn = rms_norm(h, p["input_layernorm"]["w"], eps=cfg.rms_norm_eps)
        qkv = dense(hn, p["attention"]["query_key_value"]).reshape(B, 1, Hq + 2 * Hkv, D)
        q, kn, vn = qkv.split([Hq, Hkv, Hkv], dim=2)
        q, kn = apply_rope(q, kn, cos, sin)
        a = attend(l, q, kn, vn)
        h = h + dense(a.reshape(B, 1, Hq * D), p["attention"]["dense"])
        hn = rms_norm(h, p["post_attention_layernorm"]["w"], eps=cfg.rms_norm_eps)
        h = h + moe_block_apply(p["mlp"], cfg, hn, experts_stacked=experts, layer_idx=l, int_dots=int_dots,
                                prefill_int_dots=prefill_int_dots)
    return rms_norm(h, params["norm"]["w"], eps=cfg.rms_norm_eps)


def pooled_forward(params, cfg, x, k, v, mask, write_pos, active, positions=None, int_dots: bool = True,
                   prefill_int_dots: bool = False):
    """One single-token LLM forward over dense pool rows with PER-ROW KV
    positions. x (B, 1, h); k/v (L, B, Hkv, S, D) written IN PLACE; mask
    (B, S) bool, already including the position being fed; write_pos (B,)
    the per-row KV write index; active (B,) bool: inactive rows compute but
    keep their old K/V. positions (B, 1) RoPE positions (default write_pos).
    Attention goes through the decode-attention kernel with the row mask;
    int_dots / prefill_int_dots: the MoE's dot modes. Returns (normed hidden (B, 1, h), k, v)."""
    B = x.shape[0]
    D = cfg.head_dim
    rows = torch.arange(B, device=x.device)
    keep = active[:, None, None]

    def attend(l, q, kn, vn):
        kc, vc = k[l], v[l]  # (B, Hkv, S, D)
        for cache, new in ((kc, kn), (vc, vn)):
            cache[rows, :, write_pos] = torch.where(keep, new[:, 0].to(cache.dtype), cache[rows, :, write_pos])
        return decode_attention(q, kc, vc, mask, scale=D**-0.5)

    h = pooled_layers(params, cfg, x, write_pos[:, None] if positions is None else positions, attend, int_dots,
                      prefill_int_dots)
    return h, k, v


def _sample_and_advance(params, cfg, state, hidden, generator):
    """Per-slot sampling from the last hidden states, then the state update
    both pools share: finished rows (<eos> / <image>) go inactive, active rows
    grow by one. Returns the sampled tokens, -1 for inactive rows."""
    logits = compute_logits(params, cfg, hidden)[:, -1]
    sp = state.sampling
    nxt = sample_token_per_slot(logits, generator, do_sample=sp.do_sample, temperature=sp.temperature,
                                top_k=sp.top_k, top_p=sp.top_p)
    done = (nxt == cfg.eos_token_id) | (nxt == cfg.image_start_token)
    out = torch.where(state.active, nxt, torch.full_like(nxt, -1))
    state.lengths += state.active.long()
    state.cur.copy_(torch.where(state.active, nxt, state.cur))
    state.active &= ~done
    return out


def batched_decode_step(params, cfg, state: BatchState, generator: Optional[torch.Generator] = None,
                        int_dots: bool = True, prefill_int_dots: bool = False):
    """One decode step for every slot of the dense pool, IN PLACE: inactive
    slots compute but keep their K/V, mask and length. Each slot samples with
    its own parameters; int_dots / prefill_int_dots: the MoE's dot modes. Returns the
    sampled tokens (B,), -1 for inactive."""
    B = state.cur.shape[0]
    rows = torch.arange(B, device=state.cur.device)
    state.mask[rows, state.lengths] |= state.active  # the fed token's position
    x = embed_tokens(params, state.cur[:, None]).to(state.k.dtype)
    h, _, _ = pooled_forward(params, cfg, x, state.k, state.v, state.mask, state.lengths, state.active,
                             int_dots=int_dots, prefill_int_dots=prefill_int_dots)
    return _sample_and_advance(params, cfg, state, h, generator)


@dataclasses.dataclass
class Request:
    input_ids: np.ndarray  # (T,)
    max_new_tokens: int = 128
    request_id: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # per-request sampling (None -> engine defaults)
    do_sample: Optional[bool] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None


SAMPLING_KEYS = ("do_sample", "temperature", "top_k", "top_p")


class ContinuousBatchingEngine:
    """Host scheduler over the batched decode step on the dense pool.

    Sampling parameters are per slot (`BatchState.sampling`); the engine-level
    ones are the defaults of requests that name none. RNG: one
    `torch.Generator` on the engine's device draws each admission's first
    token and each step's per-slot draw. The weight tier follows `params`
    (bf16, int4, NF4 or int8); over quantized tables `int_dots` is the decode
    MoE's dot mode (exact dequant when False) and `prefill_int_dots` the
    prefill MoE's (s8 dots when True), as RuntimeConfig's moe_int_dots and
    moe_prefill_int_dots."""

    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 1024, dtype=torch.bfloat16, seed: int = 0,
                 do_sample: bool = False, temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 device=None, int_dots: bool = True, prefill_int_dots: bool = False):
        self._setup(params, cfg, slots, max_len, dtype, seed, device,
                    dict(do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p), int_dots,
                    prefill_int_dots)
        self.state = BatchState.create(cfg, slots, max_len, dtype, self.device)
        self.active = np.zeros(slots, bool)  # host mirrors of state.active / state.lengths
        self.lengths = np.zeros(slots, np.int64)

    def _setup(self, params, cfg, slots, max_len, dtype, seed, device, sampling, int_dots, prefill_int_dots):
        """What both pools' schedulers hold besides the pool itself."""
        self.int_dots = int_dots
        self.prefill_int_dots = prefill_int_dots
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else params["norm"]["w"].device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sampling = sampling
        self.slot_req: Dict[int, Request] = {}
        self.slot_budget: Dict[int, int] = {}
        self._next_id = 0

    # -- admission ------------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for b in range(self.slots):
            if not self.active[b] and b not in self.slot_req:
                return b
        return None

    def has_free_slot(self) -> bool:
        return self._free_slot() is not None

    def _check_request(self, T: int, max_new_tokens: int):
        if T + max_new_tokens >= self.max_len:
            raise ValueError(f"prompt {T} + max_new_tokens {max_new_tokens} must stay below max_len {self.max_len}")

    def _new_request(self, ids, max_new_tokens, sampling):
        """The Request and its resolved sampling parameters."""
        req = Request(ids, max_new_tokens, self._next_id, **sampling)
        self._next_id += 1
        return req, {k: (getattr(req, k) if getattr(req, k) is not None else self.sampling[k]) for k in SAMPLING_KEYS}

    def _embed_padded(self, ids, T0: int, Tb: int):
        """Embeddings of ids[T0:] right-padded to Tb ids, in the pool's dtype."""
        ids_pad = torch.zeros((1, Tb), dtype=torch.long, device=self.device)
        ids_pad[0, : len(ids) - T0] = torch.as_tensor(ids[T0:], device=self.device)
        return embed_tokens(self.params, ids_pad).to(self.dtype)

    def add_request(self, input_ids, max_new_tokens: int = 128, *, do_sample: Optional[bool] = None,
                    temperature: Optional[float] = None, top_k: Optional[int] = None,
                    top_p: Optional[float] = None) -> Optional[Request]:
        """Admit a request: prefill into a free slot. None if the pool is full.
        Sampling kwargs override the engine defaults for this request only."""
        slot = self._free_slot()
        if slot is None:
            return None
        ids = np.asarray(input_ids).reshape(-1)
        T = len(ids)
        self._check_request(T, max_new_tokens)
        req, req_sampling = self._new_request(ids, max_new_tokens, dict(do_sample=do_sample, temperature=temperature,
                                                                          top_k=top_k, top_p=top_p))
        Tb = min(self.max_len, -(-T // PREFILL_BUCKET) * PREFILL_BUCKET)
        st = self.state
        # the bucketed one-row prefill writes the slot's rows of the pool directly
        mask1 = torch.zeros((1, self.max_len), dtype=torch.bool, device=self.device)
        mask1[:, :T] = True
        logits, _ = prefill(self.params, self.cfg, self._embed_padded(ids, 0, Tb),
                            LLMCache(st.k[:, slot : slot + 1], st.v[:, slot : slot + 1], 0), mask1,
                            int_dots=self.int_dots, prefill_int_dots=self.prefill_int_dots)
        first = int(sample_token(logits, self.generator, **req_sampling)[0])
        st.mask[slot] = mask1[0]
        st.lengths[slot] = T
        st.cur[slot] = first
        st.active[slot] = True
        st.sampling.set_slot(slot, **req_sampling)
        self.active[slot], self.lengths[slot] = True, T
        req.tokens.append(first)
        self.slot_req[slot] = req
        self.slot_budget[slot] = max_new_tokens - 1
        if first in (self.cfg.eos_token_id, self.cfg.image_start_token):
            self._finish(slot)
        return req

    def _finish(self, slot: int):
        req = self.slot_req.pop(slot, None)
        if req is not None:
            req.done = True
        self.slot_budget.pop(slot, None)
        self.state.active[slot] = False
        self.active[slot] = False

    # -- stepping -------------------------------------------------------------

    def _collect(self, toks) -> Dict[int, int]:
        """Hand a step's tokens to their requests; finish the done ones."""
        out = {}
        stop = (self.cfg.eos_token_id, self.cfg.image_start_token)
        for slot, req in list(self.slot_req.items()):
            t = int(toks[slot])
            if t < 0:
                continue
            req.tokens.append(t)
            out[req.request_id] = t
            self._grew(slot)
            self.slot_budget[slot] -= 1
            if t in stop or self.slot_budget[slot] <= 0:
                self._finish(slot)
        return out

    def _grew(self, slot: int):
        self.lengths[slot] += 1

    def step(self) -> Dict[int, int]:
        """Advance all active slots one token. Returns {request_id: token}."""
        if not self.slot_req:
            return {}
        toks = batched_decode_step(self.params, self.cfg, self.state, self.generator, self.int_dots,
                                   self.prefill_int_dots)
        return self._collect(toks.cpu().numpy())

    def run_to_completion(self, max_steps: int = 10_000) -> int:
        steps = 0
        while self.slot_req and steps < max_steps:
            self.step()
            steps += 1
        return steps
