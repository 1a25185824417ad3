"""Bailing-MoE decoder-only LLM (16B total / ~3B active) in PyTorch.

Counterpart of mingunivision_tpu/models/bailing_moe.py with the same parameter
tree: depth-stacked layer leaves (L, ...), `(in, out)` linear weights, expert
tables (L, E, h, m) / (L, E, m, h), and a head-major KV cache
(L, B, Hkv, Smax, D). The layer loop is a Python loop; each layer reads
zero-copy views of the stacked leaves, and the MoE kernels read the layer's
expert tables as views of the stacked tables.

Dispatch: decode-shape MoE (B*T <= MOE_DECODE_MAX_TOKENS) goes to the
decode-MoE kernel, larger token counts to the grouped-SwiGLU prefill kernel
(each wrapper picks its bf16 or int4 kernel from the table type), through the
capacity-dense dispatch from MOE_CAPACITY_MIN_TOKENS rows up and the
expert-sorted one below; one-token attention goes to the decode-attention
kernel and a first-round prefill that passes `flash_usable` to the
flash-attention kernel; CPU tensors take the kernels' plain versions.
Quantized dense weights (attention, shared experts, router, lm_head) are
dequantized before their product, and an int8 embedding is gathered as int8
rows and scaled in fp32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mingunivision_tpu_torch.ops.attention import mha
from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention
from mingunivision_tpu_torch.ops.kernels.flash import flash_prefill_attention
from mingunivision_tpu_torch.ops.kernels.moe_capacity import default_capacity, moe_experts_capacity_gmm_exact
from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm
from mingunivision_tpu_torch.ops.linear import dense
from mingunivision_tpu_torch.ops.norms import rms_norm
from mingunivision_tpu_torch.ops.rope import apply_rope, mrope_cos_sin, rope_cos_sin
from mingunivision_tpu_torch.utils.pytree import layer_view
from mingunivision_tpu_torch.utils.quantize import QuantizedArray, dequant_weight

# At or below this many rows the decode-shape MoE runs (as in the JAX package).
MOE_DECODE_MAX_TOKENS = 48
# From this many rows up the prefill MoE takes the capacity-dense dispatch (when
# cfg.moe_prefill_capacity_factor > 0): below it the per-expert slots, at least
# 128 each, would be mostly empty.
MOE_CAPACITY_MIN_TOKENS = 512


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LLMCache:
    """Preallocated KV cache: k/v (L, B, Hkv, Smax, D) head-major, plus the
    number of positions written (a host int). Forward passes write k/v IN
    PLACE; `repeat_rows` and `first_row` return fresh buffers."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def create(cls, cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> "LLMCache":
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device), 0)

    def repeat_rows(self, n: int) -> "LLMCache":
        """Tile the batch dim (CFG row expansion)."""
        return LLMCache(self.k.repeat_interleave(n, dim=1), self.v.repeat_interleave(n, dim=1), self.length)

    def first_row(self) -> "LLMCache":
        """Keep only the cond row."""
        return LLMCache(self.k[:, :1].clone(), self.v[:, :1].clone(), self.length)


# ---------------------------------------------------------------------------
# Router + MoE
# ---------------------------------------------------------------------------


def moe_route(gate_w: torch.Tensor, x_flat: torch.Tensor, top_k: int, norm_topk_prob: bool):
    """fp32-softmax top-k routing. x_flat (N, h) -> (topk_idx (N, k) int64,
    topk_w (N, k) fp32, logits (N, E) fp32). Logits are exact fp32 sums of the
    input-dtype products."""
    logits = torch.matmul(x_flat.float(), dequant_weight(gate_w, x_flat.dtype).float())
    scores = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(scores, top_k, dim=-1)
    if top_k > 1 and norm_topk_prob:
        topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
    return topk_idx, topk_w, logits


def _expert_mlp(x, gate_w, up_w, down_w):
    """SwiGLU expert (the shared experts): down(silu(gate(x)) * up(x))."""
    g = torch.matmul(x, dequant_weight(gate_w, x.dtype)).float()
    u = torch.matmul(x, dequant_weight(up_w, x.dtype)).float()
    a = (F.silu(g) * u).to(x.dtype)
    return torch.matmul(a, dequant_weight(down_w, x.dtype))


# phase -> routed-expert kernel wrapper (each picks its plain version for CPU
# tensors itself); every entry takes (stacked experts, x_flat, topk_idx,
# topk_w, num_experts, layer_idx), the capacity one also (capacity, token_valid)
MOE_IMPLS = {
    "decode": lambda ex, x, i, w, E, l: moe_experts_stream(ex, x, i, w, layer_idx=l),
    "prefill": lambda ex, x, i, w, E, l: moe_experts_swiglu_gmm(ex, x, i, w, E, layer_idx=l),
    "prefill_capacity": lambda ex, x, i, w, E, l, cap, valid: moe_experts_capacity_gmm_exact(
        ex, x, i, w, E, cap, token_valid=valid, layer_idx=l),
}


def moe_block_apply(params, cfg, x, image_mask=None, audio_mask=None, *, experts_stacked, layer_idx,
                    token_valid=None):
    """Sparse MoE block with multi-gate routing + shared experts.

    x (B, T, h); image_mask/audio_mask: optional bool (B, T) selecting tokens
    routed by the modality gates. `experts_stacked` are the depth-stacked
    tables, indexed by `layer_idx` inside the kernels. token_valid: optional
    bool (B, T) of real (non-padding) tokens, read by the capacity-dense
    dispatch only (see `moe_experts_capacity_gmm_exact`); the padding rows'
    outputs are discarded downstream."""
    B, T, h = x.shape
    x_flat = x.reshape(-1, h)
    topk_idx, topk_w, _ = moe_route(params["gate"]["w"], x_flat, cfg.num_experts_per_tok, cfg.norm_topk_prob)
    for gate, sel in (("image_gate", image_mask), ("audio_gate", audio_mask)):
        if cfg.multi_gate and sel is not None:
            g_idx, g_w, _ = moe_route(params[gate]["w"], x_flat, cfg.num_experts_per_tok, cfg.norm_topk_prob)
            m = sel.reshape(-1, 1)
            topk_idx = torch.where(m, g_idx, topk_idx)
            topk_w = torch.where(m, g_w, topk_w)

    args = (experts_stacked, x_flat, topk_idx, topk_w.to(x.dtype), cfg.num_experts, layer_idx)
    if B * T <= MOE_DECODE_MAX_TOKENS:
        y = MOE_IMPLS["decode"](*args)
    elif cfg.moe_prefill_capacity_factor > 0 and B * T >= MOE_CAPACITY_MIN_TOKENS:
        cap = default_capacity(B * T, cfg.num_experts_per_tok, cfg.num_experts, factor=cfg.moe_prefill_capacity_factor)
        y = MOE_IMPLS["prefill_capacity"](*args, cap, None if token_valid is None else token_valid.reshape(-1))
    else:
        y = MOE_IMPLS["prefill"](*args)
    y = y.reshape(B, T, h)
    se = params["shared_experts"]
    return y + _expert_mlp(x, se["gate_proj"]["w"], se["up_proj"]["w"], se["down_proj"]["w"])


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_apply(params, cfg, x, cos, sin, k_cache, v_cache, length: int, attn_mask, use_flash: bool = False):
    """Fused-QKV GQA attention over the static cache.

    x (B, T, h); cos/sin (B, T, head_dim); k_cache/v_cache (B, Hkv, Smax, D)
    views of one layer, written IN PLACE at [length, length + T); attn_mask
    bool (B, Smax) of allowed positions. use_flash: the first-round prefill
    path, where the new keys are the whole context and the flash kernel runs
    over (q, k, v) directly. Returns (B, T, h)."""
    B, T, _ = x.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qkv = dense(x, params["query_key_value"]).reshape(B, T, Hq + 2 * Hkv, D)
    q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
    q, k = apply_rope(q, k, cos, sin)
    k_cache[:, :, length : length + T] = k.transpose(1, 2).to(k_cache.dtype)
    v_cache[:, :, length : length + T] = v.transpose(1, 2).to(v_cache.dtype)

    Smax = k_cache.shape[2]
    k_pos = torch.arange(Smax, device=x.device)
    if use_flash:
        out = flash_prefill_attention(q, k, v, attn_mask[:, length : length + T], scale=D**-0.5)
    elif T == 1:
        out = decode_attention(q, k_cache, v_cache, attn_mask & (k_pos <= length)[None, :], scale=D**-0.5)
    else:
        causal = k_pos[None, :] <= (length + torch.arange(T, device=x.device))[:, None]  # (T, Smax)
        allowed = causal[None] & attn_mask[:, None, :]  # (B, T, Smax)
        out = mha(q, k_cache, v_cache, mask=allowed[:, None], scale=D**-0.5, kv_head_major=True)
    return dense(out.reshape(B, T, Hq * D), params["dense"])


# ---------------------------------------------------------------------------
# Decoder layer + model
# ---------------------------------------------------------------------------


def decoder_layer_apply(layer_params, cfg, x, cos, sin, k_cache, v_cache, length, attn_mask, image_mask=None,
                        audio_mask=None, *, use_flash: bool = False, experts_stacked, layer_idx, token_valid=None):
    h = rms_norm(x, layer_params["input_layernorm"]["w"], eps=cfg.rms_norm_eps)
    x = x + attention_apply(layer_params["attention"], cfg, h, cos, sin, k_cache, v_cache, length, attn_mask,
                            use_flash=use_flash)
    h = rms_norm(x, layer_params["post_attention_layernorm"]["w"], eps=cfg.rms_norm_eps)
    return x + moe_block_apply(layer_params["mlp"], cfg, h, image_mask, audio_mask,
                               experts_stacked=experts_stacked, layer_idx=layer_idx, token_valid=token_valid)


def bailing_forward(params, cfg, inputs_embeds, cache: LLMCache, attn_mask, positions=None, image_mask=None,
                    audio_mask=None, use_flash: bool = False):
    """Run T tokens through the decoder stack, writing their K/V into the
    cache IN PLACE. inputs_embeds (B, T, h); attn_mask bool (B, Smax) over the
    whole cache; positions (B, T), or (3, B, T) MRoPE planes (default
    cache.length + arange(T)). Returns (hidden_states (B, T, h), cache
    advanced by T)."""
    B, T, _ = inputs_embeds.shape
    if positions is None:
        positions = (cache.length + torch.arange(T, device=inputs_embeds.device))[None].expand(B, T)
    if positions.ndim == 2:
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    else:
        cos, sin = mrope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    attn_mask = attn_mask.bool()
    # the valid (non-padding) flags of the T new tokens: attn_mask is True exactly at the valid
    # positions of [cache.length, cache.length + T) (the prefill contract); a decode step's token is valid
    token_valid = attn_mask[:, cache.length : cache.length + T] if T > 1 else None
    # the expert tables stay stacked: the MoE kernels take a layer's view themselves
    layers = params["layers"]
    experts = layers["mlp"]["experts"]
    per_layer = {**layers, "mlp": {k: v for k, v in layers["mlp"].items() if k != "experts"}}
    x = inputs_embeds
    for l in range(cfg.num_hidden_layers):
        x = decoder_layer_apply(layer_view(per_layer, l), cfg, x, cos, sin, cache.k[l], cache.v[l], cache.length,
                                attn_mask, image_mask, audio_mask, use_flash=use_flash, experts_stacked=experts,
                                layer_idx=l, token_valid=token_valid)
    x = rms_norm(x, params["norm"]["w"], eps=cfg.rms_norm_eps)
    return x, LLMCache(cache.k, cache.v, cache.length + T)


def compute_logits(params, cfg, hidden_states):
    """LM head with optional norm_head (column-L2-normalised weight); fp32 logits."""
    w = params["lm_head"]["w"]
    if cfg.norm_head:
        wf = dequant_weight(w, torch.float32)
        w = wf / (torch.linalg.vector_norm(wf, dim=1, keepdim=True) + 1e-7)
    return torch.matmul(hidden_states, dequant_weight(w, hidden_states.dtype)).float()


def embed_tokens(params, input_ids):
    """Embedding rows; an int8 table gives fp32 rows (int8 rows times its
    row-invariant (1, h) scale), which the caller casts."""
    w = params["word_embeddings"]["w"]
    if isinstance(w, QuantizedArray):
        return w.q[input_ids].float() * w.s[0]
    return w[input_ids]
