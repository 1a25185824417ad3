"""Bailing-MoE decoder-only LLM (16B total / ~3B active) in PyTorch.

Counterpart of mingunivision_tpu/models/bailing_moe.py with the same parameter
tree: depth-stacked layer leaves (L, ...), `(in, out)` linear weights, expert
tables (L, E, h, m) / (L, E, m, h), and a head-major KV cache
(L, B, Hkv, Smax, D). The layer loop is a Python loop; each layer reads
zero-copy views of the stacked leaves, and the MoE kernels read the layer's
expert tables as views of the stacked tables (in training, a float tree's
leaves are split by one unbind each, the expert tables too).

Dispatch: decode-shape MoE (B*T <= MOE_DECODE_MAX_TOKENS) goes to the
decode-MoE kernel, larger token counts to the grouped-SwiGLU prefill kernel
(each wrapper picks its bf16, int4 or int8 kernel from the table kind; the
dot modes over quantized tables come from the caller down through
`bailing_forward`: `int_dots` for the decode MoE, s8 integer dots by default
and exact dequant with False; `prefill_int_dots` for the prefill MoE, exact
dequant by default and s8 dots with True), through the
capacity-dense dispatch from MOE_CAPACITY_MIN_TOKENS rows up and the
expert-sorted one below; NF4 tables take plain-dequant MoE entries on every
device, never the capacity dispatch (the JAX package has no kernel for them
and runs them through XLA's gather and dense dispatch); one-token attention
goes to the decode-attention kernel and a first-round prefill that passes
`flash_usable` to the flash-attention kernel; CPU tensors take the kernels'
plain versions.
Quantized dense weights (attention, shared experts, router, lm_head) are
dequantized before their product, and an int8 embedding is gathered as int8
rows and scaled in fp32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from mingunivision_tpu_torch.ops.attention import mha
from mingunivision_tpu_torch.ops.kernels.decode_attention import decode_attention
from mingunivision_tpu_torch.ops.kernels.flash import flash_prefill_attention
from mingunivision_tpu_torch.ops.kernels.moe_capacity import default_capacity, moe_experts_capacity_gmm_exact
from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream, table_kind
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm, moe_experts_swiglu_gmm_ad
from mingunivision_tpu_torch.ops.linear import dense
from mingunivision_tpu_torch.ops.norms import rms_norm
from mingunivision_tpu_torch.ops.rope import apply_rope, mrope_cos_sin, rope_cos_sin
from mingunivision_tpu_torch.utils.pytree import is_float_tree, layer_view, layer_views, leaves
from mingunivision_tpu_torch.utils.quantize import QuantizedArray, dequant_weight, is_nf4

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
# topk_w, num_experts, layer_idx), then the decode one the decode dot mode
# (int_dots), the prefill ones the prefill dot mode (prefill_int_dots), the
# capacity one after it (capacity, token_valid); "prefill_ad" is training's
# differentiable prefill MoE over floating tables
MOE_IMPLS = {
    "decode": lambda ex, x, i, w, E, l, int_dots: moe_experts_stream(ex, x, i, w, layer_idx=l, int_dots=int_dots),
    "prefill": lambda ex, x, i, w, E, l, s8: moe_experts_swiglu_gmm(ex, x, i, w, E, layer_idx=l, s8=s8),
    "prefill_ad": lambda ex, x, i, w, E, l: moe_experts_swiglu_gmm_ad(ex, x, i, w, E, layer_idx=l),
    "prefill_capacity": lambda ex, x, i, w, E, l, s8, cap, valid: moe_experts_capacity_gmm_exact(
        ex, x, i, w, E, cap, token_valid=valid, layer_idx=l, s8=s8),
}


def moe_block_apply(params, cfg, x, image_mask=None, audio_mask=None, *, experts_stacked, layer_idx,
                    token_valid=None, int_dots: bool = True, prefill_int_dots: bool = False,
                    return_router_stats: bool = False):
    """Sparse MoE block with multi-gate routing + shared experts.

    x (B, T, h); image_mask/audio_mask: optional bool (B, T) selecting tokens
    routed by the modality gates. `experts_stacked` are the depth-stacked
    tables, indexed by `layer_idx` inside the kernels, or one layer's (E, ...)
    tables with `layer_idx` None (the train forward). token_valid: optional
    bool (B, T) of real (non-padding) tokens, read by the capacity-dense
    dispatch only (see `moe_experts_capacity_gmm_exact`); the padding rows'
    outputs are discarded downstream. int_dots: the decode MoE's dot mode over
    quantized tables (s8 integer dots, or exact dequant when False);
    prefill_int_dots: the prefill MoE's (exact dequant, or s8 dots when True).
    NF4 tables never take the capacity dispatch (their prefill is plain rows).
    With cfg.moe_differentiable, floating tables take the differentiable
    prefill MoE ("prefill_ad") at every token count above
    MOE_DECODE_MAX_TOKENS, never the capacity dispatch; at or below it the
    decode MoE kernel has no gradient and a CUDA input raises.
    return_router_stats: also return (router logits (N, E) fp32 after the
    multi-gate selection, topk_idx (N, k)) for the training aux losses."""
    B, T, h = x.shape
    x_flat = x.reshape(-1, h)
    topk_idx, topk_w, logits = moe_route(params["gate"]["w"], x_flat, cfg.num_experts_per_tok, cfg.norm_topk_prob)
    for gate, sel in (("image_gate", image_mask), ("audio_gate", audio_mask)):
        if cfg.multi_gate and sel is not None:
            g_idx, g_w, g_logits = moe_route(params[gate]["w"], x_flat, cfg.num_experts_per_tok, cfg.norm_topk_prob)
            m = sel.reshape(-1, 1)
            topk_idx = torch.where(m, g_idx, topk_idx)
            topk_w = torch.where(m, g_w, topk_w)
            logits = torch.where(m, g_logits, logits)

    args = (experts_stacked, x_flat, topk_idx, topk_w.to(x.dtype), cfg.num_experts, layer_idx)
    differentiable = cfg.moe_differentiable and table_kind("moe_block_apply", experts_stacked) == "plain"
    if B * T <= MOE_DECODE_MAX_TOKENS:
        if differentiable and x.device.type != "cpu":
            raise ValueError(f"moe_block_apply: {B * T} tokens take the decode MoE kernel, which has no gradient; "
                             f"a differentiable forward needs more than {MOE_DECODE_MAX_TOKENS}")
        y = MOE_IMPLS["decode"](*args, int_dots)
    elif differentiable:
        y = MOE_IMPLS["prefill_ad"](*args)
    elif (cfg.moe_prefill_capacity_factor > 0 and B * T >= MOE_CAPACITY_MIN_TOKENS
          and not is_nf4(experts_stacked["gate_proj"])):
        cap = default_capacity(B * T, cfg.num_experts_per_tok, cfg.num_experts, factor=cfg.moe_prefill_capacity_factor)
        y = MOE_IMPLS["prefill_capacity"](*args, prefill_int_dots, cap,
                                          None if token_valid is None else token_valid.reshape(-1))
    else:
        y = MOE_IMPLS["prefill"](*args, prefill_int_dots)
    y = y.reshape(B, T, h)
    se = params["shared_experts"]
    y = y + _expert_mlp(x, se["gate_proj"]["w"], se["up_proj"]["w"], se["down_proj"]["w"])
    return (y, (logits, topk_idx)) if return_router_stats else y


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_apply(params, cfg, x, cos, sin, k_cache, v_cache, length: int, attn_mask, use_flash: bool = False,
                    kv_dtype=None):
    """Fused-QKV GQA attention over the static cache.

    x (B, T, h); cos/sin (B, T, head_dim); k_cache/v_cache (B, Hkv, Smax, D)
    views of one layer, written IN PLACE at [length, length + T); attn_mask
    bool (B, Smax) of allowed positions. use_flash: the first-round prefill
    path, where the new keys are the whole context and the flash kernel runs
    over (q, k, v) directly. k_cache None: a training forward, where the T new
    tokens are the whole context (length 0, Smax = T): nothing is written (an
    in-place write into a stacked cache would bump the version of views saved
    for the backward), and attention runs over k and v rounded to `kv_dtype`,
    as a cache of that dtype would hold them. Returns (B, T, h)."""
    B, T, _ = x.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qkv = dense(x, params["query_key_value"]).reshape(B, T, Hq + 2 * Hkv, D)
    q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
    q, k = apply_rope(q, k, cos, sin)
    if k_cache is None:
        pos = torch.arange(T, device=x.device)
        allowed = (pos[None, :] <= pos[:, None])[None] & attn_mask[:, None, :]  # (B, T, T)
        out = mha(q, k.to(kv_dtype), v.to(kv_dtype), mask=allowed[:, None], scale=D**-0.5)
        return dense(out.reshape(B, T, Hq * D), params["dense"])
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
                        audio_mask=None, *, use_flash: bool = False, experts_stacked, layer_idx, token_valid=None,
                        int_dots: bool = True, prefill_int_dots: bool = False, return_router_stats: bool = False,
                        kv_dtype=None):
    h = rms_norm(x, layer_params["input_layernorm"]["w"], eps=cfg.rms_norm_eps)
    x = x + attention_apply(layer_params["attention"], cfg, h, cos, sin, k_cache, v_cache, length, attn_mask,
                            use_flash=use_flash, kv_dtype=kv_dtype)
    h = rms_norm(x, layer_params["post_attention_layernorm"]["w"], eps=cfg.rms_norm_eps)
    out = moe_block_apply(layer_params["mlp"], cfg, h, image_mask, audio_mask, experts_stacked=experts_stacked,
                          layer_idx=layer_idx, token_valid=token_valid, int_dots=int_dots,
                          prefill_int_dots=prefill_int_dots, return_router_stats=return_router_stats)
    if return_router_stats:
        return x + out[0], out[1]
    return x + out


def bailing_forward(params, cfg, inputs_embeds, cache: LLMCache | None, attn_mask, positions=None, image_mask=None,
                    audio_mask=None, use_flash: bool = False, int_dots: bool = True, prefill_int_dots: bool = False,
                    return_router_stats: bool = False, kv_dtype=torch.bfloat16):
    """Run T tokens through the decoder stack, writing their K/V into the
    cache IN PLACE. inputs_embeds (B, T, h); attn_mask bool (B, Smax) over the
    whole cache; positions (B, T), or (3, B, T) MRoPE planes (default
    cache.length + arange(T)). int_dots / prefill_int_dots: the decode and
    prefill MoE's dot modes over quantized tables (`moe_block_apply`). Returns
    (hidden_states (B, T, h), cache advanced by T).

    cache None: the training forward, the JAX package's at an empty cache of
    Smax = T and dtype `kv_dtype` (attn_mask (B, T)); nothing is written and
    the cache returned is None. return_router_stats: also return (logits
    (L, N, E) fp32, topk_idx (L, N, k)), stacked over the layers, for the
    training aux losses. cfg.remat_layers: each layer's activations are
    recomputed in the backward (torch.utils.checkpoint) when grad is enabled.
    Under grad, when a leaf of a float tree wants a grad (training), the
    layers are read through `layer_views`, so each stacked leaf's gradient is
    one stack of its layers' gradients."""
    B, T, _ = inputs_embeds.shape
    length = 0 if cache is None else cache.length
    if positions is None:
        positions = (length + torch.arange(T, device=inputs_embeds.device))[None].expand(B, T)
    if positions.ndim == 2:
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    else:
        cos, sin = mrope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    attn_mask = attn_mask.bool()
    # the valid (non-padding) flags of the T new tokens: attn_mask is True exactly at the valid
    # positions of [cache.length, cache.length + T) (the prefill contract); a decode step's token is valid
    token_valid = attn_mask[:, length : length + T] if T > 1 else None
    layers = params["layers"]
    L = cfg.num_hidden_layers
    if torch.is_grad_enabled() and is_float_tree(layers) and any(t.requires_grad for t in leaves(layers)):
        # training: every leaf, the expert tables too, is split by one unbind (its backward one stack per leaf;
        # indexing the leaf once per layer would give it one full-size zero gradient per layer) and the MoE
        # entries take the layer's own (E, ...) tables; the views are taken outside the checkpointed layer
        views = layer_views(layers, L)
        per_layer = [{**v, "mlp": {k: t for k, t in v["mlp"].items() if k != "experts"}} for v in views]
        experts, layer_idx = [v["mlp"]["experts"] for v in views], [None] * L
    else:
        # inference (no leaf that wants a grad), and quantized trees: zero-copy views of each layer, the expert
        # tables stay stacked (the MoE kernels take a layer's view themselves)
        stacked = {**layers, "mlp": {k: v for k, v in layers["mlp"].items() if k != "experts"}}
        per_layer = [layer_view(stacked, l) for l in range(L)]
        experts, layer_idx = [layers["mlp"]["experts"]] * L, list(range(L))
    remat = cfg.remat_layers and torch.is_grad_enabled()
    x, stats = inputs_embeds, []
    for l in range(L):
        kc, vc = (None, None) if cache is None else (cache.k[l], cache.v[l])

        def layer(x, l=l, kc=kc, vc=vc):
            return decoder_layer_apply(per_layer[l], cfg, x, cos, sin, kc, vc, length, attn_mask, image_mask,
                                       audio_mask, use_flash=use_flash, experts_stacked=experts[l],
                                       layer_idx=layer_idx[l], token_valid=token_valid, int_dots=int_dots,
                                       prefill_int_dots=prefill_int_dots, return_router_stats=return_router_stats,
                                       kv_dtype=kv_dtype)

        out = torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        if return_router_stats:
            x, layer_stats = out
            stats.append(layer_stats)
        else:
            x = out
    x = rms_norm(x, params["norm"]["w"], eps=cfg.rms_norm_eps)
    new_cache = None if cache is None else LLMCache(cache.k, cache.v, cache.length + T)
    if return_router_stats:
        return x, new_cache, (torch.stack([s[0] for s in stats]), torch.stack([s[1] for s in stats]))
    return x, new_cache


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


# ---------------------------------------------------------------------------
# Router auxiliary losses (training)
# ---------------------------------------------------------------------------


def router_balance_loss(router_probs, topk_idx, num_experts: int):
    """Switch-style load-balancing loss: E * sum_e(fraction of tokens routed to
    e * mean router probability of e). router_probs (N, E) fp32; topk_idx (N, k)."""
    N = router_probs.shape[0]
    counts = torch.zeros((N, num_experts), dtype=torch.float32, device=router_probs.device)
    counts.scatter_(1, topk_idx.long(), 1.0)
    return num_experts * (counts.mean(dim=0) * router_probs.mean(dim=0)).sum()


def router_z_loss(router_logits):
    """Mean squared log-sum-exp of the router logits (keeps them small)."""
    return torch.logsumexp(router_logits.float(), dim=-1).square().mean()


def router_group_balance_loss(router_probs, topk_idx, num_experts: int, num_groups: int):
    """Balance of routed-token mass across `num_groups` contiguous expert
    groups, per sample: the means run over the sequence axis of each leading
    batch entry, then the per-sample losses average. router_probs (..., S, E);
    topk_idx (..., S, k); a flat (N, E) input is one sample."""
    if num_experts % num_groups:
        raise ValueError(f"{num_experts} experts do not split into {num_groups} groups")
    per_group = num_experts // num_groups
    expert_mask = F.one_hot(topk_idx.long(), num_experts).float().amax(dim=-2)  # routed or not, per (token, expert)
    mask_g = expert_mask.reshape(*expert_mask.shape[:-1], num_groups, per_group).sum(-1)
    tokens_per_group = mask_g.mean(dim=-2) / num_groups
    probs = router_probs.float()
    prob_per_group = probs.reshape(*probs.shape[:-1], num_groups, per_group).sum(-1).mean(dim=-2)
    return (tokens_per_group * prob_per_group * num_groups).sum(-1).mean()
