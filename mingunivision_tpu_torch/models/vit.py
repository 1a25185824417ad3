"""ViT substrate: transformer blocks with optional static KV cache
(counterpart of mingunivision_tpu/models/vit.py, the parts the decoders use).

Block params are depth-stacked (depth, ...) as in the JAX package; the stack is
a Python loop over zero-copy layer views.
"""

from __future__ import annotations

import dataclasses

import torch

from mingunivision_tpu_torch.ops.activations import gelu_exact, swiglu
from mingunivision_tpu_torch.ops.attention import cached_decode_attention, mha
from mingunivision_tpu_torch.ops.linear import dense
from mingunivision_tpu_torch.ops.norms import layer_norm
from mingunivision_tpu_torch.utils.pytree import layer_view


@dataclasses.dataclass
class ViTCache:
    """Static KV cache of the causal semantic decoder: k/v
    (depth, B, heads, max_len, head_dim) head-major, plus the number of
    positions written (a host int). Cached steps write k/v IN PLACE."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def create(cls, depth, batch, max_len, num_heads, head_dim, dtype=torch.bfloat16, device=None) -> "ViTCache":
        shape = (depth, batch, num_heads, max_len, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device), 0)


def ffn_apply(params, x, ffn_layer: str):
    if ffn_layer in ("swiglufused", "swiglu"):
        return dense(swiglu(dense(x, params["w12"])), params["w3"])
    return dense(gelu_exact(dense(x, params["fc1"])), params["fc2"])


def _qkv(params, x, num_heads: int):
    B, N, C = x.shape
    qkv = dense(x, params["attn"]["qkv"]).reshape(B, N, 3, num_heads, C // num_heads)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def block_apply(params, x, *, num_heads: int, ffn_layer: str, ln_eps: float = 1e-6):
    """One full-sequence, non-causal pre-norm transformer block (no cache)."""
    h = layer_norm(x, params["norm1"]["w"], params["norm1"]["b"], eps=ln_eps)
    q, k, v = _qkv(params, h, num_heads)
    x = x + dense(mha(q, k, v).reshape(x.shape), params["attn"]["proj"])
    h = layer_norm(x, params["norm2"]["w"], params["norm2"]["b"], eps=ln_eps)
    return x + ffn_apply(params["mlp"], h, ffn_layer)


def run_blocks(stacked_params, x, *, depth: int, num_heads: int, ffn_layer: str, ln_eps: float = 1e-6):
    for d in range(depth):
        x = block_apply(layer_view(stacked_params, d), x, num_heads=num_heads, ffn_layer=ffn_layer, ln_eps=ln_eps)
    return x


def block_apply_cached(params, x, k_cache, v_cache, length: int, *, num_heads: int, ffn_layer: str,
                       ln_eps: float = 1e-6):
    """Causal block over a static cache; writes T new positions at `length`
    IN PLACE. k_cache/v_cache (B, H, max_len, D) of this block."""
    B, T, C = x.shape
    h = layer_norm(x, params["norm1"]["w"], params["norm1"]["b"], eps=ln_eps)
    q, k, v = _qkv(params, h, num_heads)
    k_cache[:, :, length : length + T] = k.transpose(1, 2).to(k_cache.dtype)
    v_cache[:, :, length : length + T] = v.transpose(1, 2).to(v_cache.dtype)
    if T == 1:
        a = cached_decode_attention(q, k_cache, v_cache, length + 1)
    else:
        Smax = k_cache.shape[2]
        mask = torch.arange(Smax, device=x.device)[None, :] <= (length + torch.arange(T, device=x.device))[:, None]
        a = mha(q, k_cache, v_cache, mask=mask[None, None], kv_head_major=True)
    x = x + dense(a.reshape(B, T, C), params["attn"]["proj"])
    h = layer_norm(x, params["norm2"]["w"], params["norm2"]["b"], eps=ln_eps)
    return x + ffn_apply(params["mlp"], h, ffn_layer)


def run_blocks_cached(stacked_params, x, cache: ViTCache, *, num_heads: int, ffn_layer: str, ln_eps: float = 1e-6):
    """The causal blocks over the stacked cache; returns (y, cache advanced by T)."""
    for d in range(cache.k.shape[0]):
        x = block_apply_cached(layer_view(stacked_params, d), x, cache.k[d], cache.v[d], cache.length,
                               num_heads=num_heads, ffn_layer=ffn_layer, ln_eps=ln_eps)
    return x, ViTCache(cache.k, cache.v, cache.length + x.shape[1])
