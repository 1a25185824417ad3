"""ViT substrate: patch embedding and (causal) transformer blocks with optional
static KV cache (counterpart of mingunivision_tpu/models/vit.py).

Block params are depth-stacked (depth, ...) as in the JAX package; the stack is
a Python loop over zero-copy layer views. A non-causal full-sequence block
whose length and type pass `flash_vit_usable` runs the flash-attention kernel
head-major (ops/kernels/flash.py).
"""

from __future__ import annotations

import dataclasses

import torch

from mingunivision_tpu_torch.ops.activations import gelu_exact, swiglu
from mingunivision_tpu_torch.ops.attention import cached_decode_attention, mha
from mingunivision_tpu_torch.ops.kernels.flash import flash_vit_attention, flash_vit_usable
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


def extract_patches(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, h*w, C*p*p) in conv-weight order (c, p, q): the
    im2col of a Conv2d(kernel = stride = p)."""
    B, C, H, W = imgs.shape
    p = patch_size
    h, w = H // p, W // p
    x = imgs.reshape(B, C, h, p, w, p).permute(0, 2, 4, 1, 3, 5)  # B h w c p q
    return x.reshape(B, h * w, C * p * p)


def patch_embed_apply(params, imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Patch embedding as one matmul over the flattened patches (not a
    convolution, so fp32 stays true fp32 on the card)."""
    return dense(extract_patches(imgs, patch_size), params)


def ffn_apply(params, x, ffn_layer: str):
    if ffn_layer in ("swiglufused", "swiglu"):
        return dense(swiglu(dense(x, params["w12"])), params["w3"])
    return dense(gelu_exact(dense(x, params["fc1"])), params["fc2"])


def _qkv(params, x, num_heads: int):
    B, N, C = x.shape
    qkv = dense(x, params["attn"]["qkv"]).reshape(B, N, 3, num_heads, C // num_heads)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attn_flash_headmajor(params, h, num_heads: int):
    """qkv -> flash kernel -> out-proj with no token/head transpose pass: the
    projections go straight to and from the kernel's (B, H, N, D) layout,
    the biases added in fp32."""
    B, N, C = h.shape
    H = num_heads
    D = C // H
    ap = params["attn"]
    wq = ap["qkv"]["w"].to(h.dtype).reshape(C, 3, H, D)
    qkv = torch.einsum("bnc,cshd->sbhnd", h, wq)
    if "b" in ap["qkv"]:
        qkv = (qkv.float() + ap["qkv"]["b"].float().reshape(3, 1, H, 1, D)).to(h.dtype)
    out = flash_vit_attention(qkv[0], qkv[1], qkv[2], scale=D**-0.5)  # (B, H, N, D)
    y = torch.einsum("bhnd,hdc->bnc", out, ap["proj"]["w"].to(h.dtype).reshape(H, D, C))
    if "b" in ap["proj"]:
        y = (y.float() + ap["proj"]["b"].float()).to(h.dtype)
    return y


def block_apply(params, x, *, num_heads: int, ffn_layer: str, is_causal: bool = False, ln_eps: float = 1e-6):
    """One full-sequence pre-norm transformer block (no cache)."""
    h = layer_norm(x, params["norm1"]["w"], params["norm1"]["b"], eps=ln_eps)
    if not is_causal and flash_vit_usable(x.shape[1], x.dtype):
        a = _attn_flash_headmajor(params, h, num_heads)
    else:
        q, k, v = _qkv(params, h, num_heads)
        N = x.shape[1]
        mask = torch.ones((N, N), dtype=torch.bool, device=x.device).tril() if is_causal else None
        a = dense(mha(q, k, v, mask=mask).reshape(x.shape), params["attn"]["proj"])
    x = x + a
    h = layer_norm(x, params["norm2"]["w"], params["norm2"]["b"], eps=ln_eps)
    return x + ffn_apply(params["mlp"], h, ffn_layer)


def run_blocks(stacked_params, x, *, depth: int, num_heads: int, ffn_layer: str, is_causal: bool = False,
               ln_eps: float = 1e-6):
    for d in range(depth):
        x = block_apply(layer_view(stacked_params, d), x, num_heads=num_heads, ffn_layer=ffn_layer,
                        is_causal=is_causal, ln_eps=ln_eps)
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
