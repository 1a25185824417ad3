"""ViT substrate: patch embedding and (causal) transformer blocks with optional
static KV cache (counterpart of mingunivision_tpu/models/vit.py).

Block params are depth-stacked (depth, ...) as in the JAX package; the stack is
a Python loop over zero-copy layer views (for the full-sequence stack one
`unbind` per leaf: under autograd its backward is one stack, where an index
per layer would make autograd fill and add a zero gradient the size of the
whole stack per layer). A non-causal
full-sequence block whose length and type pass `flash_vit_usable` runs the
flash-attention kernel head-major (ops/kernels/flash.py). `run_blocks(remat=True)`
recomputes each block in the backward (torch.utils.checkpoint), the
counterpart of the JAX package's `jax.checkpoint` over the scanned block.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from mingunivision_tpu_torch.ops.activations import gelu_exact, swiglu
from mingunivision_tpu_torch.ops.attention import cached_decode_attention, mha
from mingunivision_tpu_torch.ops.kernels.flash import flash_vit_attention, flash_vit_usable
from mingunivision_tpu_torch.ops.linear import current_fp32_precision, dense, fp32_matmul_precision
from mingunivision_tpu_torch.ops.norms import layer_norm
from mingunivision_tpu_torch.utils.pytree import layer_view, layer_views


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


def _mm_f32(a, b):
    """a @ b of two bf16 matrices as the fp32 sums of their exact products
    (JAX's `preferred_element_type=float32`): one bf16 GEMM with an fp32
    result on the card, an fp32 product of the upcast operands on the CPU."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LinearRoundOnce(torch.autograd.Function):
    """x (M, K) @ w (K, N) + b in fp32, rounded ONCE to x's dtype (bf16). Its
    backward is the JAX transpose of that: the cotangent arrives in bf16 (the
    output's type), dx = g w^T and dw = x^T g with fp32 sums rounded once to
    their operands' type, db = the fp32 column sums of g."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = None if b is None else b.dtype
        y = _mm_f32(x, w)
        if b is not None:
            y = y + b.float()
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = _mm_f32(g, w.t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = _mm_f32(x.t(), g).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = g.float().sum(0).to(ctx.b_dtype) if ctx.b_dtype is not None and ctx.needs_input_grad[2] else None
        return dx, dw, db


def _linear_round_once(x, w, b):
    """(..., K) @ (K, N) + b with fp32 sums and one rounding to x's dtype (a
    plain fp32 product when x is fp32)."""
    if x.dtype == torch.float32:
        y = x @ w.float()
        return y if b is None else y + b.float()
    shape = x.shape[:-1]
    y = _LinearRoundOnce.apply(x.reshape(-1, x.shape[-1]), w.to(x.dtype), b)
    return y.reshape(*shape, w.shape[1])


def _attn_flash_headmajor(params, h, num_heads: int):
    """qkv -> flash kernel -> out-proj, the kernel's (B, H, N, D) layout taken
    and given back by one permute each. Each projection sums in fp32, adds its
    bias in fp32 and rounds once to h's type, as the JAX package's einsums
    with `preferred_element_type=float32` do."""
    B, N, C = h.shape
    H = num_heads
    D = C // H
    ap = params["attn"]
    qkv = _linear_round_once(h, ap["qkv"]["w"], ap["qkv"].get("b"))  # (B, N, 3C)
    qkv = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)  # (3, B, H, N, D)
    out = flash_vit_attention(qkv[0], qkv[1], qkv[2], scale=D**-0.5)  # (B, H, N, D)
    return _linear_round_once(out.transpose(1, 2).reshape(B, N, C), ap["proj"]["w"], ap["proj"].get("b"))


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
               ln_eps: float = 1e-6, remat: bool = False):
    """The stacked blocks in turn. remat=True (under grad) recomputes each
    block in the backward. The fp32 tier in force at the forward is captured
    and entered again around each block, so a recompute in the backward (run
    outside the caller's `fp32_matmul_precision` block) takes the same path
    and the same TF32 mode as the forward."""
    tier = current_fp32_precision()
    kw = dict(num_heads=num_heads, ffn_layer=ffn_layer, is_causal=is_causal, ln_eps=ln_eps)
    for p in layer_views(stacked_params, depth):
        if remat and torch.is_grad_enabled():
            def block(x, p=p):
                with fp32_matmul_precision(tier):
                    return block_apply(p, x, **kw)

            x = torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
        else:
            x = block_apply(p, x, **kw)
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


def block_apply_cached_rows(params, x, k_cache, v_cache, write_pos, *, num_heads: int, ffn_layer: str,
                            ln_eps: float = 1e-6):
    """`block_apply_cached` for one token with PER-ROW write positions (the
    slots of a continuous-batching pool sit at different offsets): row b
    writes its K/V at write_pos[b] IN PLACE and attends to positions
    [0, write_pos[b]]. x (B, 1, C); k_cache/v_cache (B, H, max_len, D) of this
    block; write_pos (B,) int64."""
    B, T, C = x.shape
    if T != 1:
        raise ValueError(f"block_apply_cached_rows is a one-token step, got T={T}")
    h = layer_norm(x, params["norm1"]["w"], params["norm1"]["b"], eps=ln_eps)
    q, k, v = _qkv(params, h, num_heads)  # (B, 1, H, D)
    rows = torch.arange(B, device=x.device)
    k_cache[rows, :, write_pos] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, :, write_pos] = v[:, 0].to(v_cache.dtype)
    valid = torch.arange(k_cache.shape[2], device=x.device)[None, :] <= write_pos[:, None]  # (B, max_len)
    a = mha(q, k_cache, v_cache, mask=valid[:, None, None, :], kv_head_major=True)
    x = x + dense(a.reshape(B, T, C), params["attn"]["proj"])
    h = layer_norm(x, params["norm2"]["w"], params["norm2"]["b"], eps=ln_eps)
    return x + ffn_apply(params["mlp"], h, ffn_layer)


def run_blocks_cached_rows(stacked_params, x, k, v, write_pos, *, num_heads: int, ffn_layer: str,
                           ln_eps: float = 1e-6):
    """The causal blocks for one token per row at per-row write positions
    (pool decode). k/v (depth, B, H, max_len, D) written IN PLACE; write_pos
    (B,). The caller keeps each row's length (a host int cannot hold rows at
    different offsets). Returns y (B, 1, C)."""
    for d in range(k.shape[0]):
        x = block_apply_cached_rows(layer_view(stacked_params, d), x, k[d], v[d], write_pos, num_heads=num_heads,
                                    ffn_layer=ffn_layer, ln_eps=ln_eps)
    return x


def run_blocks_cached(stacked_params, x, cache: ViTCache, *, num_heads: int, ffn_layer: str, ln_eps: float = 1e-6):
    """The causal blocks over the stacked cache; returns (y, cache advanced by T)."""
    for d in range(cache.k.shape[0]):
        x = block_apply_cached(layer_view(stacked_params, d), x, cache.k[d], cache.v[d], cache.length,
                               num_heads=num_heads, ffn_layer=ffn_layer, ln_eps=ln_eps)
    return x, ViTCache(cache.k, cache.v, cache.length + x.shape[1])
