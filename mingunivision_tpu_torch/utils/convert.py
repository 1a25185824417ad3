"""Parameter bridge, on-device random initialisation and the weight tiers.

`params_from_jax` is the one place where layout is decided (and
`adamw_state_from_jax` carries an optax AdamW state across with it), and it
decides to keep the JAX package's: `(in, out)` linear weights, depth-stacked (L, ...)
layer leaves, expert tables (L, E, h, m) / (L, E, m, h), and quantized leaves
in the JAX package's byte formats (`utils/quantize.py`). A tree converted here
runs through the port and through the JAX package on the same numbers.

The `init_*` functions build the same trees with random weights directly on a
device from a `torch.Generator`, with the JAX package's init
(mingunivision_tpu/utils/init.py): linear weights truncated-normal at std 0.02
(cut at 2 std), expert tables, routers and embeddings normal at std 0.02,
norms ones/zeros, AdaLN-zero for the RF head's modulations and final layer.
"""

from __future__ import annotations

import numpy as np
import torch

from mingunivision_tpu_torch.ops.activations import swiglu_hidden_dim
from mingunivision_tpu_torch.utils.quantize import _QUANT_MIN_SIZE, QuantizedArray, quantize_tree_inplace

STD = 0.02


def params_from_jax(tree, device="cuda", dtype=None):
    """JAX param tree (numpy or jax array leaves, and the JAX package's
    QuantizedArray; dicts, lists) -> the same tree of torch tensors on
    `device`; floating leaves cast to `dtype` when given. A quantized leaf
    keeps its bytes (`q` uint8/int8), fp32 scales and `bits`/`groups`/`scheme`."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    if type(tree).__name__ == "QuantizedArray":
        return QuantizedArray(params_from_jax(tree.q, device), params_from_jax(tree.s, device), tree.bits,
                              getattr(tree, "groups", 1), getattr(tree, "scheme", "linear"))
    arr = np.asarray(tree)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":  # ml_dtypes bf16 has no torch counterpart in numpy
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        arr = np.ascontiguousarray(arr)
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _same_path_leaves(tree, other):
    """(leaf of `tree`, the leaf at the same key path of `other`) in `tree`'s order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _same_path_leaves(v, other[k])
    elif isinstance(tree, (list, tuple)):
        for v, o in zip(tree, other):
            yield from _same_path_leaves(v, o)
    else:
        yield tree, other


def _adam_state(opt_state):
    """The optax ScaleByAdamState (count, mu, nu) inside an optax chain's state."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (list, tuple)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def adamw_state_from_jax(opt_state, adamw):
    """Carry an optax AdamW state (`optax.adamw`, alone or after
    `clip_by_global_norm` as `make_scheduled_optimizer` chains it) into the
    port's AdamW state `adamw` (engine/train.AdamWState, over the same param
    tree on the device the params lie on): each leaf's first and second
    moments, in the leaf's dtype, at its key path, and the update count, which
    the learning-rate schedule reads. The next step of the JAX TrainState and
    of the port's then compute the same update. Returns `adamw`."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in the optimizer state")
    count = int(np.asarray(adam.count))
    mu, nu = params_from_jax(adam.mu, "cpu"), params_from_jax(adam.nu, "cpu")
    for (p, m), (_, v) in zip(_same_path_leaves(adamw.params, mu), _same_path_leaves(adamw.params, nu)):
        adamw.opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": m.to(p.device, p.dtype),
                              "exp_avg_sq": v.to(p.device, p.dtype)}
    adamw.count = count
    return adamw


class _Init:
    """Random leaves on one device, drawn from one generator."""

    def __init__(self, device, dtype, generator: torch.Generator):
        self.device, self.dtype, self.gen = device, dtype, generator

    def normal(self, *shape):
        return torch.empty(shape, device=self.device, dtype=self.dtype).normal_(0.0, STD, generator=self.gen)

    def trunc(self, *shape):
        """Truncated normal, drawn in fp32 one leading slice at a time."""
        out = torch.empty(shape, device=self.device, dtype=self.dtype)
        flat = out.view(-1, shape[-1]) if len(shape) > 1 else out.view(1, -1)
        rows = max(1, (1 << 24) // flat.shape[1])
        for chunk in flat.split(rows):
            tmp = torch.empty(chunk.shape, device=self.device, dtype=torch.float32)
            torch.nn.init.trunc_normal_(tmp, 0.0, STD, -2 * STD, 2 * STD, generator=self.gen)
            chunk.copy_(tmp)
        return out

    def ones(self, *shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, *shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def linear(self, *lead, fan_in, fan_out, bias=True):
        p = {"w": self.trunc(*lead, fan_in, fan_out)}
        if bias:
            p["b"] = self.zeros(*lead, fan_out)
        return p

    def zeros_linear(self, *lead, fan_in, fan_out):
        return {"w": self.zeros(*lead, fan_in, fan_out), "b": self.zeros(*lead, fan_out)}

    def norm(self, *lead, dim):
        return {"w": self.ones(*lead, dim), "b": self.zeros(*lead, dim)}


def init_bailing_moe_params(cfg, init: _Init):
    L, h, m, E = cfg.num_hidden_layers, cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    shared_m = m * cfg.num_shared_experts
    mlp = {
        "gate": {"w": init.normal(L, h, E)},
        "experts": {
            "gate_proj": init.normal(L, E, h, m),
            "up_proj": init.normal(L, E, h, m),
            "down_proj": init.normal(L, E, m, h),
        },
        "shared_experts": {
            "gate_proj": init.linear(L, fan_in=h, fan_out=shared_m, bias=False),
            "up_proj": init.linear(L, fan_in=h, fan_out=shared_m, bias=False),
            "down_proj": init.linear(L, fan_in=shared_m, fan_out=h, bias=False),
        },
    }
    if cfg.multi_gate:
        mlp["image_gate"] = {"w": init.normal(L, h, E)}
        mlp["audio_gate"] = {"w": init.zeros(L, h, E)}
    layers = {
        "input_layernorm": {"w": init.ones(L, h)},
        "attention": {
            "query_key_value": init.linear(L, fan_in=h, fan_out=cfg.qkv_out_dim, bias=cfg.use_qkv_bias),
            "dense": init.linear(L, fan_in=cfg.num_attention_heads * cfg.head_dim, fan_out=h, bias=cfg.use_bias),
        },
        "post_attention_layernorm": {"w": init.ones(L, h)},
        "mlp": mlp,
    }
    return {
        "word_embeddings": {"w": init.normal(cfg.vocab_size, h)},
        "layers": layers,
        "norm": {"w": init.ones(h)},
        "lm_head": init.linear(fan_in=h, fan_out=cfg.vocab_size, bias=False),
    }


def init_rf_head_params(cfg, init: _Init):
    w, depth = cfg.width, cfg.depth
    hidden = swiglu_hidden_dim(w * cfg.mlp_mult)
    return {
        "time_embed": {
            "fc1": init.linear(fan_in=cfg.freq_embed_size, fan_out=w),
            "fc2": init.linear(fan_in=w, fan_out=w),
        },
        "cond_embed": init.linear(fan_in=cfg.z_channels, fan_out=w),
        "input_proj": init.linear(fan_in=cfg.target_channels, fan_out=w),
        "res_blocks": {
            "in_ln": init.norm(depth, dim=w),
            "mlp": {
                "w12": init.linear(depth, fan_in=w, fan_out=2 * hidden),
                "w3": init.linear(depth, fan_in=hidden, fan_out=w),
            },
            "adaLN": init.zeros_linear(depth, fan_in=w, fan_out=3 * w),
        },
        "final_layer": {
            "adaLN": init.zeros_linear(fan_in=w, fan_out=2 * w),
            "linear": init.zeros_linear(fan_in=w, fan_out=cfg.target_channels),
        },
    }


def init_vis_head_params(hidden_size: int, z_channels: int, init: _Init):
    return {"linear": init.linear(fan_in=hidden_size, fan_out=z_channels), "norm": init.norm(dim=z_channels)}


def init_linear_proj_params(in_dim: int, hidden: int, depth: int, init: _Init):
    return {"layers": [init.linear(fan_in=in_dim if d == 0 else hidden, fan_out=hidden) for d in range(depth)]}


def _blocks(depth, dim, mlp_ratio, ffn_layer, init: _Init):
    hidden = int(dim * mlp_ratio)
    if ffn_layer in ("swiglufused", "swiglu"):
        sh = swiglu_hidden_dim(hidden)
        mlp = {"w12": init.linear(depth, fan_in=dim, fan_out=2 * sh), "w3": init.linear(depth, fan_in=sh, fan_out=dim)}
    else:
        mlp = {"fc1": init.linear(depth, fan_in=dim, fan_out=hidden), "fc2": init.linear(depth, fan_in=hidden, fan_out=dim)}
    return {
        "norm1": init.norm(depth, dim=dim),
        "attn": {"qkv": init.linear(depth, fan_in=dim, fan_out=3 * dim), "proj": init.linear(depth, fan_in=dim, fan_out=dim)},
        "norm2": init.norm(depth, dim=dim),
        "mlp": mlp,
    }


def init_mingtok_params(cfg, init: _Init):
    """The encoder, the semantic and pixel decoders and sem_to_pix, with the
    leaves of the JAX package's `init_mingtok_params`."""
    enc, sem, pix = cfg.encoder, cfg.semantic_decoder, cfg.pixel_decoder
    ratio = sem.patch_size // pix.patch_size
    return {
        "encoder": {
            "patch_embed": init.linear(fan_in=enc.in_chans * enc.patch_size**2, fan_out=enc.embed_dim),
            "cls_token": init.zeros(1, 1, enc.embed_dim),
            "pos_embed": init.trunc(1, enc.num_patches + 1, enc.embed_dim),
            "blocks": _blocks(enc.depth, enc.embed_dim, enc.mlp_ratio, enc.ffn_layer, init),
            "out_norm": init.norm(dim=enc.embed_dim),
            "out_proj": init.linear(fan_in=enc.embed_dim, fan_out=enc.out_dim),
        },
        "semantic_decoder": {
            "in_proj": init.linear(fan_in=sem.in_dim, fan_out=sem.embed_dim),
            "blocks": _blocks(sem.depth, sem.embed_dim, sem.mlp_ratio, sem.ffn_layer, init),
            "norm": init.norm(dim=sem.embed_dim),
        },
        "pixel_decoder": {
            "blocks": _blocks(pix.depth, pix.embed_dim, pix.mlp_ratio, pix.ffn_layer, init),
            "norm": init.norm(dim=pix.embed_dim),
            "head": init.linear(fan_in=pix.embed_dim, fan_out=pix.patch_size**2 * 3),
        },
        "sem_to_pix": init.linear(fan_in=sem.embed_dim, fan_out=pix.embed_dim * ratio * ratio),
    }


def init_mm_params(cfg, *, device, dtype=torch.bfloat16, generator: torch.Generator):
    """Random weights of the whole model, built on `device`:
    {"llm", "vis_head", "rf_head", "linear_proj", "mingtok"}."""
    init = _Init(device, dtype, generator)
    return {
        "llm": init_bailing_moe_params(cfg.llm, init),
        "vis_head": init_vis_head_params(cfg.llm.hidden_size, cfg.rf_head.z_channels, init),
        "rf_head": init_rf_head_params(cfg.rf_head, init),
        "linear_proj": init_linear_proj_params(cfg.mingtok.feature_dim, cfg.llm.hidden_size, cfg.mlp_depth, init),
        "mingtok": init_mingtok_params(cfg.mingtok, init),
    }


# weight tier name -> bits, as the JAX package's checkpoint load reads RuntimeConfig.param_dtype
_TIER_BITS = {"int8": 8, "int4": 4, "int4-nf4": 4}


def tier_bits(runtime):
    """The bits and scheme of the LLM and of the RF head for `runtime`'s weight
    tier, as the JAX package's checkpoint load resolves them: param_dtype names
    the LLM's tier ("int8", "int4" or "int4-nf4"; any other name keeps it
    floating and returns None), rf_param_dtype overrides the RF head's (None
    follows the LLM; a name outside the table keeps the LLM's bits), and a
    name ending in "nf4" takes the NF4 scheme. Returns the keyword arguments of
    `quantize_mm_params_inplace` (bits, scheme, rf_bits, rf_scheme), or None."""
    bits = _TIER_BITS.get(runtime.param_dtype)
    if bits is None:
        return None
    rf_tier = runtime.rf_param_dtype or runtime.param_dtype
    scheme = lambda tier: "nf4" if str(tier).endswith("nf4") else "linear"  # noqa: E731
    return dict(bits=bits, scheme=scheme(runtime.param_dtype), rf_bits=_TIER_BITS.get(rf_tier, bits),
                rf_scheme=scheme(rf_tier))


def quantize_mm_params_inplace(params: dict, bits: int = 4, scheme: str = "linear", rf_bits=None,
                               rf_scheme=None, min_size: int = _QUANT_MIN_SIZE) -> dict:
    """A weight tier of the JAX package's checkpoint load, applied in place on
    the params' device: the LLM quantized to `bits` (`scheme`) and the RF head
    to `rf_bits` (`rf_scheme`; None follows the LLM) — at 4 bits the embedding
    and odd-contraction tables go to int8 — with routers, norms and biases left
    floating, and MingTok, vis_head and linear_proj left as they are (as are
    tables of fewer than `min_size` elements, as in `quantize_tree`). The
    default is the int4 tier; `**tier_bits(runtime)` gives a RuntimeConfig's
    tier (the int8 quality tier, or the int4 LLM with an int8 RF head).
    Each floating leaf is freed as its quantized copy replaces it, so a bf16
    tree on the card is quantized without a second copy."""
    quantize_tree_inplace(params["llm"], bits=bits, min_size=min_size, scheme=scheme)
    quantize_tree_inplace(params["rf_head"], bits=bits if rf_bits is None else rf_bits, min_size=min_size,
                          scheme=scheme if rf_scheme is None else rf_scheme)
    return params
