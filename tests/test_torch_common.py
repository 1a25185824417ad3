"""Shared set-up of the PyTorch-port parity tests (no tests of its own): tiny
configs and one random parameter tree that both packages run on."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import (
    BailingMoeConfig,
    ImageGenConfig,
    MingTokConfig,
    MingUniVisionConfig,
    PixelDecoderConfig,
    RFHeadConfig,
    SemanticDecoderConfig,
    ViTEncoderConfig,
)
from mingunivision_tpu.engine.generate import init_linear_proj_params
from mingunivision_tpu.models.bailing_moe import init_bailing_moe_params
from mingunivision_tpu.models.mingtok import init_mingtok_params
from mingunivision_tpu.models.rf_head import init_rf_head_params, init_vis_head_params

# Test workers share the host's cores: PyTorch's default of one intra-op thread
# per core oversubscribes them, and its OpenMP threads then wait on each other
# at every small op (with six workers on eight cores, chip_smoke's reference
# checks took hundreds of seconds each instead of a few). Every test module
# that runs the port imports this one.
torch.set_num_threads(1)

EOS, IMG_START, IMG_PATCH = 501, 500, 499
ATOL = 2e-4  # fp32 parity tolerance, as the JAX kernel tests use


def tiny_llm(**kw) -> BailingMoeConfig:
    base = dict(
        vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2, num_shared_experts=2,
        max_position_embeddings=256, mrope_section=(2, 3, 3), eos_token_id=EOS, pad_token_id=EOS,
        image_patch_token=IMG_PATCH, image_start_token=IMG_START, num_image_tokens_for_gen=4,
    )
    base.update(kw)
    return BailingMoeConfig(**base)


def tiny_mm(**llm_kw) -> MingUniVisionConfig:
    return MingUniVisionConfig(
        mingtok=MingTokConfig(
            encoder=ViTEncoderConfig(img_size=32, patch_size=16, embed_dim=64, depth=1, num_heads=1, out_dim=8),
            semantic_decoder=SemanticDecoderConfig(in_dim=8, embed_dim=64, depth=2, num_heads=2, patch_size=16),
            pixel_decoder=PixelDecoderConfig(embed_dim=64, depth=2, num_heads=2, patch_size=8, ffn_layer="mlp"),
            scaling_factor=2.0,
            mean=0.5,
        ),
        llm=tiny_llm(**llm_kw),
        rf_head=RFHeadConfig(target_channels=8, z_channels=32, width=32, depth=2, mlp_mult=4, num_sampling_steps=3),
        image_gen=ImageGenConfig(num_image_tokens=4),
        mlp_depth=2,
    )


def random_params(cfg: MingUniVisionConfig, seed: int = 0) -> dict:
    """The JAX init tree as writable numpy arrays, with the RF head's
    zero-initialised AdaLN and final layers made random so they are exercised."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    params = {
        "llm": init_bailing_moe_params(ks[0], cfg.llm, dtype=jnp.float32),
        "mingtok": init_mingtok_params(ks[1], cfg.mingtok, dtype=jnp.float32),
        "rf_head": init_rf_head_params(ks[2], cfg.rf_head, dtype=jnp.float32),
        "vis_head": init_vis_head_params(ks[3], cfg.llm.hidden_size, cfg.rf_head.z_channels, dtype=jnp.float32),
        "linear_proj": init_linear_proj_params(ks[4], cfg.mingtok.feature_dim, cfg.llm.hidden_size, cfg.mlp_depth),
    }
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(seed + 100)
    rf = params["rf_head"]
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"] = (0.05 * rng.standard_normal(leaf["w"].shape)).astype(np.float32)
    return params


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def fp32_kv(monkeypatch):
    """For the test, the training forwards of both packages keep k and v in fp32
    where `lm_loss` rounds them to bf16 (the JAX package's bf16 cache): the two
    then differentiate the same function in fp32 throughout. The bf16 rounding
    makes fp32 grads move by up to 5e-4 of their max under a 3e-6 relative
    change of the embeddings, far past what fp32 parity can hold."""
    import mingunivision_tpu.engine.train as jax_train
    import mingunivision_tpu_torch.engine.train as port_train

    cache_cls, forward = jax_train.LLMCache, port_train.bailing_forward

    class Fp32Cache:
        @staticmethod
        def create(cfg, batch, max_len, dtype=None):
            return cache_cls.create(cfg, batch, max_len, dtype=jnp.float32)

    monkeypatch.setattr(jax_train, "LLMCache", Fp32Cache)
    monkeypatch.setattr(port_train, "bailing_forward", lambda *a, **k: forward(*a, **{**k, "kv_dtype": torch.float32}))


def jax_lm_loss_grads(params, cfg, ids, mask, image, dtype=jnp.float32, **kw):
    """The JAX package's lm_loss and its grads (as a port tree on the CPU) on
    numpy params cast to `dtype`."""
    from mingunivision_tpu.engine import train as jax_train
    from mingunivision_tpu_torch.utils.convert import params_from_jax

    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    loss, grads = jax.value_and_grad(jax_train.lm_loss)(p, cfg, jnp.asarray(ids), jnp.asarray(mask),
                                                      jnp.asarray(image), **kw)
    return float(loss), params_from_jax(jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads), "cpu")


def port_lm_loss_grads(params, cfg, ids, mask, image, dtype=torch.float32, **kw):
    """The port's lm_loss on the CPU and its param tree, each leaf's .grad set."""
    from mingunivision_tpu_torch.engine import train as port_train
    from mingunivision_tpu_torch.utils.convert import params_from_jax
    from mingunivision_tpu_torch.utils.pytree import leaves

    p = params_from_jax(params, "cpu", dtype)
    for leaf in leaves(p):
        leaf.requires_grad_(True)
    loss = port_train.lm_loss(p, cfg, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(image), **kw)
    loss.backward()
    return float(loss), p


def grad_errors(port_params, want):
    """path -> (max |port grad - want|, max |want|) over the leaves of a port tree."""
    from chip_smoke import tree_paths
    from mingunivision_tpu_torch.utils.convert import _same_path_leaves

    out = {}
    for path, (p, g) in zip(tree_paths(port_params), _same_path_leaves(port_params, want)):
        got = torch.zeros_like(g) if p.grad is None else p.grad.float()
        out[path] = (float((got - g).abs().max()), float(g.abs().max()))
    return out


AUX = dict(balance_alpha=0.01, z_alpha=1e-3)  # the router aux-loss weights of the lm_loss parity tests


def train_batch(B: int = 2, T: int = 32, seed: int = 3):
    """(cfg, params, ids, mask, image) of the lm_loss parity tests:
    `tiny_llm_config()`, its JAX init at fp32 as numpy arrays, B x T token ids
    (B * T above the decode MoE's 48 rows), a mask that pads the last row's
    tail, and an image span routed by the image gate."""
    from mingunivision_tpu.config import tiny_llm_config

    cfg = tiny_llm_config()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[-1, T - 6 :] = 0
    image = np.zeros((B, T), bool)
    image[:, 4:12] = True
    params = jax.tree_util.tree_map(np.asarray, init_bailing_moe_params(jax.random.PRNGKey(seed), cfg, jnp.float32))
    return cfg, params, ids, mask, image
