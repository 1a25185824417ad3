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
