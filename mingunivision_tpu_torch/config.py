"""Typed configuration of the port: the dataclasses of the JAX package's
config module (mingunivision_tpu/config.py), field for field with the same
defaults, so a config built for either package drives the other.

Defaults reproduce the shipped Ming-UniVision-16B-A3B checkpoint: MingTok from
the reference's mingtok/config/config_mingtok.json, Bailing-MoE from
mingunivision/config.json, the RF head from modeling_bailing_moe.py
(setup_vishead_diffloss). Fields that only the JAX package reads (mesh and
sharding switches, Pallas toggles) are kept so that the two trees compare
equal; the port ignores them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# MingTok-Vision visual tokenizer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ViTEncoderConfig:
    """Low-level encoder: bidirectional ViT -> 32-d latents."""

    img_size: int = 512
    patch_size: int = 32
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ffn_layer: str = "swiglufused"
    out_dim: int = 32
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    ln_eps: float = 1e-6
    # pos-embed interpolation uses scale_factor=(w0+offset)/M, as the reference
    interpolate_offset: float = 0.1
    interpolate_antialias: bool = False

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


@dataclass(frozen=True)
class SemanticDecoderConfig:
    """Causal ViT decoder: 32-d latent -> 1024-d semantic features, KV-cached."""

    in_dim: int = 32
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    ffn_layer: str = "swiglufused"
    patch_size: int = 32  # only used for the sem->pix spatial expansion ratio
    with_cls_token: bool = True
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    ln_eps: float = 1e-6


@dataclass(frozen=True)
class PixelDecoderConfig:
    """Bidirectional ViT decoder: semantic features -> RGB patches (fp32 path)."""

    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    ffn_layer: str = "mlp"
    patch_size: int = 16
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    ln_eps: float = 1e-6
    loss_type: str = "L1-plain"
    norm_pix_loss: bool = True
    # fp32 matmul mode of this decoder ("highest" | "high" | "default" | "bf16")
    matmul_precision: str = "high"


@dataclass(frozen=True)
class MingTokConfig:
    """Three-part continuous visual tokenizer. `scaling_factor`/`mean`
    standardise latents at the encode boundary and are inverted before the
    semantic decode."""

    encoder: ViTEncoderConfig = field(default_factory=ViTEncoderConfig)
    semantic_decoder: SemanticDecoderConfig = field(default_factory=SemanticDecoderConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    scaling_factor: float = 8.09449291
    mean: float = 1.46817409
    compute_dtype: str = "bfloat16"  # encoder / semantic decoder; the pixel decoder runs fp32

    @property
    def latent_dim(self) -> int:
        return self.encoder.out_dim

    @property
    def feature_dim(self) -> int:
        return self.semantic_decoder.embed_dim


# ---------------------------------------------------------------------------
# Bailing-MoE language model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BailingMoeConfig:
    """16B-A3B decoder-only MoE LLM."""

    vocab_size: int = 126464
    hidden_size: int = 2048
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 4
    head_dim: int = 128
    intermediate_size: int = 5632  # dense FFN (unused: first_k_dense_replace=0)
    moe_intermediate_size: int = 1408
    num_experts: int = 64
    num_experts_per_tok: int = 6
    num_shared_experts: int = 2
    first_k_dense_replace: int = 0
    norm_topk_prob: bool = True
    multi_gate: bool = True
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 600000.0
    rope_scaling_type: str = "3D"  # all-equal planes == 1-D RoPE
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    max_position_embeddings: int = 32768
    use_qkv_bias: bool = False
    use_bias: bool = False
    norm_head: bool = False
    tie_word_embeddings: bool = False
    eos_token_id: int = 126081
    pad_token_id: int = 126081
    image_patch_token: int = 126346
    image_start_token: int = 126347
    video_start_token: int = 126349
    num_image_tokens_for_gen: int = 256
    # JAX-package switches for sharded expert tables and forced dispatch
    expert_tables_sharded: bool = False
    moe_force_dispatch: Any = None
    # prefill MoE: capacity-dense dispatch factor (engages at >= 512 tokens)
    # and the row-tile override of the grouped prefill kernel
    moe_prefill_capacity_factor: float = 2.0
    moe_prefill_tm: int = 0
    expert_mesh: Any = dataclasses.field(default=None, compare=False, repr=False)
    moe_differentiable: bool = False
    remat_layers: bool = False

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def qkv_out_dim(self) -> int:
        return (self.num_attention_heads + 2 * self.num_key_value_heads) * self.head_dim


@dataclass(frozen=True)
class RFHeadConfig:
    """Rectified-flow head sampling 32-d continuous latents from LLM hidden states."""

    target_channels: int = 32  # MingTok latent dim
    z_channels: int = 3072  # vis_head output / conditioning width
    width: int = 3072
    depth: int = 12
    mlp_mult: int = 4
    num_sampling_steps: int = 16
    freq_embed_size: int = 256
    ln_eps: float = 1e-6


@dataclass(frozen=True)
class ImageGenConfig:
    """Defaults of the autoregressive image loop."""

    num_image_tokens: int = 256
    text_cfg: float = 3.0
    image_cfg: float = 1.1
    temperature: float = 1.0
    cfg_schedule: str = "constant"  # constant | linear | linear-reverse
    cfg_renorm_type: Optional[str] = None  # None | "channel"
    time_shifting_factor: Optional[float] = None


@dataclass(frozen=True)
class GenerationConfig:
    """Text decoding defaults (HF-generate equivalents)."""

    max_new_tokens: int = 512
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: int = 126081


@dataclass(frozen=True)
class MingUniVisionConfig:
    """MingTok + Bailing-MoE + linear_proj MLP (1024 -> 2048, depth 2) + vis_head/RF head."""

    mingtok: MingTokConfig = field(default_factory=MingTokConfig)
    llm: BailingMoeConfig = field(default_factory=BailingMoeConfig)
    rf_head: RFHeadConfig = field(default_factory=RFHeadConfig)
    image_gen: ImageGenConfig = field(default_factory=ImageGenConfig)
    mlp_depth: int = 2


@dataclass(frozen=True)
class RuntimeConfig:
    """Engine-level knobs: cache sizes, dtypes, kernels."""

    max_seq_len: int = 4096  # preallocated KV-cache length of the LLM
    max_semdec_len: int = 257  # semantic-decoder cache (256 latents + headroom)
    cfg_rows: int = 3  # cond / uncond / text-uncond
    # weight tier of a checkpoint load ("bfloat16" | "int8" | "int4" | "int4-nf4");
    # an explicit param tree carries its own tier
    param_dtype: str = "bfloat16"
    rf_param_dtype: Optional[str] = None  # RF-head tier override (None = param_dtype)
    compute_dtype: str = "bfloat16"
    use_pallas_attention: bool = True
    use_pallas_moe: bool = True
    past_mode: str = "DROP"  # DROP | KEEP: multi-round mask persistence
    pixdec_matmul_precision: Optional[str] = None
    # integer s8 dots in the int4/int8 decode MoE; False takes the
    # exact-dequant kernels (the JAX package's INT_DOT_STREAM / _INT8)
    moe_int_dots: bool = True
    # per-row s8 activation dots in the int4/int8 prefill MoE, through the
    # sorted and the capacity dispatch (the JAX package's module flags
    # INT_DOT_PREFILL_INT8 / INT_DOT_PREFILL_INT4, off there too)
    moe_prefill_int_dots: bool = False
    # s8 dots over int8 RF tables, in the fused sampler and the per-step stack
    # (the JAX package's rf_mlp.INT8_INT_DOTS, off there too); the fused int4
    # sampler is always s8
    rf_int_dots: bool = False
    # the whole Euler sample in one fused kernel over quantized linear RF tables;
    # False runs the Euler steps, each through the per-step stack kernel (the
    # JAX package's rf_head.FUSED_SAMPLER)
    rf_fused_sampler: bool = True
    # s8 dots in the per-step int4 stack; False takes its exact-dequant body
    # (the JAX package's rf_mlp.INT4_UNPACK_MODE == "s8")
    rf_int4_int_dots: bool = True


def with_pixdec_precision(config: MingUniVisionConfig, precision: str) -> MingUniVisionConfig:
    """`config` with the pixel-decoder matmul tier replaced (the serving tiers)."""
    mt = config.mingtok
    return dataclasses.replace(config, mingtok=dataclasses.replace(
        mt, pixel_decoder=dataclasses.replace(mt.pixel_decoder, matmul_precision=precision)))


# ---------------------------------------------------------------------------
# Small test-scale presets (same code paths)
# ---------------------------------------------------------------------------


def tiny_mingtok_config() -> MingTokConfig:
    return MingTokConfig(
        encoder=ViTEncoderConfig(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2, out_dim=8),
        semantic_decoder=SemanticDecoderConfig(in_dim=8, embed_dim=64, depth=2, num_heads=2, patch_size=16),
        pixel_decoder=PixelDecoderConfig(embed_dim=64, depth=2, num_heads=2, patch_size=8),
        scaling_factor=2.0,
        mean=0.5,
    )


def tiny_llm_config() -> BailingMoeConfig:
    return BailingMoeConfig(
        vocab_size=512,
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        moe_intermediate_size=32,
        num_experts=8,
        num_experts_per_tok=2,
        num_shared_experts=2,
        max_position_embeddings=256,
        mrope_section=(2, 3, 3),
    )


def tiny_rf_config() -> RFHeadConfig:
    return RFHeadConfig(target_channels=8, z_channels=48, width=48, depth=2, mlp_mult=4, num_sampling_steps=4,
                        freq_embed_size=16)
