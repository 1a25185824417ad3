"""PyTorch port, the int4 slice: text-to-image through the port's session with
an int4 tree (the LLM and RF head quantized as the JAX package's int4 tier
does), on a tiny config at fp32 on the CPU, against the JAX package's session
on the same quantized tree.

On the CPU the JAX package takes no Pallas kernel: its int4 session computes
an EXACT dequant (gathered experts, the XLA Euler loop), while the TPU kernels,
and so the port's kernels and their plain versions, quantize activations per
row to s8. Hence two forms:
  - the port's int4 kernel entries replaced (in the test) by exact-dequant
    plain functions: the JAX session's tokens and image within 1e-3;
  - as shipped (s8 plain versions): the same tokens, and an image within twice
    the gap between the JAX session at int4 and at fp32 weights, the error the
    int4 tier itself is allowed.
"""

import numpy as np
import pytest
import torch

from mingunivision_tpu.config import GenerationConfig, ImageGenConfig, RuntimeConfig
from mingunivision_tpu.engine.session import MingUniVisionSession as JaxSession
from mingunivision_tpu.utils.quantize import quantize_tree
from mingunivision_tpu_torch.engine.session import MingUniVisionSession
from mingunivision_tpu_torch.models import bailing_moe, rf_head
from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_bf16_plain
from mingunivision_tpu_torch.ops.kernels.moe_swiglu_gmm import moe_experts_swiglu_gmm_bf16_plain
from mingunivision_tpu_torch.utils.convert import params_from_jax
from mingunivision_tpu_torch.utils.quantize import dequant_weight

from test_torch_common import IMG_START, random_params, tiny_mm, to_jax
from test_torch_slice import _bias_image_start, _t2i_prompt

IMAGE_ATOL = 1e-3
MIN_SIZE = 1024  # the tiny tables are far below the 65536-element default


@pytest.fixture(scope="module")
def int4_setup():
    cfg = tiny_mm()
    params = random_params(cfg, seed=1)
    ids, am, um, tm = _t2i_prompt(2)
    _bias_image_start(params, cfg, ids)
    qparams = dict(params)
    for key in ("llm", "rf_head"):
        qparams[key] = quantize_tree(to_jax(params[key]), bits=4, min_size=MIN_SIZE)
    runtime = RuntimeConfig(max_seq_len=192, compute_dtype="float32")
    kw = dict(uncond_attention_mask=um, text_uncond_attention_mask=tm, generation=GenerationConfig(max_new_tokens=1),
              image_gen=ImageGenConfig(num_image_tokens=4, temperature=0.0))

    def jax_round(p):
        return JaxSession(to_jax(p), cfg, runtime, seed=0).generate(ids, am, **kw)

    want, want_f32 = jax_round(qparams), jax_round(params)
    return cfg, qparams, runtime, (ids, am, kw), want, want_f32


def _port_round(cfg, qparams, runtime, prompt):
    ids, am, kw = prompt
    tree = params_from_jax(qparams, "cpu", torch.float32)
    mlp = tree["llm"]["layers"]["mlp"]["experts"]
    assert all(mlp[k].bits == 4 for k in mlp) and tree["llm"]["word_embeddings"]["w"].bits == 8
    assert tree["rf_head"]["res_blocks"]["mlp"]["w12"]["w"].bits == 4
    sess = MingUniVisionSession(tree, cfg, runtime, seed=0, device="cpu")
    return sess.generate(ids, am, **kw), sess


def _exact(plain):
    """An exact-dequant MoE entry: the layer's int4 tables dequantized, then the plain float version."""
    def run(ex, x, i, w, E, l):
        tables = {k: dequant_weight(v[l], x.dtype) for k, v in ex.items()}
        return plain(tables, x, i, w, E) if plain is moe_experts_swiglu_gmm_bf16_plain else plain(tables, x, i, w)
    return run


def test_int4_session_with_exact_dequant_matches_jax(int4_setup, monkeypatch):
    cfg, qparams, runtime, prompt, want, _ = int4_setup
    monkeypatch.setitem(bailing_moe.MOE_IMPLS, "decode", _exact(moe_experts_stream_bf16_plain))
    monkeypatch.setitem(bailing_moe.MOE_IMPLS, "prefill", _exact(moe_experts_swiglu_gmm_bf16_plain))
    monkeypatch.setattr(rf_head, "rf_sampler_supported", lambda *a: False)
    got, sess = _port_round(cfg, qparams, runtime, prompt)
    assert got.token_ids == want.token_ids == [IMG_START]
    assert sess.timings["cfg_rows"] == 2
    np.testing.assert_allclose(got.images[0], want.images[0], atol=IMAGE_ATOL)


def test_int4_session_as_shipped_within_the_tier_error(int4_setup):
    cfg, qparams, runtime, prompt, want, want_f32 = int4_setup
    got, _ = _port_round(cfg, qparams, runtime, prompt)
    assert got.token_ids == want.token_ids == want_f32.token_ids == [IMG_START]
    tier_gap = float(np.abs(want.images[0] - want_f32.images[0]).max())
    err = float(np.abs(got.images[0] - want.images[0]).max())
    assert 0 < tier_gap and np.isfinite(got.images[0]).all()
    assert err <= 2 * tier_gap, (err, tier_gap)
