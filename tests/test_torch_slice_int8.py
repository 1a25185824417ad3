"""PyTorch port, the int8 tier: text-to-image, editing, understanding and the
paged serving engine through the port with an int8 tree (the LLM and RF head
quantized as the JAX package's int8 tier does), and the int4-LLM + int8-RF
mixed tier, on a tiny config at fp32 on the CPU, against the JAX package on
the same quantized trees.

On the CPU the JAX package takes no Pallas kernel: its int8 session computes
an EXACT dequant in fp32 (the XLA Euler loop for the RF head), as do the
port's int8 prefill MoE and, with `moe_int_dots=False`, its int8 decode MoE.
As shipped, the port's decode MoE takes s8 dots (the TPU default,
INT_DOT_STREAM_INT8) and its RF head the fused sampler, which computes in
bf16 for an fp32 session, as the JAX package's fused sampler does on the
TPU. Hence:
  - the decode MoE entry swapped (in the test) for an exact-dequant plain
    function or `moe_int_dots=False`, and the RF head's Euler loop in place
    of the fused sampler (the int4 slice test's idiom): the JAX session's
    tokens and image within 1e-3;
  - as shipped (the editing and mixed-tier rounds too): the same tokens, and
    an image within twice the gap between the JAX session at the tier and at
    fp32 weights, the error the tier itself is allowed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.config import GenerationConfig, ImageGenConfig, RuntimeConfig
from mingunivision_tpu.engine.paged import PagedBatchingEngine as JaxPaged
from mingunivision_tpu.engine.session import MingUniVisionSession as JaxSession
from mingunivision_tpu.utils.quantize import quantize_tree
from mingunivision_tpu_torch.engine.paged import PagedBatchingEngine
from mingunivision_tpu_torch.engine.session import MingUniVisionSession
from mingunivision_tpu_torch.models import bailing_moe, rf_head
from mingunivision_tpu_torch.ops.kernels import moe_stream, rf_sampler
from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_bf16_plain
from mingunivision_tpu_torch.utils.convert import params_from_jax, quantize_mm_params_inplace, tier_bits
from mingunivision_tpu_torch.utils.quantize import dequant_weight
from mingunivision_tpu_torch.utils.quantize import quantize_array as port_quantize_array

from test_torch_common import IMG_START, random_params, tiny_mm, to_jax
from test_torch_quantize import _compare_trees
from test_torch_slice import _bias_image_start, _t2i_prompt
from test_torch_slice_image import _image_prompt, _pixels

IMAGE_ATOL = 1e-3
MIN_SIZE = 1024  # the tiny tables are far below the 65536-element default
RUNTIME = RuntimeConfig(max_seq_len=192, compute_dtype="float32")


def _quantized(params, bits, rf_bits):
    q = dict(params)
    q["llm"] = quantize_tree(to_jax(params["llm"]), bits=bits, min_size=MIN_SIZE)
    q["rf_head"] = quantize_tree(to_jax(params["rf_head"]), bits=rf_bits, min_size=MIN_SIZE)
    return q


def _prompt(rows, renorm=None):
    ids, am, um, tm = _t2i_prompt(rows)
    kw = dict(uncond_attention_mask=um, text_uncond_attention_mask=tm, generation=GenerationConfig(max_new_tokens=1),
              image_gen=ImageGenConfig(num_image_tokens=4, temperature=0.0, cfg_renorm_type=renorm))
    return ids, am, kw


def _jax_round(cfg, params, prompt):
    ids, am, kw = prompt
    return JaxSession(to_jax(params), cfg, RUNTIME, seed=0).generate(ids, am, **kw)


@pytest.fixture(scope="module")
def t2i():
    cfg = tiny_mm()
    params = random_params(cfg, seed=1)
    _bias_image_start(params, cfg, _t2i_prompt(2)[0])
    q8 = _quantized(params, 8, 8)
    prompt = _prompt(2)
    return cfg, params, q8, prompt, _jax_round(cfg, q8, prompt), _jax_round(cfg, params, prompt)


def _port_round(cfg, tree, prompt, runtime=RUNTIME):
    ids, am, kw = prompt
    sess = MingUniVisionSession(tree, cfg, runtime, seed=0, device="cpu")
    return sess.generate(ids, am, **kw), sess


def _port_tree(qparams, llm_bits=8, rf_bits=8):
    tree = params_from_jax(qparams, "cpu", torch.float32)
    experts = tree["llm"]["layers"]["mlp"]["experts"]
    assert all(experts[k].bits == llm_bits for k in experts)
    assert tree["rf_head"]["res_blocks"]["mlp"]["w12"]["w"].bits == rf_bits
    return tree


def _exact_decode(ex, x, i, w, E, l, int_dots):
    """An exact-dequant decode MoE entry: the layer's tables dequantized, then the plain float version."""
    return moe_experts_stream_bf16_plain({k: dequant_weight(v[l], x.dtype) for k, v in ex.items()}, x, i, w)


def _within_tier_gap(got, want, want_f32):
    """The port's image within twice the JAX session's int-tier-vs-fp32 gap."""
    tier_gap = float(np.abs(want.images[0] - want_f32.images[0]).max())
    err = float(np.abs(got.images[0] - want.images[0]).max())
    assert 0 < tier_gap and np.isfinite(got.images[0]).all()
    assert err <= 2 * tier_gap, (err, tier_gap)


class _Count:
    """Counts the calls of a module attribute (the sampler, a decode MoE plain version)."""

    def __init__(self, monkeypatch, mod, name):
        self.n, fn = 0, getattr(mod, name)

        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)


def test_int8_session_with_exact_decode_matches_jax(t2i, monkeypatch):
    cfg, _, q8, prompt, want, _ = t2i
    monkeypatch.setitem(bailing_moe.MOE_IMPLS, "decode", _exact_decode)
    monkeypatch.setattr(rf_head, "rf_sampler_supported", lambda *a: False)
    got, sess = _port_round(cfg, _port_tree(q8), prompt)
    assert got.token_ids == want.token_ids == [IMG_START]
    assert sess.timings["cfg_rows"] == 2
    np.testing.assert_allclose(got.images[0], want.images[0], atol=IMAGE_ATOL)


def test_int8_session_as_shipped_within_the_tier_error(t2i, monkeypatch):
    cfg, _, q8, prompt, want, want_f32 = t2i
    s8 = _Count(monkeypatch, moe_stream, "moe_experts_stream_q8s8_plain")
    sampler = _Count(monkeypatch, rf_sampler, "rf_sample_fused_plain")  # the int8 sampler's plain version
    got, _ = _port_round(cfg, _port_tree(q8), prompt)
    assert got.token_ids == want.token_ids == want_f32.token_ids == [IMG_START]
    assert s8.n == cfg.llm.num_hidden_layers * (cfg.image_gen.num_image_tokens + 1)  # every image-loop LLM step
    assert sampler.n == cfg.image_gen.num_image_tokens
    _within_tier_gap(got, want, want_f32)


def test_int8_exact_dot_mode_matches_jax_and_int4_refuses_it(t2i, monkeypatch):
    cfg, params, q8, prompt, want, _ = t2i
    exact = _Count(monkeypatch, moe_stream, "moe_experts_stream_q8_plain")
    monkeypatch.setattr(rf_head, "rf_sampler_supported", lambda *a: False)
    runtime = dataclasses.replace(RUNTIME, moe_int_dots=False)
    got, _ = _port_round(cfg, _port_tree(q8), prompt, runtime)
    assert got.token_ids == want.token_ids == [IMG_START]
    assert exact.n == cfg.llm.num_hidden_layers * (cfg.image_gen.num_image_tokens + 1)
    np.testing.assert_allclose(got.images[0], want.images[0], atol=IMAGE_ATOL)
    # an int4 tree now runs the exact dot mode too (held against the JAX session in
    # tests/test_torch_slice_tiers.py); shard-grouped int4 tables, still unported, refuse it
    q4 = _port_tree(_quantized(params, 4, 4), 4, 4)
    assert _port_round(cfg, q4, prompt, runtime)[0].token_ids == [IMG_START]
    experts = q4["llm"]["layers"]["mlp"]["experts"]
    for name, t in experts.items():
        experts[name] = port_quantize_array(dequant_weight(t, torch.float32), 4, groups=2)
    with pytest.raises(NotImplementedError):
        _port_round(cfg, q4, prompt, runtime)


def test_int8_editing_round_with_three_rows_and_renorm_within_the_tier_error(t2i, monkeypatch):
    cfg, params, q8, _, _, _ = t2i
    prompt = _prompt(3, renorm="channel")
    want, want_f32 = _jax_round(cfg, q8, prompt), _jax_round(cfg, params, prompt)
    sampler = _Count(monkeypatch, rf_sampler, "rf_sample_fused_plain")
    got, sess = _port_round(cfg, _port_tree(q8), prompt)
    assert got.token_ids == want.token_ids == [IMG_START] and sess.timings["cfg_rows"] == 3
    assert sampler.n == cfg.image_gen.num_image_tokens
    _within_tier_gap(got, want, want_f32)


def test_int8_understanding_through_flash_and_capacity_matches_jax(monkeypatch):
    """A prompt padded to 512 (flash prefill, the capacity dispatch over the
    int8 prefill kernel's plain version), then exact-dequant text decode."""
    cfg = tiny_mm()
    params = random_params(cfg, seed=3)
    params["llm"]["lm_head"]["w"][:, IMG_START] = 0.0  # text replies only
    q8 = _quantized(params, 8, 8)
    capacity = _Count(monkeypatch, bailing_moe, "moe_experts_capacity_gmm_exact")
    runtime = RuntimeConfig(max_seq_len=768, compute_dtype="float32", moe_int_dots=False)
    ids, am, um, tm = _image_prompt(16, 420, seed=5)  # 444 ids -> the 512 bucket
    kw = dict(uncond_attention_mask=um, text_uncond_attention_mask=tm, pixel_values=_pixels(6, 64),
              generation=GenerationConfig(max_new_tokens=4))
    want_sess = JaxSession(to_jax(q8), cfg, runtime, seed=0)
    want = want_sess.generate(ids, am, **kw)
    got, sess = _port_round(cfg, _port_tree(q8), (ids, am, kw), runtime)
    assert got.token_ids == want.token_ids and len(got.token_ids) == 4 and not got.images
    assert sess.timings["prefill_tokens"] == 512 and sess.timings["use_flash"]
    assert capacity.n == cfg.llm.num_hidden_layers
    np.testing.assert_allclose(sess.last_hidden_states, want_sess.last_hidden_states, atol=IMAGE_ATOL, rtol=0)


def test_mixed_tier_int4_llm_int8_rf_matches_jax(t2i, monkeypatch):
    cfg, params, _, prompt, _, want_f32 = t2i
    runtime = dataclasses.replace(RUNTIME, param_dtype="int4", rf_param_dtype="int8")
    assert tier_bits(runtime) == dict(bits=4, scheme="linear", rf_bits=8, rf_scheme="linear")
    jtree = _quantized(params, 4, 8)
    tree = params_from_jax({k: params[k] for k in ("llm", "rf_head")}, "cpu", torch.float32)
    quantize_mm_params_inplace(tree, **tier_bits(runtime), min_size=MIN_SIZE)
    for key in ("llm", "rf_head"):  # the same bytes, leaf by leaf
        _compare_trees(tree[key], jtree[key])
    want = _jax_round(cfg, jtree, prompt)
    sampler = _Count(monkeypatch, rf_sampler, "rf_sample_fused_plain")
    got, _ = _port_round(cfg, {**_port_tree(jtree, 4, 8), **tree}, prompt)
    assert got.token_ids == want.token_ids == [IMG_START] and sampler.n == cfg.image_gen.num_image_tokens
    _within_tier_gap(got, want, want_f32)


@pytest.mark.parametrize("int_dots", [False, True], ids=["exact", "s8"])
def test_paged_engine_int8_matches_jax(int_dots):
    """Two greedy requests, the second admitted mid-flight (two steps after the
    first), on the paged pool with an int8 LLM: the JAX paged engine's tokens."""
    cfg = tiny_mm()
    params = random_params(cfg, seed=4)
    jllm = quantize_tree(to_jax(params["llm"]), bits=8, min_size=MIN_SIZE)
    tllm = params_from_jax(jllm, "cpu", torch.float32)
    rng = np.random.default_rng(1)
    requests = [rng.integers(0, 400, (40,)), rng.integers(0, 400, (30,))]  # 30: decode crosses the page at 32

    def drive(eng):
        first = eng.add_request(requests[0], 8)
        eng.step()
        eng.step()
        second = eng.add_request(requests[1], 8)
        eng.run_to_completion(max_steps=64)
        return [first.tokens, second.tokens]

    want = drive(JaxPaged(jllm, cfg.llm, slots=3, max_len=256, page_size=32, dtype=jnp.float32))
    got = drive(PagedBatchingEngine(tllm, cfg.llm, slots=3, max_len=256, page_size=32, dtype=torch.float32,
                                    int_dots=int_dots))
    assert got == want and all(len(t) == 8 for t in got)
