"""PyTorch port, the image-in slice as a whole: understanding (image -> text),
a second round in the same session, editing (image + edit request -> image)
through the API, the processor on a PIL image and the int4 tier, each against
the JAX package's session on the same numpy-seeded weights and inputs, on a
tiny config at fp32 on the CPU.

The understanding prompt pads to 512 tokens, so the port takes the dispatch
the JAX package takes on a TPU: flash attention (its plain version here) and
the capacity-dense MoE dispatch (the grouped-SwiGLU kernels' plain version
behind the slot placement), while the JAX session on the CPU takes `mha` over
the cache and the masked-dense experts. Tolerance 1e-3 on logits and images,
as tests/test_torch_slice.py."""

import dataclasses

import numpy as np
import pytest
import torch

from mingunivision_tpu.api import MingUniVisionInfer as JaxInfer
from mingunivision_tpu.config import (
    GenerationConfig,
    ImageGenConfig,
    MingTokConfig,
    PixelDecoderConfig,
    RuntimeConfig,
    SemanticDecoderConfig,
    ViTEncoderConfig,
)
from mingunivision_tpu.engine import session as jax_session_mod
from mingunivision_tpu.engine.session import MingUniVisionSession as JaxSession
from mingunivision_tpu.processing.processor import BailingMMProcessor as JaxProcessor
from mingunivision_tpu.processing.processor import build_cfg_masks
from mingunivision_tpu.utils.quantize import quantize_tree
from mingunivision_tpu_torch.api import MingUniVisionInfer
from mingunivision_tpu_torch.engine import session as session_mod
from mingunivision_tpu_torch.engine.session import MingUniVisionSession
from mingunivision_tpu_torch.models import bailing_moe
from mingunivision_tpu_torch.ops.kernels import moe_capacity
from mingunivision_tpu_torch.ops.kernels.moe_stream import moe_experts_stream_bf16_plain
from mingunivision_tpu_torch.processing.processor import BailingMMProcessor
from mingunivision_tpu_torch.utils.convert import params_from_jax
from mingunivision_tpu_torch.utils.quantize import dequant_weight

from test_torch_common import IMG_PATCH, IMG_START, random_params, tiny_mm, to_jax

ATOL = 1e-3
IMG_END = 498
USER, ASSISTANT = [11, 12, 13], [11, 14, 13]  # stand-ins for the role-prefix id runs
IMAGE_IDS = {IMG_START, IMG_PATCH, IMG_END}


def _image_prompt(n_patches: int, n_text: int, seed: int):
    """<role>HUMAN</role> <image> patches </image> text <role>ASSISTANT</role> and its masks."""
    text = list(np.random.default_rng(seed).integers(20, 400, n_text))
    ids = USER + [IMG_START] + [IMG_PATCH] * n_patches + [IMG_END] + text + ASSISTANT
    uncond, text_uncond = build_cfg_masks(ids, USER, ASSISTANT, IMAGE_IDS)
    row = lambda a: np.asarray([a], np.int64)  # noqa: E731
    return row(ids), row([1] * len(ids)), row(uncond), row(text_uncond)


def _pixels(seed: int, size: int):
    return np.tanh(np.random.default_rng(seed).standard_normal((1, 3, size, size))).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_mm()
    params = random_params(cfg, seed=3)
    params["llm"]["lm_head"]["w"][:, IMG_START] = 0.0  # text replies only
    return cfg, params


class _Spy:
    """Records the prefill logits and flags of the two sessions, and how the
    port's prefill dispatched."""

    def __init__(self, monkeypatch):
        self.jax_logits, self.logits, self.use_flash, self.flash_calls, self.capacity_calls = [], [], [], 0, 0
        jax_prefill, port_prefill = jax_session_mod.prefill, session_mod.prefill
        flash, capacity = bailing_moe.flash_prefill_attention, bailing_moe.MOE_IMPLS["prefill_capacity"]

        def spy_jax(*a, **k):
            out = jax_prefill(*a, **k)
            self.jax_logits.append(np.asarray(out[0]))
            return out

        def spy_port(*a, **k):
            out = port_prefill(*a, **k)
            self.logits.append(out[0].numpy())
            self.use_flash.append(k["use_flash"])
            return out

        def spy_flash(*a, **k):
            self.flash_calls += 1
            return flash(*a, **k)

        def spy_capacity(*a):
            self.capacity_calls += 1
            return capacity(*a)

        monkeypatch.setattr(jax_session_mod, "prefill", spy_jax)
        monkeypatch.setattr(session_mod, "prefill", spy_port)
        monkeypatch.setattr(bailing_moe, "flash_prefill_attention", spy_flash)
        monkeypatch.setitem(bailing_moe.MOE_IMPLS, "prefill_capacity", spy_capacity)


def _sessions(cfg, params, tree, runtime):
    return (JaxSession(to_jax(tree), cfg, runtime, seed=0),
            MingUniVisionSession(params_from_jax(tree, "cpu", torch.float32), cfg, runtime, seed=0, device="cpu"))


def _understand(want_sess, sess, gen_tokens=4):
    ids, am, um, tm = _image_prompt(16, 420, seed=5)  # 444 ids -> the 512 bucket, 68 pads
    kw = dict(uncond_attention_mask=um, text_uncond_attention_mask=tm, pixel_values=_pixels(6, 64),
              generation=GenerationConfig(max_new_tokens=gen_tokens))
    return ids, want_sess.generate(ids, am, **kw), sess.generate(ids, am, **kw)


def _same_state(sess, want_sess):
    assert sess.seq_len == want_sess.seq_len
    for name in ("mask", "uncond_mask", "text_uncond_mask"):
        np.testing.assert_array_equal(getattr(sess, name).numpy(), np.asarray(getattr(want_sess, name)), err_msg=name)


def test_understanding_round_matches_jax_through_flash_and_capacity(setup, monkeypatch):
    cfg, params = setup
    spy = _Spy(monkeypatch)
    fallbacks = moe_capacity.moe_experts_capacity_gmm_exact.fallbacks
    want_sess, sess = _sessions(cfg, params, params, RuntimeConfig(max_seq_len=768, compute_dtype="float32"))
    ids, want, got = _understand(want_sess, sess)
    assert got.token_ids == want.token_ids and len(got.token_ids) == 4 and not got.images
    np.testing.assert_allclose(spy.logits[0], spy.jax_logits[0], atol=ATOL, rtol=0)
    _same_state(sess, want_sess)
    assert sess.seq_len == ids.shape[1] + 3  # the last sampled token is not fed
    # the port went the TPU dispatch's way: flash in both layers, the capacity dispatch in both, no fallback
    L = cfg.llm.num_hidden_layers
    assert spy.use_flash == [True] and spy.flash_calls == L and spy.capacity_calls == L
    assert moe_capacity.moe_experts_capacity_gmm_exact.fallbacks == fallbacks
    t = sess.timings
    assert t["prefill_tokens"] == 512 and t["use_flash"] and t["encode_ms"] > 0 and t["text_tokens"] == 3
    np.testing.assert_allclose(sess.last_hidden_states, want_sess.last_hidden_states, atol=ATOL, rtol=0)


@pytest.mark.parametrize("past_mode", ["DROP", "KEEP"])
def test_second_round_after_an_image_round_matches_jax(setup, monkeypatch, past_mode):
    """Round 2 starts on a filled cache: no flash, attention over the cache,
    the masks persisted as PAST_MODE says; it brings a second (32-px) image."""
    cfg, params = setup
    spy = _Spy(monkeypatch)
    runtime = RuntimeConfig(max_seq_len=768, compute_dtype="float32", past_mode=past_mode)
    want_sess, sess = _sessions(cfg, params, params, runtime)
    _understand(want_sess, sess, gen_tokens=2)
    ids, am, um, tm = _image_prompt(4, 6, seed=7)
    kw = dict(uncond_attention_mask=um, text_uncond_attention_mask=tm, pixel_values=_pixels(8, 32),
              generation=GenerationConfig(max_new_tokens=3))
    want, got = want_sess.generate(ids, am, **kw), sess.generate(ids, am, **kw)
    assert got.token_ids == want.token_ids and len(got.token_ids) == 3
    np.testing.assert_allclose(spy.logits[1], spy.jax_logits[1], atol=ATOL, rtol=0)
    _same_state(sess, want_sess)
    assert spy.use_flash == [True, False] and spy.flash_calls == cfg.llm.num_hidden_layers
    assert sess.timings["prefill_tokens"] == 128 and not sess.timings["use_flash"]


def test_understanding_round_int4_tier_matches_jax(setup, monkeypatch):
    """The int4 tree. Prefill is exact-dequant on both sides (the int4 prefill
    kernel's plain version, here behind the capacity placement); the decode
    MoE entry is replaced by an exact-dequant plain function, as
    tests/test_torch_slice_int4.py does, because the JAX package on the CPU
    dequantizes exactly where the kernels quantize activations to s8."""
    cfg, params = setup
    qparams = dict(params)
    qparams["llm"] = quantize_tree(to_jax(params["llm"]), bits=4, min_size=1024)
    spy = _Spy(monkeypatch)

    def exact_decode(ex, x, i, w, E, l, *_):  # the dot mode, the last argument, is not read
        return moe_experts_stream_bf16_plain({k: dequant_weight(v[l], x.dtype) for k, v in ex.items()}, x, i, w)

    monkeypatch.setitem(bailing_moe.MOE_IMPLS, "decode", exact_decode)
    want_sess, sess = _sessions(cfg, params, qparams, RuntimeConfig(max_seq_len=768, compute_dtype="float32"))
    assert sess.params["llm"]["layers"]["mlp"]["experts"]["gate_proj"].bits == 4
    _, want, got = _understand(want_sess, sess)
    assert got.token_ids == want.token_ids and len(got.token_ids) == 4
    np.testing.assert_allclose(spy.logits[0], spy.jax_logits[0], atol=ATOL, rtol=0)
    assert spy.flash_calls == spy.capacity_calls == cfg.llm.num_hidden_layers


# ---------------------------------------------------------------------------
# editing through the API, and the processor, with a PIL image
# ---------------------------------------------------------------------------


def _api_setup():
    """A tiny model whose encoder patch is the processor's 32 px, the test
    tokenizer, and processors that resize to 128 px (understanding) / 64 px
    (generation and editing: a 2 x 2 patch grid, the encoder's own)."""
    from mingunivision_tpu.processing.tokenizer import build_test_tokenizer

    tok = build_test_tokenizer()
    ids = {name: tok.convert_tokens_to_ids(t) for name, t in
           (("image_start_token", "<image>"), ("image_patch_token", "<imagePatch>"), ("eos_token_id", "<|endoftext|>"))}
    base = tiny_mm(vocab_size=len(tok) + 8, **ids)
    mingtok = MingTokConfig(
        encoder=ViTEncoderConfig(img_size=64, patch_size=32, embed_dim=64, depth=1, num_heads=1, out_dim=8),
        semantic_decoder=SemanticDecoderConfig(in_dim=8, embed_dim=64, depth=2, num_heads=2, patch_size=32),
        pixel_decoder=PixelDecoderConfig(embed_dim=64, depth=2, num_heads=2, patch_size=16, ffn_layer="mlp"),
        scaling_factor=2.0, mean=0.5)
    cfg = dataclasses.replace(base, mingtok=mingtok)
    return tok, cfg, dict(und_image_size=128, gen_image_size=64)


def _pil_image(seed=9, size=(80, 56)):
    from PIL import Image

    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, size + (3,), dtype=np.uint8))


@pytest.mark.parametrize("for_edit", [False, True], ids=["understanding", "editing"])
def test_processor_on_a_pil_image_matches_jax(for_edit):
    tok, _, sizes = _api_setup()
    messages = [{"role": "HUMAN", "content": [{"type": "image", "image": _pil_image()},
                                              {"type": "text", "text": "make the cat brown"}]}]
    outs = []
    for cls in (JaxProcessor, BailingMMProcessor):
        proc = cls(tok, **sizes)
        text = proc.apply_chat_template(messages, add_generation_prompt=True)
        outs.append(proc(text=text, images=proc.process_vision_info(messages), for_edit=for_edit))
    want, got = outs
    for name in ("input_ids", "attention_mask", "uncond_attention_mask", "text_uncond_attention_mask",
                 "pixel_values", "image_grid_thw"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    side = 64 if for_edit else 128
    assert got.pixel_values.shape == (1, 3, side, side) and got.image_grid_thw.tolist() == [[1, side // 32, side // 32]]
    n_patch = int((got.input_ids == tok.convert_tokens_to_ids("<imagePatch>")).sum())
    assert n_patch == (side // 32) ** 2
    # the image tokens stay in the text-uncond row and leave the uncond row
    assert got.text_uncond_attention_mask.sum() > got.uncond_attention_mask.sum()


def test_editing_through_the_api_matches_jax(tmp_path):
    """Image + edit request, for_edit=True: the encoder's features scattered
    over the prompt, three CFG rows in the image loop, RF noise off."""
    tok, cfg, sizes = _api_setup()
    params = random_params(cfg, seed=4)
    messages = [{"role": "HUMAN", "content": [{"type": "image", "image": _pil_image()},
                                              {"type": "text", "text": "make the cat brown"}]}]
    runtime = RuntimeConfig(max_seq_len=192, compute_dtype="float32")
    kw = dict(max_new_tokens=1, for_edit=True, image_gen_temperature=0.0)

    def port_api():
        return MingUniVisionInfer(params=params_from_jax(params, "cpu", torch.float32), config=cfg, runtime=runtime,
                                  processor=BailingMMProcessor(tok, **sizes), device="cpu")

    # make greedy decoding pick <image>: its lm_head column at +10 or -10, whichever the port's round picks it with
    col = params["llm"]["lm_head"]["w"][:, cfg.llm.image_start_token]
    col[:] = 10.0
    if port_api().generate(messages, output_image_prefix=str(tmp_path / "probe"), **kw) != "<image>":
        col[:] = -10.0
    api = port_api()
    got = api.generate(messages, output_image_prefix=str(tmp_path / "port"), **kw)
    want_api = JaxInfer(params=to_jax(params), config=cfg, runtime=runtime, processor=JaxProcessor(tok, **sizes))
    want = want_api.generate(messages, output_image_prefix=str(tmp_path / "jax"), **kw)
    assert got == want == "<image>"
    assert api.session.timings["cfg_rows"] == 3 and api.session.timings["encode_ms"] > 0
    assert api.session.seq_len == want_api.session.seq_len
    assert api.last_images[0].shape == (3, 64, 64)
    np.testing.assert_allclose(api.last_images[0], want_api.last_images[0], atol=ATOL)


@pytest.mark.parametrize("tier", [None, "default", "bf16"])
def test_api_applies_the_pixel_decoder_tier(tier):
    tok, cfg, _ = _api_setup()
    tree = {"llm": {"norm": {"w": torch.ones(4)}, "layers": {"mlp": {"experts": {"gate_proj": torch.ones(1)}}}}}
    api = MingUniVisionInfer(params=tree, config=cfg, runtime=RuntimeConfig(pixdec_matmul_precision=tier),
                             tokenizer=tok, device="cpu")
    assert api.config.mingtok.pixel_decoder.matmul_precision == (tier or "high")
    assert dataclasses.replace(api.config, mingtok=cfg.mingtok) == cfg  # everything else untouched
