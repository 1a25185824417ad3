"""PyTorch port, the tiers this slice opens: the int4 tier with exact-dequant
decode (`moe_int_dots=False`), the NF4 tier (`param_dtype="int4-nf4"`, plain
dequant: the JAX package has no NF4 kernel), the s8 prefill and the s8 int8
sampler (`moe_prefill_int_dots`, `rf_int_dots`), through the port's session
and both serving engines on a tiny config at fp32 on the CPU, against the JAX
package on the same quantized trees; and `MingUniVisionInfer.generate` called
positionally as the JAX API is, writing the same PNG files.

On the CPU the JAX package takes no Pallas kernel: its quantized sessions
compute an EXACT dequant (gathered experts, dense prefill, the XLA Euler
loop). Hence:
  - int4 with exact decode, the port's fused sampler swapped for its Euler
    loop (the int4 slice test's idiom): the JAX session's tokens and image
    within IMAGE_ATOL = 1e-3; as shipped (the s8 sampler): the same tokens, an
    image within twice the JAX session's int4-vs-fp32 gap;
  - NF4: both sides plain dequant, tokens equal and the image within 1e-3;
  - int8 with both new fields on (s8 prefill, s8 sampler): the same tokens, an
    image within twice the JAX int8-vs-fp32 gap; the int4 understanding round
    with the s8 prefill through flash and the capacity dispatch: the same
    tokens, hidden states within twice the JAX int4-vs-fp32 gap;
  - the engines: the JAX engines' greedy tokens.
"""

import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.api import MingUniVisionInfer as JaxInfer
from mingunivision_tpu.config import GenerationConfig, ImageGenConfig
from mingunivision_tpu.config import RuntimeConfig as JaxRuntimeConfig
from mingunivision_tpu.engine.batch_engine import ContinuousBatchingEngine as JaxEngine
from mingunivision_tpu.engine.paged import PagedBatchingEngine as JaxPaged
from mingunivision_tpu.engine.session import MingUniVisionSession as JaxSession
from mingunivision_tpu.utils.quantize import quantize_tree
from mingunivision_tpu_torch.api import MingUniVisionInfer
from mingunivision_tpu_torch.config import RuntimeConfig
from mingunivision_tpu_torch.engine.batch_engine import ContinuousBatchingEngine
from mingunivision_tpu_torch.engine.paged import PagedBatchingEngine
from mingunivision_tpu_torch.engine.session import MingUniVisionSession
from mingunivision_tpu_torch.models import bailing_moe, rf_head
from mingunivision_tpu_torch.ops.kernels import moe_stream, moe_swiglu_gmm, rf_sampler
from mingunivision_tpu_torch.utils.convert import params_from_jax

from test_torch_common import IMG_START, random_params, tiny_mm, to_jax
from test_torch_slice import _bias_image_start, _t2i_prompt
from test_torch_slice_image import _image_prompt, _pixels

IMAGE_ATOL = 1e-3
MIN_SIZE = 1024  # the tiny tables are far below the 65536-element default
RUNTIME = RuntimeConfig(max_seq_len=192, compute_dtype="float32")
# the tiers: (bits, scheme) of the LLM and the RF head
TIERS = {"int4": (4, "linear"), "nf4": (4, "nf4"), "int8": (8, "linear")}


def _quantized(params, tier):
    bits, scheme = TIERS[tier]
    q = dict(params)
    for key in ("llm", "rf_head"):
        q[key] = quantize_tree(to_jax(params[key]), bits=bits, min_size=MIN_SIZE, scheme=scheme)
    return q


def _jax_round(cfg, params, prompt, runtime=JaxRuntimeConfig(max_seq_len=192, compute_dtype="float32")):
    ids, am, kw = prompt
    sess = JaxSession(to_jax(params), cfg, runtime, seed=0)
    return sess.generate(ids, am, **kw), sess


def _port_round(cfg, qparams, prompt, runtime=RUNTIME):
    ids, am, kw = prompt
    sess = MingUniVisionSession(params_from_jax(qparams, "cpu", torch.float32), cfg, runtime, seed=0, device="cpu")
    return sess.generate(ids, am, **kw), sess


class _Count:
    """Counts the calls of a module attribute."""

    def __init__(self, monkeypatch, mod, name):
        self.n, fn = 0, getattr(mod, name)

        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)


def _within_tier_gap(got, want, want_f32):
    """The port's image within twice the JAX session's quantized-vs-fp32 gap."""
    tier_gap = float(np.abs(want.images[0] - want_f32.images[0]).max())
    err = float(np.abs(got.images[0] - want.images[0]).max())
    assert 0 < tier_gap and np.isfinite(got.images[0]).all()
    assert err <= 2 * tier_gap, (err, tier_gap)


@pytest.fixture(scope="module")
def t2i():
    cfg = tiny_mm()
    params = random_params(cfg, seed=1)
    _bias_image_start(params, cfg, _t2i_prompt(2)[0])
    ids, am, um, tm = _t2i_prompt(2)
    prompt = (ids, am, dict(uncond_attention_mask=um, text_uncond_attention_mask=tm,
                            generation=GenerationConfig(max_new_tokens=1),
                            image_gen=ImageGenConfig(num_image_tokens=4, temperature=0.0)))
    trees = {tier: _quantized(params, tier) for tier in TIERS}
    want = {tier: _jax_round(cfg, tree, prompt)[0] for tier, tree in trees.items()}
    return cfg, trees, prompt, want, _jax_round(cfg, params, prompt)[0]


# ---------------------------------------------------------------------------
# int4 with exact-dequant decode
# ---------------------------------------------------------------------------


def test_int4_exact_decode_session_matches_jax(t2i, monkeypatch):
    cfg, trees, prompt, want, _ = t2i
    exact = _Count(monkeypatch, moe_stream, "moe_experts_stream_q4_plain")
    monkeypatch.setattr(rf_head, "rf_sampler_supported", lambda *a: False)
    got, sess = _port_round(cfg, trees["int4"], prompt, dataclasses.replace(RUNTIME, moe_int_dots=False))
    assert got.token_ids == want["int4"].token_ids == [IMG_START] and sess.timings["cfg_rows"] == 2
    assert exact.n == cfg.llm.num_hidden_layers * (cfg.image_gen.num_image_tokens + 1)  # every image-loop LLM step
    np.testing.assert_allclose(got.images[0], want["int4"].images[0], atol=IMAGE_ATOL)


def test_int4_exact_decode_as_shipped_within_the_tier_error(t2i, monkeypatch):
    cfg, trees, prompt, want, want_f32 = t2i
    sampler = _Count(monkeypatch, rf_sampler, "rf_sample_fused_plain")  # the int4 RF head keeps its s8 sampler
    got, _ = _port_round(cfg, trees["int4"], prompt, dataclasses.replace(RUNTIME, moe_int_dots=False))
    assert got.token_ids == want["int4"].token_ids == [IMG_START]
    assert sampler.n == cfg.image_gen.num_image_tokens
    _within_tier_gap(got, want["int4"], want_f32)


# ---------------------------------------------------------------------------
# NF4: plain dequant on both sides
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int_dots", [True, False], ids=["as-shipped", "moe_int_dots-off"])
def test_nf4_session_matches_jax(t2i, monkeypatch, int_dots):
    cfg, trees, prompt, want, _ = t2i
    nf4 = _Count(monkeypatch, moe_stream, "moe_experts_nf4")
    sampler = _Count(monkeypatch, rf_sampler, "rf_sample_fused_plain")
    got, sess = _port_round(cfg, trees["nf4"], prompt, dataclasses.replace(RUNTIME, moe_int_dots=int_dots))
    tree = sess.params
    assert tree["llm"]["layers"]["mlp"]["experts"]["gate_proj"].scheme == "nf4"
    assert tree["rf_head"]["res_blocks"]["mlp"]["w12"]["w"].scheme == "nf4"
    assert got.token_ids == want["nf4"].token_ids == [IMG_START]
    assert nf4.n == cfg.llm.num_hidden_layers * (cfg.image_gen.num_image_tokens + 1) and sampler.n == 0
    np.testing.assert_allclose(got.images[0], want["nf4"].images[0], atol=IMAGE_ATOL)


# ---------------------------------------------------------------------------
# int8 with the s8 prefill and the s8 sampler; int4 understanding with the s8 prefill
# ---------------------------------------------------------------------------


def test_int8_with_s8_prefill_and_s8_sampler_within_the_tier_error(t2i, monkeypatch):
    cfg, trees, prompt, want, want_f32 = t2i
    prefill = _Count(monkeypatch, moe_swiglu_gmm, "_rows_q8s8")
    sampler = _Count(monkeypatch, rf_sampler, "_mlp_q8s8")
    runtime = dataclasses.replace(RUNTIME, moe_prefill_int_dots=True, rf_int_dots=True)
    got, _ = _port_round(cfg, trees["int8"], prompt, runtime)
    assert got.token_ids == want["int8"].token_ids == [IMG_START]
    assert prefill.n > 0  # the 128-token prompt's prefill, expert by expert
    L, S, n_tok = cfg.rf_head.depth, cfg.rf_head.num_sampling_steps, cfg.image_gen.num_image_tokens
    assert sampler.n == n_tok * S * L
    _within_tier_gap(got, want["int8"], want_f32)


def test_int4_understanding_with_s8_prefill_through_flash_and_capacity(monkeypatch):
    """A prompt padded to 512 (flash prefill, the capacity dispatch over the
    int4 s8 prefill's plain version), then text decode."""
    cfg = tiny_mm()
    params = random_params(cfg, seed=3)
    params["llm"]["lm_head"]["w"][:, IMG_START] = 0.0  # text replies only
    q4 = _quantized(params, "int4")
    capacity = _Count(monkeypatch, bailing_moe, "moe_experts_capacity_gmm_exact")
    s8_rows = _Count(monkeypatch, moe_swiglu_gmm, "_rows_q4s8")
    ids, am, um, tm = _image_prompt(16, 420, seed=5)  # 444 ids -> the 512 bucket
    prompt = (ids, am, dict(uncond_attention_mask=um, text_uncond_attention_mask=tm, pixel_values=_pixels(6, 64),
                            generation=GenerationConfig(max_new_tokens=4)))
    jrt = JaxRuntimeConfig(max_seq_len=768, compute_dtype="float32")
    want, want_sess = _jax_round(cfg, q4, prompt, jrt)
    _, want_f32 = _jax_round(cfg, params, prompt, jrt)
    got, sess = _port_round(cfg, q4, prompt, RuntimeConfig(max_seq_len=768, compute_dtype="float32",
                                                           moe_prefill_int_dots=True))
    assert got.token_ids == want.token_ids and len(got.token_ids) == 4 and not got.images
    assert sess.timings["prefill_tokens"] == 512 and sess.timings["use_flash"]
    assert capacity.n == cfg.llm.num_hidden_layers and s8_rows.n > 0
    gap = float(np.abs(want_sess.last_hidden_states - want_f32.last_hidden_states).max())
    err = float(np.abs(sess.last_hidden_states - want_sess.last_hidden_states).max())
    assert 0 < gap and err <= 2 * gap, (err, gap)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("tier", ["int4-exact", "nf4"])
def test_engines_match_jax(tier, pool):
    """Two greedy requests, the second admitted mid-flight (two steps after the
    first), with an int4 LLM in the exact dot mode or an NF4 LLM: the JAX
    engine's tokens."""
    cfg = tiny_mm()
    params = random_params(cfg, seed=4)
    bits, scheme = TIERS["nf4" if tier == "nf4" else "int4"]
    jllm = quantize_tree(to_jax(params["llm"]), bits=bits, min_size=MIN_SIZE, scheme=scheme)
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

    kw = dict(slots=3, max_len=256)
    if pool == "paged":
        want = drive(JaxPaged(jllm, cfg.llm, page_size=32, dtype=jnp.float32, **kw))
        got = drive(PagedBatchingEngine(tllm, cfg.llm, page_size=32, dtype=torch.float32, int_dots=False, **kw))
    else:
        want = drive(JaxEngine(jllm, cfg.llm, dtype=jnp.float32, **kw))
        got = drive(ContinuousBatchingEngine(tllm, cfg.llm, dtype=torch.float32, int_dots=False, **kw))
    assert got == want and all(len(t) == 8 for t in got)


# ---------------------------------------------------------------------------
# MingUniVisionInfer.generate: the JAX API's positional arguments and PNG files
# ---------------------------------------------------------------------------


def _read_png(path):
    """An 8-bit RGB PNG with no interlace -> uint8 (H, W, 3), by zlib (the five row filters undone)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        header = body if kind == b"IHDR" else header
        idat += body if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", header)
    assert (depth, colour, interlace) == (8, 2, 0)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        up = out[y - 1] if y else np.zeros(3 * w, np.int32)
        for x in range(3 * w):
            left = out[y, x - 3] if x >= 3 else 0
            ul = up[x - 3] if x >= 3 else 0
            p = left + up[x] - ul
            pa, pb, pc = abs(p - left), abs(p - up[x]), abs(p - ul)
            pred = (0, left, up[x], (left + up[x]) // 2,
                    left if pa <= pb and pa <= pc else (up[x] if pb <= pc else ul))[f]
            out[y, x] = (line[x] + pred) & 0xFF
    return out.astype(np.uint8).reshape(h, w, 3)


def test_infer_generate_takes_the_jax_positional_arguments_and_writes_pngs(tmp_path):
    from PIL import Image

    from mingunivision_tpu.processing.tokenizer import build_test_tokenizer

    tok = build_test_tokenizer()
    cfg = tiny_mm(vocab_size=len(tok) + 8, image_start_token=tok.convert_tokens_to_ids("<image>"),
                  image_patch_token=tok.convert_tokens_to_ids("<imagePatch>"),
                  eos_token_id=tok.convert_tokens_to_ids("<|endoftext|>"))
    params = random_params(cfg, seed=2)
    messages = [{"role": "HUMAN", "content": "generate a picture of a cat on a table"}]
    probe = JaxInfer(params=to_jax(params), config=cfg, runtime=JaxRuntimeConfig(max_seq_len=192), tokenizer=tok)
    _bias_image_start(params, cfg, probe.processor(text=probe.processor.apply_chat_template(messages)).input_ids)
    want_api = JaxInfer(params=to_jax(params), config=cfg, tokenizer=tok,
                        runtime=JaxRuntimeConfig(max_seq_len=256, compute_dtype="float32"))
    api = MingUniVisionInfer(params=params_from_jax(params, "cpu", torch.float32), config=cfg, tokenizer=tok,
                             runtime=RuntimeConfig(max_seq_len=256, compute_dtype="float32"), device="cpu")
    texts, names = {}, {}
    for side, infer in (("jax", want_api), ("port", api)):
        (tmp_path / side).mkdir()
        # the steered head opens an image again after each one: the later images take the collision suffixes
        texts[side] = infer.generate(messages, 8, str(tmp_path / side / "out"), image_gen_temperature=0.0)
        names[side] = sorted(p.name for p in (tmp_path / side).iterdir())
    assert texts["port"] == texts["jax"] and texts["port"].startswith("<image>")
    assert names["port"] == names["jax"] and names["port"][:2] == ["out.png", "out_1.png"]
    assert len(names["port"]) == len(api.last_images)
    for name in names["port"]:
        want = np.asarray(Image.open(tmp_path / "jax" / name).convert("RGB"))
        got = _read_png(tmp_path / "port" / name)
        assert got.shape == want.shape == api.last_images[0].shape[1:] + (3,)
        np.testing.assert_array_equal(got, want)
    # what stays refused: no variant at all, and a checkpoint directory in place of params (ROADMAP Queue 1.3)
    with pytest.raises(ValueError, match="n_images"):
        api.generate(messages, 8, str(tmp_path / "port" / "out"), n_images=0)
    with pytest.raises(NotImplementedError, match="not ported"):
        MingUniVisionInfer(str(tmp_path / "checkpoint"), tokenizer=tok)
