"""PyTorch port, the slice: text-to-image through the port's session and API
against the JAX package's, on a tiny config at fp32 on the CPU, and the
jax-free import of the port."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.api import MingUniVisionInfer as JaxInfer
from mingunivision_tpu.config import GenerationConfig, ImageGenConfig, RuntimeConfig
from mingunivision_tpu.engine.generate import prefill as jax_prefill
from mingunivision_tpu.engine.session import MingUniVisionSession as JaxSession
from mingunivision_tpu.models.bailing_moe import LLMCache, embed_tokens
from mingunivision_tpu.processing.processor import build_cfg_masks
from mingunivision_tpu_torch.api import MingUniVisionInfer
from mingunivision_tpu_torch.engine.session import MingUniVisionSession
from mingunivision_tpu_torch.utils.convert import params_from_jax

from test_torch_common import IMG_START, random_params, tiny_mm, to_jax

IMAGE_ATOL = 1e-3
USER, ASSISTANT = [11, 12, 13], [11, 14, 13]  # stand-ins for the role-prefix id runs


def _bias_image_start(params, cfg, ids):
    """Make greedy decoding pick <image> after the prompt: set its lm_head
    column to +-10, the sign chosen by a probe prefill of the prompt."""
    col = params["llm"]["lm_head"]["w"]
    col[:, cfg.llm.image_start_token] = 10.0
    T = ids.shape[1]
    mask = jnp.zeros((1, 128), bool).at[:, :T].set(True)
    ids_pad = np.zeros((1, 128), np.int64)
    ids_pad[:, :T] = ids
    llm = to_jax(params["llm"])
    logits, _ = jax_prefill(llm, cfg.llm, embed_tokens(llm, jnp.asarray(ids_pad)), LLMCache.create(cfg.llm, 1, 128, jnp.float32), mask)
    if float(logits[0, cfg.llm.image_start_token]) < 0:
        col[:, cfg.llm.image_start_token] = -10.0


def _t2i_prompt(rows: int):
    ids = USER + list(np.random.default_rng(3).integers(20, 400, 9)) + ASSISTANT
    uncond, text_uncond = build_cfg_masks(ids, USER, ASSISTANT, {IMG_START})
    if rows == 3:  # an edit-style text-uncond row that differs from the uncond row
        text_uncond = list(text_uncond)
        text_uncond[5] = 1
    row = lambda a: np.asarray([a], np.int64)  # noqa: E731
    return row(ids), row([1] * len(ids)), row(uncond), row(text_uncond)


@pytest.fixture(scope="module")
def slice_setup():
    cfg = tiny_mm()
    params = random_params(cfg, seed=1)
    ids = _t2i_prompt(2)[0]
    _bias_image_start(params, cfg, ids)
    return cfg, params


@pytest.mark.parametrize("rows", [2, 3], ids=["t2i-2rows", "edit-style-3rows"])
def test_session_generate_matches_jax(slice_setup, rows):
    cfg, params = slice_setup
    ids, am, um, tm = _t2i_prompt(rows)
    runtime = RuntimeConfig(max_seq_len=192, compute_dtype="float32")
    kw = dict(uncond_attention_mask=um, text_uncond_attention_mask=tm, generation=GenerationConfig(max_new_tokens=1),
              image_gen=ImageGenConfig(num_image_tokens=4, temperature=0.0))  # RF noise off on both sides
    want_sess = JaxSession(to_jax(params), cfg, runtime, seed=0)
    want = want_sess.generate(ids, am, **kw)
    sess = MingUniVisionSession(params_from_jax(params, "cpu", torch.float32), cfg, runtime, seed=0, device="cpu")
    got = sess.generate(ids, am, **kw)
    assert got.token_ids == want.token_ids == [IMG_START]
    assert sess.seq_len == want_sess.seq_len == ids.shape[1] + 5
    assert sess.timings["cfg_rows"] == rows
    assert len(got.images) == len(want.images) == 1 and got.images[0].shape == (3, 32, 32)
    np.testing.assert_allclose(got.images[0], want.images[0], atol=IMAGE_ATOL)
    np.testing.assert_array_equal(sess.text_uncond_mask.numpy(), np.asarray(want_sess.text_uncond_mask))


@pytest.mark.parametrize("past_mode", ["DROP", "KEEP"])
def test_multi_round_text_decode_matches_jax(slice_setup, past_mode):
    """Two text rounds: the cache and persisted masks carry over as in the JAX session."""
    cfg, params = slice_setup
    p = {**params, "llm": {**params["llm"], "lm_head": {"w": params["llm"]["lm_head"]["w"].copy()}}}
    p["llm"]["lm_head"]["w"][:, IMG_START] = 0.0  # text only
    runtime = RuntimeConfig(max_seq_len=640, compute_dtype="float32", past_mode=past_mode)
    want_sess = JaxSession(to_jax(p), cfg, runtime, seed=0)
    sess = MingUniVisionSession(params_from_jax(p, "cpu", torch.float32), cfg, runtime, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    for n in (5, 3):
        ids = rng.integers(20, 400, (1, n))
        am = np.ones((1, n), np.int64)
        um = am.copy()
        um[:, 1:] = 0
        gen = GenerationConfig(max_new_tokens=4)
        want = want_sess.generate(ids, am, uncond_attention_mask=um, generation=gen)
        got = sess.generate(ids, am, uncond_attention_mask=um, generation=gen)
        assert got.token_ids == want.token_ids
        assert sess.seq_len == want_sess.seq_len
        for name in ("mask", "uncond_mask", "text_uncond_mask"):
            np.testing.assert_array_equal(getattr(sess, name).numpy(), np.asarray(getattr(want_sess, name)), err_msg=name)
    sess.reset_inner_state()
    assert sess.seq_len == 0 and sess.cache is None


def test_infer_generate_with_test_tokenizer_matches_jax(tmp_path):
    from mingunivision_tpu.processing.tokenizer import build_test_tokenizer

    tok = build_test_tokenizer()
    cfg = tiny_mm(vocab_size=len(tok) + 8, image_start_token=tok.convert_tokens_to_ids("<image>"),
                  image_patch_token=tok.convert_tokens_to_ids("<imagePatch>"),
                  eos_token_id=tok.convert_tokens_to_ids("<|endoftext|>"))
    params = random_params(cfg, seed=2)
    messages = [{"role": "HUMAN", "content": "generate a picture of a cat on a table"}]
    probe = JaxInfer(params=to_jax(params), config=cfg, runtime=RuntimeConfig(max_seq_len=192), tokenizer=tok)
    batch = probe.processor(text=probe.processor.apply_chat_template(messages))
    _bias_image_start(params, cfg, batch.input_ids)
    runtime = RuntimeConfig(max_seq_len=192, compute_dtype="float32")
    kw = dict(max_new_tokens=1, image_gen_temperature=0.0)
    want_api = JaxInfer(params=to_jax(params), config=cfg, runtime=runtime, tokenizer=tok)
    want = want_api.generate(messages, output_image_prefix=str(tmp_path / "jax"), **kw)
    api = MingUniVisionInfer(params=params_from_jax(params, "cpu", torch.float32), config=cfg, runtime=runtime,
                             tokenizer=tok, device="cpu")
    got = api.generate(messages, **kw)
    assert got == want == "<image>"
    assert api.session.timings["cfg_rows"] == 2  # text-only prompt: uncond == text-uncond
    np.testing.assert_allclose(api.last_images[0], want_api.last_images[0], atol=IMAGE_ATOL)


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mingunivision_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'mingunivision_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 20, names\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
