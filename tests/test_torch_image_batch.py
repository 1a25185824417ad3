"""PyTorch port, several images per request: `generate_image_tokens(n_images=)`
with block-major CFG rows, the session's and the API's `n_images`, and the
barrier batcher `serving/image_batch.batched_image_generation`, each against
the JAX package on a tiny config at fp32 on the CPU with the RF noise off on
both sides (temperature 0: the two frameworks draw different noise), within
IMAGE_ATOL = 1e-3 (images and semantic tokens). With the noise on: image 0 of
a batch does not depend on the batch size, and one image draws the noise it
drew before the port took several."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import GenerationConfig, ImageGenConfig
from mingunivision_tpu.config import RuntimeConfig as JaxRuntimeConfig
from mingunivision_tpu.engine.generate import generate_image_tokens as jax_generate_image_tokens
from mingunivision_tpu.engine.generate import prefill as jax_prefill
from mingunivision_tpu.engine.session import MingUniVisionSession as JaxSession
from mingunivision_tpu.models.bailing_moe import LLMCache as JaxCache
from mingunivision_tpu.models.bailing_moe import embed_tokens as jax_embed
from mingunivision_tpu.serving.image_batch import batched_image_generation as jax_batched
from mingunivision_tpu_torch.config import RuntimeConfig
from mingunivision_tpu_torch.engine import generate as port_generate
from mingunivision_tpu_torch.engine.generate import generate_image_tokens, prefill
from mingunivision_tpu_torch.engine.session import MingUniVisionSession
from mingunivision_tpu_torch.models.bailing_moe import LLMCache, embed_tokens
from mingunivision_tpu_torch.serving.image_batch import batched_image_generation
from mingunivision_tpu_torch.utils.convert import params_from_jax

from test_torch_common import IMG_START, random_params, tiny_mm, to_jax
from test_torch_slice import _bias_image_start, _t2i_prompt

IMAGE_ATOL = 1e-3
SMAX = 192
GEN = ImageGenConfig(num_image_tokens=4, temperature=0.0)  # RF noise off on both sides


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_mm()
    params = random_params(cfg, seed=1)
    _bias_image_start(params, cfg, _t2i_prompt(2)[0])
    return cfg, params, to_jax(params), params_from_jax(params, "cpu", torch.float32)


def _request(rng, T, text_row=False):
    """A processor-output dict of T random ids: the uncond row masks the
    second half; with `text_row`, a distinct text-uncond row."""
    ids = rng.integers(20, 400, (1, T))
    am = np.ones((1, T), np.int64)
    um = am.copy()
    um[:, T // 2 :] = 0
    out = {"input_ids": ids, "attention_mask": am, "uncond_attention_mask": um}
    if text_row:
        tm = um.copy()
        tm[:, 1] = 0
        out["text_uncond_attention_mask"] = tm
    return out


def _block_major_inputs(requests, cfg_rows, bucket=64):
    """(ids (n, bucket), block-major row masks (cfg_rows * n, SMAX) bool) of
    requests padded to one bucket: [conds | unconds (| text_unconds)]."""
    n = len(requests)
    ids = np.zeros((n, bucket), np.int64)
    masks = np.zeros((3, n, SMAX), bool)
    for i, r in enumerate(requests):
        T = r["input_ids"].shape[1]
        ids[i, :T] = r["input_ids"][0]
        um = r["uncond_attention_mask"][0]
        for block, m in enumerate((r["attention_mask"][0], um, r.get("text_uncond_attention_mask", [um])[0])):
            masks[block, i, :T] = m.astype(bool)
    return ids, masks[:cfg_rows].reshape(cfg_rows * n, SMAX)


@pytest.mark.parametrize("cfg_rows,n", [(2, 2), (3, 2), (3, 3)], ids=["2rows-2img", "3rows-2img", "3rows-3img"])
def test_generate_image_tokens_block_major_matches_jax(setup, cfg_rows, n):
    """Prompts of different lengths, one batched prefill, the cache tiled over
    the CFG rows: a transposed layout would mix the images' rows."""
    cfg, params, jparams, tparams = setup
    rng = np.random.default_rng(5)
    reqs = [_request(rng, T, text_row=True) for T in (5, 11, 8)[:n]]
    ids, row_masks = _block_major_inputs(reqs, cfg_rows)
    cond = row_masks[:n]

    jcache = JaxCache.create(cfg.llm, n, SMAX, jnp.float32)
    _, jcache = jax_prefill(jparams["llm"], cfg.llm, jax_embed(jparams["llm"], jnp.asarray(ids)), jcache,
                            jnp.asarray(cond))
    jcache = JaxCache(jnp.tile(jcache.k, (1, cfg_rows, 1, 1, 1)), jnp.tile(jcache.v, (1, cfg_rows, 1, 1, 1)),
                      jnp.int32(ids.shape[1]))
    jstart = jax_embed(jparams["llm"], jnp.asarray([[IMG_START]]))
    want = jax_generate_image_tokens(jparams, cfg.llm, cfg.mingtok, cfg.rf_head, GEN, jstart, jcache,
                                     jnp.asarray(row_masks), jax.random.PRNGKey(0), cfg_rows=cfg_rows, n_images=n)

    cache = LLMCache.create(cfg.llm, n, SMAX, torch.float32)
    _, cache = prefill(tparams["llm"], cfg.llm, embed_tokens(tparams["llm"], torch.as_tensor(ids)), cache,
                       torch.as_tensor(cond))
    cache = LLMCache(cache.k.repeat(1, cfg_rows, 1, 1, 1), cache.v.repeat(1, cfg_rows, 1, 1, 1), ids.shape[1])
    start = embed_tokens(tparams["llm"], torch.tensor([[IMG_START]]))
    gens = [torch.Generator().manual_seed(i) for i in range(n)]
    got = generate_image_tokens(tparams, cfg.llm, cfg.mingtok, cfg.rf_head, GEN, start, cache,
                                torch.as_tensor(row_masks), generators=gens, cfg_rows=cfg_rows, n_images=n)
    assert got.sem_tokens.shape == (n, 4, cfg.mingtok.feature_dim) and got.last_hidden.shape[:2] == (n, 1)
    np.testing.assert_allclose(got.sem_tokens.numpy(), np.asarray(want.sem_tokens), atol=IMAGE_ATOL)
    np.testing.assert_allclose(got.last_hidden.numpy(), np.asarray(want.last_hidden), atol=IMAGE_ATOL)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    with pytest.raises(ValueError, match="generator"):
        generate_image_tokens(tparams, cfg.llm, cfg.mingtok, cfg.rf_head, GEN, start, cache,
                              torch.as_tensor(row_masks), cfg_rows=cfg_rows, n_images=n)


@pytest.mark.parametrize("rows", [2, 3], ids=["t2i-2rows", "edit-style-3rows"])
def test_session_n_images_matches_jax(setup, rows):
    cfg, params, jparams, tparams = setup
    ids, am, um, tm = _t2i_prompt(rows)
    runtime = JaxRuntimeConfig(max_seq_len=SMAX, compute_dtype="float32")
    kw = dict(uncond_attention_mask=um, text_uncond_attention_mask=tm, generation=GenerationConfig(max_new_tokens=2),
              image_gen=GEN, n_images=2)
    want_sess = JaxSession(jparams, cfg, runtime, seed=0)
    want = want_sess.generate(ids, am, **kw)
    sess = MingUniVisionSession(tparams, cfg, RuntimeConfig(max_seq_len=SMAX, compute_dtype="float32"), seed=0,
                                device="cpu")
    got = sess.generate(ids, am, **kw)
    assert got.token_ids == want.token_ids and got.token_ids[0] == IMG_START
    assert sess.timings["cfg_rows"] == rows and sess.timings["n_images"] == 2
    assert len(got.images) == len(want.images) == 2
    for g, w in zip(got.images, want.images):
        np.testing.assert_allclose(g, w, atol=IMAGE_ATOL)
    # the conversation goes on from variant 0's row
    assert sess.seq_len == want_sess.seq_len and sess.cache.k.shape[1] == 1
    np.testing.assert_array_equal(sess.mask.numpy(), np.asarray(want_sess.mask))


def test_api_n_images_writes_every_image_as_jax(tmp_path):
    from PIL import Image

    from mingunivision_tpu.api import MingUniVisionInfer as JaxInfer
    from mingunivision_tpu.processing.tokenizer import build_test_tokenizer
    from mingunivision_tpu_torch.api import MingUniVisionInfer

    tok = build_test_tokenizer()
    cfg = tiny_mm(vocab_size=len(tok) + 8, image_start_token=tok.convert_tokens_to_ids("<image>"),
                  image_patch_token=tok.convert_tokens_to_ids("<imagePatch>"),
                  eos_token_id=tok.convert_tokens_to_ids("<|endoftext|>"))
    params = random_params(cfg, seed=2)
    messages = [{"role": "HUMAN", "content": "two pictures of a cat"}]
    probe = JaxInfer(params=to_jax(params), config=cfg, runtime=JaxRuntimeConfig(max_seq_len=192), tokenizer=tok)
    _bias_image_start(params, cfg, probe.processor(text=probe.processor.apply_chat_template(messages)).input_ids)
    rt = dict(max_seq_len=SMAX, compute_dtype="float32")
    want_api = JaxInfer(params=to_jax(params), config=cfg, tokenizer=tok, runtime=JaxRuntimeConfig(**rt))
    api = MingUniVisionInfer(params=params_from_jax(params, "cpu", torch.float32), config=cfg, tokenizer=tok,
                             runtime=RuntimeConfig(**rt), device="cpu")
    texts, names = {}, {}
    for side, infer in (("jax", want_api), ("port", api)):
        (tmp_path / side).mkdir()
        texts[side] = infer.generate(messages, 2, str(tmp_path / side / "out"), image_gen_temperature=0.0,
                                     n_images=2)
        names[side] = sorted(p.name for p in (tmp_path / side).iterdir())
    assert texts["port"] == texts["jax"]
    assert names["port"] == names["jax"] == ["out.png", "out_1.png"] and len(api.last_images) == 2
    for name, img in zip(names["port"], api.last_images):
        want = np.asarray(Image.open(tmp_path / "jax" / name).convert("RGB")).astype(np.int32)
        got = np.asarray(Image.open(tmp_path / "port" / name).convert("RGB")).astype(np.int32)
        assert np.abs(got - want).max() <= 1  # one 8-bit step: the images agree within IMAGE_ATOL
    np.testing.assert_allclose(api.last_images[1], want_api.last_images[1], atol=IMAGE_ATOL)


def test_batched_image_generation_matches_jax(setup):
    """Three prompts of different lengths (one with a distinct text-uncond
    row), one batched prefill, 3 CFG rows each."""
    cfg, params, jparams, tparams = setup
    rng = np.random.default_rng(7)
    reqs = [_request(rng, 6), _request(rng, 13, text_row=True), _request(rng, 9)]
    rt = dict(max_seq_len=SMAX, compute_dtype="float32")
    want = jax_batched(jparams, cfg, JaxRuntimeConfig(**rt), reqs, jax.random.PRNGKey(0), igen=GEN)
    got = batched_image_generation(tparams, cfg, RuntimeConfig(**rt), reqs, 0, igen=GEN)
    assert got.shape == want.shape == (3, 3, 32, 32)
    np.testing.assert_allclose(got, want, atol=IMAGE_ATOL)
    assert np.abs(got[0] - got[1]).max() > 1e-2  # the images differ


def test_image0_invariant_to_batch_size(setup):
    """With the noise on: image 0 of a two-request batch is image 0 of the
    same request alone (its generator is seeded `seed + 0` in both)."""
    cfg, _, _, tparams = setup
    rng = np.random.default_rng(11)
    a, b = _request(rng, 6), _request(rng, 10)
    rt = RuntimeConfig(max_seq_len=SMAX, compute_dtype="float32")
    igen = ImageGenConfig(num_image_tokens=4, temperature=1.0)
    solo = batched_image_generation(tparams, cfg, rt, [a], 42, igen=igen)
    duo = batched_image_generation(tparams, cfg, rt, [a, b], 42, igen=igen)
    np.testing.assert_allclose(duo[0], solo[0], rtol=1e-4, atol=1e-5)
    other = batched_image_generation(tparams, cfg, rt, [a], 43, igen=igen)
    assert np.abs(other[0] - solo[0]).max() > 1e-3  # the noise acts


def test_one_image_draws_the_noise_it_drew_before(setup, monkeypatch):
    """n_images=1 with `generator`: one (1, C) draw per token from it, the
    rows every caller saw before several images were ported; `generators=[g]`
    draws the same."""
    cfg, _, _, tparams = setup
    ids, am, um, tm = _t2i_prompt(2)
    seen = []
    sample = port_generate.rf_sample

    def capture(*args, noise, **kwargs):
        seen.append(noise.clone())
        return sample(*args, noise=noise, **kwargs)

    monkeypatch.setattr(port_generate, "rf_sample", capture)
    igen = ImageGenConfig(num_image_tokens=4, temperature=1.0)
    sess = MingUniVisionSession(tparams, cfg, RuntimeConfig(max_seq_len=SMAX, compute_dtype="float32"), seed=3,
                                device="cpu")
    sess.generate(ids, am, uncond_attention_mask=um, generation=GenerationConfig(max_new_tokens=1), image_gen=igen)
    g = torch.Generator().manual_seed(3)  # greedy token samples draw nothing from the session's generator
    want = [torch.randn((1, cfg.rf_head.target_channels), generator=g) for _ in range(4)]
    assert len(seen) == 4 and all(s.shape == (1, cfg.rf_head.target_channels) for s in seen)
    for s, w in zip(seen, want):
        torch.testing.assert_close(s, w, rtol=0, atol=0)
