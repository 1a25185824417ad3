"""PyTorch port, modules: each ported op and model module against its JAX
counterpart on the same numpy-seeded inputs and weights, at fp32 on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.models import bailing_moe as jbm
from mingunivision_tpu.models import mingtok as jmt
from mingunivision_tpu.models import rf_head as jrf
from mingunivision_tpu.models.vit import ViTCache as JViTCache
from mingunivision_tpu.ops import attention as jatt
from mingunivision_tpu.ops import linear as jlin
from mingunivision_tpu.ops import norms as jnorms
from mingunivision_tpu.ops import patching as jpatch
from mingunivision_tpu.ops import rope as jrope
from mingunivision_tpu.engine.generate import linear_proj_apply as jax_linear_proj
from mingunivision_tpu_torch.engine.generate import linear_proj_apply
from mingunivision_tpu_torch.engine.sampler import sample_token
from mingunivision_tpu_torch.models import bailing_moe as tbm
from mingunivision_tpu_torch.models import mingtok as tmt
from mingunivision_tpu_torch.models import rf_head as trf
from mingunivision_tpu_torch.ops import attention as tatt
from mingunivision_tpu_torch.ops import linear as tlin
from mingunivision_tpu_torch.ops import norms as tnorms
from mingunivision_tpu_torch.ops import patching as tpatch
from mingunivision_tpu_torch.ops import rope as trope
from mingunivision_tpu_torch.utils.convert import init_mm_params, params_from_jax
from mingunivision_tpu_torch.utils.pytree import layer_view

from test_torch_common import ATOL, random_params, tiny_mm, to_jax

TOL = dict(rtol=ATOL, atol=ATOL)


def _rng(seed):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_mm()
    params = random_params(cfg)
    return cfg, params, params_from_jax(params, "cpu", torch.float32), to_jax(params)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rms", "layer", "layer-noaffine"])
def test_norms_match_jax(kind):
    rng = _rng(0)
    x, w, b = _randn(rng, 3, 5, 64, scale=3.0), _randn(rng, 64), _randn(rng, 64)
    if kind == "rms":
        want, got = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w)), tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    elif kind == "layer":
        want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    else:
        want, got = jnorms.layer_norm(jnp.asarray(x)), tnorms.layer_norm(torch.from_numpy(x))
    _close(got, want)


def test_rope_matches_jax():
    rng = _rng(1)
    pos = rng.integers(0, 3000, (2, 7))
    q, k = _randn(rng, 2, 7, 4, 16), _randn(rng, 2, 7, 2, 16)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16, 600000.0)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 16, 600000.0)
    _close(tc, jc)
    _close(ts, js)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    _close(tq, jq)
    _close(tk, jk)


@pytest.mark.parametrize("case", ["causal", "mask-head-major", "gqa-offset"])
def test_mha_matches_jax(case):
    rng = _rng(2)
    B, T, S, Hq, Hkv, D = 2, 5, 9, 4, 2, 16
    q = _randn(rng, B, T, Hq, D)
    head_major = case == "mask-head-major"
    kv_shape = (B, Hkv, S, D) if head_major else (B, S, Hkv, D)
    k, v = _randn(rng, *kv_shape), _randn(rng, *kv_shape)
    if head_major:
        mask = rng.random((B, 1, T, S)) > 0.3
        want = jatt.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask), kv_head_major=True)
        got = tatt.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mask=torch.from_numpy(mask),
                       kv_head_major=True)
    else:  # JAX's is_causal/q_offset against the port's explicit causal mask
        offset, scale = (S - T, None) if case == "causal" else (2, 0.3)
        causal = np.arange(S)[None, :] <= offset + np.arange(T)[:, None]
        want = jatt.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True, q_offset=offset, scale=scale)
        got = tatt.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mask=torch.from_numpy(causal),
                       scale=scale)
    _close(got, want)


def test_cached_decode_attention_matches_jax():
    rng = _rng(3)
    q, kc, vc = _randn(rng, 3, 1, 4, 16), _randn(rng, 3, 2, 12, 16), _randn(rng, 3, 2, 12, 16)
    for length in (1, 7, 12):
        want = jatt.cached_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), length, kv_head_major=True)
        got = tatt.cached_decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), length)
        _close(got, want)


def test_patching_matches_jax():
    rng = _rng(4)
    x = _randn(rng, 2, 16, 8 * 8 * 3)
    _close(tpatch.unpatchify(torch.from_numpy(x), 8), jpatch.unpatchify(jnp.asarray(x), 8))
    y = _randn(rng, 2, 16, 4 * 24)
    _close(tpatch.expand_sem_to_pix_tokens(torch.from_numpy(y), 2), jpatch.expand_sem_to_pix_tokens(jnp.asarray(y), 2))


def test_dense_and_fp32_precision_context():
    rng = _rng(5)
    x, w, b = _randn(rng, 3, 7, 48), _randn(rng, 48, 24), _randn(rng, 24)
    _close(tlin.dense(torch.from_numpy(x), {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}),
           jlin.dense(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)}))
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with tlin.fp32_matmul_precision("high"):
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False)
        with tlin.fp32_matmul_precision("default"):
            assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


# ---------------------------------------------------------------------------
# Bailing-MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [64, 4], ids=["prefill-shape", "decode-shape"])
def test_moe_block_with_image_gate_matches_jax(tiny, T):
    cfg, _, tparams, jparams = tiny
    c = cfg.llm
    rng = _rng(6)
    x = _randn(rng, 1, T, c.hidden_size)
    image_mask = rng.random((1, T)) > 0.5
    layer = 1
    jlayer = jax.tree_util.tree_map(lambda a: a[layer], jparams["llm"]["layers"]["mlp"])
    want = jbm.moe_block_apply(jlayer, c, jnp.asarray(x), jnp.asarray(image_mask),
                               experts_stacked=jparams["llm"]["layers"]["mlp"]["experts"], layer_idx=layer)
    tlayer = layer_view({k: v for k, v in tparams["llm"]["layers"]["mlp"].items() if k != "experts"}, layer)
    got = tbm.moe_block_apply(tlayer, c, torch.from_numpy(x), torch.from_numpy(image_mask),
                              experts_stacked=tparams["llm"]["layers"]["mlp"]["experts"], layer_idx=layer)
    _close(got, want)


@pytest.mark.parametrize("T", [6, 1], ids=["prefill", "decode"])
def test_attention_apply_matches_jax(tiny, T):
    cfg, _, tparams, jparams = tiny
    c = cfg.llm
    rng = _rng(7)
    B, Smax, length = 2, 16, 5
    x = _randn(rng, B, T, c.hidden_size)
    kc, vc = _randn(rng, B, c.num_key_value_heads, Smax, c.head_dim), _randn(rng, B, c.num_key_value_heads, Smax, c.head_dim)
    mask = rng.random((B, Smax)) > 0.3
    mask[:, length : length + T] = True
    pos = length + np.arange(T)[None].repeat(B, 0)
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), c.head_dim, c.rope_theta)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jparams["llm"]["layers"]["attention"])
    want, wk, wv = jbm.attention_apply(jlayer, c, jnp.asarray(x), jcos, jsin, jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.int32(length), jnp.asarray(mask))
    tcos, tsin = trope.rope_cos_sin(torch.from_numpy(pos), c.head_dim, c.rope_theta)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tbm.attention_apply(layer_view(tparams["llm"]["layers"]["attention"], 0), c, torch.from_numpy(x),
                              tcos, tsin, tk, tv, length, torch.from_numpy(mask))
    _close(got, want)
    _close(tk, wk)  # the cache was written in place
    _close(tv, wv)


@pytest.mark.parametrize("norm_head", [False, True])
def test_bailing_forward_prefill_then_decode_matches_jax(tiny, norm_head):
    cfg, _, tparams, jparams = tiny
    c = dataclasses.replace(cfg.llm, norm_head=norm_head)
    rng = _rng(8)
    Smax, T = 96, 64  # 64 prompt tokens: the prefill MoE dispatch
    ids = rng.integers(0, c.vocab_size, (1, T))
    mask = np.zeros((1, Smax), bool)
    mask[:, : T - 3] = True  # right-padded prompt
    jcache = jbm.LLMCache.create(c, 1, Smax, jnp.float32)
    jh, jcache = jbm.bailing_forward(jparams["llm"], c, jbm.embed_tokens(jparams["llm"], jnp.asarray(ids)), jcache,
                                     jnp.asarray(mask))
    tcache = tbm.LLMCache.create(c, 1, Smax, torch.float32)
    th, tcache = tbm.bailing_forward(tparams["llm"], c, tbm.embed_tokens(tparams["llm"], torch.from_numpy(ids)), tcache,
                                     torch.from_numpy(mask))
    _close(th, jh)
    _close(tcache.k, jcache.k)
    assert tcache.length == int(jcache.length)

    # one decode step over 2 CFG rows (the decode MoE / decode-attention dispatch)
    jcache, tcache = jcache.repeat_rows(2), tcache.repeat_rows(2)
    mask2 = np.concatenate([mask, mask], 0)
    mask2[1, :4] = False
    mask2[:, T] = True
    nxt = rng.integers(0, c.vocab_size, (2, 1))
    pos = mask2.sum(1, keepdims=True) - 1
    jh, jcache = jbm.bailing_forward(jparams["llm"], c, jbm.embed_tokens(jparams["llm"], jnp.asarray(nxt)), jcache,
                                     jnp.asarray(mask2), positions=jnp.asarray(pos))
    th, tcache = tbm.bailing_forward(tparams["llm"], c, tbm.embed_tokens(tparams["llm"], torch.from_numpy(nxt)), tcache,
                                     torch.from_numpy(mask2), positions=torch.from_numpy(pos))
    _close(th, jh)
    _close(tcache.v, jcache.v)
    _close(tbm.compute_logits(tparams["llm"], c, th), jbm.compute_logits(jparams["llm"], c, jh), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# RF head, vis_head, linear_proj
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "cfg_rows,n_img,renorm,shift",
    [(1, 1, None, None), (2, 1, "channel", None), (3, 1, "channel", 3.0), (3, 1, None, None), (2, 2, "channel", None)],
    ids=["unguided", "2rows-renorm", "3rows-renorm-shift", "3rows", "2rows-2images"],
)
def test_rf_sample_matches_jax(tiny, cfg_rows, n_img, renorm, shift):
    cfg, _, tparams, jparams = tiny
    rc = cfg.rf_head
    rng = _rng(9)
    z = _randn(rng, cfg_rows * n_img, rc.z_channels)
    noise = _randn(rng, n_img, rc.target_channels)
    kw = dict(temperature=0.7, text_cfg=3.0, image_cfg=1.1, cfg_renorm_type=renorm, time_shifting_factor=shift,
              cfg_rows=cfg_rows)
    want = jrf.rf_sample(jparams["rf_head"], rc, jnp.asarray(z), jax.random.PRNGKey(0), noise=jnp.asarray(noise), **kw)
    got = trf.rf_sample(tparams["rf_head"], rc, torch.from_numpy(z), noise=torch.from_numpy(noise), **kw)
    _close(got, want)


def test_vis_head_and_linear_proj_match_jax(tiny):
    cfg, _, tparams, jparams = tiny
    rng = _rng(10)
    h = _randn(rng, 3, cfg.llm.hidden_size)
    _close(trf.vis_head_apply(tparams["vis_head"], torch.from_numpy(h)), jrf.vis_head_apply(jparams["vis_head"], jnp.asarray(h)))
    f = _randn(rng, 2, 1, cfg.mingtok.feature_dim)
    _close(linear_proj_apply(tparams["linear_proj"], torch.from_numpy(f)), jax_linear_proj(jparams["linear_proj"], jnp.asarray(f)))


# ---------------------------------------------------------------------------
# MingTok decoders
# ---------------------------------------------------------------------------


def test_semantic_decoder_four_cached_steps_match_jax(tiny):
    cfg, _, tparams, jparams = tiny
    mc = cfg.mingtok
    rng = _rng(11)
    jcache = jmt.make_semdec_cache(mc.semantic_decoder, 2, 8, dtype=jnp.float32)
    tcache = tmt.make_semdec_cache(mc.semantic_decoder, 2, 8, dtype=torch.float32)
    for _ in range(4):
        lat = _randn(rng, 2, 1, mc.latent_dim)
        jout, jcache = jmt.mingtok_feature_decoder(jparams["mingtok"], mc, jnp.asarray(lat), jcache, compute_dtype=jnp.float32)
        tout, tcache = tmt.mingtok_feature_decoder(tparams["mingtok"], mc, torch.from_numpy(lat), tcache,
                                                   compute_dtype=torch.float32)
        _close(tout["x_norm_patchtokens"], jout["x_norm_patchtokens"])
    assert isinstance(jcache, JViTCache) and tcache.length == int(jcache.length) == 4
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)


def test_mingtok_pixel_decoder_matches_jax(tiny):
    cfg, _, tparams, jparams = tiny
    feats = _randn(_rng(12), 1, 4, cfg.mingtok.feature_dim)
    want = jmt.mingtok_pixel_decoder(jparams["mingtok"], cfg.mingtok, jnp.asarray(feats))
    got = tmt.mingtok_pixel_decoder(tparams["mingtok"], cfg.mingtok, torch.from_numpy(feats))
    assert got.shape == (1, 3, 32, 32)
    _close(got, want)


# ---------------------------------------------------------------------------
# sampler and parameter bridge
# ---------------------------------------------------------------------------


def test_sample_token_greedy_and_top_k():
    logits = torch.from_numpy(_randn(_rng(13), 4, 50))
    torch.testing.assert_close(sample_token(logits), logits.argmax(-1))
    g = torch.Generator().manual_seed(0)
    top3 = torch.topk(logits, 3).indices
    for _ in range(5):
        tok = sample_token(logits, g, do_sample=True, top_k=3, temperature=0.8)
        assert all(int(t) in top3[i].tolist() for i, t in enumerate(tok))
    tok = sample_token(logits, g, do_sample=True, top_p=1e-6)  # smallest nucleus: the argmax alone
    torch.testing.assert_close(tok, logits.argmax(-1))


def test_init_mm_params_matches_jax_tree(tiny):
    cfg, params, _, _ = tiny
    got = init_mm_params(cfg, device="cpu", dtype=torch.float32, generator=torch.Generator().manual_seed(0))

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in shapes(v, f"{prefix}/{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, v in enumerate(tree) for k2, v2 in shapes(v, f"{prefix}/{i}").items()}
        return {prefix: tuple(tree.shape)}

    assert shapes(got) == shapes(params)  # the MingTok encoder's leaves included
    w = got["llm"]["layers"]["attention"]["query_key_value"]["w"]
    assert float(w.abs().max()) <= 0.04 + 1e-6 and 0.01 < float(w.std()) < 0.02  # truncated at 2 std of 0.02


def test_params_from_jax_converts_bf16_exactly():
    x = jnp.asarray(_randn(_rng(14), 5, 7), jnp.bfloat16)
    t = params_from_jax({"a": [np.asarray(x)]}, "cpu")["a"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))
